"""Remaining 3D families on the generic GSPMD vehicle (r4, VERDICT #5
follow-through): periodic torus, Mehrstellen order-4, mixed
Dirichlet/Neumann boxes, and reaction-shifted diffusion all accept
``mesh=`` through ``dist.mesh.gspmd_solve_hierarchy`` (grid_ndim=3) and
must reproduce the single-chip trajectory and solution."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.dist.mesh import make_grid_mesh


def _traj_match(res, ref, rtol_shallow=2e-3, rtol_deep=0.2):
    h = np.asarray(res.res_history)
    hr = np.asarray(ref.res_history)
    shallow = hr / hr[0] >= 1e-3
    np.testing.assert_allclose((h / h[0])[shallow], (hr / hr[0])[shallow],
                               rtol=rtol_shallow)
    np.testing.assert_allclose((h / h[0])[~shallow],
                               (hr / hr[0])[~shallow], rtol=rtol_deep)


def _mesh22():
    return make_grid_mesh(shape=(2, 2), devices=jax.devices()[:4])


def test_periodic3d_gspmd_matches_single_chip():
    cfg = MultigridConfig(finest_level=4, coarsest_level=1,
                          dtype=jnp.float32, smoother="chebyshev",
                          nu1=3, nu2=2)
    two_pi = 2.0 * math.pi

    def f(x, y, z):
        return (jnp.sin(two_pi * x) * jnp.sin(two_pi * y)
                * jnp.sin(two_pi * z))

    kw = dict(bc="periodic", forcing=f, config=cfg, num_cycles=5,
              tol=None)
    res = mg.solve_poisson3d(4, mesh=_mesh22(), **kw)
    ref = mg.solve_poisson3d(4, **kw)
    _traj_match(res, ref)
    # Mean-zero gauge on both sides; compare directly.
    np.testing.assert_allclose(np.asarray(res.u), np.asarray(ref.u),
                               rtol=1e-4, atol=1e-7)


def test_mehrstellen3d_gspmd_matches_single_chip():
    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          dtype=jnp.float32, smoother="chebyshev",
                          nu1=3, nu2=2)
    kw = dict(order=4, config=cfg, num_cycles=5, tol=None)
    res = mg.solve_poisson3d(4, mesh=_mesh22(), **kw)
    ref = mg.solve_poisson3d(4, **kw)
    _traj_match(res, ref)
    # Layouts differ (mesh= pads to even extents): compare the physical
    # node block only.
    n = 16
    u = np.asarray(res.u)[: n + 1, : n + 1, : n + 1]
    ur = np.asarray(ref.u)[: n + 1, : n + 1, : n + 1]
    np.testing.assert_allclose(u, ur, rtol=1e-4, atol=1e-7)


def test_mehrstellen3d_gspmd_fmg_seed():
    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          dtype=jnp.float32, smoother="chebyshev",
                          nu1=3, nu2=2)
    kw = dict(order=4, config=cfg, num_cycles=3, tol=None, use_fmg=True)
    res = mg.solve_poisson3d(4, mesh=_mesh22(), **kw)
    ref = mg.solve_poisson3d(4, **kw)
    # FMG seeds start deep, so relative reductions magnify the f32
    # roundoff difference between the padded (mesh=) and unpadded
    # single-chip layouts — loosen the shallow band accordingly.
    _traj_match(res, ref, rtol_shallow=1e-2)


def test_mixedbc3d_gspmd_matches_single_chip():
    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          dtype=jnp.float32, smoother="chebyshev",
                          nu1=3, nu2=2)
    kw = dict(neumann=("xhi", "ylo"), neumann_value=0.25, config=cfg,
              num_cycles=5, tol=None)
    res = mg.solve_poisson3d(4, mesh=_mesh22(), **kw)
    ref = mg.solve_poisson3d(4, **kw)
    _traj_match(res, ref)
    n = 16
    u = np.asarray(res.u)[: n + 1, : n + 1, : n + 1]
    ur = np.asarray(ref.u)[: n + 1, : n + 1, : n + 1]
    np.testing.assert_allclose(u, ur, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("use_fmg", [False, True])
def test_diffusion3d_shift_gspmd_matches_single_chip(use_fmg):
    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          dtype=jnp.float32, smoother="chebyshev",
                          nu1=3, nu2=2)

    def a(x, y, z):
        return 1.0 + 0.5 * jnp.sin(3.0 * x) * jnp.cos(2.0 * y + z)

    kw = dict(coefficient=a, shift=4.0, config=cfg,
              num_cycles=3 if use_fmg else 5, tol=None, use_fmg=use_fmg)
    res = mg.solve_diffusion3d(4, mesh=_mesh22(), **kw)
    ref = mg.solve_diffusion3d(4, **kw)
    _traj_match(res, ref)
    # the mesh path pads its levels so they shard; compare physical nodes
    n = 16
    u = np.asarray(res.u)[: n + 1, : n + 1, : n + 1]
    ur = np.asarray(ref.u)[: n + 1, : n + 1, : n + 1]
    np.testing.assert_allclose(u, ur, rtol=1e-4, atol=1e-7)


def test_gspmd3_leaves_actually_shard():
    """Guard against the silent-replication failure mode: the padded
    finest level of a mesh= Mehrstellen solve must divide a (2, 2) mesh
    (dist.mesh._shard_leaf shards only divisible extents)."""
    from tpu_multigrid.problems.poisson4_3d import Poisson4_3DProblem

    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          dtype=jnp.float32)
    problem = Poisson4_3DProblem(cfg, align=16, min_pad_level=0,
                                 lane_align=128)
    op = problem.hierarchy.levels[0]
    Sz, Sy, _ = op.grid_shape
    assert Sz % 2 == 0 and Sy % 2 == 0
