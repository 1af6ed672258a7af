"""Distributed 3D variable-coefficient diffusion (dist/local_var3.py,
shard_cycle3.build_sharded_diffusion3): completes the distribution
matrix (2D const/var and 3D const were already distributed).

Plain-jnp shard_map at 8 virtual devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tpu_multigrid import MultigridConfig
from tpu_multigrid.core.operators import diffusion_op3_host
from tpu_multigrid.dist import local_var3 as V3
from tpu_multigrid.dist.shard_cycle3 import (make_grid_mesh3,
                                             sharded_solve3)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _coef(x, y, z):
    return 1.0 + 10.0 * ((x > 0.5) & (z > 0.5))


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_local_var3_ops_match_global(mesh_shape, rng):
    """Shard-local 7-point flux ops == the global VarStencilOp3D (f64)."""
    mz, my = mesh_shape
    mesh = make_grid_mesh3(shape=mesh_shape,
                           devices=jax.devices()[: mz * my])
    n, S = 14, 16
    op = diffusion_op3_host(rng.uniform(0.5, 2.0, (n, n, n)), n, S, S)
    u = np.zeros((S, S, S))
    b = np.zeros((S, S, S))
    u[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
    b[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
    u, b = jnp.asarray(u), jnp.asarray(b)
    planes = tuple(jnp.asarray(t)
                   for t in (op.tz, op.ty, op.tx, op.inv_diag))
    opj = jax.device_put(op)

    from jax import shard_map
    spec = P("gz", "gy", None)

    cases = [
        ("apply", lambda ul, bl, pl: V3.var3_apply_local(ul, *pl, n),
         opj.apply(u)),
        ("residual", lambda ul, bl, pl: V3.var3_residual_local(
            ul, bl, *pl, n), opj.residual(u, b)),
        ("jacobi3", lambda ul, bl, pl: V3.var3_jacobi_local(
            ul, bl, *pl, n, 2 / 3, 3),
         opj.smooth(u, b, smoother="jacobi", omega=2 / 3, sweeps=3)),
        ("rbgs2", lambda ul, bl, pl: V3.var3_rbgs_local(
            ul, bl, *pl, n, 2),
         opj.smooth(u, b, smoother="rbgs", omega=2 / 3, sweeps=2)),
    ]
    for name, fn, want in cases:
        got = jax.jit(shard_map(
            fn, mesh=mesh, in_specs=(spec, spec, (spec,) * 4),
            out_specs=spec, check_vma=False))(u, b, planes)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-12, err_msg=name)


def test_parity_2x2_vs_1x1():
    """Identical level sizes at (2,2) and (1,1) => identical residual
    histories up to f32 reduction-order noise."""
    cfg = MultigridConfig(finest_level=5, coarsest_level=2,
                          smoother="chebyshev", nu1=3, nu2=2)
    r1, l1 = sharded_solve3(cfg, make_grid_mesh3(shape=(1, 1),
                                                 devices=jax.devices()[:1]),
                            coefficient=_coef, num_cycles=4, tol=0.0,
                            replicate_below=4)
    r4, l4 = sharded_solve3(cfg, make_grid_mesh3(shape=(2, 2),
                                                 devices=jax.devices()[:4]),
                            coefficient=_coef, num_cycles=4, tol=0.0,
                            replicate_below=4)
    assert l1.sizes == l4.sizes
    # f32: per-shard psum reduction order differs from the single-shard
    # sum, and the noise compounds through the cycles — measured 5.5e-5
    # relative after 4 cycles at this size.
    np.testing.assert_allclose(np.asarray(r4.res_history),
                               np.asarray(r1.res_history), rtol=3e-4)


def test_convergence_2x4():
    res, levels = sharded_solve3(
        cfg := MultigridConfig(finest_level=5, coarsest_level=2,
                               smoother="chebyshev", nu1=3, nu2=2),
        make_grid_mesh3(shape=(2, 4), devices=jax.devices()[:8]),
        coefficient=_coef, num_cycles=5, tol=0.0, replicate_below=4)
    h = np.asarray(res.res_history)
    assert np.isfinite(h).all()
    assert h[5] < 5e-3 * h[0], h


def test_matches_single_chip_problem():
    """The sharded var solve reaches the same physical solution as the
    single-chip Diffusion3DProblem machinery (same cells, different
    padding/layout)."""
    from tpu_multigrid.cycles import solve_fixed
    from tpu_multigrid.problems.diffusion3d import Diffusion3DProblem

    n = 16
    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          smoother="chebyshev", nu1=3, nu2=2)
    prob = Diffusion3DProblem(cfg, coefficient=_coef, align=1,
                              min_pad_level=99, lane_align=1)
    res1 = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 12)
    mesh = make_grid_mesh3(shape=(2, 2), devices=jax.devices()[:4])
    res2, _ = sharded_solve3(cfg, mesh, coefficient=_coef, forcing=6.0,
                             num_cycles=12, tol=0.0, replicate_below=4)
    u1 = np.asarray(res1.u)[: n + 1, : n + 1, : n + 1]
    u2 = np.asarray(res2.u)[: n + 1, : n + 1, : n + 1]
    rel = (np.linalg.norm((u1 - u2).ravel())
           / np.linalg.norm(u1.ravel()))
    assert rel < 1e-5, rel
