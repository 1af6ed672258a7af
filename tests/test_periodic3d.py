"""Periodic (3-torus) Poisson (problems/periodic3d.py).

The 3D torus pair carries the same variational scaling as the Dirichlet
3D transfers (R = P^T / 2 — the h-independent 7-point stencil scales
linearly with h in 3D); the missing factor made deep hierarchies
DIVERGE (rho 1.5 at level 5) while 2- and 3-level solves still looked
plausible, so the mesh-independence test here spans >= 4 levels.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.cycles import solve_fixed
from tpu_multigrid.problems.periodic3d import (Periodic3DPoissonProblem,
                                               PeriodicOp3,
                                               periodic3_coarse_pinv)

pi = math.pi


def _forcing(x, y, z):
    return (12 * pi ** 2 * jnp.sin(2 * pi * x) * jnp.cos(2 * pi * y)
            * jnp.sin(2 * pi * z))


class TestOperator:
    def test_matches_dense_circulant(self, rng):
        n = 4
        op = PeriodicOp3(n)
        m = n ** 3
        idx = np.arange(m).reshape(n, n, n)
        A = 6.0 * np.eye(m)
        for ax in (0, 1, 2):
            for d in (1, -1):
                A[idx.ravel(), np.roll(idx, d, axis=ax).ravel()] -= 1.0
        u = rng.standard_normal((n, n, n))
        got = np.asarray(op.apply(jnp.asarray(u)))
        np.testing.assert_allclose(got,
                                   (A @ u.ravel()).reshape(n, n, n),
                                   atol=1e-13)

    def test_transfer_adjoint_up_to_variational_half(self, rng):
        """restrict_into == P^T/2 exactly: <R r, e> == <r, P e>/2."""
        nf = 8
        opc = PeriodicOp3(nf // 2)
        fine = PeriodicOp3(nf)
        r = rng.standard_normal((nf, nf, nf))
        e = rng.standard_normal((nf // 2,) * 3)
        Rr = np.asarray(opc.restrict_into(jnp.asarray(r), fine))
        Pe = np.asarray(opc.prolong_add_into(
            jnp.zeros((nf, nf, nf)), jnp.asarray(e), fine))
        np.testing.assert_allclose((Rr * e).sum(), 0.5 * (r * Pe).sum(),
                                   rtol=1e-12)
        # mean-zero subspace invariant
        r0 = r - r.mean()
        assert abs(np.asarray(opc.restrict_into(
            jnp.asarray(r0), fine)).mean()) < 1e-14

    def test_pinv_mean_zero(self, rng):
        n = 4
        pinv = np.asarray(periodic3_coarse_pinv(n, jnp.float64))
        b = rng.standard_normal((n, n, n))
        b -= b.mean()
        sol = (pinv @ b.ravel()).reshape(n, n, n)
        assert abs(sol.mean()) < 1e-12
        got = np.asarray(PeriodicOp3(n).apply(jnp.asarray(sol)))
        np.testing.assert_allclose(got, b, atol=1e-10)


class TestSolve:
    def test_mesh_independent_rho_deep_hierarchy(self):
        """>= 4 levels: this is the depth where a wrong variational
        scaling diverges (see module docstring)."""
        rhos = []
        for lvl in (4, 5):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            prob = Periodic3DPoissonProblem(cfg, forcing=_forcing)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            rhos.append((h[8] / h[0]) ** (1 / 8))
        assert max(rhos) < 0.25, rhos

    def test_o_h2_via_api(self):
        errs = {}
        for lvl in (3, 4):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            r = mg.solve_poisson3d(lvl, bc="periodic", forcing=_forcing,
                                   config=cfg, num_cycles=12)
            idx = np.arange(n) / n
            want = (np.sin(2 * pi * idx)[None, None, :]
                    * np.cos(2 * pi * idx)[None, :, None]
                    * np.sin(2 * pi * idx)[:, None, None])
            got = np.array(r.u)
            got -= got.mean()
            errs[lvl] = np.abs(got - (want - want.mean())).max()
        assert 3.0 < errs[3] / errs[4] < 5.5, errs

    def test_extract_solution_wrap(self):
        cfg = MultigridConfig(finest_level=3, coarsest_level=2,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        r = mg.solve_poisson3d(3, bc="periodic", forcing=_forcing,
                               config=cfg, num_cycles=6)
        u = np.asarray(mg.extract_solution(r.u, 8))
        assert u.shape == (9, 9, 9)
        np.testing.assert_array_equal(u[8], u[0])

    def test_incompatible_options(self):
        with pytest.raises(ValueError):
            mg.solve_poisson3d(3, bc="periodic", forcing=_forcing,
                               refined=True)
        with pytest.raises(ValueError):
            mg.solve_poisson3d(3, bc="nonsense")
