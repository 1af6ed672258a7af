"""Periodic (torus) Poisson (problems/periodic.py).

Verified: the wrap-around operator matches a dense circulant assembly;
the transfer pair is an exact adjoint and preserves the mean-zero
subspace; the coarse pseudo-inverse returns the mean-zero
representative; multigrid converges mesh-independently; O(h^2) accuracy
against a periodic manufactured solution.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.cycles import solve_fixed
from tpu_multigrid.problems.periodic import (PeriodicOp,
                                             PeriodicPoissonProblem,
                                             periodic_coarse_pinv)


def _forcing(x, y):
    return (8 * math.pi ** 2 * jnp.sin(2 * math.pi * x)
            * jnp.cos(2 * math.pi * y))


class TestOperator:
    def test_matches_dense_circulant(self, rng):
        n = 8
        op = PeriodicOp(n)
        m = n * n
        idx = np.arange(m).reshape(n, n)
        A = 4.0 * np.eye(m)
        for ax, d in ((0, 1), (0, -1), (1, 1), (1, -1)):
            A[idx.ravel(), np.roll(idx, d, axis=ax).ravel()] -= 1.0
        u = rng.standard_normal((n, n))
        got = np.asarray(op.apply(jnp.asarray(u)))
        want = (A @ u.ravel()).reshape(n, n)
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_constants_in_null_space(self):
        op = PeriodicOp(16)
        ones = jnp.ones((16, 16), jnp.float64)
        np.testing.assert_allclose(np.asarray(op.apply(ones)), 0.0,
                                   atol=1e-14)

    def test_transfer_adjoint_and_mean_preserving(self, rng):
        nf = 16
        opc = PeriodicOp(nf // 2)
        r = rng.standard_normal((nf, nf))
        e = rng.standard_normal((nf // 2, nf // 2))
        Rr = np.asarray(opc.restrict_into(jnp.asarray(r), PeriodicOp(nf)))
        Pe = np.asarray(opc.prolong_add_into(
            jnp.zeros((nf, nf)), jnp.asarray(e), PeriodicOp(nf)))
        np.testing.assert_allclose((Rr * e).sum(), (r * Pe).sum(),
                                   rtol=1e-12)
        # mean-zero subspace is invariant under both transfers
        r0 = r - r.mean()
        e0 = e - e.mean()
        assert abs(np.asarray(opc.restrict_into(
            jnp.asarray(r0), PeriodicOp(nf))).mean()) < 1e-14
        assert abs(np.asarray(opc.prolong_add_into(
            jnp.zeros((nf, nf)), jnp.asarray(e0),
            PeriodicOp(nf))).mean()) < 1e-14

    def test_pinv_gives_mean_zero_solution(self, rng):
        n = 8
        pinv = np.asarray(periodic_coarse_pinv(n, jnp.float64))
        b = rng.standard_normal((n, n))
        b -= b.mean()
        sol = (pinv @ b.ravel()).reshape(n, n)
        assert abs(sol.mean()) < 1e-12
        got = np.asarray(PeriodicOp(n).apply(jnp.asarray(sol)))
        np.testing.assert_allclose(got, b, atol=1e-10)


class TestSolve:
    def test_mesh_independent_rho(self):
        rhos = []
        for lvl in (5, 6):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            prob = PeriodicPoissonProblem(cfg, forcing=_forcing)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            rhos.append((h[8] / h[0]) ** (1 / 8))
        assert max(rhos) < 0.25, rhos

    def test_o_h2_manufactured(self):
        errs = {}
        for lvl in (4, 5):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            r = mg.solve_poisson(lvl, bc="periodic", forcing=_forcing,
                                 config=cfg, tol=1e-11, max_cycles=40)
            assert bool(r.converged)
            h = 1.0 / n
            x = np.arange(n)[None, :] * h
            y = np.arange(n)[:, None] * h
            want = np.sin(2 * math.pi * x) * np.cos(2 * math.pi * y)
            got = np.asarray(r.u)
            errs[lvl] = np.abs((got - got.mean())
                               - (want - want.mean())).max()
        assert 3.0 < errs[4] / errs[5] < 5.5, errs

    def test_extract_solution_appends_wrap(self):
        cfg = MultigridConfig(finest_level=4, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        r = mg.solve_poisson(4, bc="periodic", forcing=_forcing,
                             config=cfg, num_cycles=6)
        u = np.asarray(mg.extract_solution(r.u, 16))
        assert u.shape == (17, 17)
        np.testing.assert_array_equal(u[16], u[0])
        np.testing.assert_array_equal(u[:, 16], u[:, 0])

    def test_incompatible_options_rejected(self):
        with pytest.raises(ValueError):
            mg.solve_poisson(4, bc="periodic", forcing=_forcing,
                             boundary=1.0)
        with pytest.raises(ValueError):
            mg.solve_poisson(4, bc="periodic", forcing=4.0)  # constant f
        with pytest.raises(ValueError):
            mg.solve_poisson(4, bc="nonsense")
