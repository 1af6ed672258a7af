"""Fourth-order compact Mehrstellen Poisson (problems/poisson4.py,
core.operators.Const9Op).

Verified: the operator matches a dense 9-point assembly; constant-f RHS
reduces to the second-order RHS exactly (B has unit row sum); multigrid
converges mesh-independently on the 9-point hierarchy; and the headline
property — O(h^4) error against a manufactured solution (ratio 16 per
refinement, vs 4 for the 5-point path on the same problem).
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.core.operators import Const9Op
from tpu_multigrid.cycles import solve_fixed
from tpu_multigrid.problems.poisson4 import (Poisson4Problem,
                                             mehrstellen_rhs)

_SIN = lambda x, y: jnp.sin(math.pi * x) * jnp.sin(math.pi * y)


def _forcing(x, y):
    return 2 * math.pi ** 2 * _SIN(x, y)


class TestOperator:
    def test_matches_dense_9point(self, rng):
        n, S = 8, 9
        op = Const9Op(n, S)
        w = np.array([[-1, -4, -1], [-4, 20, -4], [-1, -4, -1]],
                     np.float64) / 6.0
        u = np.zeros((S, S))
        u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
        want = np.zeros((S, S))
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                want[1:n, 1:n] += (w[di + 1, dj + 1]
                                   * u[1 + di:n + di, 1 + dj:n + dj])
        got = np.asarray(op.apply(jnp.asarray(u)))
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_row_sum_zero_and_spd(self):
        """Constants are in the null space away from the boundary, and the
        interior matrix is symmetric positive definite."""
        n, S = 8, 9
        op = Const9Op(n, S)
        ones = jnp.zeros((S, S), jnp.float64).at[1:n, 1:n].set(1.0)
        out = np.asarray(op.apply(ones))
        np.testing.assert_allclose(out[2:n - 1, 2:n - 1], 0.0, atol=1e-14)
        from tpu_multigrid.core.grids import coarse_dense_inverse
        inv = np.asarray(coarse_dense_inverse(op, dtype=jnp.float64))
        A = np.linalg.inv(inv)
        np.testing.assert_allclose(A, A.T, atol=1e-10)
        assert np.linalg.eigvalsh(A).min() > 0

    def test_constant_rhs_matches_second_order(self):
        from tpu_multigrid.problems.poisson import poisson_rhs
        got = mehrstellen_rhs(16, 17, 4.0, jnp.float64)
        want = poisson_rhs(16, 17, 4.0, jnp.float64)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=0)


class TestConvergence:
    @pytest.mark.parametrize("smoother,nu", [("chebyshev", (3, 2)),
                                             ("rbgs", (1, 1))])
    def test_mesh_independent(self, smoother, nu):
        rhos = []
        for lvl in (5, 6):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother=smoother, nu1=nu[0], nu2=nu[1],
                                  dtype=jnp.float64)
            prob = Poisson4Problem(cfg)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            rhos.append((h[8] / h[0]) ** (1 / 8))
        assert max(rhos) < 0.25, rhos


class TestAccuracy:
    def test_o_h4_vs_o_h2(self):
        """The headline: error ratio ~16 per refinement at order=4
        (vs ~4 at order=2 on the same problem)."""
        errs = {2: {}, 4: {}}
        for order in (2, 4):
            for lvl in (4, 5):
                n = 2 ** lvl
                cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                      smoother="chebyshev", nu1=3, nu2=2,
                                      dtype=jnp.float64)
                r = mg.solve_poisson(lvl, order=order, forcing=_forcing,
                                     config=cfg, tol=1e-13, max_cycles=40)
                S = n + 1
                h = 1.0 / n
                x = np.arange(S)[None, :] * h
                y = np.arange(S)[:, None] * h
                want = np.sin(math.pi * x) * np.sin(math.pi * y)
                errs[order][lvl] = np.abs(
                    np.asarray(r.u)[:S, :S] - want)[1:n, 1:n].max()
        r4 = errs[4][4] / errs[4][5]
        r2 = errs[2][4] / errs[2][5]
        assert 13.0 < r4 < 19.0, errs
        assert 3.0 < r2 < 5.5, errs
        # at level 5 the 4th-order answer is far more accurate outright
        assert errs[4][5] < 0.01 * errs[2][5], errs

    def test_boundary_lifting(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        r = mg.solve_poisson(5, order=4, forcing=0.0, boundary=1.5,
                             config=cfg, tol=1e-12)
        u = np.asarray(r.u)[:33, :33]
        np.testing.assert_allclose(u, 1.5, atol=1e-10)
