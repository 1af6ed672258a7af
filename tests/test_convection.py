"""Convection-diffusion (problems/convection.py): nonsymmetric upwind
operators through the whole driver stack.

Verified: the Poisson limit (b = 0) reproduces the 5-point stencil
exactly; the upwind operator is an M-matrix at any Peclet; multigrid with
rbgs smoothing converges mesh-independently on re-discretized
hierarchies; and first-order (O(h)) accuracy against a manufactured
solution.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_multigrid import (ConvectionDiffusionProblem, MultigridConfig,
                           solve_convection_diffusion)
from tpu_multigrid.cycles import solve_fixed
from tpu_multigrid.problems.convection import convection_diffusion_op


class TestOperator:
    def test_poisson_limit(self):
        op = convection_diffusion_op(8, 9, 1.0, 0.0, 0.0, dtype=np.float64)
        c = np.asarray(op.coef)
        assert c[1, 1, 4, 4] == 4.0
        for di, dj in ((0, 1), (2, 1), (1, 0), (1, 2)):
            assert c[di, dj, 4, 4] == -1.0

    @pytest.mark.parametrize("bx,by", [(3.0, 0.0), (-2.0, 5.0),
                                       (1.0, -1.0)])
    def test_m_matrix_at_any_peclet(self, bx, by):
        """Upwinding: positive diagonal, nonpositive off-diagonals, zero
        row sums on the interior — at a mesh Peclet where central
        differencing would have positive off-diagonals."""
        n, S = 16, 17
        op = convection_diffusion_op(n, S, 1e-4, bx, by, dtype=np.float64)
        c = np.asarray(op.coef)
        inter = np.s_[2:n - 1, 2:n - 1]  # away from masked neighbors
        assert (c[1, 1][inter] > 0).all()
        for di in (0, 1, 2):
            for dj in (0, 1, 2):
                if di == 1 and dj == 1:
                    continue
                assert (c[di, dj][inter] <= 0).all(), (di, dj)
        rowsum = c.sum(axis=(0, 1))
        np.testing.assert_allclose(rowsum[inter], 0.0, atol=1e-15)

    def test_upwind_direction_follows_sign(self):
        n, S = 8, 9
        op = convection_diffusion_op(n, S, 0.0, 2.0, 0.0, dtype=np.float64)
        c = np.asarray(op.coef)
        h = 1.0 / n
        # bx > 0: donor is WEST (j-1); east coupling zero
        assert c[1, 0, 4, 4] == pytest.approx(-2.0 * h)
        assert c[1, 2, 4, 4] == 0.0


class TestConvergence:
    @pytest.mark.parametrize("eps", [0.01, 0.0025])
    def test_rbgs_h_independent(self, eps):
        rhos = []
        for lvl in (5, 6):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother="rbgs", nu1=2, nu2=2,
                                  dtype=jnp.float64)
            prob = ConvectionDiffusionProblem(cfg, eps=eps, bx=1.0, by=0.5)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            rhos.append((h[8] / h[0]) ** (1 / 8))
        assert max(rhos) < 0.35, rhos

    def test_variable_wind(self):
        """Recirculating wind b = (y - 1/2, 1/2 - x)."""
        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="rbgs", nu1=2, nu2=2,
                              dtype=jnp.float64)
        prob = ConvectionDiffusionProblem(
            cfg, eps=0.02,
            bx=lambda x, y: y - 0.5, by=lambda x, y: 0.5 - x)
        res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 10)
        h = np.asarray(res.res_history)
        assert (h[10] / h[0]) ** 0.1 < 0.35

    def test_galerkin_option_low_peclet(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="rbgs", nu1=2, nu2=2,
                              dtype=jnp.float64)
        prob = ConvectionDiffusionProblem(cfg, eps=1.0, bx=1.0, by=1.0,
                                          hierarchy_method="galerkin")
        res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
        h = np.asarray(res.res_history)
        assert (h[8] / h[0]) ** (1 / 8) < 0.25


class TestAccuracy:
    def test_manufactured_o_h(self):
        """u = sin(pi x) sin(pi y); upwinding is first order, so the max
        error halves per refinement."""
        eps, bx, by = 0.5, 1.0, 0.5

        def forcing(x, y):
            s, c = jnp.sin, jnp.cos
            pi = math.pi
            return (eps * 2 * pi ** 2 * s(pi * x) * s(pi * y)
                    + bx * pi * c(pi * x) * s(pi * y)
                    + by * pi * s(pi * x) * c(pi * y))

        errs = {}
        for lvl in (4, 5, 6):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother="rbgs", nu1=2, nu2=2,
                                  dtype=jnp.float64)
            prob = ConvectionDiffusionProblem(cfg, eps=eps, bx=bx, by=by,
                                              forcing=forcing)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 14)
            S = prob.finest.S
            h = 1.0 / n
            x = np.arange(S)[None, :] * h
            y = np.arange(S)[:, None] * h
            want = np.sin(math.pi * x) * np.sin(math.pi * y)
            errs[lvl] = np.abs(np.asarray(res.u) - want)[1:n, 1:n].max()
        r45 = errs[4] / errs[5]
        r56 = errs[5] / errs[6]
        assert 1.5 < r45 < 3.0, errs
        assert 1.5 < r56 < 3.0, errs


class TestAPI:
    def test_solve_convection_diffusion(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="rbgs", nu1=2, nu2=2,
                              dtype=jnp.float64)
        r = solve_convection_diffusion(5, eps=0.05, bx=1.0, by=0.0,
                                       tol=1e-10, config=cfg)
        assert bool(r.converged) and int(r.iterations) <= 20

    def test_boundary_lifting(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="rbgs", nu1=2, nu2=2,
                              dtype=jnp.float64)
        r = solve_convection_diffusion(5, eps=0.1, bx=1.0, by=0.5,
                                       forcing=0.0, boundary=3.0,
                                       tol=1e-10, config=cfg)
        u = np.asarray(r.u)[:33, :33]
        # zero forcing + constant boundary: constants are in the null
        # space of b.grad and lap alike => u == boundary
        np.testing.assert_allclose(u, 3.0, atol=1e-8)
