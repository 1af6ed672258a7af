"""Anisotropic Poisson + zebra line relaxation (core/lines.py,
problems/anisotropic.py).

The headline property: at strong anisotropy, point smoothing stalls while
zebra lines along the strong axis keep the textbook mesh-independent
factor.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_multigrid import AnisotropicPoissonProblem, MultigridConfig
from tpu_multigrid.core import lines, ops
from tpu_multigrid.cycles import solve_until_tol
from tpu_multigrid.problems.anisotropic import anisotropic_poisson_op


class TestPCR:
    @pytest.mark.parametrize("S", [8, 37, 128])
    def test_matches_dense_solve(self, rng, S):
        dl = rng.standard_normal(S) * 0.3
        du = rng.standard_normal(S) * 0.3
        d = 2.0 + rng.random(S)          # diagonally dominant
        dl[0] = du[-1] = 0.0
        b = rng.standard_normal(S)
        T = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
        want = np.linalg.solve(T, b)
        got = lines.tridiag_pcr(jnp.asarray(dl), jnp.asarray(d),
                                jnp.asarray(du), jnp.asarray(b))
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10)

    def test_batched(self, rng):
        B, S = 5, 64
        dl = rng.standard_normal((B, S)) * 0.3
        du = rng.standard_normal((B, S)) * 0.3
        d = 2.0 + rng.random((B, S))
        dl[:, 0] = du[:, -1] = 0.0
        b = rng.standard_normal((B, S))
        got = np.asarray(lines.tridiag_pcr(
            jnp.asarray(dl), jnp.asarray(d), jnp.asarray(du),
            jnp.asarray(b)))
        for k in range(B):
            T = (np.diag(d[k]) + np.diag(dl[k, 1:], -1)
                 + np.diag(du[k, :-1], 1))
            np.testing.assert_allclose(got[k], np.linalg.solve(T, b[k]),
                                       rtol=1e-9)


class TestZebra:
    @pytest.mark.parametrize("axis,name", [(1, "zebra_x"), (0, "zebra_y")])
    def test_fixed_point(self, rng, axis, name):
        n, S = 16, 17
        op = anisotropic_poisson_op(n, S, 50.0, 1.0, dtype=np.float64)
        u = np.zeros((S, S))
        u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
        u = jnp.asarray(u)
        b = op.apply(u)
        out = op.smooth(u, b, smoother=name, omega=1.0, sweeps=3)
        np.testing.assert_allclose(np.asarray(out), np.asarray(u),
                                   atol=1e-10)

    def test_zebra_reduces_residual(self, rng):
        n, S = 32, 33
        op = anisotropic_poisson_op(n, S, 100.0, 1.0, dtype=np.float64)
        b = ops.mask_interior(jnp.asarray(rng.standard_normal((S, S))), n)
        u = jnp.zeros((S, S))
        u = op.smooth(u, b, smoother="zebra_x", omega=1.0, sweeps=2)
        r = float(ops.norm2(op.residual(u, b)) / ops.norm2(b))
        assert r < 0.5


class TestSolve:
    def test_point_smoother_stalls_zebra_does_not(self):
        """eps = 100:1.  V(2,2) with point Jacobi: factor near 1; with
        zebra lines along the strong axis: textbook factor."""
        eps = 100.0
        base = MultigridConfig(finest_level=5, coarsest_level=2,
                               nu1=2, nu2=2, dtype=jnp.float64)

        def rho(cfg):
            prob = AnisotropicPoissonProblem(cfg, eps_x=eps, eps_y=1.0)
            res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                  tol=1e-10, max_cycles=25,
                                  stall_factor=1.0)
            hist = np.asarray(res.res_history)
            n_it = int(res.iterations)
            return (hist[n_it] / hist[0]) ** (1.0 / max(n_it, 1)), res

        import dataclasses
        r_point, _ = rho(base)
        r_zebra, res_z = rho(dataclasses.replace(base, smoother="zebra_x"))
        assert r_point > 0.55, r_point         # point smoothing stalls
        assert r_zebra < 0.15, r_zebra         # lines restore the factor
        assert bool(res_z.converged)

    def test_zebra_mesh_independent(self):
        rhos = []
        for lvl in (4, 5, 6):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  nu1=1, nu2=1, smoother="zebra_x",
                                  dtype=jnp.float64)
            prob = AnisotropicPoissonProblem(cfg, eps_x=1000.0, eps_y=1.0)
            res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                  tol=1e-10, max_cycles=30)
            assert bool(res.converged)
            hist = np.asarray(res.res_history)
            n_it = int(res.iterations)
            rhos.append((hist[n_it] / hist[0]) ** (1.0 / n_it))
        assert max(rhos) < 0.25, rhos
        assert max(rhos) - min(rhos) < 0.1, rhos

    def test_transposed_anisotropy_uses_zebra_y(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=2,
                              nu1=1, nu2=1, smoother="zebra_y",
                              dtype=jnp.float64)
        prob = AnisotropicPoissonProblem(cfg, eps_x=1.0, eps_y=100.0)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-10,
                              max_cycles=30)
        assert bool(res.converged)

    def test_matches_dense_solve(self):
        n = 16
        cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                              smoother="zebra_x", dtype=jnp.float64)
        prob = AnisotropicPoissonProblem(cfg, eps_x=25.0, eps_y=1.0)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-12,
                              max_cycles=40)
        op = prob.finest
        m = (n - 1) ** 2
        A = np.zeros((m, m))
        idx = np.arange(m).reshape(n - 1, n - 1)
        coef = np.asarray(op.coef, np.float64)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                C = coef[di + 1, dj + 1, 1:n, 1:n]
                i0, i1 = max(0, -di), (n - 1) - max(0, di)
                j0, j1 = max(0, -dj), (n - 1) - max(0, dj)
                A[idx[i0:i1, j0:j1].ravel(),
                  idx[i0 + di:i1 + di, j0 + dj:j1 + dj].ravel()] += \
                    C[i0:i1, j0:j1].ravel()
        b = np.asarray(prob.rhs())[1:n, 1:n].ravel()
        want = np.linalg.solve(A, b)
        np.testing.assert_allclose(np.asarray(res.u)[1:n, 1:n].ravel(),
                                   want, rtol=1e-9)

    def test_isotropic_zebra_still_works(self):
        """Zebra on the isotropic operator: sanity (it is just line GS)."""
        cfg = MultigridConfig(finest_level=5, coarsest_level=2,
                              nu1=1, nu2=1, smoother="zebra_x",
                              dtype=jnp.float64)
        prob = AnisotropicPoissonProblem(cfg, eps_x=1.0, eps_y=1.0)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-10,
                              max_cycles=25)
        assert bool(res.converged)


class TestRotated:
    """Rotated anisotropy: -div(K grad u), K = R(t) diag(ex, ey) R(t)^T.

    The classic hard case: at 45 degrees the strong direction is
    off-grid, so neither axis-aligned remedy is exact; Galerkin
    coarsening + zebra lines give the textbook degraded-but-usable
    factors (measured rho ~0.34/0.41 at eps 0.05, levels 5/6), and
    MG-preconditioned CG restores fast convergence.
    """

    def test_angle_zero_matches_axis_aligned(self):
        import numpy as np
        a0 = anisotropic_poisson_op(16, 17, 50.0, 1.0, dtype=np.float64)
        a1 = anisotropic_poisson_op(16, 17, 50.0, 1.0, angle=0.0,
                                    dtype=np.float64)
        np.testing.assert_array_equal(np.asarray(a0.coef),
                                      np.asarray(a1.coef))

    def test_matches_dense_and_spd(self, rng):
        import math

        import numpy as np

        from tpu_multigrid.core.grids import coarse_dense_inverse

        n, S = 8, 9
        th = math.radians(30)
        op = anisotropic_poisson_op(n, S, 1.0, 0.05, angle=th,
                                    dtype=np.float64)
        inv = np.asarray(coarse_dense_inverse(op, dtype=jnp.float64))
        A = np.linalg.inv(inv)
        np.testing.assert_allclose(A, A.T, atol=1e-10)
        assert np.linalg.eigvalsh(A).min() > 0
        # operator action == dense action on a random interior grid
        u = np.zeros((S, S))
        u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
        got = np.asarray(op.apply(jnp.asarray(u)))[1:n, 1:n].ravel()
        want = A @ u[1:n, 1:n].ravel()
        np.testing.assert_allclose(got, want, atol=1e-12)

    @pytest.mark.parametrize("smoother,nu", [("zebra_x", (1, 1)),
                                             ("rbgs", (2, 2))])
    def test_45deg_usable_rate(self, smoother, nu):
        import math

        from tpu_multigrid.cycles import solve_fixed

        rhos = []
        for lvl in (5, 6):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother=smoother, nu1=nu[0], nu2=nu[1],
                                  dtype=jnp.float64)
            prob = AnisotropicPoissonProblem(cfg, eps_x=1.0, eps_y=0.05,
                                             angle=math.radians(45))
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 10)
            h = np.asarray(res.res_history)
            rhos.append((h[10] / h[0]) ** 0.1)
        assert max(rhos) < 0.5, rhos

    def test_pcg_wraps_hard_rotation(self):
        import math

        import jax

        from tpu_multigrid.krylov import pcg_solve

        cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                              smoother="zebra_x", nu1=1, nu2=1,
                              dtype=jnp.float64)
        prob = AnisotropicPoissonProblem(cfg, eps_x=1.0, eps_y=0.01,
                                         angle=math.radians(45))
        res = jax.jit(lambda h, b: pcg_solve(
            h, cfg, b, tol=1e-10, max_iters=40))(prob.hierarchy,
                                                 prob.rhs())
        assert bool(res.converged) and int(res.iterations) <= 30

    def test_o_h2_manufactured_rotated(self):
        import math

        from tpu_multigrid.cycles import solve_fixed

        th = math.radians(30)
        ex, ey = 1.0, 0.1
        ct, st = math.cos(th), math.sin(th)
        a = ex * ct * ct + ey * st * st
        bb = ex * st * st + ey * ct * ct
        c = (ex - ey) * st * ct
        pi = math.pi

        def forcing(x, y):
            s = jnp.sin(pi * x) * jnp.sin(pi * y)
            cc = jnp.cos(pi * x) * jnp.cos(pi * y)
            return (a + bb) * pi ** 2 * s - 2 * c * pi ** 2 * cc

        errs = {}
        for lvl in (4, 5):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother="zebra_x", nu1=1, nu2=1,
                                  dtype=jnp.float64)
            prob = AnisotropicPoissonProblem(cfg, eps_x=ex, eps_y=ey,
                                             angle=th, forcing=forcing)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 14)
            S = prob.finest.S
            h = 1.0 / n
            x = np.arange(S)[None, :] * h
            y = np.arange(S)[:, None] * h
            want = np.sin(pi * x) * np.sin(pi * y)
            errs[lvl] = np.abs(np.asarray(res.u) - want)[1:n, 1:n].max()
        assert 3.0 < errs[4] / errs[5] < 5.5, errs

    def test_semi_with_rotation_rejected(self):
        import math
        with pytest.raises(ValueError):
            AnisotropicPoissonProblem(
                MultigridConfig(finest_level=4, coarsest_level=3),
                eps_x=1.0, eps_y=0.05, angle=math.radians(45),
                coarsening="semi")
