"""3D (7-point) multigrid: core.ops3d + Poisson3DProblem through the shared
cycle drivers.

The reference is strictly 2D; this covers the framework's dimensional
extension: operator correctness vs a scipy oracle, the variational transfer
pair (R = P^T/2, R A P = re-discretized stencil), O(N) convergence, and
discretization-order accuracy via a manufactured solution.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_multigrid import MultigridConfig, Poisson3DProblem
from tpu_multigrid.core import ops3d
from tpu_multigrid.cycles import cycle, fmg, solve_until_tol


def laplacian3d_dense(n):
    """Dense h-independent 7-point operator over the (n-1)^3 interior."""
    m = (n - 1) ** 3
    idx = np.arange(m).reshape(n - 1, n - 1, n - 1)
    A = np.zeros((m, m))
    A[np.arange(m), np.arange(m)] = 6.0
    for ax in range(3):
        sl_lo = [slice(None)] * 3
        sl_hi = [slice(None)] * 3
        sl_lo[ax] = slice(0, -1)
        sl_hi[ax] = slice(1, None)
        lo, hi = idx[tuple(sl_lo)].ravel(), idx[tuple(sl_hi)].ravel()
        A[lo, hi] -= 1.0
        A[hi, lo] -= 1.0
    return A


def grid(u, n):
    return np.asarray(u)[1:n, 1:n, 1:n].reshape(-1)


class TestOps3d:
    def test_apply_matches_dense(self, rng):
        n, S = 8, 9
        u = np.zeros((S, S, S))
        u[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
        got = ops3d.apply_poisson3(jnp.asarray(u), n)
        want = laplacian3d_dense(n) @ grid(u, n)
        np.testing.assert_allclose(grid(got, n), want, atol=1e-12)

    def test_jacobi_fixed_point(self, rng):
        n, S = 8, 9
        u = np.zeros((S, S, S))
        u[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
        u = jnp.asarray(u)
        b = ops3d.apply_poisson3(u, n)
        out = ops3d.jacobi_sweeps3(u, b, n, 2.0 / 3.0, 4)
        np.testing.assert_allclose(np.asarray(out), np.asarray(u), atol=1e-12)

    def test_rbgs_fixed_point(self, rng):
        n, S = 8, 9
        u = np.zeros((S, S, S))
        u[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
        u = jnp.asarray(u)
        b = ops3d.apply_poisson3(u, n)
        out = ops3d.redblack_gs_sweeps3(u, b, n, 3)
        np.testing.assert_allclose(np.asarray(out), np.asarray(u), atol=1e-12)

    def test_restrict_is_half_prolong_adjoint(self, rng):
        """<R r, e>_c == 0.5 * <r, P e>_f — the R = P^T/2 scaling."""
        nf, nc = 8, 4
        Sf, Sc = 9, 5
        r = np.zeros((Sf,) * 3)
        r[1:nf, 1:nf, 1:nf] = rng.standard_normal((nf - 1,) * 3)
        e = np.zeros((Sc,) * 3)
        e[1:nc, 1:nc, 1:nc] = rng.standard_normal((nc - 1,) * 3)
        Rr = np.asarray(ops3d.restrict_fw3(jnp.asarray(r), nf, Sc))
        Pe = np.asarray(ops3d.prolong3(jnp.asarray(e), nc, Sf))
        lhs = np.sum(Rr * e)
        rhs = 0.5 * np.sum(r * Pe)
        np.testing.assert_allclose(lhs, rhs, rtol=1e-12)

    def test_galerkin_product_symmetric_and_spectrally_close(self, rng):
        """R A_h P (a 27-point operator in 3D — trilinear Galerkin is not
        the 7-point re-discretization, unlike the 2D P1 case) is symmetric
        (R = P^T/2), positive definite, and agrees with A_2h on smooth
        modes — the properties the two-grid correction actually needs."""
        nf, nc = 8, 4
        Sf, Sc = 9, 5
        mc = (nc - 1) ** 3
        A2h = laplacian3d_dense(nc)
        got = np.zeros((mc, mc))
        for k in range(mc):
            e = np.zeros((Sc,) * 3)
            e[1:nc, 1:nc, 1:nc].flat[k] = 1.0
            Pe = ops3d.prolong3(jnp.asarray(e), nc, Sf)
            APe = ops3d.apply_poisson3(Pe, nf)
            got[:, k] = grid(ops3d.restrict_fw3(APe, nf, Sc), nc)
        np.testing.assert_allclose(got, got.T, atol=1e-12)
        assert np.linalg.eigvalsh(got).min() > 0
        # lowest mode of A_2h: Rayleigh quotients agree to ~h^2 accuracy
        w = np.zeros((Sc,) * 3)
        x = np.arange(Sc) / nc
        sx = np.sin(np.pi * np.clip(x, 0, 1))
        w[:nc + 1, :nc + 1, :nc + 1] = (sx[:nc + 1, None, None]
                                        * sx[None, :nc + 1, None]
                                        * sx[None, None, :nc + 1])
        v = grid(w, nc)
        q_rap = v @ got @ v / (v @ v)
        q_2h = v @ A2h @ v / (v @ v)
        assert abs(q_rap - q_2h) / q_2h < 0.15

    def test_transfer_of_constants(self):
        """P reproduces constants on the interior away from the boundary;
        R scales constants by 4 (so f*h^2 -> f*(2h)^2)."""
        nf, nc, Sf, Sc = 16, 8, 17, 9
        e = ops3d.mask_interior3(jnp.ones((Sc,) * 3), nc)
        Pe = np.asarray(ops3d.prolong3(e, nc, Sf))
        assert abs(Pe[8, 8, 8] - 1.0) < 1e-12
        r = ops3d.mask_interior3(jnp.ones((Sf,) * 3), nf)
        Rr = np.asarray(ops3d.restrict_fw3(r, nf, Sc))
        assert abs(Rr[4, 4, 4] - 4.0) < 1e-12


class TestSolve3d:
    def test_vcycle_convergence_factor(self):
        """Jacobi(2,2) at omega=2/3 (the 2D-optimal weight): measured
        rho ~0.28-0.36 in 3D — converges, but the Chebyshev schedule is
        the recommended 3D smoother (see mesh-independence test)."""
        cfg = MultigridConfig(finest_level=5, coarsest_level=2,
                              nu1=2, nu2=2, dtype=jnp.float64)
        prob = Poisson3DProblem(cfg)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-10,
                              max_cycles=40)
        hist = np.asarray(res.res_history)
        n_it = int(res.iterations)
        assert bool(res.converged)
        rho = (hist[n_it] / hist[0]) ** (1.0 / n_it)
        assert rho < 0.45, rho

    def test_convergence_mesh_independent(self):
        """Chebyshev(3,2): rho ~0.11-0.15, flat in depth (O(N))."""
        rhos = []
        for lvl in (3, 4, 5):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  nu1=3, nu2=2, smoother="chebyshev",
                                  dtype=jnp.float64)
            prob = Poisson3DProblem(cfg)
            res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                  tol=1e-10, max_cycles=30)
            hist = np.asarray(res.res_history)
            n_it = int(res.iterations)
            rhos.append((hist[n_it] / hist[0]) ** (1.0 / n_it))
        assert max(rhos) < 0.20
        assert max(rhos) - min(rhos) < 0.06

    def test_matches_dense_solve(self):
        n = 8
        cfg = MultigridConfig(finest_level=3, coarsest_level=1,
                              dtype=jnp.float64)
        prob = Poisson3DProblem(cfg)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-12,
                              max_cycles=40)
        A = laplacian3d_dense(n)
        want = np.linalg.solve(A, grid(prob.rhs(), n))
        np.testing.assert_allclose(grid(res.u, n), want, rtol=1e-9)

    def test_manufactured_solution_order(self):
        """u = sin(pi x) sin(pi y) sin(pi z): discrete solve converges to it
        at O(h^2)."""
        import math

        def forcing(x, y, z):
            return (3 * math.pi ** 2 * jnp.sin(math.pi * x)
                    * jnp.sin(math.pi * y) * jnp.sin(math.pi * z))

        errs = []
        for lvl in (3, 4, 5):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  dtype=jnp.float64)
            prob = Poisson3DProblem(cfg, forcing=forcing)
            res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                  tol=1e-11, max_cycles=40)
            from tpu_multigrid.problems.poisson3d import node_coordinates3
            x, y, z = node_coordinates3(n, n + 1, jnp.float64)
            exact = (jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
                     * jnp.sin(math.pi * z))
            err = np.asarray(res.u - ops3d.mask_interior3(exact, n))
            errs.append(np.sqrt((err ** 2).mean()))
        # each refinement divides the error by ~4
        assert errs[0] / errs[1] > 3.3
        assert errs[1] / errs[2] > 3.3

    def test_fmg_reaches_discretization_accuracy(self):
        import math

        def forcing(x, y, z):
            return (3 * math.pi ** 2 * jnp.sin(math.pi * x)
                    * jnp.sin(math.pi * y) * jnp.sin(math.pi * z))

        lvl, n = 4, 16
        cfg = MultigridConfig(finest_level=lvl, coarsest_level=2, nu0=2,
                              dtype=jnp.float64)
        prob = Poisson3DProblem(cfg, forcing=forcing)
        u = fmg(prob.hierarchy, cfg, prob.rhs())
        from tpu_multigrid.problems.poisson3d import node_coordinates3
        x, y, z = node_coordinates3(n, n + 1, jnp.float64)
        exact = ops3d.mask_interior3(
            jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
            * jnp.sin(math.pi * z), n)
        # FMG error within ~2x of the converged discrete solution's error
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-11,
                              max_cycles=40)
        e_fmg = float(jnp.sqrt(((u - exact) ** 2).mean()))
        e_conv = float(jnp.sqrt(((res.u - exact) ** 2).mean()))
        assert e_fmg < 2.0 * e_conv

    def test_w_cycle_and_chebyshev(self):
        cfg = MultigridConfig(finest_level=4, coarsest_level=2, cycle="W",
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        prob = Poisson3DProblem(cfg)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-10,
                              max_cycles=20)
        assert bool(res.converged)
        hist = np.asarray(res.res_history)
        n_it = int(res.iterations)
        assert (hist[n_it] / hist[0]) ** (1.0 / n_it) < 0.12

    def test_api_entry(self):
        import tpu_multigrid as mg
        res = mg.solve_poisson3d(4, config=MultigridConfig(
            finest_level=4, coarsest_level=2, smoother="chebyshev",
            nu1=3, nu2=2, dtype=jnp.float64), tol=1e-9)
        assert bool(res.converged)
        u = mg.extract_solution(res.u, 16)
        assert u.shape == (17, 17, 17)
        assert float(u[8, 8, 8]) > 0

    def test_padded_levels(self):
        """Per-level padding (shard alignment) does not change results."""
        cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                              dtype=jnp.float64)
        p0 = Poisson3DProblem(cfg)
        p1 = Poisson3DProblem(cfg, align=8, min_pad_level=0)
        r0 = solve_until_tol(p0.hierarchy, cfg, p0.rhs(), tol=1e-10)
        r1 = solve_until_tol(p1.hierarchy, cfg, p1.rhs(), tol=1e-10)
        n = 16
        np.testing.assert_allclose(grid(r1.u, n), grid(r0.u, n), rtol=1e-8)


class TestBoundaryLifting3D:
    """Inhomogeneous Dirichlet via lifting in 3D (boundary_grid3 +
    _run's ndim dispatch), across all four 3D operator families."""

    def test_constant_boundary_all_families(self):
        import tpu_multigrid as mg

        cfg = MultigridConfig(finest_level=3, coarsest_level=2,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        ccfg = MultigridConfig(finest_level=3, coarsest_level=2,
                               smoother="rbgs", nu1=2, nu2=2,
                               dtype=jnp.float64)
        runs = [
            mg.solve_poisson3d(3, forcing=0.0, boundary=2.0, config=cfg,
                               tol=1e-11),
            mg.solve_diffusion3d(3, coefficient=lambda x, y, z: 1 + z,
                                 forcing=0.0, boundary=2.0, config=cfg,
                                 tol=1e-11),
            mg.solve_convection_diffusion3d(3, eps=0.1, bx=1.0,
                                            forcing=0.0, boundary=2.0,
                                            config=ccfg, tol=1e-11),
            mg.solve_poisson3d(3, order=4, forcing=0.0, boundary=2.0,
                               config=cfg, tol=1e-11),
        ]
        for r in runs:
            u = np.asarray(r.u)[:9, :9, :9]
            np.testing.assert_allclose(u, 2.0, atol=1e-9)

    def test_harmonic_linear_exact(self):
        """u = x + y + z is discretely harmonic: lifting reproduces it to
        roundoff at any n (no discretization error for linears)."""
        import tpu_multigrid as mg

        cfg = MultigridConfig(finest_level=3, coarsest_level=2,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        g = lambda x, y, z: x + y + z
        r = mg.solve_poisson3d(3, forcing=0.0, boundary=g, config=cfg,
                               tol=1e-12)
        n = 8
        idx = np.arange(n + 1) / n
        want = (idx[:, None, None] + idx[None, :, None]
                + idx[None, None, :])
        u = np.asarray(r.u)[: n + 1, : n + 1, : n + 1]
        np.testing.assert_allclose(u, want, atol=1e-10)

    def test_periodic_rejects_boundary(self):
        import math

        import tpu_multigrid as mg

        f = lambda x, y, z: jnp.sin(2 * math.pi * x) * jnp.ones_like(y * z)
        with pytest.raises(ValueError):
            mg.solve_poisson3d(3, bc="periodic", forcing=f, boundary=1.0)
