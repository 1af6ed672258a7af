"""Semi-coarsened multigrid (core/semicoarsen.py).

The second textbook anisotropy remedy (alongside zebra lines,
test_anisotropic.py): coarsen only the strongly coupled axis so plain
point smoothing keeps the mesh-independent two-grid factor.  Verified:

* per-axis transfers are exact adjoints (R_a = P_a^T);
* the closed-form one-axis Galerkin coarsening matches a dense R A P;
* chained x+y coarsening reproduces the 2D bilinear/FW Galerkin operator;
* point-Chebyshev convergence at 100:1 anisotropy is h-independent and
  far below the full-coarsening point-smoother factor;
* O(h^2) accuracy against a manufactured solution;
* the hierarchy builder equilibrates (strong axis first, then both).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_multigrid import AnisotropicPoissonProblem, MultigridConfig
from tpu_multigrid.core import semicoarsen as sc
from tpu_multigrid.core.operators import galerkin_coarsen_host
from tpu_multigrid.cycles import fmg, solve_fixed
from tpu_multigrid.problems.anisotropic import anisotropic_poisson_op


def _dense_from_semiop(op):
    """Dense matrix over ALL (Sy*Sx) padded nodes (rows/cols of
    non-unknowns are zero, matching the masked apply())."""
    coef = np.asarray(op.coef, np.float64)
    Sy, Sx = op.Sy, op.Sx
    m = Sy * Sx
    A = np.zeros((m, m))
    idx = np.arange(m).reshape(Sy, Sx)
    i0, i1, j0, j1 = op.box
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            C = coef[di + 1, dj + 1]
            r0, r1 = max(0, -di), Sy - max(0, di)
            c0, c1 = max(0, -dj), Sx - max(0, dj)
            rows = idx[r0:r1, c0:c1].ravel()
            cols = idx[r0 + di:r1 + di, c0 + dj:c1 + dj].ravel()
            A[rows, cols] += C[r0:r1, c0:c1].ravel()
    return A


def _dense_prolong_x(Syf, Sxf, Syc, Sxc, ny, nxf):
    """Dense P_x: coarse (Syc*Sxc) -> fine (Syf*Sxf), linear along x,
    rows only at fine unknowns."""
    P = np.zeros((Syf * Sxf, Syc * Sxc))
    fidx = np.arange(Syf * Sxf).reshape(Syf, Sxf)
    cidx = np.arange(Syc * Sxc).reshape(Syc, Sxc)
    for i in range(1, ny):
        for jf in range(1, nxf):
            if jf % 2 == 0:
                P[fidx[i, jf], cidx[i, jf // 2]] = 1.0
            else:
                P[fidx[i, jf], cidx[i, jf // 2]] = 0.5
                P[fidx[i, jf], cidx[i, jf // 2 + 1]] = 0.5
    return P


class TestTransfers:
    def test_adjoint_per_axis(self, rng):
        ny, nx = 16, 16
        opf = sc.semi_anisotropic_op(ny, nx, 10.0, 1.0, dtype=np.float64)
        opc = sc.galerkin_semicoarsen_host(opf, "x")
        r = np.zeros((opf.Sy, opf.Sx))
        r[1:ny, 1:nx] = rng.standard_normal((ny - 1, nx - 1))
        e = np.zeros((opc.Sy, opc.Sx))
        e[1:ny, 1:nx // 2] = rng.standard_normal((ny - 1, nx // 2 - 1))
        Rr = np.asarray(sc.restrict_to(jnp.asarray(r), opc))
        z = jnp.zeros((opf.Sy, opf.Sx))
        Pe = np.asarray(sc.prolong_add_from(z, jnp.asarray(e), opc, opf))
        # <R r, e> == <r, P e>
        np.testing.assert_allclose((Rr * e).sum(), (r * Pe).sum(),
                                   rtol=1e-12)

    def test_prolong_matches_dense(self, rng):
        ny, nxf = 8, 8
        opf = sc.semi_anisotropic_op(ny, nxf, 10.0, 1.0, dtype=np.float64)
        opc = sc.galerkin_semicoarsen_host(opf, "x")
        P = _dense_prolong_x(opf.Sy, opf.Sx, opc.Sy, opc.Sx, ny, nxf)
        e = np.zeros((opc.Sy, opc.Sx))
        e[1:ny, 1:nxf // 2] = rng.standard_normal((ny - 1, nxf // 2 - 1))
        got = np.asarray(sc.prolong_add_from(
            jnp.zeros((opf.Sy, opf.Sx)), jnp.asarray(e), opc, opf))
        want = (P @ e.ravel()).reshape(opf.Sy, opf.Sx)
        np.testing.assert_allclose(got, want, atol=1e-13)


def _dense_prolong_y(Syf, Sxf, Syc, Sxc, nyf, nx):
    """Dense P_y: linear along y, rows only at fine unknowns."""
    P = np.zeros((Syf * Sxf, Syc * Sxc))
    fidx = np.arange(Syf * Sxf).reshape(Syf, Sxf)
    cidx = np.arange(Syc * Sxc).reshape(Syc, Sxc)
    for i in range(1, nyf):
        for j in range(1, nx):
            if i % 2 == 0:
                P[fidx[i, j], cidx[i // 2, j]] = 1.0
            else:
                P[fidx[i, j], cidx[i // 2, j]] = 0.5
                P[fidx[i, j], cidx[i // 2 + 1, j]] = 0.5
    return P


def _mask_unknowns(dense, op):
    """Zero rows AND columns at non-unknown coarse nodes.

    The framework's operators only ever see box-masked iterates, so
    couplings to non-unknown nodes are non-observable; different but
    equivalent construction orders (one-shot 2D RAP vs chained per-axis)
    legitimately disagree there.
    """
    i0, i1, j0, j1 = op.box
    m = np.zeros((op.Sy, op.Sx), bool)
    m[i0:i1 + 1, j0:j1 + 1] = True
    out = dense.copy()
    out[~m.ravel(), :] = 0.0
    out[:, ~m.ravel()] = 0.0
    return out


class TestGalerkin:
    @pytest.mark.parametrize("axis", ["x", "y"])
    def test_matches_dense_rap(self, axis):
        ny = nx = 8
        opf = sc.semi_anisotropic_op(ny, nx, 25.0, 1.0, dtype=np.float64)
        opc = sc.galerkin_semicoarsen_host(opf, axis)
        Af = _dense_from_semiop(opf)
        if axis == "x":
            P = _dense_prolong_x(opf.Sy, opf.Sx, opc.Sy, opc.Sx, ny, nx)
        else:
            P = _dense_prolong_y(opf.Sy, opf.Sx, opc.Sy, opc.Sx, ny, nx)
        want = _mask_unknowns(P.T @ Af @ P, opc)
        got = _mask_unknowns(_dense_from_semiop(opc), opc)
        np.testing.assert_allclose(got, want, atol=1e-12)

    def test_y_matches_transposed_problem(self):
        """Independent oracle: y-coarsening the (eps_x, eps_y) problem ==
        transposing x-coarsening of the (eps_y, eps_x) problem."""
        ny, nx = 4, 4
        opf = sc.semi_anisotropic_op(ny, nx, 25.0, 1.0, dtype=np.float64)
        got = np.asarray(sc.galerkin_semicoarsen_host(opf, "y").coef)
        opf_t = sc.semi_anisotropic_op(nx, ny, 1.0, 25.0, dtype=np.float64)
        want = np.asarray(sc.galerkin_semicoarsen_host(
            opf_t, "x").coef).transpose(1, 0, 3, 2)
        np.testing.assert_allclose(got, want, atol=0)

    def test_xy_chain_matches_full_2d_galerkin(self):
        """x-then-y semi-coarsening == the square 2D Galerkin RAP on all
        unknown-to-unknown couplings (tensor-product transfers:
        P_x P_y = bilinear P; the orders differ only in couplings to
        always-masked boundary nodes)."""
        n = 8
        opf_sq = anisotropic_poisson_op(n, n + 1, 7.0, 1.0,
                                        dtype=np.float64)
        want_op = galerkin_coarsen_host(opf_sq, n // 2 + 1)
        opf = sc.semi_anisotropic_op(n, n, 7.0, 1.0, dtype=np.float64)
        opc = sc.galerkin_coarsen_axes(opf, ("x", "y"))
        want_semi = sc.SemiOp(np.asarray(want_op.coef),
                              np.asarray(want_op.inv_diag),
                              n // 2, n // 2, n // 2 + 1, n // 2 + 1)
        got = _mask_unknowns(_dense_from_semiop(opc), opc)
        want = _mask_unknowns(_dense_from_semiop(want_semi), opc)
        np.testing.assert_allclose(got, want, atol=1e-12)


class TestHierarchy:
    def test_strong_axis_first_then_equilibrate(self):
        cfg = MultigridConfig(finest_level=6, coarsest_level=3)
        prob = AnisotropicPoissonProblem(cfg, eps_x=100.0, eps_y=1.0,
                                         coarsening="semi")
        shapes = [(l.ny, l.nx) for l in prob.hierarchy.levels]
        # x (strong) coarsens first; y joins once x's effective coupling
        # has equilibrated; stop at the full-coarsening coarsest size
        assert shapes[0] == (64, 64)
        assert shapes[1] == (64, 32)
        assert all(s[0] >= s[1] for s in shapes)
        ny_c, nx_c = shapes[-1]
        assert (ny_c - 1) * (nx_c - 1) <= 49

    def test_isotropic_reduces_to_full_coarsening(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=3)
        prob = AnisotropicPoissonProblem(cfg, eps_x=1.0, eps_y=1.0,
                                         coarsening="semi")
        shapes = [(l.ny, l.nx) for l in prob.hierarchy.levels]
        assert shapes == [(32, 32), (16, 16), (8, 8)]


class TestConvergence:
    @pytest.mark.parametrize("eps", [100.0, 1000.0])
    def test_point_smoother_h_independent(self, eps):
        """Point Chebyshev on the semi-coarsened hierarchy: rho far below
        the full-coarsening point-smoother factor, not degrading with n."""
        rhos = []
        for lvl in (5, 6):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            prob = AnisotropicPoissonProblem(cfg, eps_x=eps, eps_y=1.0,
                                             coarsening="semi")
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            rhos.append((h[8] / h[0]) ** (1 / 8))
        assert max(rhos) < 0.3, rhos
        assert rhos[1] < 2.5 * max(rhos[0], 0.05), rhos

    def test_beats_full_coarsening_point_smoother(self):
        def rho(coarsening):
            cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            prob = AnisotropicPoissonProblem(cfg, eps_x=100.0, eps_y=1.0,
                                             coarsening=coarsening)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            return (h[8] / h[0]) ** (1 / 8)

        assert rho("semi") < 0.3 < 0.6 < rho("full")

    def test_y_strong_transpose(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        prob = AnisotropicPoissonProblem(cfg, eps_x=1.0, eps_y=100.0,
                                         coarsening="semi")
        assert prob.hierarchy.levels[1].from_axes == ("y",)
        res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
        h = np.asarray(res.res_history)
        assert (h[8] / h[0]) ** (1 / 8) < 0.3

    def test_zebra_on_semi_hierarchy(self):
        """Rectangular-grid zebra lines (generalized core/lines) compose
        with semi-coarsening."""
        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="zebra_x", nu1=1, nu2=1,
                              dtype=jnp.float64)
        prob = AnisotropicPoissonProblem(cfg, eps_x=100.0, eps_y=1.0,
                                         coarsening="semi")
        res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 6)
        h = np.asarray(res.res_history)
        assert (h[6] / h[0]) ** (1 / 6) < 0.2

    def test_fmg_start(self):
        cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        prob = AnisotropicPoissonProblem(cfg, eps_x=100.0, eps_y=1.0,
                                         coarsening="semi")
        b = prob.rhs()
        op = prob.finest
        u_fmg = fmg(prob.hierarchy, cfg, b)
        r_fmg = float(jnp.linalg.norm(op.residual(u_fmg, b)))
        r0 = float(jnp.linalg.norm(b))
        assert r_fmg < 0.05 * r0, (r_fmg, r0)


class TestAPI:
    def test_solve_anisotropic_auto_picks_semi(self):
        import tpu_multigrid as mg

        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        r = mg.solve_anisotropic(5, eps_x=200.0, eps_y=1.0, tol=1e-9,
                                 config=cfg)
        assert bool(r.converged) and int(r.iterations) <= 8

    def test_solve_anisotropic_boundary_lifting(self):
        import tpu_multigrid as mg

        cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        r = mg.solve_anisotropic(5, eps_x=100.0, eps_y=1.0, tol=1e-9,
                                 forcing=0.0, boundary=2.5, config=cfg)
        u = np.asarray(r.u)[:33, :33]
        # zero forcing + constant boundary => u == boundary everywhere
        np.testing.assert_allclose(u, 2.5, atol=1e-8)


class TestAccuracy:
    def test_manufactured_o_h2(self):
        """u = sin(pi x) sin(pi y), f = (eps_x + eps_y) pi^2 u."""
        import math

        ex, ey = 50.0, 1.0
        errs = {}
        for lvl in (4, 5):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            prob = AnisotropicPoissonProblem(
                cfg, eps_x=ex, eps_y=ey,
                forcing=lambda x, y: (ex + ey) * math.pi ** 2
                * jnp.sin(math.pi * x) * jnp.sin(math.pi * y),
                coarsening="semi")
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 12)
            S = prob.finest.Sy
            h = 1.0 / n
            x = np.arange(S)[None, :] * h
            y = np.arange(S)[:, None] * h
            want = np.sin(math.pi * x) * np.sin(math.pi * y)
            want[n:, :] = 0.0
            want[:, n:] = 0.0
            want[[0], :] = 0.0
            want[:, [0]] = 0.0
            err = np.abs(np.asarray(res.u) - want)[1:n, 1:n].max()
            errs[lvl] = err
        ratio = errs[4] / errs[5]
        assert 3.0 < ratio < 5.2, errs
