"""3D convection-diffusion (problems/convection3d.py): nonsymmetric
directional 7-point upwind operators through the 3D driver stack."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.cycles import solve_fixed
from tpu_multigrid.problems.convection3d import (
    ConvectionDiffusion3DProblem, Directional7Op, convection_diffusion_op3)


def _dense(op):
    """Dense matrix over all padded nodes (rows at non-unknowns zero)."""
    S, _, Sx = op.grid_shape
    m = S * S * Sx
    idx = np.arange(m).reshape(S, S, Sx)
    A = np.zeros((m, m))
    A[np.arange(m), np.arange(m)] = np.asarray(op.diag, np.float64).ravel()
    for ax in (0, 1, 2):
        for arr, d in ((op.cp[ax], -1), (op.cm[ax], 1)):
            nb = np.roll(idx, d, axis=ax)
            A[idx.ravel(), nb.ravel()] -= np.asarray(arr,
                                                     np.float64).ravel()
    return A


class TestOperator:
    def test_poisson_limit(self):
        op = convection_diffusion_op3(4, 5, 5, 1.0, 0.0, 0.0, 0.0,
                                      dtype=np.float64)
        assert np.asarray(op.diag)[2, 2, 2] == 6.0
        for ax in (0, 1, 2):
            assert np.asarray(op.cp[ax])[2, 2, 2] == 1.0
            assert np.asarray(op.cm[ax])[2, 2, 2] == 1.0

    def test_matches_dense(self, rng):
        n = 6
        op = convection_diffusion_op3(n, n + 1, n + 1, 0.01, 1.0, -0.5,
                                      0.25, dtype=np.float64)
        A = _dense(op)
        u = np.zeros((n + 1,) * 3)
        u[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
        got = np.asarray(op.apply(jnp.asarray(u)))
        want = (A @ u.ravel()).reshape(u.shape)
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_m_matrix_any_peclet(self):
        op = convection_diffusion_op3(8, 9, 9, 1e-5, 3.0, -2.0, 1.0,
                                      dtype=np.float64)
        inter = np.s_[2:7, 2:7, 2:7]
        assert (np.asarray(op.diag)[inter] > 0).all()
        for ax in (0, 1, 2):
            assert (np.asarray(op.cp[ax])[inter] >= 0).all()
            assert (np.asarray(op.cm[ax])[inter] >= 0).all()
        # zero row sums away from the boundary
        rowsum = np.asarray(op.diag, np.float64)
        for ax in (0, 1, 2):
            rowsum = rowsum - np.asarray(op.cp[ax], np.float64) \
                - np.asarray(op.cm[ax], np.float64)
        np.testing.assert_allclose(rowsum[inter], 0.0, atol=1e-15)


class TestConvergence:
    @pytest.mark.parametrize("eps", [0.02, 0.005])
    def test_rbgs_h_independent(self, eps):
        rhos = []
        for lvl in (4, 5):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  smoother="rbgs", nu1=2, nu2=2,
                                  dtype=jnp.float64)
            prob = ConvectionDiffusion3DProblem(cfg, eps=eps, bx=1.0,
                                                by=0.5, bz=0.25)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            rhos.append((h[8] / h[0]) ** (1 / 8))
        assert max(rhos) < 0.35, rhos

    def test_bicgstab_wraps_3d(self):
        from tpu_multigrid.krylov import bicgstab_solve
        import jax

        cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                              smoother="rbgs", nu1=2, nu2=2,
                              dtype=jnp.float64)
        prob = ConvectionDiffusion3DProblem(cfg, eps=0.005, bx=1.0,
                                            by=0.5, bz=0.25)
        res = jax.jit(lambda h, b: bicgstab_solve(
            h, cfg, b, tol=1e-10, max_iters=25))(prob.hierarchy,
                                                 prob.rhs())
        assert bool(res.converged), np.asarray(res.res_history)


class TestAccuracy:
    def test_manufactured_o_h(self):
        eps, bx, by, bz = 0.5, 1.0, 0.5, 0.25
        pi = math.pi

        def forcing(x, y, z):
            s, c = jnp.sin, jnp.cos
            sss = s(pi * x) * s(pi * y) * s(pi * z)
            return (eps * 3 * pi ** 2 * sss
                    + bx * pi * c(pi * x) * s(pi * y) * s(pi * z)
                    + by * pi * s(pi * x) * c(pi * y) * s(pi * z)
                    + bz * pi * s(pi * x) * s(pi * y) * c(pi * z))

        errs = {}
        for lvl in (3, 4):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  smoother="rbgs", nu1=2, nu2=2,
                                  dtype=jnp.float64)
            r = mg.solve_convection_diffusion3d(
                lvl, eps=eps, bx=bx, by=by, bz=bz, forcing=forcing,
                config=cfg, num_cycles=14)
            S = n + 1
            idx = np.arange(S) / n
            want = (np.sin(pi * idx)[:, None, None]
                    * np.sin(pi * idx)[None, :, None]
                    * np.sin(pi * idx)[None, None, :])
            errs[lvl] = np.abs(np.asarray(r.u)[:S, :S, :S]
                               - want)[1:n, 1:n, 1:n].max()
        assert 1.5 < errs[3] / errs[4] < 3.0, errs
