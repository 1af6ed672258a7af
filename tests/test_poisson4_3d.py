"""Fourth-order compact Mehrstellen Poisson in 3D (problems/poisson4_3d.py,
core.operators.Const19Op)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.core.operators import Const19Op
from tpu_multigrid.cycles import solve_fixed
from tpu_multigrid.problems.poisson4_3d import (Poisson4_3DProblem,
                                                mehrstellen_rhs3)

pi = math.pi


def _forcing(x, y, z):
    return 3 * pi ** 2 * jnp.sin(pi * x) * jnp.sin(pi * y) * jnp.sin(pi * z)


class TestOperator:
    def test_matches_dense_19point(self, rng):
        n, S = 4, 5
        op = Const19Op(n, S)
        u = np.zeros((S, S, S))
        u[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
        want = np.zeros((S, S, S))
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    nz = abs(dz) + abs(dy) + abs(dx)
                    w = {0: 24.0, 1: -2.0, 2: -1.0, 3: 0.0}[nz] / 6.0
                    if w == 0.0:
                        continue
                    want[1:n, 1:n, 1:n] += w * u[1 + dz:n + dz,
                                                 1 + dy:n + dy,
                                                 1 + dx:n + dx]
        got = np.asarray(op.apply(jnp.asarray(u)))
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_row_sum_zero_and_spd(self):
        n, S = 4, 5
        op = Const19Op(n, S)
        ones = jnp.zeros((S,) * 3, jnp.float64).at[1:n, 1:n, 1:n].set(1.0)
        out = np.asarray(op.apply(ones))
        np.testing.assert_allclose(out[2:n - 1, 2:n - 1, 2:n - 1], 0.0,
                                   atol=1e-14)
        from tpu_multigrid.core.grids import coarse_dense_inverse
        inv = np.asarray(coarse_dense_inverse(op, dtype=jnp.float64))
        A = np.linalg.inv(inv)
        np.testing.assert_allclose(A, A.T, atol=1e-9)
        assert np.linalg.eigvalsh(A).min() > 0

    def test_constant_rhs_matches_second_order(self):
        from tpu_multigrid.problems.poisson3d import poisson3d_rhs
        got = mehrstellen_rhs3(8, (9, 9, 9), 6.0, jnp.float64)
        want = poisson3d_rhs(8, (9, 9, 9), 6.0, jnp.float64)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=0)


class TestSolve:
    def test_mesh_independent_rho(self):
        rhos = []
        for lvl in (3, 4):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            prob = Poisson4_3DProblem(cfg, forcing=_forcing)
            res = solve_fixed(prob.hierarchy, cfg, prob.rhs(), 8)
            h = np.asarray(res.res_history)
            rhos.append((h[8] / h[0]) ** (1 / 8))
        assert max(rhos) < 0.2, rhos

    def test_o_h4_via_api(self):
        errs = {}
        for lvl in (3, 4):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            r = mg.solve_poisson3d(lvl, order=4, forcing=_forcing,
                                   config=cfg, num_cycles=14)
            S = n + 1
            idx = np.arange(S) / n
            want = (np.sin(pi * idx)[:, None, None]
                    * np.sin(pi * idx)[None, :, None]
                    * np.sin(pi * idx)[None, None, :])
            errs[lvl] = np.abs(np.asarray(r.u)[:S, :S, :S]
                               - want)[1:n, 1:n, 1:n].max()
        assert 13.0 < errs[3] / errs[4] < 19.5, errs

    def test_incompatible_options(self):
        with pytest.raises(ValueError):
            mg.solve_poisson3d(3, order=4, bc="periodic", forcing=_forcing)
        with pytest.raises(ValueError):
            mg.solve_poisson3d(3, order=3)
