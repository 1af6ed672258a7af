"""MG-powered inverse power iteration (tpu_multigrid/eigen.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid import MultigridConfig, PoissonProblem
from tpu_multigrid.eigen import smallest_eigenpair


def test_unit_square_ground_state_o_h2():
    errs = {}
    for lvl in (5, 6):
        cfg = MultigridConfig(finest_level=lvl, coarsest_level=3,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        prob = PoissonProblem(cfg)
        lam, v, hist = jax.jit(
            lambda h: smallest_eigenpair(h, cfg))(prob.hierarchy)
        errs[lvl] = abs(float(lam) - 2 * math.pi ** 2)
        # eigenfunction ~ sin sin (sign-fixed), unit norm
        n = 2 ** lvl
        S = n + 1
        idx = np.arange(S) / n
        want = np.sin(math.pi * idx)[:, None] * np.sin(math.pi * idx)[None]
        want /= np.linalg.norm(want)
        got = np.array(v)[:S, :S]
        got *= np.sign(got[n // 2, n // 2])
        assert np.abs(got - want).max() < 1e-3
    assert 3.0 < errs[5] / errs[6] < 5.5, errs


def test_anisotropic_ground_state():
    """-(4 u_xx + u_yy): lambda_min = 4 pi^2 + pi^2 = 5 pi^2."""
    from tpu_multigrid import AnisotropicPoissonProblem

    cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                          smoother="chebyshev", nu1=3, nu2=2,
                          dtype=jnp.float64)
    prob = AnisotropicPoissonProblem(cfg, eps_x=4.0, eps_y=1.0)
    lam, _, _ = jax.jit(
        lambda h: smallest_eigenpair(h, cfg))(prob.hierarchy)
    want = 5 * math.pi ** 2
    assert abs(float(lam) - want) / want < 5e-3, float(lam)


def test_poisson3d_ground_state():
    from tpu_multigrid.problems.poisson3d import Poisson3DProblem

    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          smoother="chebyshev", nu1=3, nu2=2,
                          dtype=jnp.float64)
    prob = Poisson3DProblem(cfg, align=1, min_pad_level=99, lane_align=1)
    lam, _, _ = jax.jit(
        lambda h: smallest_eigenpair(h, cfg))(prob.hierarchy)
    want = 3 * math.pi ** 2
    assert abs(float(lam) - want) / want < 5e-3, float(lam)
