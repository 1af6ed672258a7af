"""The 2D constant-coefficient operators the card runs, against independent
numpy replicas (``tests/replicas.py``), at the sizes, paddings, sweep
counts and weight schedules the fused level-visit kernels are used with.

Every level visit on the card runs these jnp operators (or the fused
kernels, which are checked against them in ``test_level2d.py``), so each
parametrisation here pins one shape of the plain path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import replicas as R
from tpu_multigrid.core import ops
from tpu_multigrid.core.operators import Const9Op

# (n, S): unpadded, lightly padded, padded past a tile edge.
SIZES = [(8, 9), (16, 17), (16, 24), (32, 33), (32, 40), (64, 65), (64, 72)]
SMOOTH_SIZES = [(16, 17), (16, 24), (32, 33), (64, 65), (64, 80)]


def _rand(n, S, seed, scale=1.0):
    return R.random_interior(n, S, np.random.default_rng(seed), scale)


@pytest.mark.parametrize("n,S", SIZES)
def test_apply_matches_replica(n, S):
    u = _rand(n, S, 1)
    np.testing.assert_allclose(np.asarray(ops.apply_poisson(jnp.asarray(u),
                                                            n)),
                               R.apply5(u, n), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n,S", SIZES)
def test_residual_matches_replica(n, S):
    u, b = _rand(n, S, 2), _rand(n, S, 3)
    got = ops.residual(jnp.asarray(u), jnp.asarray(b), n)
    np.testing.assert_allclose(np.asarray(got), R.residual5(u, b, n),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("sweeps", [1, 2, 3])
@pytest.mark.parametrize("n,S", SMOOTH_SIZES)
def test_weighted_jacobi_matches_replica(n, S, sweeps):
    u, b = _rand(n, S, 4), _rand(n, S, 5)
    got = ops.jacobi_sweeps(jnp.asarray(u), jnp.asarray(b), n, 2.0 / 3.0,
                            sweeps)
    np.testing.assert_allclose(np.asarray(got),
                               R.jacobi5(u, b, n, [2.0 / 3.0] * sweeps),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("degree", [2, 3, 4])
@pytest.mark.parametrize("n,S", SMOOTH_SIZES)
def test_chebyshev_schedule_matches_replica(n, S, degree):
    u, b = _rand(n, S, 6), _rand(n, S, 7)
    ws = ops.chebyshev_omegas(degree, 0.4)
    got = ops.jacobi_sweeps(jnp.asarray(u), jnp.asarray(b), n, ws, degree)
    np.testing.assert_allclose(np.asarray(got), R.jacobi5(u, b, n, ws),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sweeps", [1, 2])
@pytest.mark.parametrize("n,S", SMOOTH_SIZES)
def test_rbgs_matches_replica(n, S, sweeps):
    u, b = _rand(n, S, 8), _rand(n, S, 9)
    got = ops.redblack_gs_sweeps(jnp.asarray(u), jnp.asarray(b), n, sweeps)
    np.testing.assert_allclose(np.asarray(got), R.rbgs5(u, b, n, sweeps),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("extra", [0, 5])
@pytest.mark.parametrize("n,S", SIZES)
def test_restrict_fw_matches_replica(n, S, extra):
    nc = n // 2
    Sc = nc + 1 + extra
    r = _rand(n, S, 10)
    got = ops.restrict_fw(jnp.asarray(r), n, Sc)
    np.testing.assert_allclose(np.asarray(got), R.restrict_fw(r, n, Sc),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("extra", [0, 5])
@pytest.mark.parametrize("n,S", SIZES)
def test_prolong_matches_replica(n, S, extra):
    nc = n // 2
    Sc = nc + 1 + extra
    e = R.random_interior(nc, Sc, np.random.default_rng(11))
    got = ops.prolong(jnp.asarray(e), nc, S)
    np.testing.assert_allclose(np.asarray(got), R.prolong(e, nc, S),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n,S", [(16, 17), (32, 40)])
def test_prolong_p1_and_injection_match_replica(n, S):
    nc = n // 2
    e = R.random_interior(nc, nc + 1, np.random.default_rng(12))
    got = ops.prolong_p1(jnp.asarray(e), nc, S)
    np.testing.assert_allclose(np.asarray(got),
                               R.prolong(e, nc, S, diag="p1"),
                               rtol=1e-13, atol=1e-13)
    r = _rand(n, S, 13)
    got = ops.restrict_injection(jnp.asarray(r), n, nc + 1)
    np.testing.assert_allclose(np.asarray(got),
                               R.restrict_injection(r, n, nc + 1),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n,S", [(16, 17), (16, 24), (32, 33), (64, 72)])
def test_mehrstellen_apply_matches_replica(n, S):
    u = _rand(n, S, 14)
    got = Const9Op(n, S).apply(jnp.asarray(u))
    np.testing.assert_allclose(np.asarray(got), R.apply9(u, n),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("schedule", ["weighted", "chebyshev"])
@pytest.mark.parametrize("n,S", [(16, 17), (16, 24), (32, 33), (64, 72)])
def test_mehrstellen_jacobi_matches_replica(n, S, schedule):
    u, b = _rand(n, S, 15), _rand(n, S, 16)
    ws = ((0.8, 0.8) if schedule == "weighted"
          else ops.chebyshev_omegas(3, 0.4))
    omega = ws if schedule == "chebyshev" else 0.8
    got = Const9Op(n, S).smooth(jnp.asarray(u), jnp.asarray(b),
                                smoother="jacobi", omega=omega,
                                sweeps=len(ws))
    np.testing.assert_allclose(np.asarray(got), R.jacobi9(u, b, n, ws),
                               rtol=1e-12, atol=1e-12)
