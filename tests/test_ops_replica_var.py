"""Variable-coefficient, line, 3D, nonlinear, mixed-BC and compensated
operators against independent numpy replicas (``tests/replicas.py``).

These are the families whose fused kernels were removed: each now runs the
plain jnp operator on the card, and each parametrisation below pins that
operator at one family, smoother, sweep count, size and padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import replicas as R
from tpu_multigrid.core import ops, ops3d
from tpu_multigrid.core.nonlinear import PointwiseNonlinearOp
from tpu_multigrid.core.operators import diffusion_op_host, poisson_op
from tpu_multigrid.problems.anisotropic import anisotropic_poisson_op
from tpu_multigrid.problems.convection import convection_diffusion_op
from tpu_multigrid.problems.mixedbc import mixed_poisson_op

VAR_SIZES = [(16, 17), (16, 24), (32, 33), (32, 40)]


def _rand(n, S, seed, scale=1.0):
    return R.random_interior(n, S, np.random.default_rng(seed), scale)


def _family(kind, n, S):
    """A 9-plane operator of one family, built in f64 on the host."""
    if kind == "diffusion":
        cells = 1.0 + np.random.default_rng(20).random((n, n)) * 9.0
        return diffusion_op_host(cells, n, S)
    if kind == "convection":          # nonsymmetric upwind stencil
        return convection_diffusion_op(n, S, 0.05, 1.0, -0.5,
                                       dtype=np.float64)
    if kind == "rotated":             # cross-derivative corners
        return anisotropic_poisson_op(n, S, 1.0, 0.1, angle=0.5,
                                      dtype=np.float64)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["diffusion", "convection", "rotated"])
@pytest.mark.parametrize("n,S", VAR_SIZES)
def test_var_apply_matches_replica(kind, n, S):
    op = _family(kind, n, S)
    u = _rand(n, S, 21)
    got = op.apply(jnp.asarray(u))
    want = R.var_apply(np.asarray(op.coef), u, R.interior(u.shape, n))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("schedule", ["weighted", "chebyshev"])
@pytest.mark.parametrize("kind", ["diffusion", "convection"])
@pytest.mark.parametrize("n,S", VAR_SIZES)
def test_var_jacobi_matches_replica(kind, n, S, schedule):
    op = _family(kind, n, S)
    u, b = _rand(n, S, 22), _rand(n, S, 23)
    if schedule == "weighted":
        ws, omega = [0.7] * 3, 0.7
    else:
        ws = omega = ops.chebyshev_omegas(3, 0.4)
    got = op.smooth(jnp.asarray(u), jnp.asarray(b), smoother="jacobi",
                    omega=omega, sweeps=3)
    want = R.var_jacobi(np.asarray(op.coef), u, b, R.interior(u.shape, n),
                        ws)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-11,
                               atol=1e-11)


@pytest.mark.parametrize("kind", ["diffusion", "convection"])
@pytest.mark.parametrize("n,S", VAR_SIZES)
def test_var_rbgs_matches_replica(kind, n, S):
    op = _family(kind, n, S)
    u, b = _rand(n, S, 24), _rand(n, S, 25)
    got = op.smooth(jnp.asarray(u), jnp.asarray(b), smoother="rbgs",
                    omega=1.0, sweeps=2)
    want = R.var_rbgs(np.asarray(op.coef), u, b, R.interior(u.shape, n), 2)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-11,
                               atol=1e-11)


@pytest.mark.parametrize("axis", ["zebra_x", "zebra_y"])
@pytest.mark.parametrize("n,S", [(8, 9), (16, 17), (16, 24)])
def test_zebra_matches_dense_line_solves(axis, n, S):
    op = anisotropic_poisson_op(n, S, 50.0, 1.0, dtype=np.float64) \
        if axis == "zebra_x" else \
        anisotropic_poisson_op(n, S, 1.0, 50.0, dtype=np.float64)
    u, b = _rand(n, S, 26), _rand(n, S, 27)
    got = op.smooth(jnp.asarray(u), jnp.asarray(b), smoother=axis,
                    omega=1.0, sweeps=2)
    want = R.zebra(np.asarray(op.coef), u, b, n, 2,
                   axis=1 if axis == "zebra_x" else 0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-10,
                               atol=1e-10)


SIZES3 = [(4, 5), (8, 9), (8, 12)]


def _rand3(n, S, seed):
    u = np.zeros((S,) * 3)
    u[1:n, 1:n, 1:n] = np.random.default_rng(seed).standard_normal(
        (n - 1,) * 3)
    return u


@pytest.mark.parametrize("n,S", SIZES3)
def test_apply7_matches_replica(n, S):
    u = _rand3(n, S, 30)
    np.testing.assert_allclose(
        np.asarray(ops3d.apply_poisson3(jnp.asarray(u), n)),
        R.apply7(u, n), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("schedule", ["weighted", "chebyshev"])
@pytest.mark.parametrize("n,S", SIZES3)
def test_jacobi7_matches_replica(n, S, schedule):
    u, b = _rand3(n, S, 31), _rand3(n, S, 32)
    if schedule == "weighted":
        ws, omega = [6.0 / 7.0] * 2, 6.0 / 7.0
    else:
        ws = omega = ops.chebyshev_omegas(2, 0.4)
    got = ops3d.jacobi_sweeps3(jnp.asarray(u), jnp.asarray(b), n, omega, 2)
    np.testing.assert_allclose(np.asarray(got), R.jacobi7(u, b, n, ws),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,S", SIZES3)
def test_restrict3_matches_replica(n, S):
    r = _rand3(n, S, 33)
    Sc = n // 2 + 1
    np.testing.assert_allclose(
        np.asarray(ops3d.restrict_fw3(jnp.asarray(r), n, Sc)),
        R.restrict_fw3(r, n, Sc), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n,S", SIZES3)
def test_prolong3_matches_replica(n, S):
    nc = n // 2
    e = _rand3(nc, nc + 1, 34)
    np.testing.assert_allclose(
        np.asarray(ops3d.prolong3(jnp.asarray(e), nc, S)),
        R.prolong3(e, nc, S), rtol=1e-13, atol=1e-13)


def _bratu_phi(u):
    return -2.0 * np.exp(u) if isinstance(u, np.ndarray) else \
        -2.0 * jnp.exp(u)


@pytest.mark.parametrize("n,S", [(16, 17), (16, 24), (32, 33)])
def test_fas_pointwise_residual_matches_replica(n, S):
    op = PointwiseNonlinearOp(poisson_op(n, S), _bratu_phi, _bratu_phi)
    u, b = _rand(n, S, 40, 0.3), _rand(n, S, 41, 1e-3)
    got = op.residual(jnp.asarray(u), jnp.asarray(b))
    m = R.interior(u.shape, n)
    want = b - (R.apply5(u, n) + np.where(m, _bratu_phi(u) / n ** 2, 0.0))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("n,S", [(16, 17), (16, 24), (32, 33)])
def test_fas_jacobi_newton_matches_replica(n, S):
    op = PointwiseNonlinearOp(poisson_op(n, S), _bratu_phi, _bratu_phi)
    u, b = _rand(n, S, 42, 0.3), _rand(n, S, 43, 1e-3)
    got = op.nsmooth(jnp.asarray(u), jnp.asarray(b), omega=0.8, sweeps=3)
    m = R.interior(u.shape, n)
    h2 = 1.0 / n ** 2
    v = u.copy()
    for _ in range(3):
        pv = _bratu_phi(v)
        r = b - (R.apply5(v, n) + np.where(m, h2 * pv, 0.0))
        v = v + np.where(m, 0.8 * r / (4.0 + h2 * pv), 0.0)
    np.testing.assert_allclose(np.asarray(got), v, rtol=1e-12, atol=1e-13)


BOX_SIDES = [("top",), ("bottom", "left"), ("top", "right")]


@pytest.mark.parametrize("sides", BOX_SIDES)
def test_box_restrict_matches_replica(sides):
    n, S = 16, 20
    op = mixed_poisson_op(n, S, sides, dtype=np.float64)
    opc = mixed_poisson_op(n // 2, 12, sides, dtype=np.float64)
    r = np.where(R.box_mask((S, S), op.box),
                 np.random.default_rng(44).standard_normal((S, S)), 0.0)
    got = ops.restrict_fw(jnp.asarray(r), n, 12, box=opc.box)
    np.testing.assert_allclose(np.asarray(got),
                               R.restrict_fw(r, n, 12, box=opc.box),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("sides", BOX_SIDES)
def test_box_prolong_matches_replica(sides):
    n, S = 16, 20
    op = mixed_poisson_op(n, S, sides, dtype=np.float64)
    opc = mixed_poisson_op(n // 2, 12, sides, dtype=np.float64)
    e = np.where(R.box_mask((12, 12), opc.box),
                 np.random.default_rng(45).standard_normal((12, 12)), 0.0)
    got = ops.prolong(jnp.asarray(e), n // 2, S, box=op.box)
    np.testing.assert_allclose(np.asarray(got),
                               R.prolong(e, n // 2, S, box=op.box),
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n,S", [(64, 65), (128, 136)])
def test_compensated_residual_matches_f64(n, S):
    """The double-single residual of an f32 pair equals the f64 residual
    of their sum to f32 output rounding."""
    from tpu_multigrid.precision import ds_residual
    rng = np.random.default_rng(46)
    uh = R.random_interior(n, S, rng).astype(np.float32)
    ul = (R.random_interior(n, S, rng) * 1e-8).astype(np.float32)
    b = (R.random_interior(n, S, rng) * 1e-3).astype(np.float32)
    got = np.asarray(ds_residual(jnp.asarray(b), jnp.asarray(uh),
                                 jnp.asarray(ul), n), np.float64)
    want = R.residual5(uh.astype(np.float64) + ul.astype(np.float64),
                       b.astype(np.float64), n)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 2e-7 * scale
