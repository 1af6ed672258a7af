"""Periodic Poisson on the unit 3-torus: -lap(u) = f, all axes periodic.

3D twin of :mod:`problems.periodic`: grids are (n, n, n) arrays of the
unique torus nodes (node n == node 0), ``jnp.roll`` wrap IS the topology
(no masks anywhere), the operator has the constant null space, and the
coarsest solve is a dense pseudo-inverse whose minimal-norm solution is
the mean-zero gauge.  Transfers are the torus variational pair per axis
(replication + averaging rolls / separable full weighting with wrap),
via the operator transfer protocol (``restrict_into`` /
``prolong_add_into``), using the parity reshape for decimation
and transposes for the minor axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from ..core.grids import Hierarchy


@jax.tree_util.register_pytree_node_class
class PeriodicOp3:
    """Matrix-free 7-point Poisson operator on the (n, n, n) torus."""

    ndim = 3

    def __init__(self, n: int):
        self.n = int(n)

    @property
    def S(self):
        return self.n

    @property
    def grid_shape(self):
        return (self.n, self.n, self.n)

    @property
    def unknown_slices(self):
        # every torus node is an unknown (grids._unknown_slices protocol)
        return (slice(0, self.n),) * 3

    def tree_flatten(self):
        return (), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    @staticmethod
    def _nbr(u):
        return (jnp.roll(u, 1, -3) + jnp.roll(u, -1, -3)
                + jnp.roll(u, 1, -2) + jnp.roll(u, -1, -2)
                + jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1))

    def apply(self, u):
        return (6.0 * u - self._nbr(u)).astype(u.dtype)

    def residual(self, u, b):
        return (b - 6.0 * u + self._nbr(u)).astype(u.dtype)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
            if len(ws) < sweeps:
                ws = tuple(ws[i % len(ws)] for i in range(sweeps))
            v = u
            sixth = 1.0 / 6.0
            for w in ws[:sweeps]:
                v = (jnp.asarray(1.0 - w, u.dtype) * v
                     + jnp.asarray(sixth * w, u.dtype)
                     * (b + self._nbr(v))).astype(u.dtype)
            return v
        elif smoother == "rbgs":
            n = self.n
            shape = (n, n, n)
            i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
            j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
            k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
            v = u
            sixth = jnp.asarray(1.0 / 6.0, u.dtype)
            for _ in range(sweeps):
                for parity in (0, 1):
                    vn = sixth * (b + self._nbr(v))
                    v = jnp.where((i + j + k) % 2 == parity,
                                  vn.astype(u.dtype), v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    # -- transfer protocol: per-axis torus pair --
    @staticmethod
    def _even_axis0(x):
        """Even-index decimation along axis -3 via the parity reshape."""
        Z = x.shape[-3]
        return x.reshape(x.shape[:-3] + (Z // 2, 2) + x.shape[-2:])[
            ..., :, 0, :, :]

    @staticmethod
    def _even_rows(x):
        R, C = x.shape[-2:]
        return x.reshape(x.shape[:-2] + (R // 2, 2, C))[..., :, 0, :]

    @staticmethod
    def _double_axis0(x):
        Z = x.shape[-3]
        return jnp.stack([x, x], axis=-3).reshape(
            x.shape[:-3] + (2 * Z,) + x.shape[-2:])

    @staticmethod
    def _double_rows(x):
        R, C = x.shape[-2:]
        return jnp.stack([x, x], axis=-2).reshape(
            x.shape[:-2] + (2 * R, C))

    def restrict_into(self, r, fine_op):
        """R = P^T / 2 on the torus: separable [0.5, 1, 0.5] blurs with
        wrap, then even decimation (sublane reshapes; lane axis via
        swap).  The extra 1/2 is the 3D variational scaling — the
        h-independent 7-point stencil scales LINEARLY with h in 3D
        (stiffness ~ h), so R A P with R = P^T would be 2x the
        re-discretized coarse operator (same factor as
        ``dist.local_ops3.restrict_fw_local3`` / ``core.ops3d``)."""
        t = r
        for ax in (-3, -2, -1):
            t = t + 0.5 * (jnp.roll(t, 1, ax) + jnp.roll(t, -1, ax))
        t = self._even_axis0(t)
        t = self._even_rows(t)
        t = self._even_rows(t.swapaxes(-1, -2)).swapaxes(-1, -2)
        return (0.5 * t).astype(r.dtype)

    def prolong_add_into(self, u, ec, fine_op):
        e = self._double_axis0(ec)
        e = self._double_rows(e)
        e = self._double_rows(e.swapaxes(-1, -2)).swapaxes(-1, -2)
        for ax in (-3, -2, -1):
            e = 0.5 * (e + jnp.roll(e, -1, ax))
        return (u + e.astype(u.dtype)).astype(u.dtype)

    def __repr__(self):
        return f"PeriodicOp3(n={self.n})"


def periodic3_coarse_pinv(n: int, dtype=jnp.float32) -> jnp.ndarray:
    """Dense pseudo-inverse of the n^3-node torus operator (mean-zero
    gauge)."""
    m = n ** 3
    idx = np.arange(m).reshape(n, n, n)
    A = np.zeros((m, m))
    A[np.arange(m), np.arange(m)] = 6.0
    for ax in (0, 1, 2):
        for d in (1, -1):
            nb = np.roll(idx, d, axis=ax)
            A[idx.ravel(), nb.ravel()] -= 1.0
    return jnp.asarray(np.linalg.pinv(A), dtype)


def build_periodic3_hierarchy(config: MultigridConfig) -> Hierarchy:
    levels = tuple(PeriodicOp3(2 ** l)
                   for l in range(config.finest_level,
                                  config.coarsest_level - 1, -1))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = periodic3_coarse_pinv(levels[-1].n)
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class Periodic3DPoissonProblem:
    """-lap(u) = forcing on the unit 3-torus (mean-zero gauge)."""

    config: MultigridConfig
    forcing: Union[Callable, None] = None

    def __post_init__(self):
        if not callable(self.forcing):
            raise ValueError("periodic problems need a (zero-mean) "
                             "callable forcing")
        self.hierarchy: Hierarchy = build_periodic3_hierarchy(self.config)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        op = self.finest
        n = op.n
        dt = dtype if dtype is not None else self.config.dtype
        h = 1.0 / n
        c = jnp.arange(n, dtype=dt) * h
        x = c[None, None, :]
        y = c[None, :, None]
        z = c[:, None, None]
        vals = jnp.broadcast_to(self.forcing(x, y, z),
                                (n, n, n)).astype(dt) * jnp.asarray(
                                    h * h, dt)
        return (vals - jnp.mean(vals)).astype(dt)
