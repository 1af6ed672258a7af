"""Periodic Poisson: -lap(u) = f on the unit torus.

Extension beyond the Dirichlet-only reference (``Poissons_SYCL.cpp:224``
hard-codes boundary elimination): fully periodic boundary conditions in
both axes.  TPU-natively this is the EASY case — the framework's
neighbor access is ``jnp.roll``, whose wrap-around is exactly the torus
topology, so the operator needs no masks at all.  Grids are (n, n)
arrays of the n = 2^l unique nodes (node n == node 0), h = 1/n.

The operator is singular with a one-dimensional null space (constants):

* compatibility: the RHS is mean-projected (``f`` must integrate to
  zero up to quadrature; the projection enforces it exactly);
* every smoother/residual/transfer here PRESERVES the mean-zero
  subspace (row sums are zero, R/P have matching constants), so no
  per-cycle re-projection is needed;
* the coarsest solve uses the dense PSEUDO-inverse, whose minimal-norm
  solution is exactly the mean-zero representative.

Transfers are the torus variational pair: bilinear prolongation via
2x-replication + averaging rolls (wrap = periodicity, for free) and its
exact adjoint R = P^T — separable full weighting with wraparound.
The solution is reported in its mean-zero gauge.
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
class PeriodicOp:
    """Matrix-free 5-point Poisson operator on the (n, n) torus."""

    ndim = 2

    def __init__(self, n: int):
        self.n = int(n)

    @property
    def S(self):
        return self.n

    @property
    def grid_shape(self):
        return (self.n, self.n)

    @property
    def box(self):
        # every node is an unknown (used by grids.coarse_solve)
        return (0, self.n - 1, 0, self.n - 1)

    def tree_flatten(self):
        return (), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    @staticmethod
    def _nbr(u):
        return (jnp.roll(u, 1, -2) + jnp.roll(u, -1, -2)
                + jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1))

    def apply(self, u):
        return (4.0 * u - self._nbr(u)).astype(u.dtype)

    def residual(self, u, b):
        return (b - 4.0 * u + self._nbr(u)).astype(u.dtype)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
            if len(ws) < sweeps:
                ws = tuple(ws[i % len(ws)] for i in range(sweeps))
            v = u
            for w in ws[:sweeps]:
                v = (jnp.asarray(1.0 - w, u.dtype) * v
                     + jnp.asarray(0.25 * w, u.dtype)
                     * (b + self._nbr(v))).astype(u.dtype)
            return v
        elif smoother == "rbgs":
            n = self.n
            i = jax.lax.broadcasted_iota(jnp.int32, (n, n), 0)
            j = jax.lax.broadcasted_iota(jnp.int32, (n, n), 1)
            v = u
            quarter = jnp.asarray(0.25, u.dtype)
            for _ in range(sweeps):
                for parity in (0, 1):
                    vn = quarter * (b + self._nbr(v))
                    v = jnp.where((i + j) % 2 == parity,
                                  vn.astype(u.dtype), v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    # -- cycle transfer protocol (the coarse op owns the pair) --
    # Decimation/replication use the row parity reshape
    # (R, C) -> (R//2, 2, C) and stack+reshape interleaves; the minor axis
    # gets the same trick conjugated by transposes.

    @staticmethod
    def _even_rows(x):
        R, C = x.shape[-2:]
        return x.reshape(x.shape[:-2] + (R // 2, 2, C))[..., :, 0, :]

    @staticmethod
    def _double_rows(x):
        R, C = x.shape[-2:]
        return jnp.stack([x, x], axis=-2).reshape(
            x.shape[:-2] + (2 * R, C))

    def restrict_into(self, r, fine_op):
        """R = P^T on the torus: separable full weighting with wrap."""
        t = r + 0.5 * (jnp.roll(r, 1, -1) + jnp.roll(r, -1, -1))
        t = t + 0.5 * (jnp.roll(t, 1, -2) + jnp.roll(t, -1, -2))
        t = self._even_rows(t)
        t = self._even_rows(t.mT).mT
        return t.astype(r.dtype)

    def prolong_add_into(self, u, ec, fine_op):
        """u + P ec: 2x replication + averaging rolls (wrap = periodic)."""
        e = self._double_rows(ec)
        e = self._double_rows(e.mT).mT
        e = 0.5 * (e + jnp.roll(e, -1, -2))
        e = 0.5 * (e + jnp.roll(e, -1, -1))
        return (u + e.astype(u.dtype)).astype(u.dtype)

    def __repr__(self):
        return f"PeriodicOp(n={self.n})"


def periodic_coarse_pinv(n: int, dtype=jnp.float32) -> jnp.ndarray:
    """Dense pseudo-inverse of the n^2-node torus operator.

    The minimal-norm least-squares solution is the mean-zero
    representative, which is exactly the gauge the solver reports.
    """
    m = n * n
    idx = np.arange(m).reshape(n, n)
    A = np.zeros((m, m))
    A[np.arange(m), np.arange(m)] = 4.0
    for ax, d in ((0, 1), (0, -1), (1, 1), (1, -1)):
        nb = np.roll(idx, d, axis=ax)
        A[idx.ravel(), nb.ravel()] -= 1.0
    return jnp.asarray(np.linalg.pinv(A), dtype)


def build_periodic_hierarchy(config: MultigridConfig) -> Hierarchy:
    levels = tuple(PeriodicOp(2 ** l)
                   for l in range(config.finest_level,
                                  config.coarsest_level - 1, -1))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = periodic_coarse_pinv(levels[-1].n)
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class PeriodicPoissonProblem:
    """-lap(u) = forcing on the unit torus (solution in mean-zero gauge).

    ``forcing`` must be compatible (zero mean); the RHS construction
    projects the mean out exactly, so mildly incompatible quadrature is
    absorbed rather than amplified.
    """

    config: MultigridConfig
    forcing: Union[float, Callable] = None

    def __post_init__(self):
        if not callable(self.forcing):
            raise ValueError("periodic problems need a (zero-mean) "
                             "callable forcing; a nonzero constant f is "
                             "incompatible on the torus")
        self.hierarchy: Hierarchy = build_periodic_hierarchy(self.config)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        op = self.finest
        n = op.n
        dt = dtype if dtype is not None else self.config.dtype
        h = 1.0 / n
        c = jnp.arange(n, dtype=dt) * h
        x = jnp.broadcast_to(c[None, :], (n, n))
        y = jnp.broadcast_to(c[:, None], (n, n))
        vals = self.forcing(x, y).astype(dt) * jnp.asarray(h * h, dt)
        return (vals - jnp.mean(vals)).astype(dt)
