"""Grid hierarchy construction.

Replaces the reference's per-level global matrix tables
(``Poissons_SYCL.cpp:24-52``) and its host-side assembly loop
(``main``, ``Poissons_SYCL.cpp:661-690``): on a structured grid the operator
is a stencil, so "assembly" is closed-form and the hierarchy is a static
tuple of levels that jit unrolls into one compiled program.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from .operators import (ConstStencilOp, ConstStencilOp3D, VarStencilOp,
                        galerkin_coarsen, poisson_op)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def level_sizes(
    config: MultigridConfig,
    *,
    align: int = 1,
    min_pad_level: int = 99,
) -> Tuple[Tuple[int, int], ...]:
    """(n, S) per level, finest first.

    ``S`` is the padded array side: ``n + 1`` rounded up to ``align`` for
    levels >= ``min_pad_level`` (shard alignment).  Padding is
    per-level independent: the transfer operators crop/pad so only the
    physical ``0..n`` region couples across levels.
    """
    sizes = []
    for lvl in range(config.finest_level, config.coarsest_level - 1, -1):
        n = 2 ** lvl
        S = n + 1
        if lvl >= min_pad_level and align > 1:
            S = round_up(S, align)
        sizes.append((n, S))
    return tuple(sizes)


@jax.tree_util.register_pytree_node_class
class Hierarchy:
    """Static multigrid level stack: operators finest->coarsest + coarse factor.

    ``coarse_inv`` is the dense inverse of the coarsest-level interior
    operator, precomputed at setup (the TPU-native stand-in for the WIP
    variant's Eigen SparseLU, ``Multigrid_functions.cpp:63-72``): the
    coarsest grid has at most a few hundred unknowns, so the "solve" inside
    the jitted cycle is one tiny matvec.
    """

    def __init__(self, levels: Tuple[Any, ...], coarse_inv: Optional[jnp.ndarray]):
        self.levels = tuple(levels)
        self.coarse_inv = coarse_inv

    def tree_flatten(self):
        return (self.levels, self.coarse_inv), ()

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(children[0], children[1])

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def __repr__(self):
        return f"Hierarchy({[l for l in self.levels]!r})"


def coarse_dense_inverse(op, dtype=None) -> jnp.ndarray:
    """Dense inverse of the interior operator.

    Stencil operators whose coefficients live in host memory (the
    host-built Galerkin hierarchies) assemble the dense matrix directly in
    numpy — probing them with eager device ops would dispatch thousands of
    device calls.  Other operators (the matrix-free Poisson stencil) are
    probed with unit grids under one jit.  Computed once at setup in f64,
    stored in the solve dtype.
    """
    n, S = op.n, op.S
    box = getattr(op, "box", None)
    coef = getattr(op, "coef", None)
    if type(op) is ConstStencilOp:
        # Closed-form 5-point assembly (h-independent: diag 4, off -1)
        # for the constant 2D stencil — no device probing at setup.
        from .nonlinear import dense_poisson_matrix
        inv = np.linalg.inv(dense_poisson_matrix(n))
        return jnp.asarray(inv, dtype if dtype is not None else jnp.float32)
    if isinstance(op, ConstStencilOp3D):
        # Closed-form 7-point assembly (h-independent: diag 6, off -1),
        # for the constant-stencil 3D op ONLY (var/directional/19-point
        # 3D ops take the probe or dense-from-planes paths) — probing a
        # 3D operator with unit grids would ship ~(n-1)^3 whole cubes
        # through the device.
        m1 = n - 1
        m = m1 ** 3
        idx = np.arange(m).reshape(m1, m1, m1)
        a = np.zeros((m, m))
        a[np.arange(m), np.arange(m)] = 6.0
        for ax in range(3):
            lo = [slice(None)] * 3
            hi = [slice(None)] * 3
            lo[ax] = slice(0, -1)
            hi[ax] = slice(1, None)
            rows = idx[tuple(lo)].ravel()
            cols = idx[tuple(hi)].ravel()
            a[rows, cols] -= 1.0
            a[cols, rows] -= 1.0
        inv = np.linalg.inv(a)
        return jnp.asarray(inv, dtype if dtype is not None else jnp.float32)
    if coef is not None and isinstance(coef, np.ndarray):
        bi0, bi1, bj0, bj1 = box if box is not None else (1, n - 1, 1, n - 1)
        ri, rj = bi1 - bi0 + 1, bj1 - bj0 + 1
        m = ri * rj
        a = np.zeros((m, m))
        idx = np.arange(m).reshape(ri, rj)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                C = coef[di + 1, dj + 1,
                         bi0:bi1 + 1, bj0:bj1 + 1].astype(np.float64)
                i0, i1 = max(0, -di), ri - max(0, di)
                j0, j1 = max(0, -dj), rj - max(0, dj)
                rows = idx[i0:i1, j0:j1].ravel()
                cols = idx[i0 + di:i1 + di, j0 + dj:j1 + dj].ravel()
                a[rows, cols] += C[i0:i1, j0:j1].ravel()
        inv = np.linalg.inv(a)
        return jnp.asarray(inv, dtype if dtype is not None else jnp.float32)
    d = getattr(op, "ndim", 2)
    inter = _unknown_slices(op)
    m = 1
    shp = []
    for s in inter:
        shp.append(s.stop - s.start)
        m *= s.stop - s.start
    eye = jnp.eye(m, dtype=jnp.float32).reshape((m,) + tuple(shp))
    gshape = getattr(op, "grid_shape", (S,) * d)
    grids = jnp.zeros((m,) + tuple(gshape), jnp.float32)
    grids = grids.at[(slice(None),) + inter].set(eye)
    cols = jax.jit(jax.vmap(op.apply))(grids)[(slice(None),) + inter]
    cols = cols.reshape(m, m)
    a = np.asarray(cols).astype(np.float64).T  # apply(e_k) is column k
    inv = np.linalg.inv(a)
    out_dtype = dtype if dtype is not None else jnp.float32
    return jnp.asarray(inv, out_dtype)


def _unknown_slices(op):
    """Per-axis slices of the operator's unknowns (box-aware, 2D/3D).

    Operators whose unknown set is not a 2D Dirichlet box (e.g. the
    periodic torus, where EVERY node is an unknown) expose
    ``unknown_slices`` directly.
    """
    us = getattr(op, "unknown_slices", None)
    if us is not None:
        return tuple(us)
    box = getattr(op, "box", None)
    if box is not None:
        if len(box) == 6:   # 3D mixed-BC box (problems/mixedbc3d.py)
            i0, i1, j0, j1, k0, k1 = box
            return (slice(i0, i1 + 1), slice(j0, j1 + 1),
                    slice(k0, k1 + 1))
        i0, i1, j0, j1 = box
        return (slice(i0, i1 + 1), slice(j0, j1 + 1))
    return (slice(1, op.n),) * getattr(op, "ndim", 2)


def coarse_solve(op, coarse_inv: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Direct coarsest-grid solve via the precomputed dense inverse."""
    S = op.S
    d = getattr(op, "ndim", 2)
    inter = _unknown_slices(op)
    shp = tuple(s.stop - s.start for s in inter)
    rhs = b[inter].reshape(-1).astype(coarse_inv.dtype)
    # HIGHEST: a float32 product may otherwise run in TF32 on a GPU,
    # which keeps about three digits.
    sol = jnp.matmul(coarse_inv, rhs, precision=jax.lax.Precision.HIGHEST)
    sol = sol.reshape(shp).astype(b.dtype)
    gshape = getattr(op, "grid_shape", (S,) * d)
    return jnp.zeros(tuple(gshape), b.dtype).at[inter].set(sol)


def build_poisson_hierarchy(
    config: MultigridConfig, *, align: int = 1, min_pad_level: int = 99
) -> Hierarchy:
    """Constant-coefficient Poisson hierarchy (re-discretized every level).

    For nested P1 elements the re-discretized stencil equals the Galerkin
    operator R A P, so this is variational for free.
    """
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = tuple(poisson_op(n, S) for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(levels, coarse_inv)


def build_galerkin_hierarchy(
    fine_op: VarStencilOp, config: MultigridConfig, *, align: int = 1,
    min_pad_level: int = 99, method: str = "host",
) -> Hierarchy:
    """Variable-coefficient hierarchy: coarse operators via R A P (setup-time).

    ``method="host"`` evaluates the closed-form R A P on the CPU in numpy
    (zero device compiles — galerkin_coarsen_host); ``"probe"`` uses the
    9-comb device probing (galerkin_coarsen), kept as an independent oracle.
    """
    from .operators import galerkin_coarsen_host

    coarsen = galerkin_coarsen_host if method == "host" else (
        lambda op, Sc: galerkin_coarsen(op, Sc))
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    assert sizes[0][0] == fine_op.n, (sizes[0], fine_op.n)
    levels = [fine_op]
    for (_, Sc) in sizes[1:]:
        levels.append(coarsen(levels[-1], Sc))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


def node_coordinates(n: int, S: int, dtype=jnp.float32):
    """(x, y) coordinate grids of the (S, S) padded node array; h = 1/n."""
    h = 1.0 / n
    idx = jnp.arange(S, dtype=dtype) * h
    x = jnp.broadcast_to(idx[None, :], (S, S))
    y = jnp.broadcast_to(idx[:, None], (S, S))
    return x, y
