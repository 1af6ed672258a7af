"""Shard-local stencil/transfer operators with explicit ppermute halo rings.

The TPU-native replacement for a distributed backend the reference never had
(SURVEY.md §2.3: no MPI/NCCL anywhere): each (S, S) grid is domain-decomposed
(gy, gx) over a 2D device mesh; every operator runs on the local block and
pulls one ghost ring from its mesh neighbors with ``jax.lax.ppermute``.
Wrap-around ghosts (shard 0 receiving from shard N-1) land only on
global-boundary/padding nodes, which the interior masks zero — the same
invariant the single-device ``core.ops`` rolls rely on.

All functions here are meant to run *inside* ``shard_map`` with mesh axes
``("gy", "gx")``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

GY, GX = "gy", "gx"


def _perms(axis_name):
    n = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # dst i receives from i-1
    bwd = [((i + 1) % n, i) for i in range(n)]   # dst i receives from i+1
    return fwd, bwd


def _shift_from_prev(edge, axis_name):
    """Each shard receives its previous neighbor's edge (wraps at 0)."""
    fwd, _ = _perms(axis_name)
    return lax.ppermute(edge, axis_name, perm=fwd)


def _shift_from_next(edge, axis_name):
    _, bwd = _perms(axis_name)
    return lax.ppermute(edge, axis_name, perm=bwd)


def with_halo1(u):
    """Local (r, c) block -> (r+2, c+2) with a 1-deep ghost ring + corners.

    Rows first, then columns of the row-extended block, so corner ghosts
    arrive via two hops (the standard 2D halo trick — no diagonal sends).
    """
    top = _shift_from_prev(u[-1:, :], GY)
    bot = _shift_from_next(u[:1, :], GY)
    xr = jnp.concatenate([top, u, bot], axis=0)
    lf = _shift_from_prev(xr[:, -1:], GX)
    rt = _shift_from_next(xr[:, :1], GX)
    return jnp.concatenate([lf, xr, rt], axis=1)


def _local_offsets(shape):
    r, c = shape
    return lax.axis_index(GY) * r, lax.axis_index(GX) * c


def interior_mask_local(shape, n):
    r, c = shape
    r0, c0 = _local_offsets(shape)
    gi = lax.broadcasted_iota(jnp.int32, (r, c), 0) + r0
    gj = lax.broadcasted_iota(jnp.int32, (r, c), 1) + c0
    return (gi >= 1) & (gi <= n - 1) & (gj >= 1) & (gj <= n - 1)


def box_mask_local(shape, box):
    """Inclusive global unknown box (i0, i1, j0, j1) on a local block —
    mixed Dirichlet/Neumann problems keep Neumann-side boundary nodes as
    unknowns (problems/mixedbc.py)."""
    i0, i1, j0, j1 = box
    r, c = shape
    r0, c0 = _local_offsets(shape)
    gi = lax.broadcasted_iota(jnp.int32, (r, c), 0) + r0
    gj = lax.broadcasted_iota(jnp.int32, (r, c), 1) + c0
    return (gi >= i0) & (gi <= i1) & (gj >= j0) & (gj <= j1)


def mask_of_local(shape, n, box=None):
    return (box_mask_local(shape, box) if box is not None
            else interior_mask_local(shape, n))


def neighbor_sum_local(u):
    h = with_halo1(u)
    return (h[:-2, 1:-1] + h[2:, 1:-1] + h[1:-1, :-2] + h[1:-1, 2:])


def apply_poisson_local(u, n):
    out = 4.0 * u - neighbor_sum_local(u)
    return jnp.where(interior_mask_local(u.shape, n), out,
                     jnp.zeros((), u.dtype)).astype(u.dtype)


def residual_local(u, b, n):
    r = b - 4.0 * u + neighbor_sum_local(u)
    return jnp.where(interior_mask_local(u.shape, n), r,
                     jnp.zeros((), u.dtype)).astype(u.dtype)


def jacobi_local(u, b, n, omega, sweeps):
    """Weighted Jacobi with one ppermute halo exchange per sweep.

    ``omega`` may be a per-sweep tuple (Chebyshev schedule,
    core.ops.chebyshev_omegas).
    """
    if sweeps <= 0:
        return u
    m = interior_mask_local(u.shape, n)

    if isinstance(omega, tuple):
        ws = tuple(omega[i % len(omega)] for i in range(sweeps))
        v = u
        for w in ws:
            vn = (jnp.asarray(1.0 - w, u.dtype) * v
                  + jnp.asarray(0.25 * w, u.dtype)
                  * (b + neighbor_sum_local(v)))
            v = jnp.where(m, vn, jnp.zeros((), u.dtype))
        return v

    one_minus = jnp.asarray(1.0 - omega, u.dtype)
    quarter = jnp.asarray(0.25 * omega, u.dtype)

    def body(_, v):
        vn = one_minus * v + quarter * (b + neighbor_sum_local(v))
        return jnp.where(m, vn, jnp.zeros((), u.dtype))

    return lax.fori_loop(0, sweeps, body, u)


def rbgs_local(u, b, n, sweeps):
    if sweeps <= 0:
        return u
    r, c = u.shape
    r0, c0 = _local_offsets(u.shape)
    gi = lax.broadcasted_iota(jnp.int32, (r, c), 0) + r0
    gj = lax.broadcasted_iota(jnp.int32, (r, c), 1) + c0
    inter = (gi >= 1) & (gi <= n - 1) & (gj >= 1) & (gj <= n - 1)
    red = inter & ((gi + gj) % 2 == 0)
    black = inter & ((gi + gj) % 2 == 1)

    def half(v, color):
        vn = 0.25 * (b + neighbor_sum_local(v))
        return jnp.where(color, vn.astype(v.dtype), v)

    def body(_, v):
        return half(half(v, red), black)

    return lax.fori_loop(0, sweeps, body, u)


def restrict_fw_local(rf, nf, box=None):
    """Full-weighting restriction of a local fine block -> local coarse block.

    Fine block (r, c) at global origin (r0, c0) (both even since block sizes
    are even) maps to coarse block (r//2, c//2) at (r0//2, c0//2).
    ``box``: optional COARSE unknown box (mixed-BC; same zero-boundary
    blur, different mask — R = P^T holds on boxes, core.ops.restrict_fw).
    """
    nc = nf // 2
    h = with_halo1(rf)
    up, mid, dn = h[:-2, 1:-1], h[1:-1, 1:-1], h[2:, 1:-1]
    row3 = up + 2.0 * mid + dn
    hh = jnp.concatenate(
        [_shift_from_prev(row3[:, -1:], GX), row3,
         _shift_from_next(row3[:, :1], GX)], axis=1)
    g = 0.25 * (hh[:, :-2] + 2.0 * hh[:, 1:-1] + hh[:, 2:])
    coarse = g[::2, ::2]
    m = mask_of_local(coarse.shape, nc, box)
    return jnp.where(m, coarse, jnp.zeros((), rf.dtype)).astype(rf.dtype)


def prolong_local(ec, nc, box=None):
    """Bilinear prolongation of a local coarse block -> local fine block.
    ``box``: optional FINE unknown box (mixed-BC)."""
    nf = 2 * nc
    h = with_halo1(ec)
    c = h[1:-1, 1:-1]
    cdn = h[2:, 1:-1]
    crt = h[1:-1, 2:]
    cdr = h[2:, 2:]
    va = 0.5 * (c + cdn)
    ha = 0.5 * (c + crt)
    qa = 0.25 * (c + cdn + crt + cdr)
    r, cc = c.shape
    f = jnp.zeros((2 * r, 2 * cc), ec.dtype)
    f = f.at[0::2, 0::2].set(c)
    f = f.at[1::2, 0::2].set(va.astype(ec.dtype))
    f = f.at[0::2, 1::2].set(ha.astype(ec.dtype))
    f = f.at[1::2, 1::2].set(qa.astype(ec.dtype))
    m = mask_of_local(f.shape, nf, box)
    return jnp.where(m, f, jnp.zeros((), ec.dtype))


def norm2_local(r):
    """Global L2 norm of a sharded residual via psum over both mesh axes."""
    acc = r.astype(jnp.float32) if r.dtype == jnp.bfloat16 else r
    ss = jnp.sum(acc * acc)
    ss = lax.psum(lax.psum(ss, GY), GX)
    return jnp.sqrt(ss).astype(jnp.float32)


def gather_full(x):
    """All-gather a sharded block into the full global array (replicated)."""
    rows = lax.all_gather(x, GY, axis=0, tiled=True)
    return lax.all_gather(rows, GX, axis=1, tiled=True)


def local_slice(full, shape):
    """Take this shard's block of a replicated full array."""
    r, c = shape
    r0, c0 = _local_offsets(shape)
    return lax.dynamic_slice(full, (r0, c0), (r, c))
