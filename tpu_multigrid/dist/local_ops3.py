"""Shard-local 3D (7-point) operators with explicit ppermute halo rings.

3D extension of ``dist.local_ops``: each (Sz, Sy, Sx) grid is domain-
decomposed (gz, gy) over a 2D device mesh with the x (lane) axis kept
shard-local.  Each operator pulls ghost planes (z) and ghost rows (y)
from mesh neighbors via ``jax.lax.ppermute``;
x-neighbors are local rolls whose global wrap lands on masked padding.
Wrap-around ghosts land on global-boundary/padding nodes, zeroed by the
interior masks — the invariant of ``core.ops3d``.

All functions run *inside* ``shard_map`` with mesh axes ``("gz", "gy")``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

GZ, GY3 = "gz", "gy"


def _perms(axis_name):
    n = lax.axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]   # dst i receives from i-1
    bwd = [((i + 1) % n, i) for i in range(n)]   # dst i receives from i+1
    return fwd, bwd


def _from_prev(edge, axis_name):
    fwd, _ = _perms(axis_name)
    return lax.ppermute(edge, axis_name, perm=fwd)


def _from_next(edge, axis_name):
    _, bwd = _perms(axis_name)
    return lax.ppermute(edge, axis_name, perm=bwd)


def _extend_z(u):
    """(z, y, x) -> (z+2, y, x): ghost planes from gz neighbors."""
    top = _from_prev(u[-1:], GZ)
    bot = _from_next(u[:1], GZ)
    return jnp.concatenate([top, u, bot], axis=0)


def _extend_y(u):
    """(z, y, x) -> (z, y+2, x): ghost rows from gy neighbors."""
    lf = _from_prev(u[:, -1:], GY3)
    rt = _from_next(u[:, :1], GY3)
    return jnp.concatenate([lf, u, rt], axis=1)


def with_halo1_3(u):
    """1-deep ghost shell in z and y (corners via two hops); x is local."""
    return _extend_y(_extend_z(u))


def _local_offsets3(shape):
    z, y, _ = shape
    return lax.axis_index(GZ) * z, lax.axis_index(GY3) * y


def interior_mask_local3(shape, n):
    z, y, x = shape
    z0, y0 = _local_offsets3(shape)
    gz = lax.broadcasted_iota(jnp.int32, shape, 0) + z0
    gy = lax.broadcasted_iota(jnp.int32, shape, 1) + y0
    gx = lax.broadcasted_iota(jnp.int32, shape, 2)
    return ((gz >= 1) & (gz <= n - 1) & (gy >= 1) & (gy <= n - 1)
            & (gx >= 1) & (gx <= n - 1))


def neighbor_sum_local3(u):
    hz = _extend_z(u)
    hy = _extend_y(u)
    return (hz[:-2] + hz[2:] + hy[:, :-2] + hy[:, 2:]
            + jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1))


def apply_poisson_local3(u, n):
    out = 6.0 * u - neighbor_sum_local3(u)
    return jnp.where(interior_mask_local3(u.shape, n), out,
                     jnp.zeros((), u.dtype)).astype(u.dtype)


def residual_local3(u, b, n):
    r = b - 6.0 * u + neighbor_sum_local3(u)
    return jnp.where(interior_mask_local3(u.shape, n), r,
                     jnp.zeros((), u.dtype)).astype(u.dtype)


def jacobi_local3(u, b, n, omega, sweeps):
    """Weighted Jacobi, one halo exchange per sweep; ``omega`` float or
    per-sweep tuple (Chebyshev schedule)."""
    if sweeps <= 0:
        return u
    m = interior_mask_local3(u.shape, n)
    sixth = 1.0 / 6.0

    if isinstance(omega, tuple):
        ws = tuple(omega[i % len(omega)] for i in range(sweeps))
        v = u
        for w in ws:
            vn = (jnp.asarray(1.0 - w, u.dtype) * v
                  + jnp.asarray(sixth * w, u.dtype)
                  * (b + neighbor_sum_local3(v)))
            v = jnp.where(m, vn, jnp.zeros((), u.dtype))
        return v

    one_minus = jnp.asarray(1.0 - omega, u.dtype)
    wq = jnp.asarray(sixth * omega, u.dtype)

    def body(_, v):
        vn = one_minus * v + wq * (b + neighbor_sum_local3(v))
        return jnp.where(m, vn, jnp.zeros((), u.dtype))

    return lax.fori_loop(0, sweeps, body, u)


def rbgs_local3(u, b, n, sweeps):
    if sweeps <= 0:
        return u
    z0, y0 = _local_offsets3(u.shape)
    gz = lax.broadcasted_iota(jnp.int32, u.shape, 0) + z0
    gy = lax.broadcasted_iota(jnp.int32, u.shape, 1) + y0
    gx = lax.broadcasted_iota(jnp.int32, u.shape, 2)
    inter = interior_mask_local3(u.shape, n)
    par = (gz + gy + gx) % 2
    sixth = jnp.asarray(1.0 / 6.0, u.dtype)

    def half(v, color):
        vn = sixth * (b + neighbor_sum_local3(v))
        return jnp.where(color, vn.astype(v.dtype), v)

    def body(_, v):
        v = half(v, inter & (par == 0))
        return half(v, inter & (par == 1))

    return lax.fori_loop(0, sweeps, body, u)


def restrict_fw_local3(rf, nf):
    """Full-weighting restriction R = P^T/2 of a local fine block.

    Separable per-axis [0.5, 1, 0.5] blurs — z and y blurs exchange the
    halo of the *partially blurred* array so diagonal contributions arrive
    via two hops — then even-index decimation (local origins are even:
    block sizes are even).
    """
    nc = nf // 2
    hz = _extend_z(rf)
    t = hz[1:-1] + 0.5 * (hz[:-2] + hz[2:])
    hy = _extend_y(t)
    t = hy[:, 1:-1] + 0.5 * (hy[:, :-2] + hy[:, 2:])
    t = t + 0.5 * (jnp.roll(t, 1, -1) + jnp.roll(t, -1, -1))
    coarse = 0.5 * t[::2, ::2, ::2]
    m = interior_mask_local3(coarse.shape, nc)
    return jnp.where(m, coarse, jnp.zeros((), rf.dtype)).astype(rf.dtype)


def prolong_local3(ec, nc):
    """Trilinear prolongation of a local coarse block -> local fine block."""
    nf = 2 * nc
    h = with_halo1_3(ec)
    c = h[1:-1, 1:-1]
    czp = h[2:, 1:-1]                           # z+1 (ghost at block edge)
    cyp = h[1:-1, 2:]
    czyp = h[2:, 2:]
    z, y, x = c.shape
    f = jnp.zeros((2 * z, 2 * y, 2 * x), ec.dtype)
    for pz in (0, 1):
        vz = c if pz == 0 else 0.5 * (c + czp)
        vzy = cyp if pz == 0 else 0.5 * (cyp + czyp)
        for py in (0, 1):
            v = vz if py == 0 else 0.5 * (vz + vzy)
            for px in (0, 1):
                w = v if px == 0 else 0.5 * (v + jnp.roll(v, -1, -1))
                f = f.at[pz::2, py::2, px::2].set(w.astype(ec.dtype))
    m = interior_mask_local3(f.shape, nf)
    return jnp.where(m, f, jnp.zeros((), ec.dtype))


def norm2_local3(r):
    acc = r.astype(jnp.float32) if r.dtype == jnp.bfloat16 else r
    ss = jnp.sum(acc * acc)
    ss = lax.psum(lax.psum(ss, GZ), GY3)
    return jnp.sqrt(ss).astype(jnp.float32)


def gather_full3(x):
    planes = lax.all_gather(x, GZ, axis=0, tiled=True)
    return lax.all_gather(planes, GY3, axis=1, tiled=True)


def local_slice3(full, shape):
    z, y, x = shape
    z0, y0 = _local_offsets3(shape)
    zero = jnp.zeros((), z0.dtype)
    return lax.dynamic_slice(full, (z0, y0, zero), (z, y, x))
