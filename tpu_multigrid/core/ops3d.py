"""Pure-jnp operators for 3D (7-point) structured-grid multigrid.

The reference is strictly 2D (``Poissons_SYCL.cpp:119-123``: unit square);
this module extends the framework's matrix-free design to the unit *cube* —
the same conventions lifted one dimension:

* Grids are (S, S, S) padded node arrays; physical nodes ``0..n`` per axis,
  interior (unknowns) ``1..n-1``; everything outside is zero, re-masked with
  inline iota masks.
* The operator is the h-independent 7-point stencil (diagonal 6,
  off-diagonals -1); the RHS carries ``f * h^2``, so every level shares one
  stencil.
* Transfers are the adjoint pair for that normalization: trilinear
  prolongation ``P`` and ``R = P^T / 2``.  The /2 is the FD-consistency
  scaling: in d dimensions the h-independent stencil absorbs ``h^2`` (one
  power-of-4 per coarsening), while ``P^T`` scales constants by ``2^d`` —
  so ``R = (4 / 2^d) P^T`` keeps the restricted RHS carrying exactly
  ``f * (2h)^2`` (d=2 gives the 2D module's ``R = P^T``; d=3 the /2).
  Unlike 2D, the coarse operator is the *re-discretized* stencil, not the
  Galerkin product (trilinear ``P^T A P`` is a 27-point operator); R and P
  remain exact adjoints up to the scale, which the tests pin.

Smoother spectra match 2D: ``D^-1 A`` lives in (0, 2), so the same weighted-
Jacobi / Chebyshev weight schedules apply unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def _shape3(S) -> tuple:
    """Cubic int or (Sz, Sy, Sx) tuple -> 3-tuple.  Grids may be padded
    per-axis; padding is zero/masked like 2D."""
    return (S, S, S) if isinstance(S, int) else tuple(S)


def interior_mask3(S, n: int) -> jnp.ndarray:
    shape = _shape3(S)
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    lo, hi = 1, n - 1
    return ((i >= lo) & (i <= hi) & (j >= lo) & (j <= hi)
            & (k >= lo) & (k <= hi))


def mask_interior3(u: jnp.ndarray, n: int) -> jnp.ndarray:
    m = interior_mask3(u.shape[-3:], n)
    return jnp.where(m, u, jnp.zeros((), u.dtype))


def box_mask3(S, box) -> jnp.ndarray:
    """Inclusive unknown box (i0, i1, j0, j1, k0, k1) over a (Sz, Sy, Sx)
    grid — the 3D analogue of ``ops.box_mask`` (mixed Dirichlet/Neumann
    problems keep Neumann-side boundary nodes as unknowns)."""
    shape = _shape3(S)
    i0, i1, j0, j1, k0, k1 = box
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    return ((i >= i0) & (i <= i1) & (j >= j0) & (j <= j1)
            & (k >= k0) & (k <= k1))


def mask_box3(u: jnp.ndarray, box) -> jnp.ndarray:
    m = box_mask3(u.shape[-3:], box)
    return jnp.where(m, u, jnp.zeros((), u.dtype))


# ---------------------------------------------------------------------------
# 7-point stencil primitives
# ---------------------------------------------------------------------------

def neighbor_sum3(u: jnp.ndarray) -> jnp.ndarray:
    """Sum of the six face neighbors via rolls (wraps land on masked cells)."""
    return (jnp.roll(u, 1, -3) + jnp.roll(u, -1, -3)
            + jnp.roll(u, 1, -2) + jnp.roll(u, -1, -2)
            + jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1))


def apply_poisson3(u: jnp.ndarray, n: int) -> jnp.ndarray:
    out = 6.0 * u - neighbor_sum3(u)
    return mask_interior3(out.astype(u.dtype), n)


def residual3(u: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    r = b - 6.0 * u + neighbor_sum3(u)
    return mask_interior3(r.astype(u.dtype), n)


def jacobi_sweeps3(u, b, n: int, omega, sweeps: int) -> jnp.ndarray:
    """Weighted Jacobi, D = 6I; ``omega`` float or per-sweep tuple."""
    if sweeps <= 0:
        return u
    m = interior_mask3(u.shape[-3:], n)
    sixth = 1.0 / 6.0

    if isinstance(omega, tuple):
        ws = tuple(omega[i % len(omega)] for i in range(sweeps))
        v = u
        for w in ws:
            vn = (jnp.asarray(1.0 - w, u.dtype) * v
                  + jnp.asarray(sixth * w, u.dtype) * (b + neighbor_sum3(v)))
            v = jnp.where(m, vn, jnp.zeros((), u.dtype))
        return v

    wq = jnp.asarray(sixth * omega, u.dtype)
    om = jnp.asarray(1.0 - omega, u.dtype)

    def body(_, v):
        vn = om * v + wq * (b + neighbor_sum3(v))
        return jnp.where(m, vn, jnp.zeros((), u.dtype))

    return jax.lax.fori_loop(0, sweeps, body, u, unroll=min(sweeps, 4))


def redblack_gs_sweeps3(u, b, n: int, sweeps: int) -> jnp.ndarray:
    """Red-black Gauss-Seidel, 3D checkerboard coloring."""
    if sweeps <= 0:
        return u
    shape = u.shape[-3:]
    i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    inter = interior_mask3(shape, n)
    parity = (i + j + k) % 2
    sixth = jnp.asarray(1.0 / 6.0, u.dtype)

    def half(v, color):
        vn = sixth * (b + neighbor_sum3(v))
        return jnp.where(color, vn, v)

    def body(_, v):
        v = half(v, inter & (parity == 0))
        v = half(v, inter & (parity == 1))
        return v

    return jax.lax.fori_loop(0, sweeps, body, u, unroll=min(sweeps, 4))


# ---------------------------------------------------------------------------
# Inter-grid transfers
# ---------------------------------------------------------------------------

def _blur_decimate(t: jnp.ndarray, ax: int) -> jnp.ndarray:
    """[0.5, 1, 0.5] blur along ``ax`` then keep even indices.

    Decimation is a parity reshape (``(m, 2, ...)[:, 0]``).  The minor
    axis routes through a transpose pair like :func:`prolong3`.  Roll
    wrap-around only ever reads masked-zero padding (inputs are masked
    residuals).
    """
    half = jnp.asarray(0.5, t.dtype)
    t = t + half * (jnp.roll(t, 1, ax) + jnp.roll(t, -1, ax))
    if ax == 2:
        tt = t.transpose(2, 0, 1)
        m = tt.shape[0] // 2
        out = tt[: 2 * m].reshape(m, 2, tt.shape[1], tt.shape[2])[:, 0]
        return out.transpose(1, 2, 0)
    m = t.shape[ax] // 2
    if ax == 0:
        return t[: 2 * m].reshape(m, 2, t.shape[1], t.shape[2])[:, 0]
    return t[:, : 2 * m].reshape(t.shape[0], m, 2, t.shape[2])[:, :, 0]


def _shift_zero3(t: jnp.ndarray, d: int, ax: int) -> jnp.ndarray:
    """t shifted by ``d`` along ``ax`` with ZERO fill (pad + unit-stride
    slice — no wrap).  Box problems (mixed BCs) have live values on the
    edge planes, so the roll-wrap-onto-masked-cells invariant the interior
    transfers rely on does not hold for them."""
    pad = [(0, 0)] * 3
    sl = [slice(None)] * 3
    if d > 0:
        pad[ax] = (d, 0)
        sl[ax] = slice(0, t.shape[ax])
    else:
        pad[ax] = (0, -d)
        sl[ax] = slice(-d, t.shape[ax] - d)
    return jnp.pad(t, pad)[tuple(sl)]


def _blur_decimate_box(t: jnp.ndarray, ax: int) -> jnp.ndarray:
    """:func:`_blur_decimate` with zero-fill shifts (box-safe), keeping
    the TOP even plane.

    The interior decimation drops fine index 2*(S//2) when S is odd —
    harmless there (index n is a masked Dirichlet plane) but it IS the
    live hi-side Neumann boundary plane on boxes: without this the
    restriction zeroed coarse node n_c and R = P^T/2 adjointness broke
    (measured rel err 8.1 for a yhi box).  Pad one zero plane so the
    parity reshape keeps indices 0, 2, ..., 2*ceil(S/2)-2 >= n."""
    half = jnp.asarray(0.5, t.dtype)
    t = t + half * (_shift_zero3(t, 1, ax) + _shift_zero3(t, -1, ax))
    if t.shape[ax] % 2:
        pad = [(0, 0)] * 3
        pad[ax] = (0, 1)
        t = jnp.pad(t, pad)
    if ax == 2:
        tt = t.transpose(2, 0, 1)
        m = tt.shape[0] // 2
        out = tt[: 2 * m].reshape(m, 2, tt.shape[1], tt.shape[2])[:, 0]
        return out.transpose(1, 2, 0)
    m = t.shape[ax] // 2
    if ax == 0:
        return t[: 2 * m].reshape(m, 2, t.shape[1], t.shape[2])[:, 0]
    return t[:, : 2 * m].reshape(t.shape[0], m, 2, t.shape[2])[:, :, 0]


def restrict_fw3(rf: jnp.ndarray, nf: int, Sc, box=None) -> jnp.ndarray:
    """Full-weighting restriction R = P^T/2, fine -> coarse padded grid.

    Separable: per-axis [0.5, 1, 0.5] blur + even-index decimation (volume
    halves each axis, so the whole restriction costs ~2 fine-grid passes),
    scaled by the 0.5 FD-consistency factor (module docstring).

    ``box``: the COARSE unknown box (mixed BCs) — zero-fill shifts replace
    the rolls (edge planes hold live values) and the output masks to the
    box instead of the Dirichlet interior.
    """
    nc = nf // 2
    shc = _shape3(Sc)
    t = rf
    for ax in (0, 1, 2):
        t = (_blur_decimate_box if box is not None
             else _blur_decimate)(t, ax)
    coarse = jnp.asarray(0.5, rf.dtype) * t
    coarse = coarse[tuple(slice(0, min(coarse.shape[ax], shc[ax]))
                          for ax in range(3))]
    pad = [(0, shc[ax] - coarse.shape[ax]) for ax in range(3)]
    if any(p != (0, 0) for p in pad):
        coarse = jnp.pad(coarse, pad)
    if box is not None:
        return mask_box3(coarse, box)
    return mask_interior3(coarse, nc)


def _interleave_axis(a: jnp.ndarray, b: jnp.ndarray, axis: int):
    """out[..., 2t, ...] = a[..., t, ...], out[..., 2t+1, ...] = b: stack +
    merge-reshape.  Minor-axis interleaves transpose first (see
    :func:`prolong3`)."""
    st = jnp.stack([a, b], axis=axis + 1)
    shape = list(a.shape)
    shape[axis] *= 2
    return st.reshape(shape)


def prolong3(ec: jnp.ndarray, nc: int, Sf: int,
             box=None) -> jnp.ndarray:
    """Trilinear prolongation, coarse (Sc,)^3 -> fine (Sf,)^3.

    Eight parity phases: even axes inject, odd axes average the two coarse
    neighbors along that axis (the 3D analogue of ``core.ops.prolong``).

    Implemented by pairwise axis interleaves (z, then y, then x through a
    transpose) instead of strided scatters.
    """
    nf = 2 * nc
    shf = _shape3(Sf)
    m = tuple(min(ec.shape[ax], (shf[ax] + 1) // 2) for ax in range(3))
    e = ec[tuple(slice(0, m[ax]) for ax in range(3))]

    def phase(pi, pj, pk):
        v = e
        for ax, p in enumerate((pi, pj, pk)):
            if p:
                lo = [slice(None)] * 3
                hi = [slice(None)] * 3
                lo[ax] = slice(0, -1)
                hi[ax] = slice(1, None)
                v = 0.5 * (v[tuple(lo)] + v[tuple(hi)])
                pad = [(0, 0)] * 3
                pad[ax] = (0, 1)
                v = jnp.pad(v, pad)
        return v.astype(ec.dtype)

    # z (axis 0), then y (axis 1) — both major-dim interleaves.
    s = []
    for pk in (0, 1):
        t0 = _interleave_axis(phase(0, 0, pk), phase(1, 0, pk), 0)
        t1 = _interleave_axis(phase(0, 1, pk), phase(1, 1, pk), 0)
        s.append(_interleave_axis(t0, t1, 1))        # (2m0, 2m1, m2)
    # x (lane axis): transpose x to the front, interleave, transpose back.
    f = _interleave_axis(s[0].transpose(2, 0, 1), s[1].transpose(2, 0, 1),
                         0).transpose(1, 2, 0)        # (2m0, 2m1, 2m2)

    f = f[tuple(slice(0, min(2 * m[ax], shf[ax])) for ax in range(3))]
    pad = [(0, shf[ax] - f.shape[ax]) for ax in range(3)]
    if any(p != (0, 0) for p in pad):
        f = jnp.pad(f, pad)
    if box is not None:
        return mask_box3(f, box)   # FINE unknown box (mixed BCs)
    return mask_interior3(f, nf)
