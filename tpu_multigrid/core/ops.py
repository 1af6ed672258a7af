"""Pure-jnp (XLA) reference operators for structured-grid 2D multigrid.

Design (see SURVEY.md §7): the reference stores the P1-FEM stiffness matrix in
CSR and applies it with oneMKL sparse gemv (``Poissons_SYCL.cpp:138,604-605``).
On the structured unit-square mesh that matrix *is* the 5-point stencil
``[[0,-1,0],[-1,4,-1],[0,-1,0]]`` (h-independent in FEM scaling; the RHS
carries ``f*h^2``), so this framework is matrix-free: every level is a dense
``(S, S)`` node grid living in HBM, with the physical grid occupying indices
``0..n`` (``n = 2**level`` cells) and homogeneous-Dirichlet boundary plus any
alignment padding held at zero.

Conventions used throughout:

* Arrays may be padded (``S >= n+1``) so fine grids can be sharded evenly;
  the *interior* (unknowns) is indices ``1..n-1`` in each axis.
* Interior masks are generated inline from ``broadcasted_iota`` — they cost
  no HBM traffic, unlike a stored mask array.
* Neighbor access uses ``jnp.roll``; wrap-around values only ever land on
  non-interior rows/cols, which the mask zeroes, and padding is maintained at
  zero so interior nodes always read true neighbor values.

Inter-grid transfers use the *variational* pair for nested P1 elements:
bilinear prolongation ``P`` (reference ``interpolation2d``,
``Poissons_SYCL.cpp:337-425``) and its exact adjoint ``R = P^T`` — the
full-weighting stencil ``[[1,2,1],[2,4,2],[1,2,1]]/4`` in FEM scaling.  (The
reference intended full weighting but its ``(1/16)`` integer division zeroed
the operator, ``Poissons_SYCL.cpp:539``; and in FD scaling the textbook
factor is /16.  With the FEM-scaled h-independent stencil, R = P^T needs /4,
which makes Galerkin coarsening R A P *equal* the re-discretized stiffness.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def interior_mask(S: int, n: int) -> jnp.ndarray:
    """Boolean (S, S) mask of interior (unknown) nodes: 1 <= i,j <= n-1."""
    i = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
    return (i >= 1) & (i <= n - 1) & (j >= 1) & (j <= n - 1)


def mask_interior(u: jnp.ndarray, n: int) -> jnp.ndarray:
    """Zero out everything but the interior."""
    m = interior_mask(u.shape[-1], n)
    return jnp.where(m, u, jnp.zeros((), u.dtype))


def box_mask(S: int, box) -> jnp.ndarray:
    """Boolean (S, S) mask of an inclusive unknown box (i0, i1, j0, j1).

    Generalizes :func:`interior_mask` (box = (1, n-1, 1, n-1)) for mixed
    Dirichlet/Neumann problems, where Neumann-side boundary nodes are
    unknowns (problems/mixedbc.py).
    """
    i0, i1, j0, j1 = box
    i = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
    return (i >= i0) & (i <= i1) & (j >= j0) & (j <= j1)


def mask_box(u: jnp.ndarray, box) -> jnp.ndarray:
    m = box_mask(u.shape[-1], box)
    return jnp.where(m, u, jnp.zeros((), u.dtype))


# ---------------------------------------------------------------------------
# 5-point stencil primitives
# ---------------------------------------------------------------------------

def neighbor_sum(u: jnp.ndarray) -> jnp.ndarray:
    """u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1] via rolls.

    Wrapped values only affect rows/cols outside the interior (masked by
    callers); padding is zero by invariant.
    """
    return (
        jnp.roll(u, 1, axis=-2)
        + jnp.roll(u, -1, axis=-2)
        + jnp.roll(u, 1, axis=-1)
        + jnp.roll(u, -1, axis=-1)
    )


def apply_poisson(u: jnp.ndarray, n: int) -> jnp.ndarray:
    """A u with the FEM-scaled 5-point stencil (diagonal 4), interior only.

    Reference equivalent: CSR gemv of the assembled stiffness
    (``Poissons_SYCL.cpp:604-605``).
    """
    out = 4.0 * u - neighbor_sum(u)
    return mask_interior(out.astype(u.dtype), n)


def residual(u: jnp.ndarray, b: jnp.ndarray, n: int) -> jnp.ndarray:
    """r = b - A u on the interior (``Poissons_SYCL.cpp:604-608``)."""
    r = b - 4.0 * u + neighbor_sum(u)
    return mask_interior(r.astype(u.dtype), n)


def chebyshev_omegas(k: int, lo: float = 0.4, hi: float = 2.0) -> tuple:
    """Per-step Jacobi weights for degree-``k`` Chebyshev smoothing.

    The smoother iterates ``v <- v + w_j * D^-1 (b - A v)`` with ``w_j`` the
    reciprocals of the Chebyshev roots on the D^-1 A smoothing interval
    ``[lo, hi]`` — the polynomial that minimizes the max error multiplier
    over that interval (textbook Chebyshev relaxation, the standard
    parallel-friendly smoother in e.g. hypre/AMG).  For the 5-point stencil
    D^-1 A has spectrum (0, 2); high-frequency (coarse-grid-invisible) modes
    live in [0.5, 2], and extending slightly below (default ``lo=0.4``)
    optimizes the measured two-grid factor.  Same per-step cost as plain
    weighted Jacobi (reference smoother, ``Poissons_SYCL.cpp:127``), ~2x
    fewer cycles at degree 2.

    Steps run in **descending-omega order**: the over-relaxed steps
    (``w > 1``, which transiently amplify high-frequency content by up to
    ``|1 - w*hi|``) come first, so every later step damps their rounding
    noise; the final step is the most damping one (``max |1 - w*l| <= 1``
    over the whole spectrum).  The reverse order measurably raises the f32
    residual floor of deep solves (~2x at 8193^2) because the last step
    amplifies all accumulated roundoff with nothing after it.
    """
    import math
    roots = [(lo + hi) / 2 + (hi - lo) / 2 * math.cos(
        math.pi * (2 * j + 1) / (2 * k)) for j in range(k)]
    # roots[] is descending in tau => ascending in omega; reverse it.
    return tuple(sorted((1.0 / t for t in roots), reverse=True))


def jacobi_sweeps(
    u: jnp.ndarray,
    b: jnp.ndarray,
    n: int,
    omega,
    sweeps: int,
) -> jnp.ndarray:
    """`sweeps` sweeps of weighted Jacobi, fixed D = 4I.

    v <- (1-w) v + (w/4)(b + sum of neighbors), the same update the reference
    builds from gemv/scal/add with a host sync per sweep
    (``Poissons_SYCL.cpp:125-147``); here the sweep loop is a single fused
    XLA computation with no host round-trips.

    ``omega`` may be a float (stationary) or a tuple of per-sweep weights
    (Chebyshev smoothing schedule, :func:`chebyshev_omegas`).
    """
    if sweeps <= 0:
        return u
    m = interior_mask(u.shape[-1], n)

    if isinstance(omega, tuple):
        ws = omega
        if len(ws) < sweeps:
            ws = tuple(ws[i % len(ws)] for i in range(sweeps))
        v = u
        for w in ws[:sweeps]:
            vn = (jnp.asarray(1.0 - w, u.dtype) * v
                  + jnp.asarray(0.25 * w, u.dtype) * (b + neighbor_sum(v)))
            v = jnp.where(m, vn, jnp.zeros((), u.dtype))
        return v

    quarter = jnp.asarray(0.25 * omega, u.dtype)
    one_minus = jnp.asarray(1.0 - omega, u.dtype)

    def body(_, v):
        vn = one_minus * v + quarter * (b + neighbor_sum(v))
        return jnp.where(m, vn, jnp.zeros((), u.dtype))

    return jax.lax.fori_loop(0, sweeps, body, u, unroll=min(sweeps, 4))


def redblack_gs_sweeps(
    u: jnp.ndarray,
    b: jnp.ndarray,
    n: int,
    sweeps: int,
) -> jnp.ndarray:
    """Red-black Gauss-Seidel: two masked half-sweeps per sweep.

    Not present in the reference (its only smoother is weighted Jacobi);
    provided per the framework's smoother registry (BASELINE config 2).  On
    an accelerator the sequential dependence is resolved by checkerboard
    coloring: all same-color updates are independent, so each half-sweep
    is a full vectorized update under a parity mask.
    """
    if sweeps <= 0:
        return u
    S = u.shape[-1]
    i = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
    inter = (i >= 1) & (i <= n - 1) & (j >= 1) & (j <= n - 1)
    parity = (i + j) % 2
    red = inter & (parity == 0)
    black = inter & (parity == 1)
    quarter = jnp.asarray(0.25, u.dtype)

    def half(v, color):
        vn = quarter * (b + neighbor_sum(v))
        return jnp.where(color, vn, v)

    def body(_, v):
        v = half(v, red)
        v = half(v, black)
        return v

    return jax.lax.fori_loop(0, sweeps, body, u, unroll=min(sweeps, 4))


# ---------------------------------------------------------------------------
# Inter-grid transfers
# ---------------------------------------------------------------------------

def _blur121(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Zero-boundary [1/2, 1, 1/2] window along one trailing axis.

    Pad-then-unit-stride-slice rather than roll, so out-of-range taps read
    exact zeros for ANY input (matching a zero-padded convolution) instead
    of wrapped values.
    """
    ax = axis if axis >= 0 else x.ndim + axis
    pad = [(0, 0)] * x.ndim
    pad[ax] = (1, 1)
    xp = jnp.pad(x, pad)
    L = x.shape[ax]
    lo = jax.lax.slice_in_dim(xp, 0, L, axis=ax)
    hi = jax.lax.slice_in_dim(xp, 2, L + 2, axis=ax)
    half = jnp.asarray(0.5, x.dtype)
    return (x + half * (lo + hi)).astype(x.dtype)


def _even_decimate(x: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Keep even indices along a trailing axis — sublane parity reshape
    ``(..., 2m, C) -> (..., m, 2, C)[..., 0, :]``; the minor axis is
    conjugated by a transpose pair.  Output length is
    ``ceil(L/2)`` — the same as a stride-2 conv with (1, 1) padding."""
    ax = axis if axis >= 0 else x.ndim + axis
    if ax == x.ndim - 1:
        return _even_decimate(x.mT, -2).mT
    L = x.shape[-2]
    if L % 2:
        pad = [(0, 0)] * x.ndim
        pad[-2] = (0, 1)
        x = jnp.pad(x, pad)
        L += 1
    m = L // 2
    return x.reshape(x.shape[:-2] + (m, 2, x.shape[-1]))[..., :, 0, :]


def _interleave(a: jnp.ndarray, b: jnp.ndarray, axis: int) -> jnp.ndarray:
    """out[..., 2t, ...] = a[..., t, ...]; out[..., 2t+1, ...] = b — via
    stack + merge-reshape (never a strided scatter).  Lane axis routes
    through a transpose pair like :func:`_even_decimate`."""
    ax = axis if axis >= 0 else a.ndim + axis
    if ax == a.ndim - 1:
        return _interleave(a.mT, b.mT, -2).mT
    st = jnp.stack([a, b], axis=-2)                # (..., m, 2, C)
    return st.reshape(a.shape[:-2] + (2 * a.shape[-2], a.shape[-1]))


def _pad_tail(x: jnp.ndarray, axis: int, k: int = 1) -> jnp.ndarray:
    pad = [(0, 0)] * x.ndim
    pad[axis if axis >= 0 else x.ndim + axis] = (0, k)
    return jnp.pad(x, pad)


def _crop_pad_square(x: jnp.ndarray, S: int) -> jnp.ndarray:
    """Crop or zero-pad the trailing two axes to (S, S)."""
    side = x.shape[-1]
    if side >= S:
        return x[..., :S, :S]
    pad = S - side
    return jnp.pad(x, [(0, 0)] * (x.ndim - 2) + [(0, pad), (0, pad)])


def restrict_fw(rf: jnp.ndarray, nf: int, Sc: int, box=None) -> jnp.ndarray:
    """Full-weighting restriction, FEM scaling R = P^T (stencil /4).

    Fine grid ``(Sf, Sf)`` with ``nf`` cells -> coarse grid ``(Sc, Sc)`` with
    ``nf//2`` cells: the [[1,2,1],[2,4,2],[1,2,1]]/4 kernel applied at even
    fine nodes.  Separable: per-axis zero-boundary [1/2, 1, 1/2] blur then
    even-index parity-reshape decimation.
    Requires ``Sf >= 2*Sc - 1`` (hierarchy construction guarantees this).
    Reference: ``restriction2d`` (``Poissons_SYCL.cpp:531-546``), with its
    integer-division bug fixed and the FEM /4 scaling so that R A P equals
    the coarse FEM stiffness.

    ``box``: optional inclusive coarse unknown box (mixed-BC problems; the
    zero-boundary blur makes the boundary rows exactly P^T of the
    truncated prolongation, so R = P^T holds on boxes too).
    """
    nc = nf // 2
    t = _blur121(_blur121(rf, -1), -2)
    coarse = _even_decimate(_even_decimate(t, -2), -1)  # side = (Sf+1)//2
    coarse = _crop_pad_square(coarse, Sc)
    if box is not None:
        return mask_box(coarse, box)
    return mask_interior(coarse, nc)


def prolong(ec: jnp.ndarray, nc: int, Sf: int, box=None) -> jnp.ndarray:
    """Bilinear prolongation, coarse ``(Sc, Sc)`` -> fine ``(Sf, Sf)``.

    fine[2i,2j] = c[i,j]; odd rows/cols average 2 neighbors; odd-odd averages
    4.  Reference: ``interpolation2d`` (``Poissons_SYCL.cpp:337-425``), whose
    89 lines of even/odd case analysis collapse to four phase averages here.

    Implemented as phase averages + stack/reshape interleaves (the 2D
    analogue of ``ops3d.prolong3``).

    ``box``: optional inclusive fine unknown box (mixed-BC problems).
    """
    return _prolong_phases(ec, nc, Sf, diag="bilinear", box=box)


def _prolong_phases(ec, nc, Sf, *, diag: str, box=None) -> jnp.ndarray:
    """Shared bilinear/P1 prolongation core: four parity phases at coarse
    resolution, interleaved rows-then-columns (lane axis via a transpose
    pair).  ``diag``: "bilinear" = 4-point odd-odd average; "p1" = 2-point
    diagonal-edge average (criss-cross triangulation)."""
    nf = 2 * nc
    # Only the coarse rows/cols that land inside the fine array matter;
    # everything past nc is non-physical padding (zero) anyway.
    m = min(ec.shape[-1], (Sf + 1) // 2)
    e = ec[..., :m, :m]
    half = jnp.asarray(0.5, ec.dtype)
    # Phase (odd row, even col): vertical 2-point average; last row pads 0.
    va = _pad_tail(half * (e[..., :-1, :] + e[..., 1:, :]), -2)
    # Phase (even row, odd col): horizontal 2-point average.
    ha = _pad_tail(half * (e[..., :, :-1] + e[..., :, 1:]), -1)
    if diag == "bilinear":
        dd = jnp.asarray(0.25, ec.dtype) * (
            e[..., :-1, :-1] + e[..., :-1, 1:]
            + e[..., 1:, :-1] + e[..., 1:, 1:])
    else:  # P1 diagonal-edge midpoint: avg of the two diagonal endpoints.
        dd = half * (e[..., 1:, :-1] + e[..., :-1, 1:])
    dd = _pad_tail(_pad_tail(dd, -2), -1)
    col_even = _interleave(e, va.astype(ec.dtype), -2)          # (2m, m)
    col_odd = _interleave(ha.astype(ec.dtype), dd.astype(ec.dtype), -2)
    f = _crop_pad_square(_interleave(col_even, col_odd, -1), Sf)
    if box is not None:
        return mask_box(f, box)
    return mask_interior(f, nf)


def restrict_injection(rf: jnp.ndarray, nf: int, Sc: int) -> jnp.ndarray:
    """Injection restriction: coarse node takes the coinciding fine value.

    Reference v2 semantics (``restriction2D``,
    ``Multigrid_functions.cpp:122-130``): no weighting, coarse dof = fine
    value at the same topological node.  Scaled by 4 to stay consistent with
    the FEM (h-independent stencil) normalization, matching R = P^T's row
    sum so constants transfer identically.
    """
    nc = nf // 2
    coarse = jnp.asarray(4.0, rf.dtype) * _even_decimate(
        _even_decimate(rf, -2), -1)
    coarse = _crop_pad_square(coarse, Sc)
    return mask_interior(coarse, nc)


def prolong_p1(ec: jnp.ndarray, nc: int, Sf: int) -> jnp.ndarray:
    """P1 (triangular-element) prolongation: every fine node lies on a
    coarse vertex or a coarse edge of the criss-cross triangulation.

    Reference v2 semantics (``interpolation2D``,
    ``Multigrid_functions.cpp:98-118``): vertex-coincident nodes inject;
    edge-midpoint nodes average the edge's two endpoints — including the
    odd-odd nodes, which sit on the *diagonal* edge and average its two
    endpoints (c[i,j+1] and c[i+1,j] for the NE-SW diagonal), unlike
    bilinear's 4-point average.  Same interleave machinery as
    :func:`prolong` (TPU-safe; no strided scatters).
    """
    return _prolong_phases(ec, nc, Sf, diag="p1")


def norm2(r: jnp.ndarray) -> jnp.ndarray:
    """Global L2 norm of a residual grid, returned as f32 (history dtype).

    Accumulates in the input precision (>= f32; bf16 inputs are upcast).
    """
    racc = r.astype(jnp.float32) if r.dtype == jnp.bfloat16 else r
    return jnp.sqrt(jnp.sum(racc * racc)).astype(jnp.float32)
