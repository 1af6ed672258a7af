"""Semi-coarsened multigrid for anisotropic operators.

For ``-(eps_x u_xx + eps_y u_yy)`` with strong anisotropy, point smoothers
damp only the modes that oscillate along the strongly coupled axis; error
that is smooth along the strong axis but oscillatory along the weak one is
invisible to both the smoother and a fully coarsened grid, and the two-grid
factor degrades toward 1.  Two textbook remedies exist:

* **line relaxation** on the standard (fully coarsened) hierarchy —
  implemented in :mod:`core.lines` (zebra PCR);
* **semi-coarsening** — coarsen ONLY the strongly coupled axis, so the
  coarse grid keeps full resolution along the weak axis and plain point
  Jacobi/Chebyshev smoothing suffices.  This module implements it.

Grids here are rectangular ``(Sy, Sx)`` padded node arrays with independent
per-axis cell counts ``(ny, nx)`` — the per-level aspect ratio changes as
one axis coarsens ahead of the other.  The hierarchy builder coarsens
whichever axis currently has the stronger effective coupling
``eps_a / h_a^2`` (both axes when balanced within a factor of two), which
reproduces full coarsening in the isotropic limit and pure x- (or y-)
semi-coarsening under strong anisotropy, equilibrating automatically as
``h`` grows on the coarsened axis.

Transfers are the tensor-product variational pair: per-axis linear
interpolation ``P_a`` and its exact adjoint ``R_a = P_a^T`` (weights
``[1/2, 1, 1/2]`` in the framework's FEM/h-independent scaling, matching
the 2D pair in :mod:`core.ops` which is ``P_x P_y`` / ``R_y R_x``).  Coarse
operators are Galerkin ``R A P``, computed in closed form on the host per
axis (the 1D analogue of ``core.operators.galerkin_coarsen_host``).

Extension beyond the reference (which is isotropic-Poisson-only,
``Poissons_SYCL.cpp:119-123``); complements ``smoother="zebra_*"`` as the
second standard anisotropy remedy.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from . import ops
from .grids import Hierarchy, coarse_dense_inverse


# ---------------------------------------------------------------------------
# Rectangular masks
# ---------------------------------------------------------------------------

def rect_mask(shape, box) -> jnp.ndarray:
    """Boolean mask of an inclusive unknown box on a rectangular grid."""
    i0, i1, j0, j1 = box
    i = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), len(shape) - 2)
    j = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), len(shape) - 1)
    return (i >= i0) & (i <= i1) & (j >= j0) & (j <= j1)


def _shift(u, di, dj):
    out = u
    if di:
        out = jnp.roll(out, -di, axis=-2)
    if dj:
        out = jnp.roll(out, -dj, axis=-1)
    return out


# ---------------------------------------------------------------------------
# Rectangular spatially varying 9-point operator
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class SemiOp:
    """9-point stencil operator on a rectangular ``(Sy, Sx)`` node grid.

    ``coef[di+1, dj+1, i, j]`` multiplies ``u[i+di, j+dj]``; unknowns are
    the interior ``1..ny-1`` x ``1..nx-1``.  ``from_axes`` records which
    axes were coarsened to REACH this level from the finer one
    (``("x",)``, ``("y",)``, or ``("x", "y")``; ``None`` on the finest
    level) — the cycle drivers dispatch the matching tensor-product
    transfers on it.

    Deliberately *not* a :class:`core.operators.VarStencilOp` subclass:
    its grids are rectangular.
    """

    ndim = 2

    def __init__(self, coef, inv_diag, ny: int, nx: int, Sy: int, Sx: int,
                 from_axes: Optional[Tuple[str, ...]] = None):
        self.coef = coef
        self.inv_diag = inv_diag
        self.ny = int(ny)
        self.nx = int(nx)
        self.Sy = int(Sy)
        self.Sx = int(Sx)
        self.from_axes = tuple(from_axes) if from_axes is not None else None

    # -- compatibility surface used by grids.coarse_dense_inverse /
    #    coarse_solve (box-driven) and generic drivers --
    @property
    def n(self):
        return self.ny

    @property
    def S(self):
        return self.Sy

    @property
    def box(self):
        return (1, self.ny - 1, 1, self.nx - 1)

    @property
    def grid_shape(self):
        return (self.Sy, self.Sx)

    def tree_flatten(self):
        return ((self.coef, self.inv_diag),
                (self.ny, self.nx, self.Sy, self.Sx, self.from_axes))

    @classmethod
    def tree_unflatten(cls, aux, children):
        ny, nx, Sy, Sx, from_axes = aux
        return cls(children[0], children[1], ny, nx, Sy, Sx,
                   from_axes=from_axes)

    def _mask(self, u):
        m = rect_mask(u.shape, self.box)
        return jnp.where(m, u, jnp.zeros((), u.dtype))

    def _off_diag_apply(self, u):
        acc = jnp.zeros_like(u)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                acc = acc + self.coef[di + 1, dj + 1] * _shift(u, di, dj)
        return acc

    def apply(self, u):
        out = self.coef[1, 1] * u + self._off_diag_apply(u)
        return self._mask(out.astype(u.dtype))

    def residual(self, u, b):
        return self._mask((b - self.apply(u)).astype(u.dtype))

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            return self._jacobi(u, b, omega, sweeps)
        if smoother == "rbgs":
            return self._rbgs(u, b, sweeps)
        if smoother in ("zebra_x", "zebra_y"):
            from .lines import zebra_sweeps
            return zebra_sweeps(self, u, b, sweeps,
                                axis=1 if smoother == "zebra_x" else 0)
        raise ValueError(f"unknown smoother {smoother!r}")

    def _jacobi(self, u, b, omega, sweeps):
        m = rect_mask(u.shape, self.box)
        inv_d = self.inv_diag.astype(u.dtype)
        ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
        if len(ws) < sweeps:
            ws = tuple(ws[i % len(ws)] for i in range(sweeps))
        v = u
        for w in ws[:sweeps]:
            vn = (jnp.asarray(1.0 - w, u.dtype) * v
                  + jnp.asarray(w, u.dtype) * inv_d
                  * (b - self._off_diag_apply(v)))
            v = jnp.where(m, vn, jnp.zeros((), u.dtype))
        return v

    def _rbgs(self, u, b, sweeps):
        shape = u.shape[-2:]
        i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        inter = rect_mask(shape, self.box)
        inv_d = self.inv_diag.astype(u.dtype)

        def half(v, color):
            vn = v + inv_d * (b - self.apply(v))
            return jnp.where(color, vn, v)

        v = u
        for _ in range(sweeps):
            v = half(v, inter & ((i + j) % 2 == 0))
            v = half(v, inter & ((i + j) % 2 == 1))
        return v

    # -- cycle transfer protocol: the coarse op owns the pair --
    def restrict_into(self, r, fine_op):
        return restrict_to(r, self)

    def prolong_add_into(self, u, ec, fine_op):
        return prolong_add_from(u, ec, self, fine_op)

    def __repr__(self):
        return (f"SemiOp(ny={self.ny}, nx={self.nx}, Sy={self.Sy}, "
                f"Sx={self.Sx}, from_axes={self.from_axes})")


def semi_anisotropic_op(ny: int, nx: int, eps_x: float, eps_y: float,
                        Sy: Optional[int] = None, Sx: Optional[int] = None,
                        dtype=np.float32) -> SemiOp:
    """h-independent anisotropic 5-point stencil on a rectangular grid.

    On the (square-cell) finest level this matches
    ``problems.anisotropic.anisotropic_poisson_op`` exactly: diagonal
    ``2(eps_x + eps_y)``, E/W ``-eps_x``, N/S ``-eps_y``; RHS carries
    ``f * hx * hy``.  Host numpy arrays (uploaded once at first jit call).
    """
    Sy = Sy if Sy is not None else ny + 1
    Sx = Sx if Sx is not None else nx + 1
    coef = np.zeros((3, 3, Sy, Sx), dtype)
    coef[1, 1] = 2.0 * (eps_x + eps_y)
    coef[1, 0] = -eps_x
    coef[1, 2] = -eps_x
    coef[0, 1] = -eps_y
    coef[2, 1] = -eps_y
    iy = np.arange(Sy)
    ix = np.arange(Sx)
    m = (((iy >= 1) & (iy <= ny - 1))[:, None]
         & ((ix >= 1) & (ix <= nx - 1))[None])
    coef = np.where(m[None, None], coef, np.zeros((), dtype))
    diag = coef[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0).astype(dtype)
    return SemiOp(coef, inv_diag, ny, nx, Sy, Sx)


# ---------------------------------------------------------------------------
# Per-axis variational transfers (R_a = P_a^T, weights [1/2, 1, 1/2])
# ---------------------------------------------------------------------------

_W1D = (0.5, 1.0, 0.5)


def restrict_axis(r: jnp.ndarray, axis: int, Sc_ax: int) -> jnp.ndarray:
    """One-axis restriction ``R_a = P_a^T``: zero-boundary [1/2, 1, 1/2]
    blur + even-index parity-reshape decimation (``core.ops`` helpers).

    Output size along ``axis`` is cropped/zero-padded to ``Sc_ax``; the
    caller masks to the coarse unknown box.
    """
    out = ops._even_decimate(ops._blur121(r, axis), axis)
    side = out.shape[axis]
    sl = [slice(None)] * out.ndim
    if side >= Sc_ax:
        sl[axis] = slice(0, Sc_ax)
        return out[tuple(sl)]
    pad = [(0, 0)] * out.ndim
    pad[axis] = (0, Sc_ax - side)
    return jnp.pad(out, pad)


def prolong_axis(e: jnp.ndarray, axis: int, Sf_ax: int) -> jnp.ndarray:
    """One-axis linear interpolation ``P_a``: even inject, odd average.

    Interleave form (``core.ops._interleave``: stack + merge-reshape, lane
    axis via a transpose pair) — never a strided scatter.
    """
    Sc_ax = e.shape[axis]
    m = min(Sc_ax, (Sf_ax + 1) // 2)

    def ax_slice(arr, s):
        sl = [slice(None)] * arr.ndim
        sl[axis if axis >= 0 else arr.ndim + axis] = s
        return tuple(sl)

    e = e[ax_slice(e, slice(0, m))]
    lo = e[ax_slice(e, slice(0, m - 1))]
    hi = e[ax_slice(e, slice(1, m))]
    odd = ops._pad_tail((0.5 * (lo + hi)).astype(e.dtype), axis)
    f = ops._interleave(e, odd, axis)              # length 2m along axis
    L = f.shape[axis]
    if L >= Sf_ax:
        return f[ax_slice(f, slice(0, Sf_ax))]
    pad = [(0, 0)] * f.ndim
    pad[axis if axis >= 0 else f.ndim + axis] = (0, Sf_ax - L)
    return jnp.pad(f, pad)


def restrict_to(r: jnp.ndarray, opc: SemiOp) -> jnp.ndarray:
    """Restrict a fine residual onto coarse level ``opc`` (its
    ``from_axes`` drive the per-axis tensor-product composition)."""
    out = r
    for ax in opc.from_axes:
        out = restrict_axis(out, -1 if ax == "x" else -2,
                            opc.Sx if ax == "x" else opc.Sy)
    m = rect_mask(out.shape, opc.box)
    return jnp.where(m, out, jnp.zeros((), out.dtype))


def prolong_add_from(u: jnp.ndarray, e: jnp.ndarray, opc: SemiOp,
                     opf: SemiOp) -> jnp.ndarray:
    """u + P e with the tensor-product prolongation matching
    :func:`restrict_to` (P_x and P_y commute; order irrelevant)."""
    out = e
    for ax in opc.from_axes:
        out = prolong_axis(out, -1 if ax == "x" else -2,
                           opf.Sx if ax == "x" else opf.Sy)
    m = rect_mask(out.shape, opf.box)
    return u + jnp.where(m, out, jnp.zeros((), out.dtype))


# ---------------------------------------------------------------------------
# One-axis Galerkin coarsening (closed form, host numpy)
# ---------------------------------------------------------------------------

def galerkin_semicoarsen_host(fine: SemiOp, axis: str) -> SemiOp:
    """Coarse operator ``A_c = R_a A P_a`` for one coarsened axis.

    1D analogue of ``core.operators.galerkin_coarsen_host``: with the
    fixed per-axis pair (``Pw = Rw = [1/2, 1, 1/2]``), ``R A P`` is the
    local algebraic formula

        A_c(dr, dc)[i, J] = sum_{a, b} Rw[a] * A(dr, b)[i, 2J + a]
                            * Pw[a + b - 2 dc] * Ind(i + dr, 2J + a + b)

    (for ``axis="x"``; ``a, b, dc`` in {-1, 0, 1}), where ``Ind`` is the
    fine unknown-box indicator (the prolongation has zero rows at
    Dirichlet/padding nodes).  ``axis="y"`` runs the same formula on the
    transposed operator.  Computed on the host so chained coarsening never
    round-trips the device.
    """
    if axis == "y":
        # Transpose the grid axes AND the stencil offset axes, reuse the
        # x-axis formula, transpose back.
        t = _transpose_semiop(fine)
        ct = galerkin_semicoarsen_host(t, "x")
        out = _transpose_semiop(ct)
        out.from_axes = ("y",)
        return out

    ny, nxf, Sy = fine.ny, fine.nx, fine.Sy
    nxc = nxf // 2
    Scx = nxc + 1
    dt = fine.coef.dtype
    work_dt = np.float64 if np.dtype(dt) == np.float64 else np.float32
    A = np.asarray(fine.coef, work_dt)              # (3, 3, Sy, Sxf)

    # Margin-2 padded x frame: column (2 + g) holds fine column g.
    W = 2 * Scx + 4
    lim = min(fine.Sx, W - 2)
    F = np.zeros((3, 3, Sy, W), work_dt)
    F[:, :, :, 2: 2 + lim] = A[:, :, :, :lim]
    # Fine unknown indicator with margin 2 on BOTH axes (row shifts by dr,
    # column samples at 2J + a + b).
    gy = np.arange(Sy + 4) - 2
    gx = np.arange(W) - 2
    If = (((gy >= 1) & (gy <= ny - 1))[:, None]
          & ((gx >= 1) & (gx <= nxf - 1))[None]).astype(work_dt)

    Rw = np.asarray(_W1D, work_dt)
    offs = (-1, 0, 1)

    def samp(arr, ac):
        return arr[..., 2 + ac: 2 + ac + 2 * Scx: 2]

    def samp_if(dr, ac):
        return If[2 + dr: 2 + dr + Sy, 2 + ac: 2 + ac + 2 * Scx: 2]

    C2 = np.zeros((3, 3, Sy, Scx), work_dt)
    for a in offs:
        ra = Rw[a + 1]
        for b in offs:
            for dr in offs:
                term = ra * samp(F[dr + 1, b + 1], a) * samp_if(dr, a + b)
                for dc in offs:
                    c = a + b - 2 * dc
                    if abs(c) > 1:
                        continue
                    C2[dr + 1, dc + 1] += Rw[c + 1] * term

    iy = np.arange(Sy)
    ix = np.arange(Scx)
    m = (((iy >= 1) & (iy <= ny - 1))[:, None]
         & ((ix >= 1) & (ix <= nxc - 1))[None])
    C2 = np.where(m[None, None], C2, 0.0)
    diag = C2[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0)
    dt_np = np.dtype(dt)
    return SemiOp(C2.astype(dt_np), inv_diag.astype(dt_np), ny, nxc,
                  Sy, Scx, from_axes=("x",))


def _transpose_semiop(op: SemiOp) -> SemiOp:
    """Swap the x/y roles of a SemiOp (stencil offsets and grid axes)."""
    coef_t = np.asarray(op.coef).transpose(1, 0, 3, 2)
    inv_t = np.asarray(op.inv_diag).T
    return SemiOp(np.ascontiguousarray(coef_t), np.ascontiguousarray(inv_t),
                  op.nx, op.ny, op.Sx, op.Sy, from_axes=op.from_axes)


def galerkin_coarsen_axes(fine: SemiOp, axes: Tuple[str, ...]) -> SemiOp:
    """Chain per-axis Galerkin coarsening; ``from_axes`` records the set.

    For ``axes=("x", "y")`` this equals the one-shot 2D ``R A P`` with the
    tensor-product bilinear pair (P_x P_y = bilinear P exactly).
    """
    out = fine
    for ax in axes:
        out = galerkin_semicoarsen_host(out, ax)
    out.from_axes = tuple(axes)
    return out


# ---------------------------------------------------------------------------
# Hierarchy construction
# ---------------------------------------------------------------------------

def choose_coarsen_axes(eps_x: float, eps_y: float, nx: int, ny: int,
                        balance: float = 2.0) -> Tuple[str, ...]:
    """Axes to coarsen next under the coupling-balance rule.

    Coarsening axis ``a`` is safe for a point smoother iff modes that
    oscillate along ``a`` are damped, i.e. the effective coupling
    ``c_a = eps_a / h_a^2 = eps_a * n_a^2`` is within an O(1) factor
    (``balance``) of the strongest coupling among the *mode-carrying*
    axes.  An axis at extent 2 has a single interior plane — it carries
    no modes — so it leaves both sides of the comparison.  Isotropic =>
    both axes (full coarsening); strong anisotropy => the strong axis
    only, equilibrating as its ``h`` doubles (``c_a`` drops 4x per
    level); extreme anisotropy => the strong axis runs to extent 2,
    after which the remaining axis is a plain 1D problem and coarsens
    safely alone.
    """
    coup = {}
    if nx > 2:
        coup["x"] = eps_x * nx ** 2
    if ny > 2:
        coup["y"] = eps_y * ny ** 2
    if not coup:
        return ()
    cmax = max(coup.values())
    return tuple(a for a in ("y", "x")
                 if a in coup and coup[a] * balance >= cmax)


def build_semicoarsened_hierarchy(config: MultigridConfig, eps_x: float,
                                  eps_y: float,
                                  balance: float = 2.0) -> Hierarchy:
    """Coupling-balanced semi-coarsened Galerkin hierarchy.

    The finest level is the square ``2**finest_level`` grid; each step
    coarsens the axes picked by :func:`choose_coarsen_axes`, stopping
    once the unknown count reaches the full-coarsening coarsest size
    ``(2**coarsest_level - 1)^2`` (or no axis may coarsen).  The coarsest
    level may be rectangular — the dense direct solve is box-aware.
    Levels are :class:`SemiOp` with ``from_axes`` recording each step for
    the cycle transfers.
    """
    n = 2 ** config.finest_level
    target_unknowns = (2 ** config.coarsest_level - 1) ** 2
    dt = np.dtype(jnp.dtype(config.dtype).name)
    fine = semi_anisotropic_op(n, n, eps_x, eps_y, dtype=dt)
    levels = [fine]
    nx = ny = n
    while (nx - 1) * (ny - 1) > target_unknowns:
        axes = choose_coarsen_axes(eps_x, eps_y, nx, ny, balance)
        if not axes:
            break
        levels.append(galerkin_coarsen_axes(levels[-1], axes))
        nx, ny = levels[-1].nx, levels[-1].ny
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


def smoothing_factor_bound(eps_x: float, eps_y: float,
                           omega: float = 0.8) -> float:
    """Worst-mode damping of omega-Jacobi over the modes a FULLY coarsened
    grid cannot represent — the classical argument for why semi-coarsening
    (or lines) is needed: as ``eps_x/eps_y -> inf`` this tends to 1.

    For the anisotropic 5-point stencil, the mode (theta_x, theta_y) has
    amplification ``1 - omega * (eps_x (1 - cos tx) + eps_y (1 - cos ty))
    / (eps_x + eps_y)``; the binding mode under full coarsening is
    ``(0, pi/2)``-ish: smooth along the strong axis, oscillatory along the
    weak one.  Used by tests to document the failure this module fixes.
    """
    ex, ey = max(eps_x, eps_y), min(eps_x, eps_y)
    # worst high-frequency-in-weak-axis, smooth-in-strong-axis mode
    tx, ty = 0.0, math.pi / 2
    amp = 1.0 - omega * (ex * (1 - math.cos(tx)) + ey * (1 - math.cos(ty))) \
        / (ex + ey)
    return abs(amp)
