"""Semi-coarsened multigrid for 3D anisotropic operators.

The 3D twin of :mod:`core.semicoarsen`: for ``-(eps_x u_xx + eps_y u_yy +
eps_z u_zz)`` with strong anisotropy, point smoothers damp only modes
oscillating along strongly coupled axes, and full coarsening loses the
mixed smooth/oscillatory error — coarsening ONLY the strongly coupled
axes keeps point Jacobi/Chebyshev mesh-independent (the 3D robust remedy
that does not need plane/line relaxation).

Design difference from the 2D module: operators here are **constant
stencils with inline masks** rather than stored coefficient volumes — a
27-point spatial coefficient array at 3D sizes would be 27 grid volumes
of HBM.  This is exact, not an approximation: with the framework's
conventions (zero Dirichlet exterior, transfer rows vanish at boundary
nodes) the Galerkin product ``R_a A P_a`` of a constant-stencil interior
operator is again constant over the coarse interior — every entry
``p_I^T A p_J`` only reads interior-interior stencil entries, which are
translation-invariant (the tests verify this against a dense R A P).

Per-axis transfers are the variational pair ``P_a`` (linear
interpolation) / ``R_a = P_a^T`` (weights [1/2, 1, 1/2]) built from
parity reshapes (minor axis conjugated by a transpose pair).  Grids are
rectangular ``(Sz, Sy, Sx)`` node boxes with independent per-axis cell
counts.

Extension beyond the isotropic-only reference
(``Poissons_SYCL.cpp:119-123``), completing the anisotropy-remedy matrix
in 3D (2D has both zebra lines and semi-coarsening).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from .grids import Hierarchy

_W1D = np.array([0.5, 1.0, 0.5])


# ---------------------------------------------------------------------------
# Axis-generic parity helpers (any axis of a 3D array; minor axis via mT)
# ---------------------------------------------------------------------------

def _even_decimate_ax(x: jnp.ndarray, ax: int) -> jnp.ndarray:
    """Keep even indices along ``ax`` via a parity reshape (never a
    stride-2 slice).  Minor (lane) axis routes through a transpose pair."""
    if ax == x.ndim - 1:
        return _even_decimate_ax(x.mT, x.ndim - 2).mT
    L = x.shape[ax]
    if L % 2:
        pad = [(0, 0)] * x.ndim
        pad[ax] = (0, 1)
        x = jnp.pad(x, pad)
        L += 1
    shp = x.shape[:ax] + (L // 2, 2) + x.shape[ax + 1:]
    idx = (slice(None),) * (ax + 1) + (0,)
    return x.reshape(shp)[idx]


def _interleave_ax(a: jnp.ndarray, b: jnp.ndarray, ax: int) -> jnp.ndarray:
    """out[2t] = a[t], out[2t+1] = b[t] along ``ax`` (stack + merge
    reshape); minor axis via a transpose pair."""
    if ax == a.ndim - 1:
        return _interleave_ax(a.mT, b.mT, a.ndim - 2).mT
    st = jnp.stack([a, b], axis=ax + 1)
    shp = a.shape[:ax] + (2 * a.shape[ax],) + a.shape[ax + 1:]
    return st.reshape(shp)


def _blur121_ax(x: jnp.ndarray, ax: int) -> jnp.ndarray:
    """Zero-boundary [1/2, 1, 1/2] window along ``ax`` (pad + unit-stride
    slices, matching core.ops._blur121)."""
    pad = [(0, 0)] * x.ndim
    pad[ax] = (1, 1)
    xp = jnp.pad(x, pad)
    L = x.shape[ax]
    lo = jax.lax.slice_in_dim(xp, 0, L, axis=ax)
    hi = jax.lax.slice_in_dim(xp, 2, L + 2, axis=ax)
    return (x + jnp.asarray(0.5, x.dtype) * (lo + hi)).astype(x.dtype)


def _crop_pad_ax(x: jnp.ndarray, ax: int, L: int) -> jnp.ndarray:
    side = x.shape[ax]
    if side >= L:
        return jax.lax.slice_in_dim(x, 0, L, axis=ax)
    pad = [(0, 0)] * x.ndim
    pad[ax] = (0, L - side)
    return jnp.pad(x, pad)


# ---------------------------------------------------------------------------
# Constant 27-point operator on a rectangular 3D box
# ---------------------------------------------------------------------------

_AXN = {"z": 0, "y": 1, "x": 2}


def _box_mask3(shape, box):
    i0, i1, j0, j1, k0, k1 = box
    gi = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), 0)
    gj = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), 1)
    gk = jax.lax.broadcasted_iota(jnp.int32, tuple(shape), 2)
    return ((gi >= i0) & (gi <= i1) & (gj >= j0) & (gj <= j1)
            & (gk >= k0) & (gk <= k1))


@jax.tree_util.register_pytree_node_class
class SemiConstOp3:
    """Constant (3, 3, 3) stencil on a rectangular ``(Sz, Sy, Sx)`` grid.

    ``sten[dz+1, dy+1, dx+1]`` multiplies ``u[i+dz, j+dy, k+dx]``;
    unknowns are the interior box ``1..n_a - 1`` per axis.  The stencil
    is a static (host numpy) aux field — no coefficient volumes exist on
    device.  ``from_axes`` records the axes coarsened to reach this level
    (drives the tensor-product cycle transfers, like 2D ``SemiOp``).
    """

    ndim = 3

    def __init__(self, sten: np.ndarray, nz: int, ny: int, nx: int,
                 Sz: int, Sy: int, Sx: int,
                 from_axes: Optional[Tuple[str, ...]] = None):
        self.sten = np.asarray(sten, np.float64)
        self.nz, self.ny, self.nx = int(nz), int(ny), int(nx)
        self.Sz, self.Sy, self.Sx = int(Sz), int(Sy), int(Sx)
        self.from_axes = tuple(from_axes) if from_axes is not None else None

    @property
    def n(self):
        return self.nz

    @property
    def S(self):
        return self.Sz

    @property
    def box(self):
        return (1, self.nz - 1, 1, self.ny - 1, 1, self.nx - 1)

    @property
    def grid_shape(self):
        return (self.Sz, self.Sy, self.Sx)

    def tree_flatten(self):
        # all-static: the stencil is host data baked into the trace
        return ((), (self.sten.tobytes(), self.nz, self.ny, self.nx,
                     self.Sz, self.Sy, self.Sx, self.from_axes))

    @classmethod
    def tree_unflatten(cls, aux, children):
        raw, nz, ny, nx, Sz, Sy, Sx, from_axes = aux
        sten = np.frombuffer(raw, np.float64).reshape(3, 3, 3)
        return cls(sten, nz, ny, nx, Sz, Sy, Sx, from_axes=from_axes)

    def _mask(self, u):
        m = _box_mask3(u.shape, self.box)
        return jnp.where(m, u, jnp.zeros((), u.dtype))

    def _off_diag_apply(self, u):
        acc = jnp.zeros_like(u)
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dz == 0 and dy == 0 and dx == 0:
                        continue
                    c = float(self.sten[dz + 1, dy + 1, dx + 1])
                    if c == 0.0:
                        continue
                    v = u
                    if dz:
                        v = jnp.roll(v, -dz, axis=0)
                    if dy:
                        v = jnp.roll(v, -dy, axis=1)
                    if dx:
                        v = jnp.roll(v, -dx, axis=2)
                    acc = acc + jnp.asarray(c, u.dtype) * v
        return acc

    def apply(self, u):
        d = jnp.asarray(float(self.sten[1, 1, 1]), u.dtype)
        return self._mask((d * u + self._off_diag_apply(u)).astype(u.dtype))

    def residual(self, u, b):
        return self._mask((b - self.apply(u)).astype(u.dtype))

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            return self._jacobi(u, b, omega, sweeps)
        if smoother == "rbgs":
            return self._rbgs(u, b, sweeps)
        raise ValueError(f"SemiConstOp3 supports jacobi/chebyshev/rbgs, "
                         f"not {smoother!r}")

    def _jacobi(self, u, b, omega, sweeps):
        m = _box_mask3(u.shape, self.box)
        inv_d = jnp.asarray(1.0 / float(self.sten[1, 1, 1]), u.dtype)
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
        shape = u.shape
        gi = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
        gj = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
        gk = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
        inter = _box_mask3(shape, self.box)
        inv_d = jnp.asarray(1.0 / float(self.sten[1, 1, 1]), u.dtype)

        def half(v, color):
            vn = v + inv_d * (b - self.apply(v))
            return jnp.where(color, vn, v)

        v = u
        for _ in range(sweeps):
            v = half(v, inter & ((gi + gj + gk) % 2 == 0))
            v = half(v, inter & ((gi + gj + gk) % 2 == 1))
        return v

    # -- cycle transfer protocol (cycles/__init__.py dispatches on these) --
    def restrict_into(self, r, fine_op):
        out = r
        for ax in self.from_axes:
            a = _AXN[ax]
            Sc_ax = self.grid_shape[a]
            out = _crop_pad_ax(
                _even_decimate_ax(_blur121_ax(out, a), a), a, Sc_ax)
        m = _box_mask3(out.shape, self.box)
        return jnp.where(m, out, jnp.zeros((), out.dtype))

    def prolong_add_into(self, u, ec, fine_op):
        out = ec
        for ax in self.from_axes:
            a = _AXN[ax]
            Sf_ax = fine_op.grid_shape[a]
            Sc_ax = out.shape[a]
            mm = min(Sc_ax, (Sf_ax + 1) // 2)
            e = jax.lax.slice_in_dim(out, 0, mm, axis=a)
            lo = jax.lax.slice_in_dim(e, 0, mm - 1, axis=a)
            hi = jax.lax.slice_in_dim(e, 1, mm, axis=a)
            pad = [(0, 0)] * e.ndim
            pad[a] = (0, 1)
            odd = jnp.pad((0.5 * (lo + hi)).astype(e.dtype), pad)
            out = _crop_pad_ax(_interleave_ax(e, odd, a), a, Sf_ax)
        m = _box_mask3(out.shape, fine_op.box)
        return u + jnp.where(m, out, jnp.zeros((), out.dtype))

    def dense_matrix(self) -> np.ndarray:
        """Host dense realization over the unknown box (f64) — the coarse
        direct factor and the tests' Galerkin oracle."""
        mz, my, mx = self.nz - 1, self.ny - 1, self.nx - 1
        m = mz * my * mx
        idx = np.arange(m).reshape(mz, my, mx)
        A = np.zeros((m, m))
        for dz in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    c = self.sten[dz + 1, dy + 1, dx + 1]
                    if c == 0.0:
                        continue
                    sl_r = (slice(max(0, -dz), mz - max(0, dz)),
                            slice(max(0, -dy), my - max(0, dy)),
                            slice(max(0, -dx), mx - max(0, dx)))
                    sl_c = (slice(max(0, dz), mz - max(0, -dz)),
                            slice(max(0, dy), my - max(0, -dy)),
                            slice(max(0, dx), mx - max(0, -dx)))
                    A[idx[sl_r].ravel(), idx[sl_c].ravel()] += c
        return A

    def __repr__(self):
        return (f"SemiConstOp3(n=({self.nz},{self.ny},{self.nx}), "
                f"S=({self.Sz},{self.Sy},{self.Sx}), "
                f"from_axes={self.from_axes})")


def semi_anisotropic_op3(n: int, eps_x: float, eps_y: float, eps_z: float,
                         ) -> SemiConstOp3:
    """Finest-level 7-point anisotropic stencil (square cells): diagonal
    ``2(eps_x + eps_y + eps_z)``, faces ``-eps_a``; RHS carries f h²."""
    sten = np.zeros((3, 3, 3))
    sten[1, 1, 1] = 2.0 * (eps_x + eps_y + eps_z)
    sten[1, 1, 0] = sten[1, 1, 2] = -eps_x
    sten[1, 0, 1] = sten[1, 2, 1] = -eps_y
    sten[0, 1, 1] = sten[2, 1, 1] = -eps_z
    return SemiConstOp3(sten, n, n, n, n + 1, n + 1, n + 1)


# ---------------------------------------------------------------------------
# One-axis Galerkin on constant stencils (closed form)
# ---------------------------------------------------------------------------

def semicoarsen_axis_stencil(sten: np.ndarray, ax: int) -> np.ndarray:
    """``R_a A P_a`` on a constant (3, 3, 3) stencil along stencil axis
    ``ax``: ``c(D) = sum_{a, m : |a + m - 2D| <= 1} Rw[a] s(m)
    Pw[a + m - 2D]`` per the 1D convolution identity (exact over the
    coarse interior; module docstring)."""
    out = np.zeros_like(sten)
    for D in (-1, 0, 1):
        acc = np.zeros((3, 3))
        for a in (-1, 0, 1):
            for mo in (-1, 0, 1):
                c = a + mo - 2 * D
                if abs(c) > 1:
                    continue
                acc = acc + (_W1D[a + 1] * _W1D[c + 1]
                             * np.take(sten, mo + 1, axis=ax))
        sl = [slice(None)] * 3
        sl[ax] = D + 1
        out[tuple(sl)] = acc
    return out


def galerkin_semicoarsen3(fine: SemiConstOp3,
                          axes: Tuple[str, ...]) -> SemiConstOp3:
    """Chain per-axis Galerkin coarsening; ``from_axes`` records the set."""
    sten = fine.sten
    nz, ny, nx = fine.nz, fine.ny, fine.nx
    Sz, Sy, Sx = fine.Sz, fine.Sy, fine.Sx
    for ax in axes:
        a = _AXN[ax]
        sten = semicoarsen_axis_stencil(sten, a)
        if ax == "z":
            nz //= 2
            Sz = nz + 1
        elif ax == "y":
            ny //= 2
            Sy = ny + 1
        else:
            nx //= 2
            Sx = nx + 1
    return SemiConstOp3(sten, nz, ny, nx, Sz, Sy, Sx, from_axes=tuple(axes))


# ---------------------------------------------------------------------------
# Hierarchy construction
# ---------------------------------------------------------------------------

def choose_coarsen_axes3(eps_x: float, eps_y: float, eps_z: float,
                         nx: int, ny: int, nz: int,
                         balance: float = 2.0) -> Tuple[str, ...]:
    """Coupling-balance rule (2D ``choose_coarsen_axes`` with three axes):
    coarsen every axis whose effective coupling ``eps_a n_a^2`` is within
    ``balance`` of the strongest mode-carrying axis."""
    coup = {}
    if nx > 2:
        coup["x"] = eps_x * nx ** 2
    if ny > 2:
        coup["y"] = eps_y * ny ** 2
    if nz > 2:
        coup["z"] = eps_z * nz ** 2
    if not coup:
        return ()
    cmax = max(coup.values())
    return tuple(a for a in ("z", "y", "x")
                 if a in coup and coup[a] * balance >= cmax)


def build_semicoarsened_hierarchy3(config: MultigridConfig, eps_x: float,
                                   eps_y: float, eps_z: float,
                                   balance: float = 2.0) -> Hierarchy:
    """Coupling-balanced semi-coarsened Galerkin hierarchy in 3D.

    Stops once the unknown count reaches the full-coarsening coarsest
    size ``(2**coarsest_level - 1)^3`` or no axis may coarsen; the
    coarsest (possibly anisotropic-shaped) level gets a dense direct
    inverse from the host assembly."""
    n = 2 ** config.finest_level
    target = (2 ** config.coarsest_level - 1) ** 3
    fine = semi_anisotropic_op3(n, eps_x, eps_y, eps_z)
    levels = [fine]
    nx = ny = nz = n
    while (nx - 1) * (ny - 1) * (nz - 1) > target:
        axes = choose_coarsen_axes3(eps_x, eps_y, eps_z, nx, ny, nz,
                                    balance)
        if not axes:
            break
        levels.append(galerkin_semicoarsen3(levels[-1], axes))
        nx, ny, nz = levels[-1].nx, levels[-1].ny, levels[-1].nz
    coarse_inv = None
    if config.coarse_solver == "direct":
        A = levels[-1].dense_matrix()
        coarse_inv = jnp.asarray(np.linalg.inv(A), jnp.float32)
    return Hierarchy(tuple(levels), coarse_inv)
