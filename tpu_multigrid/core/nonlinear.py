"""Nonlinear level operators for the FAS (Full Approximation Scheme) tier.

The reference is strictly linear (constant-coefficient Poisson,
``Poissons_SYCL.cpp:119-123``); this module extends the framework to
nonlinear elliptic problems, solved by FAS multigrid (``cycles.fas``) —
the textbook nonlinear analogue of the reference's ``vcyclemultigrid``
(``Poissons_SYCL.cpp:575-627``).

Two operator families, both matrix-free and jit-transparent pytrees like
the linear ops in :mod:`.operators`:

* :class:`PointwiseNonlinearOp` — N(u) = A u + h² φ(u) with A a linear
  stencil operator and φ a *pointwise* nonlinearity (Bratu's −λ eᵘ,
  cubic reactions λu³, …).  The Jacobian is A + h² diag(φ′(u)), so
  Jacobi–Newton smoothing costs one extra pointwise evaluation per sweep
  and the coarsest level admits an exact in-jit Newton solve with a
  precomputed dense A.

* :class:`QuasilinearFluxOp` — N(u) = Σ_edges a(ū_e)(u − u_nbr) for a
  solution-dependent diffusion coefficient a(u) (e.g. 1 + γu²), the
  h-independent FEM flux form of −∇·(a(u)∇u).  Edge coefficients are
  recomputed from the current iterate on every application (matrix-free:
  zero stored planes, purely bandwidth-bound like ``ConstStencilOp``);
  smoothing is Picard–Jacobi with the frozen-coefficient diagonal.

Everything here obeys the framework's grid invariants (CLAUDE.md):
(S, S) padded node arrays, unknowns ``1..n-1``, zero outside, inline iota
masks, FEM scaling (h-independent stencil, RHS f·h²).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import ops


def dense_poisson_matrix(n: int, ndim: int = 2) -> np.ndarray:
    """Dense (m, m) interior matrix of the h-independent 2·ndim+1-point
    stencil (diag 2·ndim, off −1), m = (n−1)^ndim, row-major interior
    ordering.

    Closed-form numpy assembly (no device probing), mirroring the 3D
    branch of :func:`..core.grids.coarse_dense_inverse`.  Used for the
    coarsest-level Newton solve in FAS.
    """
    m1 = n - 1
    m = m1 ** ndim
    idx = np.arange(m).reshape((m1,) * ndim)
    a = np.zeros((m, m))
    a[np.arange(m), np.arange(m)] = 2.0 * ndim
    for ax in range(ndim):
        lo = [slice(None)] * ndim
        hi = [slice(None)] * ndim
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        rows = idx[tuple(lo)].ravel()
        cols = idx[tuple(hi)].ravel()
        a[rows, cols] -= 1.0
        a[cols, rows] -= 1.0
    return a


@jax.tree_util.register_pytree_node_class
class PointwiseNonlinearOp:
    """N(u) = A u + h² φ(u) on the interior of an (S, S) padded grid.

    ``lin`` is any linear stencil operator with ``apply``/``S``/``n``
    (normally :class:`..core.operators.ConstStencilOp`); ``phi``/``dphi``
    are traceable pointwise callables.  ``diag`` is the linear operator's
    diagonal (scalar for the constant stencil).  ``a_dense`` (coarsest
    level only) enables the exact Newton coarse solve.
    """

    def __init__(self, lin, phi: Callable, dphi: Callable,
                 diag: float = 4.0, a_dense: Optional[jnp.ndarray] = None):
        self.lin = lin
        self.phi = phi
        self.dphi = dphi
        self.diag = float(diag)
        self.a_dense = a_dense

    # -- pytree protocol: lin + a_dense are children; callables static --
    def tree_flatten(self):
        return (self.lin, self.a_dense), (self.phi, self.dphi, self.diag)

    @classmethod
    def tree_unflatten(cls, aux, children):
        lin, a_dense = children
        phi, dphi, diag = aux
        return cls(lin, phi, dphi, diag, a_dense)

    @property
    def n(self) -> int:
        return self.lin.n

    @property
    def S(self) -> int:
        return self.lin.S

    @property
    def ndim(self) -> int:
        return getattr(self.lin, "ndim", 2)

    @property
    def grid_shape(self):
        return getattr(self.lin, "grid_shape", (self.lin.S, self.lin.S))

    @property
    def h2(self) -> float:
        return (1.0 / self.lin.n) ** 2

    def _mask(self, x):
        if self.ndim == 3:
            from . import ops3d
            return ops3d.mask_interior3(x, self.n)
        return ops.mask_interior(x, self.n)

    # -- nonlinear operator interface --
    def apply(self, u):
        nl = jnp.asarray(self.h2, u.dtype) * self.phi(u).astype(u.dtype)
        return self.lin.apply(u) + self._mask(nl)

    def residual(self, u, b):
        return b - self.apply(u)

    def nsmooth(self, u, b, *, omega: float, sweeps: int):
        """Jacobi–Newton relaxation: one pointwise Newton update per node,
        damped by ``omega`` — the nonlinear analogue of weighted Jacobi
        (the reference's only smoother, ``Poissons_SYCL.cpp:125-173``)."""
        if sweeps <= 0:
            return u
        h2 = jnp.asarray(self.h2, u.dtype)
        om = jnp.asarray(omega, u.dtype)

        def body(_, v):
            # dphi is phi (Bratu): one transcendental per sweep, not two
            # (same expression/rounding order as residual()/apply()).
            pv = self.phi(v).astype(v.dtype)
            dv = pv if self.dphi is self.phi \
                else self.dphi(v).astype(v.dtype)
            r = b - (self.lin.apply(v) + self._mask(h2 * pv))
            denom = self.diag + h2 * dv
            upd = om * r / denom
            return v + self._mask(upd)

        return jax.lax.fori_loop(0, sweeps, body, u)

    def coarse_newton(self, u, b, steps: int = 3):
        """Exact-Jacobian Newton at the coarsest level: J = A + h²φ′(u) is
        dense-assembled in-jit from the precomputed interior A (tiny:
        (n−1)² unknowns) — the FAS stand-in for the linear tier's
        precomputed dense inverse (``grids.coarse_dense_inverse``)."""
        if self.a_dense is None:
            raise ValueError("coarse_newton needs a_dense (coarsest level)")
        n = self.n
        m1 = n - 1
        h2 = jnp.asarray(self.h2, u.dtype)
        A = self.a_dense.astype(u.dtype)
        inter = (slice(1, n),) * self.ndim
        eshape = (m1,) * self.ndim

        def body(_, v):
            rv = self.residual(v, b)[inter].reshape(-1)
            dd = (h2 * self.dphi(v).astype(v.dtype))[inter].reshape(-1)
            J = A + jnp.diag(dd)
            ev = jnp.linalg.solve(J, rv)
            return v.at[inter].add(ev.reshape(eshape))

        return jax.lax.fori_loop(0, steps, body, u)

    def __repr__(self):
        return f"PointwiseNonlinearOp(n={self.n}, S={self.S})"


def _shift(u, di, dj):
    """Wraparound shift: result[i, j] = u[i+di, j+dj] (pure jnp.roll —
    NO edge zeroing happens here).

    Safe ONLY for |d| = 1 under the padded-grid invariant (everything
    outside the physical region is zero, padding ≥ 1 ring) AND when the
    result is interior-masked: the wrapped edge then lands on padding
    whose value is zero / masked away.  Do not reuse for periodic grids
    or wider shifts — those need explicit edge handling."""
    return jnp.roll(u, (-di, -dj), (0, 1))


@jax.tree_util.register_pytree_node_class
class QuasilinearFluxOp:
    """Matrix-free quasilinear diffusion: N(u) = Σ_e a(ū_e)(u − u_nbr).

    ``a`` (and its derivative ``da``, used only for reporting) evaluate the
    diffusion coefficient at edge midpoints ū_e = (u_i + u_j)/2 — the
    standard second-order finite-volume/FEM flux discretization of
    −∇·(a(u)∇u) in the framework's h-independent scaling (RHS carries h²).

    Carries no array state: coefficients are recomputed from the iterate on
    every application, so the operator stays purely bandwidth-bound and the
    FAS coarse levels need no Galerkin setup — each level re-discretizes,
    which is variational for nested P1 up to O(h²) (same argument as
    ``grids.build_poisson_hierarchy``).
    """

    def __init__(self, n: int, S: int, a: Callable, da: Callable):
        self.n = int(n)
        self.S = int(S)
        self.a = a
        self.da = da

    def tree_flatten(self):
        return (), (self.n, self.S, self.a, self.da)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    @property
    def h2(self) -> float:
        return (1.0 / self.n) ** 2

    def _edge_fluxes(self, u):
        """Sum over the 4 edges of a(midpoint)·(u − u_nbr)."""
        half = jnp.asarray(0.5, u.dtype)
        out = jnp.zeros_like(u)
        for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            un = _shift(u, di, dj)
            ae = self.a(half * (u + un)).astype(u.dtype)
            out = out + ae * (u - un)
        return out

    def apply(self, u):
        return ops.mask_interior(self._edge_fluxes(u), self.n)

    def residual(self, u, b):
        return b - self.apply(u)

    def _frozen_diag(self, u):
        """Picard diagonal: Σ_e a(ū_e) with coefficients frozen at u."""
        half = jnp.asarray(0.5, u.dtype)
        d = jnp.zeros_like(u)
        for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            un = _shift(u, di, dj)
            d = d + self.a(half * (u + un)).astype(u.dtype)
        return d

    def nsmooth(self, u, b, *, omega: float, sweeps: int):
        """Picard–Jacobi: Jacobi step on the frozen-coefficient operator.

        Ignoring the da/du coupling keeps the sweep at two coefficient
        evaluations and is the standard smoother for quasilinear FAS
        (full Newton coupling adds nothing to the smoothing factor)."""
        if sweeps <= 0:
            return u
        om = jnp.asarray(omega, u.dtype)

        def body(_, v):
            r = self.residual(v, b)
            denom = self._frozen_diag(v)
            safe = jnp.where(denom > 0, denom, jnp.ones((), v.dtype))
            return v + ops.mask_interior(om * r / safe, self.n)

        return jax.lax.fori_loop(0, sweeps, body, u)

    def __repr__(self):
        return f"QuasilinearFluxOp(n={self.n}, S={self.S})"


def _shift3(u, d, ax):
    """3D wraparound shift: result[idx] = u[idx + d·e_ax] (pure roll; same
    |d| = 1 + zero-padding + interior-mask contract as :func:`_shift`)."""
    return jnp.roll(u, -d, ax)


_EDGES3 = tuple((d, ax) for ax in (0, 1, 2) for d in (1, -1))


@jax.tree_util.register_pytree_node_class
class QuasilinearFluxOp3:
    """3D matrix-free quasilinear diffusion: N(u) = Σ_e a(ū_e)(u − u_nbr).

    The unit-cube analogue of :class:`QuasilinearFluxOp` — six edge fluxes
    with coefficients at solution midpoints, h-independent FEM/FV scaling
    (RHS carries h²; see ``core.ops3d`` for the 3D normalization).  Cubic
    (S, S, S) grids (the FAS tier is jnp-only; see
    ``problems.bratu.build_pointwise_hierarchy3``).
    """

    ndim = 3

    def __init__(self, n: int, S: int, a: Callable, da: Callable,
                 Sx: int = None):
        self.n = int(n)
        self.S = int(S)
        self.a = a
        self.da = da
        # Optional minor-axis padding (same convention as
        # ConstStencilOp3D).
        self.Sx = int(Sx) if Sx is not None else int(S)

    def tree_flatten(self):
        return (), (self.n, self.S, self.a, self.da, self.Sx)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    @property
    def h2(self) -> float:
        return (1.0 / self.n) ** 2

    def _mask(self, x):
        from . import ops3d
        return ops3d.mask_interior3(x, self.n)

    def apply(self, u):
        half = jnp.asarray(0.5, u.dtype)
        out = jnp.zeros_like(u)
        for d, ax in _EDGES3:
            un = _shift3(u, d, ax)
            ae = self.a(half * (u + un)).astype(u.dtype)
            out = out + ae * (u - un)
        return self._mask(out)

    def residual(self, u, b):
        return b - self.apply(u)

    def _frozen_diag(self, u):
        half = jnp.asarray(0.5, u.dtype)
        d0 = jnp.zeros_like(u)
        for d, ax in _EDGES3:
            un = _shift3(u, d, ax)
            d0 = d0 + self.a(half * (u + un)).astype(u.dtype)
        return d0

    def nsmooth(self, u, b, *, omega: float, sweeps: int):
        """Picard–Jacobi (see :meth:`QuasilinearFluxOp.nsmooth`)."""
        if sweeps <= 0:
            return u
        om = jnp.asarray(omega, u.dtype)

        def body(_, v):
            r = self.residual(v, b)
            denom = self._frozen_diag(v)
            safe = jnp.where(denom > 0, denom, jnp.ones((), v.dtype))
            return v + self._mask(om * r / safe)

        return jax.lax.fori_loop(0, sweeps, body, u)

    def __repr__(self):
        return f"QuasilinearFluxOp3(n={self.n}, S={self.S})"


def inject_solution(u: jnp.ndarray, nf: int, Sc: int) -> jnp.ndarray:
    """Literal (unscaled) injection of a SOLUTION grid to the coarse level:
    coarse[i, j] = fine[2i, 2j], masked to the coarse interior.

    FAS restricts the *solution* as well as the residual; unlike
    ``ops.restrict_injection`` (scaled ×4 = R row sum, correct for
    residuals in FEM scaling), solution values transfer verbatim."""
    nc = nf // 2
    c = ops._even_decimate(ops._even_decimate(u, -2), -1)
    c = ops._crop_pad_square(c, Sc)
    return ops.mask_interior(c, nc)


def inject_solution3(u: jnp.ndarray, nf: int, Sc) -> jnp.ndarray:
    """3D literal solution injection: coarse[i,j,k] = fine[2i,2j,2k].

    Per-axis parity-reshape decimation (``ops3d`` module docstring); the
    lane axis routes through a transpose pair like ``ops3d._blur_decimate``."""
    from . import ops3d
    nc = nf // 2
    shc = ops3d._shape3(Sc)
    t = u
    for ax in (0, 1, 2):
        if ax == 2:
            tt = t.transpose(2, 0, 1)
            m = tt.shape[0] // 2
            out = tt[: 2 * m].reshape(m, 2, tt.shape[1], tt.shape[2])[:, 0]
            t = out.transpose(1, 2, 0)
        elif ax == 0:
            m = t.shape[0] // 2
            t = t[: 2 * m].reshape(m, 2, t.shape[1], t.shape[2])[:, 0]
        else:
            m = t.shape[1] // 2
            t = t[:, : 2 * m].reshape(t.shape[0], m, 2, t.shape[2])[:, :, 0]
    t = t[tuple(slice(0, min(t.shape[ax], shc[ax])) for ax in range(3))]
    pad = [(0, shc[ax] - t.shape[ax]) for ax in range(3)]
    if any(p != (0, 0) for p in pad):
        t = jnp.pad(t, pad)
    return ops3d.mask_interior3(t, nc)
