"""Level operators as jit-transparent pytrees.

Two operator families cover the framework's problem classes:

* :class:`ConstStencilOp` — the constant-coefficient FEM Poisson stencil
  (diagonal 4, off-diagonals -1).  Carries *no* array state: applying it
  reads only the solution/RHS grids, so the smoother is purely
  bandwidth-bound on u and b.  This replaces the reference's CSR matrix +
  oneMKL gemv per level (``Poissons_SYCL.cpp:24-52,138,604-605``).

* :class:`VarStencilOp` — a spatially varying 9-point stencil, stored as a
  ``(3, 3, S, S)`` coefficient array.  Used for variable-coefficient
  diffusion and for Galerkin coarse operators ``R A P`` (BASELINE config 4;
  the reference has no variable-coefficient support).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from . import ops


@jax.tree_util.register_pytree_node_class
class ConstStencilOp:
    """FEM-scaled 5-point Poisson operator on an (S, S) padded node grid."""

    def __init__(self, n: int, S: int):
        self.n = int(n)
        self.S = int(S)

    # -- pytree protocol (no leaves; n/S are static) --
    def tree_flatten(self):
        return (), (self.n, self.S)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    # -- operator interface --
    def apply(self, u):
        return ops.apply_poisson(u, self.n)

    def residual(self, u, b):
        return ops.residual(u, b, self.n)

    def smooth(self, u, b, *, smoother: str, omega: float, sweeps: int):
        if smoother == "jacobi":
            return ops.jacobi_sweeps(u, b, self.n, omega, sweeps)
        elif smoother == "rbgs":
            return ops.redblack_gs_sweeps(u, b, self.n, sweeps)
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"ConstStencilOp(n={self.n}, S={self.S})"


@jax.tree_util.register_pytree_node_class
class ConstStencilOp3D:
    """h-independent 7-point Poisson operator on an (S, S, S) padded grid.

    3D extension beyond the strictly-2D reference (``Poissons_SYCL.cpp:
    119-123``); see ``core.ops3d`` for the normalization and transfer pair.
    The cycle drivers dispatch transfers on ``ndim``.
    """

    ndim = 3

    def __init__(self, n: int, S: int, Sx: int = None):
        self.n = int(n)
        self.S = int(S)
        # The minor (x) axis may be padded apart from (z, y).
        self.Sx = int(Sx) if Sx is not None else int(S)

    def tree_flatten(self):
        return (), (self.n, self.S, self.Sx)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    def apply(self, u):
        from . import ops3d
        return ops3d.apply_poisson3(u, self.n)

    def residual(self, u, b):
        from . import ops3d
        return ops3d.residual3(u, b, self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        from . import ops3d
        if smoother == "jacobi":
            return ops3d.jacobi_sweeps3(u, b, self.n, omega, sweeps)
        elif smoother == "rbgs":
            return ops3d.redblack_gs_sweeps3(u, b, self.n, sweeps)
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"ConstStencilOp3D(n={self.n}, S={self.S}, Sx={self.Sx})"


@jax.tree_util.register_pytree_node_class
class Const19Op:
    """Matrix-free compact 19-point Mehrstellen operator in 3D (4th order).

    h-independent scaling: ``A = (1/6)(24 I - 2 faces - edges)``; the
    standard fourth-order compact discretization of ``-lap`` with the
    smoothed RHS ``h^2 (f + h^2/12 lap f)`` (problems/poisson4_3d.py).
    Like :class:`Const9Op`, carries no array state.
    """

    ndim = 3
    DIAG = 4.0  # 24 / 6

    def __init__(self, n: int, S: int, Sx: int = None):
        self.n = int(n)
        self.S = int(S)
        self.Sx = int(Sx) if Sx is not None else int(S)

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    def tree_flatten(self):
        return (), (self.n, self.S, self.Sx)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    @staticmethod
    def _off_sum(u):
        """(2 * faces + edges) / 6 — the negated off-diagonal part."""
        zp, zm = jnp.roll(u, -1, -3), jnp.roll(u, 1, -3)
        yp, ym = jnp.roll(u, -1, -2), jnp.roll(u, 1, -2)
        faces = (zp + zm + yp + ym
                 + jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1))
        edges = jnp.zeros_like(u)
        for a in (zp, zm):
            edges = edges + jnp.roll(a, 1, -2) + jnp.roll(a, -1, -2) \
                + jnp.roll(a, 1, -1) + jnp.roll(a, -1, -1)
        for a in (yp, ym):
            edges = edges + jnp.roll(a, 1, -1) + jnp.roll(a, -1, -1)
        return (2.0 * faces + edges) * (1.0 / 6.0)

    def _mask(self, u):
        from . import ops3d
        return ops3d.mask_interior3(u, self.n)

    def apply(self, u):
        return self._mask((self.DIAG * u - self._off_sum(u)).astype(u.dtype))

    def residual(self, u, b):
        return self._mask((b - self.DIAG * u
                           + self._off_sum(u)).astype(u.dtype))

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        from . import ops3d
        m = ops3d.interior_mask3(u.shape[-3:], self.n)
        inv_d = 1.0 / self.DIAG
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
            if len(ws) < sweeps:
                ws = tuple(ws[i % len(ws)] for i in range(sweeps))
            v = u
            for w in ws[:sweeps]:
                vn = (jnp.asarray(1.0 - w, u.dtype) * v
                      + jnp.asarray(w * inv_d, u.dtype)
                      * (b + self._off_sum(v)))
                v = jnp.where(m, vn, jnp.zeros((), u.dtype))
            return v
        elif smoother == "rbgs":
            shape = u.shape[-3:]
            i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
            j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
            k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
            par = (i + j + k) % 2
            # edges couple same-color nodes: damped block relaxation,
            # not exact GS (same caveat as Const9Op)
            v = u
            for _ in range(sweeps):
                for parity in (0, 1):
                    vn = jnp.asarray(inv_d, u.dtype) * (b + self._off_sum(v))
                    v = jnp.where(m & (par == parity),
                                  vn.astype(u.dtype), v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"Const19Op(n={self.n}, S={self.S}, Sx={self.Sx})"


def _shift(u, di, dj):
    """u[i+di, j+dj] with zero-invariant wrap (callers mask non-interior)."""
    out = u
    if di:
        out = jnp.roll(out, -di, axis=-2)
    if dj:
        out = jnp.roll(out, -dj, axis=-1)
    return out


@jax.tree_util.register_pytree_node_class
class Const9Op:
    """Matrix-free compact 9-point Mehrstellen operator (fourth order).

    h-independent scaling like :class:`ConstStencilOp`: stencil
    ``[[-1,-4,-1],[-4,20,-4],[-1,-4,-1]] / 6``, RHS carries
    ``h^2 * B f`` (problems/poisson4.py).  Carries no array state — the
    cross and diagonal neighbor sums are rolls, so smoothing stays
    bandwidth-bound on u and b.
    """

    DIAG = 20.0 / 6.0

    def __init__(self, n: int, S: int):
        self.n = int(n)
        self.S = int(S)

    def tree_flatten(self):
        return (), (self.n, self.S)

    @classmethod
    def tree_unflatten(cls, aux, _children):
        return cls(*aux)

    @staticmethod
    def _off_sum(u):
        """(4 * cross + diagonal) neighbor sum / 6 (the negated
        off-diagonal part of A)."""
        up = jnp.roll(u, 1, -2)
        dn = jnp.roll(u, -1, -2)
        cross = up + dn + jnp.roll(u, 1, -1) + jnp.roll(u, -1, -1)
        diag = (jnp.roll(up, 1, -1) + jnp.roll(up, -1, -1)
                + jnp.roll(dn, 1, -1) + jnp.roll(dn, -1, -1))
        return (4.0 * cross + diag) * (1.0 / 6.0)

    def apply(self, u):
        out = self.DIAG * u - self._off_sum(u)
        return ops.mask_interior(out.astype(u.dtype), self.n)

    def residual(self, u, b):
        r = b - self.DIAG * u + self._off_sum(u)
        return ops.mask_interior(r.astype(u.dtype), self.n)

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        m = ops.interior_mask(u.shape[-1], self.n)
        inv_d = 1.0 / self.DIAG
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
            if len(ws) < sweeps:
                ws = tuple(ws[i % len(ws)] for i in range(sweeps))
            v = u
            for w in ws[:sweeps]:
                vn = (jnp.asarray(1.0 - w, u.dtype) * v
                      + jnp.asarray(w * inv_d, u.dtype)
                      * (b + self._off_sum(v)))
                v = jnp.where(m, vn, jnp.zeros((), u.dtype))
            return v
        elif smoother == "rbgs":
            S = u.shape[-1]
            i = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
            j = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
            # NOTE: the 9-point stencil couples same-color diagonal
            # neighbors, so red-black is damped block relaxation here,
            # not exact GS — still a valid smoother.
            v = u
            for _ in range(sweeps):
                for parity in (0, 1):
                    vn = jnp.asarray(inv_d, u.dtype) * (b + self._off_sum(v))
                    upd = m & ((i + j) % 2 == parity)
                    v = jnp.where(upd, vn.astype(u.dtype), v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"Const9Op(n={self.n}, S={self.S})"


@jax.tree_util.register_pytree_node_class
class VarStencilOp:
    """Spatially varying 9-point stencil operator.

    ``coef[di+1, dj+1, i, j]`` multiplies ``u[i+di, j+dj]`` in ``(A u)[i, j]``.
    ``inv_diag`` is the precomputed reciprocal of ``coef[1, 1]`` on the
    interior (zero elsewhere).

    ``box``: optional inclusive unknown box (i0, i1, j0, j1) replacing the
    default Dirichlet interior ``(1, n-1, 1, n-1)`` — mixed Dirichlet/
    Neumann problems include Neumann-side boundary nodes as unknowns
    (problems/mixedbc.py).
    """

    def __init__(self, coef, inv_diag, n: int, S: int, box=None):
        self.coef = coef
        self.inv_diag = inv_diag
        self.n = int(n)
        self.S = int(S)
        self.box = tuple(int(v) for v in box) if box is not None else None

    def tree_flatten(self):
        return (self.coef, self.inv_diag), (self.n, self.S, self.box)

    @classmethod
    def tree_unflatten(cls, aux, children):
        n, S, box = aux
        return cls(children[0], children[1], n, S, box=box)

    def _mask(self, u):
        if self.box is not None:
            return ops.mask_box(u, self.box)
        return ops.mask_interior(u, self.n)

    def apply(self, u):
        acc = self.coef[1, 1] * u
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                acc = acc + self.coef[di + 1, dj + 1] * _shift(u, di, dj)
        return self._mask(acc.astype(u.dtype))

    def residual(self, u, b):
        return self._mask((b - self.apply(u)).astype(u.dtype))

    def smooth(self, u, b, *, smoother: str, omega: float, sweeps: int):
        if sweeps <= 0:
            return u
        if smoother == "jacobi":
            return self._jacobi(u, b, omega, sweeps)
        elif smoother == "rbgs":
            return self._rbgs(u, b, sweeps)
        elif smoother in ("zebra_x", "zebra_y"):
            # Line relaxation for anisotropic operators (core.lines): lines
            # along the strong-coupling axis, solved exactly by parallel
            # cyclic reduction; zebra (odd/even) ordering.
            from .lines import zebra_sweeps
            return zebra_sweeps(self, u, b, sweeps,
                                axis=1 if smoother == "zebra_x" else 0)
        raise ValueError(f"unknown smoother {smoother!r}")

    def _off_diag_apply(self, u):
        acc = jnp.zeros_like(u)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                acc = acc + self.coef[di + 1, dj + 1] * _shift(u, di, dj)
        return acc

    def _jacobi(self, u, b, omega, sweeps):
        m = (ops.box_mask(self.S, self.box) if self.box is not None
             else ops.interior_mask(self.S, self.n))
        inv_d = self.inv_diag.astype(u.dtype)

        if isinstance(omega, tuple):
            # Chebyshev schedule: per-sweep weights (core.ops.chebyshev_omegas)
            ws = omega
            if len(ws) < sweeps:
                ws = tuple(ws[i % len(ws)] for i in range(sweeps))
            v = u
            for w in ws[:sweeps]:
                vn = (jnp.asarray(1.0 - w, u.dtype) * v
                      + jnp.asarray(w, u.dtype) * inv_d
                      * (b - self._off_diag_apply(v)))
                v = jnp.where(m, vn, jnp.zeros((), u.dtype))
            return v

        w = jnp.asarray(omega, u.dtype)
        one_minus = jnp.asarray(1.0 - omega, u.dtype)

        def body(_, v):
            vn = one_minus * v + w * inv_d * (b - self._off_diag_apply(v))
            return jnp.where(m, vn, jnp.zeros((), u.dtype))

        return jax.lax.fori_loop(0, sweeps, body, u, unroll=min(sweeps, 4))

    def _rbgs(self, u, b, sweeps):
        S, n = self.S, self.n
        i = jax.lax.broadcasted_iota(jnp.int32, (S, S), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (S, S), 1)
        inter = (ops.box_mask(S, self.box) if self.box is not None
                 else (i >= 1) & (i <= n - 1) & (j >= 1) & (j <= n - 1))
        red = inter & ((i + j) % 2 == 0)
        black = inter & ((i + j) % 2 == 1)
        inv_d = self.inv_diag.astype(u.dtype)

        def half(v, color):
            vn = v + inv_d * (b - self.apply(v))
            return jnp.where(color, vn, v)

        def body(_, v):
            v = half(v, red)
            v = half(v, black)
            return v

        return jax.lax.fori_loop(0, sweeps, body, u, unroll=min(sweeps, 4))

    def __repr__(self):
        return f"VarStencilOp(n={self.n}, S={self.S})"


def poisson_op(n: int, S: int) -> ConstStencilOp:
    return ConstStencilOp(n, S)


def diffusion_op(cell_coeff: jnp.ndarray, n: int, S: int) -> VarStencilOp:
    """Variable-coefficient diffusion -div(a grad u) as a 5-point flux stencil.

    ``cell_coeff`` has shape (n, n): one coefficient per grid cell.  Face
    transmissibilities are arithmetic means of the two adjacent cells (in the
    FEM/h-independent scaling, so ``a == 1`` reduces exactly to the Poisson
    stencil).  Extension over the reference, which supports constant
    coefficients only (BASELINE config 4).
    """
    if cell_coeff.shape != (n, n):
        raise ValueError(f"cell_coeff must be ({n},{n}), got {cell_coeff.shape}")
    dt = cell_coeff.dtype
    # Pad cells into an (S+1, S+1)-independent frame: cell (i, j) spans nodes
    # (i..i+1, j..j+1).  Face coefficient between node (i,j) and (i,j+1)
    # (horizontal neighbor): mean of cells (i-1, j) and (i, j) — the two
    # cells sharing that edge; zero outside the domain.
    # Build node-indexed cell views: c[di,dj][i,j] = coeff of cell (i+di, j+dj)
    cpad = jnp.zeros((S + 2, S + 2), dt).at[1 : n + 1, 1 : n + 1].set(cell_coeff)
    c_mm = cpad[0:S, 0:S]      # cell (i-1, j-1)
    c_mp = cpad[0:S, 1 : S + 1]  # cell (i-1, j)
    c_pm = cpad[1 : S + 1, 0:S]  # cell (i, j-1)
    c_pp = cpad[1 : S + 1, 1 : S + 1]  # cell (i, j)

    # Face transmissibilities at node (i, j):
    t_e = 0.5 * (c_mp + c_pp)   # face to (i, j+1): cells (i-1,j) and (i,j)
    t_w = 0.5 * (c_mm + c_pm)   # face to (i, j-1)
    t_s = 0.5 * (c_pm + c_pp)   # face to (i+1, j): cells (i,j-1) and (i,j)
    t_n = 0.5 * (c_mm + c_mp)   # face to (i-1, j)

    coef = jnp.zeros((3, 3, S, S), dt)
    coef = coef.at[1, 2].set(-t_e)
    coef = coef.at[1, 0].set(-t_w)
    coef = coef.at[2, 1].set(-t_s)
    coef = coef.at[0, 1].set(-t_n)
    coef = coef.at[1, 1].set(t_e + t_w + t_s + t_n)

    m = ops.interior_mask(S, n)
    coef = jnp.where(m[None, None], coef, jnp.zeros((), dt))
    diag = coef[1, 1]
    inv_diag = jnp.where(m, 1.0 / jnp.where(m, diag, jnp.ones((), dt)), 0.0).astype(dt)
    return VarStencilOp(coef, inv_diag, n, S)


def diffusion_op_host(cell_coeff, n: int, S: int) -> VarStencilOp:
    """diffusion_op computed entirely in numpy on the host.

    Setup-path twin of :func:`diffusion_op`: identical math, but the
    coefficient planes never touch the device, so the Galerkin hierarchy
    (galerkin_coarsen_host) chains in host memory and uploads once when
    the hierarchy enters jit: no device->host readback of coefficient
    slabs during setup.
    """
    import numpy as np

    cells = np.asarray(cell_coeff)
    if cells.shape != (n, n):
        raise ValueError(f"cell_coeff must be ({n},{n}), got {cells.shape}")
    dt = cells.dtype
    cpad = np.zeros((S + 2, S + 2), dt)
    cpad[1: n + 1, 1: n + 1] = cells
    c_mm = cpad[0:S, 0:S]
    c_mp = cpad[0:S, 1: S + 1]
    c_pm = cpad[1: S + 1, 0:S]
    c_pp = cpad[1: S + 1, 1: S + 1]
    t_e = 0.5 * (c_mp + c_pp)
    t_w = 0.5 * (c_mm + c_pm)
    t_s = 0.5 * (c_pm + c_pp)
    t_n = 0.5 * (c_mm + c_mp)
    coef = np.zeros((3, 3, S, S), dt)
    coef[1, 2] = -t_e
    coef[1, 0] = -t_w
    coef[2, 1] = -t_s
    coef[0, 1] = -t_n
    coef[1, 1] = t_e + t_w + t_s + t_n
    i = np.arange(S)
    mrow = (i >= 1) & (i <= n - 1)
    m = mrow[:, None] & mrow[None, :]
    coef = np.where(m[None, None], coef, np.zeros((), dt))
    diag = coef[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, np.ones((), dt)),
                        0.0).astype(dt)
    # numpy arrays: jit converts/uploads them once at first call
    return VarStencilOp(coef, inv_diag, n, S)


def galerkin_coarsen_host(fine: VarStencilOp, Sc: int) -> VarStencilOp:
    """Coarse operator A_2h = R A_h P in closed form, on the host (numpy).

    For the fixed FW/bilinear pair, R A P is a *local* algebraic formula:

        A_2h(I, I+d) = sum_{a,b} Rw[a] * A(2I+a, 2I+a+b) * Pw[a+b-2d]

    with ``a, b, d`` in {-1,0,1}^2 and ``Rw = Pw`` the FEM-scaled
    full-weighting weights ([[1,2,1],[2,4,2],[1,2,1]]/4).  Terms whose fine
    column ``2I+a+b`` is a Dirichlet/padding node are dropped (the masked
    prolongation has zero rows there); A's own rows are already interior-
    masked.  Computed in f64 and cast back.

    This replaces the 9-comb device probing (``galerkin_coarsen``) on the
    setup path: identical results to fp roundoff (tested), but zero device
    compiles.  The probing version remains as an independent oracle.
    """
    import numpy as np

    nf = fine.n
    Sf = fine.S
    nc = nf // 2
    dt = fine.coef.dtype
    # Compute in the operator's own precision (promoted to >= f32): f64
    # fine operators get exact-to-roundoff f64 RAP (the oracle-parity
    # tests); f32 problems get f32 RAP — the same precision the device
    # probing had — at half the (single-core) memory traffic.
    work_dt = np.float64 if np.dtype(jnp.dtype(dt).name) == np.float64 \
        else np.float32
    A = np.asarray(fine.coef, work_dt)  # free when fine is host-built

    # Padded fine frame with margin 2: index (2 + g) holds fine node g,
    # g in [-2, 2*Sc+1] covers every sample 2I+a(+b) for I in [0, Sc).
    W = 2 * Sc + 4
    lim = min(Sf, W - 2)
    F = np.zeros((3, 3, W, W), work_dt)
    F[:, :, 2:2 + lim, 2:2 + lim] = A[:, :, :lim, :lim]
    # Unknown-set indicator (the prolongation's column mask): the default
    # Dirichlet interior, or the operator's box (mixed-BC problems —
    # Neumann-side boundary nodes are unknowns, problems/mixedbc.py).
    fbox = getattr(fine, "box", None)
    fi0, fi1, fj0, fj1 = fbox if fbox is not None else (1, nf - 1, 1, nf - 1)
    If = np.zeros((W, W), work_dt)
    g = np.arange(W) - 2
    mr = (g >= fi0) & (g <= fi1)
    mc = (g >= fj0) & (g <= fj1)
    If[np.ix_(mr, mc)] = 1.0

    Rw = np.array([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5],
                   [0.25, 0.5, 0.25]], work_dt)

    def samp(arr, ir, ic):
        return arr[..., 2 + ir: 2 + ir + 2 * Sc: 2,
                   2 + ic: 2 + ic + 2 * Sc: 2]

    C2 = np.zeros((3, 3, Sc, Sc), work_dt)
    offs = (-1, 0, 1)
    for ar in offs:
        for ac in offs:
            ra = Rw[ar + 1, ac + 1]
            for br in offs:
                for bc in offs:
                    term = (ra * samp(F[br + 1, bc + 1], ar, ac)
                            * samp(If, ar + br, ac + bc))
                    for dr in offs:
                        cr = ar + br - 2 * dr
                        if abs(cr) > 1:
                            continue
                        for dc in offs:
                            cc = ac + bc - 2 * dc
                            if abs(cc) > 1:
                                continue
                            C2[dr + 1, dc + 1] += Rw[cr + 1, cc + 1] * term

    # Coarse unknown box nests the fine one: fine node 2I <-> coarse I.
    cbox = None
    if fbox is not None:
        cbox = (fi0, nc if fi1 == nf else nc - 1,
                fj0, nc if fj1 == nf else nc - 1)
    ci0, ci1, cj0, cj1 = cbox if cbox is not None else (1, nc - 1, 1, nc - 1)
    i = np.arange(Sc)
    m = (((i >= ci0) & (i <= ci1))[:, None]
         & ((i >= cj0) & (i <= cj1))[None])
    C2 = np.where(m[None, None], C2, 0.0)
    diag = C2[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0)
    # Keep the arrays in HOST memory (numpy): chained coarsening then never
    # round-trips the device, and jit uploads the whole hierarchy once at
    # the first solve call.
    dt_np = np.dtype(jnp.dtype(dt).name) if not isinstance(dt, np.dtype) \
        else dt
    return VarStencilOp(C2.astype(dt_np), inv_diag.astype(dt_np), nc, Sc,
                        box=cbox)


@functools.partial(jax.jit, static_argnames=("Sc",))
def galerkin_coarsen(fine: VarStencilOp, Sc: int) -> VarStencilOp:
    """Coarse operator A_2h = R A_h P via the 9-comb probing trick.

    Applies ``R ∘ A ∘ P`` to nine coarse comb grids (ones on coarse nodes
    congruent to (p, q) mod 3) — each coarse node's 3x3 neighborhood contains
    exactly one comb node, so the nine responses separate all stencil
    entries exactly.  Runs once at setup, entirely on device (jitted: the
    nine probes compile into one program instead of ~30 eager dispatches).
    """
    nf, Sf = fine.n, fine.S
    nc = nf // 2
    dt = fine.coef.dtype

    i = jax.lax.broadcasted_iota(jnp.int32, (Sc, Sc), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (Sc, Sc), 1)

    responses = []
    for p in range(3):
        row = []
        for q in range(3):
            comb = ((i % 3 == p) & (j % 3 == q)).astype(dt)
            # Combs are NOT masked to the interior: stencil rows of interior
            # nodes adjacent to the boundary still probe boundary columns,
            # which the masked apply() zeroes anyway.
            y = ops.restrict_fw(fine.apply(ops.prolong(comb, nc, Sf)), nf,
                                Sc)
            row.append(y)
        responses.append(row)
    resp = jnp.stack([jnp.stack(r) for r in responses])  # (3, 3, Sc, Sc)

    coef = jnp.zeros((3, 3, Sc, Sc), dt)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            p = (i + di) % 3
            q = (j + dj) % 3
            # coef[di+1,dj+1][i,j] = resp[p,q][i,j] for that node's (p,q)
            val = jnp.zeros((Sc, Sc), dt)
            for pp in range(3):
                for qq in range(3):
                    val = jnp.where((p == pp) & (q == qq), resp[pp, qq], val)
            coef = coef.at[di + 1, dj + 1].set(val)

    m = ops.interior_mask(Sc, nc)
    coef = jnp.where(m[None, None], coef, jnp.zeros((), dt))
    diag = coef[1, 1]
    inv_diag = jnp.where(m, 1.0 / jnp.where(m, diag, jnp.ones((), dt)), 0.0).astype(dt)
    return VarStencilOp(coef, inv_diag, nc, Sc)


@jax.tree_util.register_pytree_node_class
class VarStencilOp3D:
    """Variable-coefficient 7-point flux-stencil operator in 3D.

    Stores the positive-direction edge transmissibilities ``tz``, ``ty``,
    ``tx`` as node-shaped (Sz, Sy, Sx) arrays — ``tx[i, j, k]`` couples
    node (i, j, k) to (i, j, k+1); the negative-direction coupling is the
    shifted array (zero-invariant wrap onto masked padding).  ``a == 1``
    reduces exactly to the 7-point Poisson stencil.  The cycle transfers
    dispatch on ``ndim``.
    """

    ndim = 3

    def __init__(self, tz, ty, tx, inv_diag, n: int, S: int, Sx: int,
                 c2=None, t_minus=None, box=None):
        self.tz = tz
        self.ty = ty
        self.tx = tx
        self.inv_diag = inv_diag
        self.n = int(n)
        self.S = int(S)
        self.Sx = int(Sx)
        # Optional zeroth-order (reaction/Helmholtz) term: nodal
        # c(x,y,z) * h^2, added to the diagonal (problems/diffusion3d.py
        # with shift=...).  inv_diag must be built WITH it.  The sharded
        # 3D path recomputes diagonals from the t planes and does not
        # carry c2 (its builders never set it).
        self.c2 = c2
        # Optional precomputed minus-direction planes (tz@z-1, ty@y-1,
        # tx@x-1): the -direction couplings otherwise re-roll the STATIC
        # planes on every smoother application (3 extra HBM passes +
        # roll compute per sweep).  Host builders set them.
        self.t_minus = tuple(t_minus) if t_minus is not None else None
        # Optional inclusive unknown box (i0, i1, j0, j1, k0, k1) replacing
        # the default Dirichlet interior (mixed Dirichlet/Neumann problems,
        # problems/mixedbc3d.py).
        self.box = tuple(int(v) for v in box) if box is not None else None

    def tree_flatten(self):
        return ((self.tz, self.ty, self.tx, self.inv_diag, self.c2,
                 self.t_minus),
                (self.n, self.S, self.Sx, self.box))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:4], *aux[:3], c2=children[4],
                   t_minus=children[5], box=aux[3])

    def _tm(self):
        if self.t_minus is not None:
            return self.t_minus
        return (jnp.roll(self.tz, 1, -3), jnp.roll(self.ty, 1, -2),
                jnp.roll(self.tx, 1, -1))

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    def _mask(self, u):
        from . import ops3d
        if self.box is not None:
            return ops3d.mask_box3(u, self.box)
        return ops3d.mask_interior3(u, self.n)

    def _unknown_mask(self, shape):
        from . import ops3d
        if self.box is not None:
            return ops3d.box_mask3(shape, self.box)
        return ops3d.interior_mask3(shape, self.n)

    def _diag(self, dtype):
        tzm, tym, txm = self._tm()
        d = (self.tx + txm + self.ty + tym + self.tz + tzm)
        if self.c2 is not None:
            d = d + self.c2
        return d.astype(dtype)

    def _off_diag_apply(self, u):
        # coupling to +dir uses t at this node; to -dir the shifted t
        # (precomputed at setup when t_minus is present)
        tzm, tym, txm = self._tm()
        acc = (self.tx * jnp.roll(u, -1, -1)
               + txm * jnp.roll(u, 1, -1)
               + self.ty * jnp.roll(u, -1, -2)
               + tym * jnp.roll(u, 1, -2)
               + self.tz * jnp.roll(u, -1, -3)
               + tzm * jnp.roll(u, 1, -3))
        return acc.astype(u.dtype)

    def apply(self, u):
        out = self._diag(u.dtype) * u - self._off_diag_apply(u)
        return self._mask(out.astype(u.dtype))

    def residual(self, u, b):
        return self._mask((b - self.apply(u)).astype(u.dtype))

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        m = self._unknown_mask(u.shape[-3:])
        inv_d = self.inv_diag.astype(u.dtype)
        if smoother == "jacobi":
            if isinstance(omega, tuple):
                ws = tuple(omega[i % len(omega)] for i in range(sweeps))
                v = u
                for w in ws:
                    vn = (jnp.asarray(1.0 - w, u.dtype) * v
                          + jnp.asarray(w, u.dtype) * inv_d
                          * (b + self._off_diag_apply(v)))
                    v = jnp.where(m, vn, jnp.zeros((), u.dtype))
                return v

            w = jnp.asarray(omega, u.dtype)
            om = jnp.asarray(1.0 - omega, u.dtype)

            def body(_, v):
                vn = om * v + w * inv_d * (b + self._off_diag_apply(v))
                return jnp.where(m, vn, jnp.zeros((), u.dtype))

            return jax.lax.fori_loop(0, sweeps, body, u,
                                     unroll=min(sweeps, 4))
        elif smoother == "rbgs":
            shape = u.shape[-3:]
            i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
            j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
            k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
            par = (i + j + k) % 2

            def half(v, color):
                vn = inv_d * (b + self._off_diag_apply(v))
                return jnp.where(m & color, vn.astype(v.dtype), v)

            def body(_, v):
                v = half(v, par == 0)
                return half(v, par == 1)

            return jax.lax.fori_loop(0, sweeps, body, u,
                                     unroll=min(sweeps, 4))
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return (f"VarStencilOp3D(n={self.n}, S={self.S}, Sx={self.Sx})")


def diffusion_op3_host(cell_coeff, n: int, S: int, Sx: int):
    """3D -div(a grad u) as a 7-point flux stencil, built in host numpy.

    ``cell_coeff`` has shape (n, n, n): one coefficient per cell.  The
    transmissibility of the edge from node (i,j,k) in the +x direction is
    the arithmetic mean of the FOUR cells sharing that edge (the 3D
    analogue of :func:`diffusion_op_host`'s two-cell mean); ``a == 1``
    reduces exactly to the 7-point Poisson stencil.  All arrays stay in
    host memory until the hierarchy enters jit (see diffusion_op_host).
    """
    import numpy as np

    cells = np.asarray(cell_coeff)
    if cells.shape != (n, n, n):
        raise ValueError(f"cell_coeff must be ({n},{n},{n}), got "
                         f"{cells.shape}")
    dt = cells.dtype
    shape = (S, S, Sx)
    cpad = np.zeros((S + 1, S + 1, Sx + 1), dt)
    cpad[1: n + 1, 1: n + 1, 1: n + 1] = cells

    def cview(di, dj, dk):
        return cpad[di: di + S, dj: dj + S, dk: dk + Sx]

    # Edge (i,j,k)->(i,j,k+1): cells (i-1..i, j-1..j, k) -> cview offsets
    # (0|1, 0|1, 1).  Analogously for y and z edges.
    tx = 0.25 * (cview(0, 0, 1) + cview(0, 1, 1)
                 + cview(1, 0, 1) + cview(1, 1, 1))
    ty = 0.25 * (cview(0, 1, 0) + cview(0, 1, 1)
                 + cview(1, 1, 0) + cview(1, 1, 1))
    tz = 0.25 * (cview(1, 0, 0) + cview(1, 0, 1)
                 + cview(1, 1, 0) + cview(1, 1, 1))

    def rollp(t, ax):
        return np.roll(t, 1, ax)

    tzm, tym, txm = rollp(tz, 0), rollp(ty, 1), rollp(tx, 2)
    diag = (tx + txm + ty + tym + tz + tzm)
    inter = np.zeros(shape, bool)
    inter[1: n, 1: n, 1: n] = True
    inv_diag = np.zeros(shape, dt)
    inv_diag[inter] = 1.0 / diag[inter]
    return VarStencilOp3D(tx=tx.astype(dt), ty=ty.astype(dt),
                          tz=tz.astype(dt), inv_diag=inv_diag,
                          n=n, S=S, Sx=Sx,
                          t_minus=(tzm.astype(dt), tym.astype(dt),
                                   txm.astype(dt)))
