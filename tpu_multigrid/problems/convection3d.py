"""3D convection-diffusion: -eps lap(u) + b . grad(u) = f (upwind).

3D twin of :mod:`problems.convection`: first-order donor-cell upwinding
keeps the operator an M-matrix at any mesh Peclet.  Because the operator
is NONSYMMETRIC, the symmetric-transmissibility storage of
:class:`core.operators.VarStencilOp3D` (one plane per axis, minus
couplings derived by rolls) cannot represent it; this module's
:class:`Directional7Op` stores the six directional coupling magnitudes
explicitly.  In the h-independent scaling (stencil x h^2, RHS f * h^2):

    diag = 6 eps + h (|bx| + |by| + |bz|)
    coupling to the -axis neighbor = eps + h * max(b_axis, 0)  (donor)
    coupling to the +axis neighbor = eps + h * max(-b_axis, 0)

Hierarchies re-discretize per level (each level's own h — the same
choice as 2D: Galerkin with the symmetric transfer pair degrades for
strongly nonsymmetric operators).  rbgs is the robust smoother at high
Peclet.  All arrays are built host-side and uploaded once.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core import ops3d


def _field3(v, n: int, shape, dtype):
    S, Sy, Sx = shape
    if callable(v):
        h = 1.0 / n
        idx = np.arange(max(S, Sy, Sx), dtype=np.float64) * h
        x = idx[None, None, :Sx]
        y = idx[None, :Sy, None]
        z = idx[:S, None, None]
        return np.asarray(np.broadcast_to(v(x, y, z), (S, Sy, Sx)),
                          np.float64)
    return np.full((S, Sy, Sx), float(v), np.float64)


@jax.tree_util.register_pytree_node_class
class Directional7Op:
    """Nonsymmetric 7-point operator with explicit directional planes.

    ``cp[ax]`` couples node (i,j,k) to its +axis neighbor, ``cm[ax]`` to
    its -axis neighbor (ax 0 = z, 1 = y, 2 = x); ``diag``/``inv_diag``
    stored.  (A u)[p] = diag[p] u[p] - sum_ax (cp u_+ + cm u_-).
    """

    ndim = 3

    def __init__(self, cp, cm, diag, inv_diag, n: int, S: int, Sx: int):
        self.cp = tuple(cp)
        self.cm = tuple(cm)
        self.diag = diag
        self.inv_diag = inv_diag
        self.n = int(n)
        self.S = int(S)
        self.Sx = int(Sx)

    @property
    def grid_shape(self):
        return (self.S, self.S, self.Sx)

    def tree_flatten(self):
        return ((self.cp, self.cm, self.diag, self.inv_diag),
                (self.n, self.S, self.Sx))

    @classmethod
    def tree_unflatten(cls, aux, children):
        cp, cm, diag, inv_diag = children
        return cls(cp, cm, diag, inv_diag, *aux)

    def _mask(self, u):
        return ops3d.mask_interior3(u, self.n)

    def _off_diag_apply(self, u):
        acc = jnp.zeros_like(u)
        for ax in (0, 1, 2):
            a = ax - 3
            acc = acc + (self.cp[ax] * jnp.roll(u, -1, a)
                         + self.cm[ax] * jnp.roll(u, 1, a))
        return acc.astype(u.dtype)

    def apply(self, u):
        out = self.diag.astype(u.dtype) * u - self._off_diag_apply(u)
        return self._mask(out.astype(u.dtype))

    def residual(self, u, b):
        return self._mask((b - self.apply(u)).astype(u.dtype))

    def smooth(self, u, b, *, smoother: str, omega, sweeps: int):
        if sweeps <= 0:
            return u
        m = ops3d.interior_mask3(u.shape[-3:], self.n)
        inv_d = self.inv_diag.astype(u.dtype)
        if smoother == "jacobi":
            ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
            if len(ws) < sweeps:
                ws = tuple(ws[i % len(ws)] for i in range(sweeps))
            v = u
            for w in ws[:sweeps]:
                vn = (jnp.asarray(1.0 - w, u.dtype) * v
                      + jnp.asarray(w, u.dtype) * inv_d
                      * (b + self._off_diag_apply(v)))
                v = jnp.where(m, vn, jnp.zeros((), u.dtype))
            return v
        elif smoother == "rbgs":
            shape = u.shape[-3:]
            i = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
            j = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
            k = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
            par = (i + j + k) % 2
            v = u
            for _ in range(sweeps):
                for parity in (0, 1):
                    vn = inv_d * (b + self._off_diag_apply(v))
                    v = jnp.where(m & (par == parity),
                                  vn.astype(u.dtype), v)
            return v
        raise ValueError(f"unknown smoother {smoother!r}")

    def __repr__(self):
        return f"Directional7Op(n={self.n}, S={self.S}, Sx={self.Sx})"


def convection_diffusion_op3(n: int, S: int, Sx: int, eps: float,
                             bx, by, bz, dtype=np.float32) -> Directional7Op:
    """Upwind 7-point stencil of -eps lap(u) + b . grad(u), h = 1/n."""
    h = 1.0 / n
    shape = (S, S, Sx)
    winds = [_field3(v, n, shape, dtype) for v in (bz, by, bx)]  # z, y, x
    cp, cm = [], []
    absum = np.zeros(shape, np.float64)
    for B in winds:
        bp, bm = np.maximum(B, 0.0), np.maximum(-B, 0.0)
        cm.append(eps + h * bp)       # -axis neighbor: donor when b > 0
        cp.append(eps + h * bm)       # +axis neighbor: donor when b < 0
        absum += bp + bm
    diag = 6.0 * eps + h * absum

    inter = np.zeros(shape, bool)
    inter[1:n, 1:n, 1:n] = True
    dt = np.dtype(jnp.dtype(dtype).name)
    # Row-mask the couplings (apply() masks output anyway; masked planes
    # keep the dense oracle comparison exact).
    cp = [np.where(inter, c, 0.0).astype(dt) for c in cp]
    cm = [np.where(inter, c, 0.0).astype(dt) for c in cm]
    diag_m = np.where(inter, diag, 0.0).astype(dt)
    inv_diag = np.zeros(shape, np.float64)
    inv_diag[inter] = 1.0 / diag[inter]
    return Directional7Op(cp, cm, diag_m, inv_diag.astype(dt), n, S, Sx)


def build_convection3d_hierarchy(config: MultigridConfig, eps, bx, by, bz,
                                 *, align: int = 1, min_pad_level: int = 99,
                                 lane_align: int = 1) -> Hierarchy:
    """Per-level re-discretized upwind hierarchy (M-matrix at every h)."""
    from ..core.grids import round_up

    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    dt = np.dtype(jnp.dtype(config.dtype).name)
    levels = []
    for (n, S) in sizes:
        Sx = round_up(n + 1, lane_align) if lane_align > 1 else S
        levels.append(convection_diffusion_op3(n, S, Sx, eps, bx, by, bz,
                                               dtype=dt))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class ConvectionDiffusion3DProblem:
    """-eps lap(u) + b . grad(u) = forcing on the unit cube."""

    config: MultigridConfig
    eps: float = 1.0
    bx: Union[float, Callable] = 0.0
    by: Union[float, Callable] = 0.0
    bz: Union[float, Callable] = 0.0
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1

    def __post_init__(self):
        hier = build_convection3d_hierarchy(
            self.config, self.eps, self.bx, self.by, self.bz,
            align=self.align, min_pad_level=self.min_pad_level,
            lane_align=self.lane_align)
        self.hierarchy: Hierarchy = jax.device_put(hier)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        from .poisson3d import poisson3d_rhs
        op = self.finest
        dt = dtype if dtype is not None else self.config.dtype
        return poisson3d_rhs(op.n, op.grid_shape, self.forcing, dt)
