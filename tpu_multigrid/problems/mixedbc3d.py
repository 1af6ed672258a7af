"""Mixed Dirichlet/Neumann boundary conditions for the 3D Poisson problem.

The 3D analogue of ``problems/mixedbc.py`` (extension beyond the strictly
2D, all-Dirichlet reference, ``Poissons_SYCL.cpp:188-198``): any subset of
the six cube faces may carry a (possibly inhomogeneous) Neumann condition
``du/dn = g``.

Formulation — the half-cell finite-volume identity.  The ghost-reflection
closure (``u(-h) = u(h) + 2 h g``) followed by the FEM half-cell row
scaling (×1/2 per Neumann face the node lies on, ×1/4 on Neumann edges,
×1/8 at triple-Neumann corners) is EXACTLY the finite-volume flux operator
whose face transmissibilities are scaled by the transverse half-cell
areas:

    t_axis(face) = prod over the two transverse axes q of
                   (1/2 if the face lies on axis q's Neumann boundary
                    plane, else 1)

with faces existing only between physical node pairs.  (1D check: the
scaled boundary row is ``u0 - u1 = (f h^2)/2 + h g`` with t(0→1) = 1 —
symmetric against the interior row's coupling.)  This fits
:class:`~tpu_multigrid.core.operators.VarStencilOp3D`'s symmetric
transmissibility storage directly, so the whole existing 3D jnp tier
(smoothers, residual, BiCGStab/PCG, eigensolver) serves mixed BCs with a
``box`` unknown set; A is SPD by construction (tested).

Coarse levels REDISCRETIZE the same FV operator (boxes nest: fine node 0
<-> coarse node 0; trilinear R A P in 3D would be a 27-point operator —
not worth an operator class: with exactly-adjoint box transfers the
rediscretized chebyshev(3,2) V-cycle factor measures 0.11/0.14/0.15 over
levels 3/4/5, essentially flat, for every tested face combination).

Transfers: the box-safe 3D pair (``ops3d.restrict_fw3(box=)`` /
``prolong3(box=)``): zero-FILL blur shifts (edge planes hold live values,
so the interior path's roll-wrap-onto-masked-cells invariant does not
apply) and top-even-plane-preserving decimation.  R = P^T/2 holds on
boxes to roundoff (tested) — an earlier decimation that dropped fine
plane ``n`` (harmless on Dirichlet interiors) broke adjointness on
hi-side Neumann boxes and sent the V-cycle factor drifting to 0.77.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, FrozenSet, Iterable, Union

import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from ..core import ops3d
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core.operators import VarStencilOp3D

SIDES3 = ("zlo", "zhi", "ylo", "yhi", "xlo", "xhi")   # axes 0, 1, 2


def _box_of3(n: int, neumann: FrozenSet[str]):
    return (0 if "zlo" in neumann else 1, n if "zhi" in neumann else n - 1,
            0 if "ylo" in neumann else 1, n if "yhi" in neumann else n - 1,
            0 if "xlo" in neumann else 1, n if "xhi" in neumann else n - 1)


def _axis_weights(n: int, size: int, lo: bool, hi: bool, dtype):
    """Per-index transverse weight along one axis: 1/2 on a Neumann
    boundary plane, 1 on physical indices, 0 outside 0..n."""
    w = np.zeros(size, dtype)
    w[: n + 1] = 1.0
    if lo:
        w[0] = 0.5
    if hi:
        w[n] = 0.5
    return w


def mixed_poisson_op3(n: int, S: int, Sx: int, neumann: Iterable[str],
                      dtype=np.float32) -> VarStencilOp3D:
    """Mixed-BC Laplacian as a half-face-weighted 7-point flux stencil
    (host numpy; uploads once when the hierarchy enters jit)."""
    neumann = frozenset(neumann)
    bad = neumann - set(SIDES3)
    if bad:
        raise ValueError(f"unknown sides {sorted(bad)}; valid: {SIDES3}")
    if neumann == set(SIDES3):
        raise ValueError("all-Neumann Poisson is singular; keep at least "
                         "one Dirichlet face")
    box = _box_of3(n, neumann)

    dt = np.dtype(dtype)
    wz = _axis_weights(n, S, "zlo" in neumann, "zhi" in neumann, dt)
    wy = _axis_weights(n, S, "ylo" in neumann, "yhi" in neumann, dt)
    wx = _axis_weights(n, Sx, "xlo" in neumann, "xhi" in neumann, dt)
    # Face-axis existence: faces (m -> m+1) for m in 0..n-1.
    ez = np.zeros(S, dt)
    ez[:n] = 1.0
    ey = np.zeros(S, dt)
    ey[:n] = 1.0
    ex = np.zeros(Sx, dt)
    ex[:n] = 1.0

    tz = ez[:, None, None] * wy[None, :, None] * wx[None, None, :]
    ty = wz[:, None, None] * ey[None, :, None] * wx[None, None, :]
    tx = wz[:, None, None] * wy[None, :, None] * ex[None, None, :]

    tzm = np.roll(tz, 1, 0)
    tym = np.roll(ty, 1, 1)
    txm = np.roll(tx, 1, 2)
    diag = tx + txm + ty + tym + tz + tzm

    i0, i1, j0, j1, k0, k1 = box
    iz = np.arange(S)
    ix = np.arange(Sx)
    m = ((iz >= i0) & (iz <= i1))[:, None, None] \
        & ((iz >= j0) & (iz <= j1))[None, :, None] \
        & ((ix >= k0) & (ix <= k1))[None, None, :]
    inv_diag = np.zeros((S, S, Sx), dt)
    inv_diag[m] = 1.0 / diag[m]
    return VarStencilOp3D(tz=tz.astype(dt), ty=ty.astype(dt),
                          tx=tx.astype(dt), inv_diag=inv_diag,
                          n=n, S=S, Sx=Sx,
                          t_minus=(tzm.astype(dt), tym.astype(dt),
                                   txm.astype(dt)),
                          box=box)


def node_weights3(n: int, S: int, Sx: int, neumann: FrozenSet[str],
                  dtype=np.float64) -> np.ndarray:
    """(S, S, Sx) row scaling: 1/2 per Neumann face the node sits on
    (the half-cell volume factor; applies to the RHS too)."""
    w = np.ones((S, S, Sx), dtype)
    if "zlo" in neumann:
        w[0] *= 0.5
    if "zhi" in neumann:
        w[n] *= 0.5
    if "ylo" in neumann:
        w[:, 0] *= 0.5
    if "yhi" in neumann:
        w[:, n] *= 0.5
    if "xlo" in neumann:
        w[:, :, 0] *= 0.5
    if "xhi" in neumann:
        w[:, :, n] *= 0.5
    return w


def build_mixed_hierarchy3(config: MultigridConfig,
                           neumann: Iterable[str], *, align: int = 1,
                           min_pad_level: int = 99,
                           lane_align: int = 1) -> Hierarchy:
    """Mixed-BC 3D hierarchy: the FV operator rediscretized per level
    (nested boxes — see the module docstring on Galerkin vs redisc).

    ``align``/``lane_align``: padded (S, S, Sx) level sizes; the box
    indices are padding-independent.
    """
    neumann = frozenset(neumann)
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    rup = lambda v, q: (v + q - 1) // q * q
    dt = np.dtype(jnp.dtype(config.dtype).name)
    levels = [mixed_poisson_op3(
        n, S, rup(n + 1, lane_align) if lane_align > 1 else S, neumann,
        dtype=dt) for (n, S) in sizes]
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class MixedBC3DPoissonProblem:
    """-lap(u) = forcing on the unit cube; u = 0 on Dirichlet faces,
    du/dn = neumann_value on the ``neumann`` faces."""

    config: MultigridConfig
    neumann: Iterable[str] = ()
    forcing: Union[float, Callable] = 6.0
    neumann_value: Union[float, Callable] = 0.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1

    def __post_init__(self):
        self.neumann = frozenset(self.neumann)
        self.hierarchy: Hierarchy = build_mixed_hierarchy3(
            self.config, self.neumann, align=self.align,
            min_pad_level=self.min_pad_level, lane_align=self.lane_align)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        from .poisson3d import node_coordinates3
        op = self.finest
        n, S, Sx = op.n, op.S, op.Sx
        dt = dtype if dtype is not None else self.config.dtype
        h = 1.0 / n
        if callable(self.forcing):
            x, y, z = node_coordinates3(n, (S, S, Sx), dt)
            vals = self.forcing(x, y, z).astype(dt) * (h * h)
        else:
            vals = jnp.full((S, S, Sx), float(self.forcing) * h * h, dt)
        # Inhomogeneous Neumann: + 2 h g per Neumann face the node is on.
        if callable(self.neumann_value) or float(self.neumann_value) != 0.0:
            x, y, z = node_coordinates3(n, (S, S, Sx), dt)
            g = (self.neumann_value(x, y, z).astype(dt)
                 if callable(self.neumann_value)
                 else jnp.full((S, S, Sx), float(self.neumann_value), dt))
            two_h_g = jnp.asarray(2.0 * h, dt) * g
            iz = jnp.arange(S)
            ix = jnp.arange(Sx)
            for side, axis, idx in (("zlo", 0, 0), ("zhi", 0, n),
                                    ("ylo", 1, 0), ("yhi", 1, n),
                                    ("xlo", 2, 0), ("xhi", 2, n)):
                if side not in self.neumann:
                    continue
                on = (ix if axis == 2 else iz) == idx
                shape = [1, 1, 1]
                shape[axis] = -1
                vals = vals + jnp.where(on.reshape(shape), two_h_g,
                                        jnp.zeros((), dt))
        w = jnp.asarray(node_weights3(n, S, Sx, self.neumann), dt)
        return ops3d.mask_box3(vals * w, self.finest.box)
