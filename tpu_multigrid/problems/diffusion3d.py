"""3D variable-coefficient diffusion: -div(a grad u) = f on the unit cube.

3D analogue of ``problems/diffusion.py`` (itself an extension beyond the
constant-coefficient-only reference): per-cell coefficients ``a(x,y,z)``
become 7-point flux stencils with four-cell edge transmissibilities
(``core.operators.diffusion_op3_host``).  Coarse operators re-discretize
from 2x2x2 cell-averaged coefficients (the pragmatic 3D choice — the
trilinear Galerkin product is a 27-point operator; for smooth or mildly
jumping coefficients re-discretization converges mesh-independently,
which the tests pin).  Setup runs entirely in host numpy and uploads
once (see DiffusionProblem).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes, \
    round_up
from ..core.operators import diffusion_op3_host
from .poisson3d import poisson3d_rhs


def cell_coefficients3(n: int, a: Union[float, Callable],
                       dtype=np.float64) -> np.ndarray:
    """(n, n, n) per-cell coefficients, evaluated at cell centers (host)."""
    if callable(a):
        h = 1.0 / n
        idx = (np.arange(n, dtype=np.float64) + 0.5) * h
        x = idx[None, None, :]
        y = idx[None, :, None]
        z = idx[:, None, None]
        return np.asarray(np.broadcast_to(a(x, y, z), (n, n, n)), dtype)
    return np.full((n, n, n), float(a), dtype)


def coarsen_cells3(cells: np.ndarray) -> np.ndarray:
    """2x2x2 arithmetic cell-average coarsening."""
    n = cells.shape[0]
    return cells.reshape(n // 2, 2, n // 2, 2, n // 2, 2).mean((1, 3, 5))


def _nodal_shift3(n: int, S: int, Sx: int, c, np_dt) -> np.ndarray:
    """(S, S, Sx) nodal ``c(x, y, z) * h^2`` values, zero outside the
    interior (host numpy)."""
    h = 1.0 / n
    if callable(c):
        idx = np.arange(max(S, Sx), dtype=np.float64) * h
        x = idx[None, None, :Sx]
        y = idx[None, :S, None]
        z = idx[:S, None, None]
        vals = np.asarray(np.broadcast_to(c(x, y, z), (S, S, Sx)),
                          np.float64)
    else:
        vals = np.full((S, S, Sx), float(c), np.float64)
    inter = np.zeros((S, S, Sx), bool)
    inter[1:n, 1:n, 1:n] = True
    return np.where(inter, vals * h * h, 0.0).astype(np_dt)


def _with_shift3(op, c, np_dt):
    """Fold a reaction term c(x,y,z)*u into a flux-stencil level: the
    nodal c*h^2 joins the diagonal and inv_diag is rebuilt.  A positive
    shift only strengthens the diagonal (see problems/helmholtz.py for
    the 2D discussion; this is NOT an indefinite-Helmholtz solver)."""
    from ..core.operators import VarStencilOp3D

    n, S, Sx = op.n, op.S, op.Sx
    c2 = _nodal_shift3(n, S, Sx, c, np_dt)
    tz, ty, tx = (np.asarray(op.tz), np.asarray(op.ty), np.asarray(op.tx))
    diag = (tx + np.roll(tx, 1, 2) + ty + np.roll(ty, 1, 1)
            + tz + np.roll(tz, 1, 0)).astype(np.float64) + c2
    if float(diag[1:n, 1:n, 1:n].min()) <= 0.0:
        raise ValueError("shift makes the 3D diagonal non-positive: the "
                         "operator leaves the positive-definite regime "
                         "this solver supports")
    inter = np.zeros((S, S, Sx), bool)
    inter[1:n, 1:n, 1:n] = True
    inv_diag = np.zeros((S, S, Sx), np.float64)
    inv_diag[inter] = 1.0 / diag[inter]
    return VarStencilOp3D(tz=tz, ty=ty, tx=tx,
                          inv_diag=inv_diag.astype(np_dt), n=n, S=S,
                          Sx=Sx, c2=c2, t_minus=getattr(op, "t_minus",
                                                        None))


def build_diffusion3d_hierarchy(config: MultigridConfig, a, *,
                                shift=0.0, align: int = 1,
                                min_pad_level: int = 99,
                                lane_align: int = 1) -> Hierarchy:
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    np_dt = np.dtype(jnp.dtype(config.dtype).name)
    cells = cell_coefficients3(2 ** config.finest_level, a)
    with_shift = callable(shift) or float(shift) != 0.0
    levels = []
    for (n, S) in sizes:
        Sx = round_up(n + 1, lane_align) if lane_align > 1 else S
        op = diffusion_op3_host(cells.astype(np_dt), n, S, Sx)
        if with_shift:
            # per-level re-discretized reaction term (each level's own
            # h^2 scaling), matching the 2D HelmholtzProblem semantics
            op = _with_shift3(op, shift, np_dt)
        levels.append(op)
        if n > 2 ** config.coarsest_level:
            cells = coarsen_cells3(cells)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class Diffusion3DProblem:
    """Front-door 3D diffusion problem: hierarchy + RHS assembly."""

    config: MultigridConfig
    coefficient: Union[float, Callable] = 1.0
    forcing: Union[float, Callable] = 6.0
    shift: Union[float, Callable] = 0.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1

    def __post_init__(self):
        hier = build_diffusion3d_hierarchy(
            self.config, self.coefficient, shift=self.shift,
            align=self.align, min_pad_level=self.min_pad_level,
            lane_align=self.lane_align)
        self.hierarchy: Hierarchy = jax.device_put(hier)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> jnp.ndarray:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson3d_rhs(op.n, op.grid_shape, self.forcing, dt)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
