"""3D Poisson problem on the unit cube, homogeneous Dirichlet BCs.

Dimensional extension beyond the strictly-2D reference
(``Poissons_SYCL.cpp:119-123``): -∇²u = f on (0,1)³ discretized with the
h-independent 7-point stencil and RHS ``f * h²`` (``core.ops3d``).  The same
cycle drivers (V/W/F, FMG, until-tol) orchestrate 3D hierarchies — transfers
dispatch on the operator's ``ndim``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax.numpy as jnp

from ..config import MultigridConfig
from ..core import ops3d
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core.operators import ConstStencilOp3D


def node_coordinates3(n: int, S, dtype=jnp.float32):
    """Node coordinates on a padded (Sz, Sy, Sx) grid (cubic if S is int)."""
    shape = ops3d._shape3(S)
    h = 1.0 / n

    def ax(sz):
        return jnp.arange(sz, dtype=dtype) * h

    x = jnp.broadcast_to(ax(shape[2])[None, None, :], shape)
    y = jnp.broadcast_to(ax(shape[1])[None, :, None], shape)
    z = jnp.broadcast_to(ax(shape[0])[:, None, None], shape)
    return x, y, z


def boundary_grid3(n: int, S, g: Union[float, Callable],
                   dtype=jnp.float32) -> jnp.ndarray:
    """Padded grid holding the Dirichlet values ``g`` on the six physical
    boundary faces (any axis index in {0, n}) and zeros elsewhere.

    3D twin of ``problems.poisson.boundary_grid`` for inhomogeneous
    Dirichlet lifting u = w + G, A w = b - A G.
    """
    shape = ops3d._shape3(S)
    if callable(g):
        x, y, z = node_coordinates3(n, S, dtype)
        vals = jnp.broadcast_to(g(x, y, z), shape).astype(dtype)
    else:
        vals = jnp.full(shape, float(g), dtype)

    def ax_masks(sz):
        i = jnp.arange(sz)
        return (i == 0) | (i == n), (i >= 0) & (i <= n)

    ez, rz = ax_masks(shape[0])
    ey, ry = ax_masks(shape[1])
    ex, rx = ax_masks(shape[2])
    in_rng = (rz[:, None, None] & ry[None, :, None] & rx[None, None, :])
    on_face = (ez[:, None, None] | ey[None, :, None] | ex[None, None, :])
    return jnp.where(in_rng & on_face, vals, jnp.zeros((), dtype))


def poisson3d_rhs(n: int, S, f: Union[float, Callable] = 6.0,
                  dtype=jnp.float32) -> jnp.ndarray:
    """Padded RHS grid: b = f(x, y, z) * h² on the interior.

    Default constant forcing 6.0 mirrors the 2D module's f = 4 (the
    reference's constant, ``Poissons_SYCL.cpp:121``, scaled to make the
    dimension-count the natural constant); ``f`` may also be a callable
    f(x, y, z) evaluated at the nodes (manufactured-solution tests).
    """
    shape = ops3d._shape3(S)
    h2 = (1.0 / n) ** 2
    if callable(f):
        x, y, z = node_coordinates3(n, shape, dtype)
        vals = f(x, y, z).astype(dtype) * h2
    else:
        vals = jnp.full(shape, float(f) * h2, dtype)
    return ops3d.mask_interior3(vals, n)


def build_poisson3d_hierarchy(config: MultigridConfig, *, align: int = 1,
                              min_pad_level: int = 0,
                              lane_align: int = 1) -> Hierarchy:
    """3D hierarchy; ``lane_align`` pads the minor (x) axis independently."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    rup = lambda v, q: (v + q - 1) // q * q
    levels = tuple(
        ConstStencilOp3D(n, S, rup(n + 1, lane_align) if lane_align > 1
                         else S)
        for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class Poisson3DProblem:
    """Front-door 3D problem object: hierarchy + per-level RHS assembly."""

    config: MultigridConfig
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1

    def __post_init__(self):
        self.hierarchy: Hierarchy = build_poisson3d_hierarchy(
            self.config, align=self.align,
            min_pad_level=self.min_pad_level, lane_align=self.lane_align)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> jnp.ndarray:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson3d_rhs(op.n, op.grid_shape, self.forcing, dt)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
