"""Fourth-order compact (Mehrstellen) Poisson in 3D.

3D twin of :mod:`problems.poisson4`: the 19-point compact stencil

    (1/6) (24 u_0 - 2 sum_faces u - sum_edges u)
        = h^2 (f + h^2/12 lap f)  ~  h^2 B f,
    B f = f + (1/12)(sum_faces f - 6 f)

is O(h^4)-accurate for -lap(u) = f with smooth f, still compact (one
ring), so every transfer/masking invariant holds unchanged.  The
operator is h-independent in this framework's scaling — every level
re-discretizes to the same matrix-free stencil
(:class:`core.operators.Const19Op`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax.numpy as jnp

from ..config import MultigridConfig
from ..core import ops3d
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core.operators import Const19Op


def mehrstellen_rhs3(n: int, grid_shape, forcing: Union[float, Callable],
                     dtype=jnp.float32) -> jnp.ndarray:
    """RHS ``h^2 * B f`` with ``B = I + (faces - 6 I)/12``.

    Constant f: B f = f exactly (unit row sum), matching
    ``problems.poisson3d.poisson3d_rhs``.
    """
    h2 = (1.0 / n) ** 2
    Sz, Sy, Sx = grid_shape
    if callable(forcing):
        h = 1.0 / n
        idx = jnp.arange(max(Sz, Sy, Sx), dtype=dtype) * h
        x = idx[None, None, :Sx]
        y = idx[None, :Sy, None]
        z = idx[:Sz, None, None]
        f = jnp.broadcast_to(forcing(x, y, z), grid_shape).astype(dtype)
        faces = (jnp.roll(f, 1, -3) + jnp.roll(f, -1, -3)
                 + jnp.roll(f, 1, -2) + jnp.roll(f, -1, -2)
                 + jnp.roll(f, 1, -1) + jnp.roll(f, -1, -1))
        bf = f + (faces - 6.0 * f) / 12.0
        vals = bf.astype(dtype) * jnp.asarray(h2, dtype)
    else:
        vals = jnp.full(grid_shape, float(forcing) * h2, dtype)
    return ops3d.mask_interior3(vals, n)


def build_mehrstellen3_hierarchy(config: MultigridConfig, *,
                                 align: int = 1, min_pad_level: int = 99,
                                 lane_align: int = 1) -> Hierarchy:
    """Default cubic levels; ``align``/``lane_align`` pad them."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    rup = lambda v, q: (v + q - 1) // q * q
    levels = tuple(
        Const19Op(n, S, rup(n + 1, lane_align) if lane_align > 1 else S)
        for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class Poisson4_3DProblem:
    """-lap(u) = forcing on the unit cube at fourth order."""

    config: MultigridConfig
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1

    def __post_init__(self):
        self.hierarchy: Hierarchy = build_mehrstellen3_hierarchy(
            self.config, align=self.align,
            min_pad_level=self.min_pad_level, lane_align=self.lane_align)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        op = self.finest
        dt = dtype if dtype is not None else self.config.dtype
        return mehrstellen_rhs3(op.n, op.grid_shape, self.forcing, dt)
