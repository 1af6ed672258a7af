"""Quasilinear diffusion −∇·(a(u)∇u) = f on the unit square (FAS tier).

Default coefficient a(u) = 1 + γu² (a smooth, positive quasilinear model);
any traceable positive a(u) works.  Matrix-free flux discretization
(:class:`..core.nonlinear.QuasilinearFluxOp`): edge coefficients are
evaluated at solution midpoints on every application, so there are no
stored coefficient planes and no Galerkin setup — each FAS level
re-discretizes with its own h, exactly like the linear variable-coefficient
family re-assembles per level in the reference-v2 design
(``Multigrid_functions.cpp:16-26``), but with the "assembly" folded into
the operator application itself.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax
import jax.numpy as jnp

from ..config import MultigridConfig
from ..core.grids import Hierarchy, level_sizes
from ..core.nonlinear import QuasilinearFluxOp, QuasilinearFluxOp3
from .poisson import poisson_rhs
from .poisson3d import poisson3d_rhs


def build_quasilinear_hierarchy(config: MultigridConfig, a: Callable,
                                da: Callable, *, align: int = 1,
                                min_pad_level: int = 99) -> Hierarchy:
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = tuple(QuasilinearFluxOp(n, S, a, da) for n, S in sizes)
    return Hierarchy(levels, None)


def build_quasilinear_hierarchy3(config: MultigridConfig, a: Callable,
                                 da: Callable, *, align: int = 1,
                                 min_pad_level: int = 99,
                                 lane_align: int = 1) -> Hierarchy:
    """3D quasilinear flux stack; default cubic (S, S, S) = (n+1,)³
    levels, or padded (S, S, Sx) ones."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    rup = lambda v, q: (v + q - 1) // q * q
    levels = tuple(
        QuasilinearFluxOp3(n, S, a, da,
                           rup(n + 1, lane_align) if lane_align > 1 else S)
        for n, S in sizes)
    return Hierarchy(levels, None)


@dataclasses.dataclass
class QuasilinearDiffusion3DProblem:
    """−∇·(a(u)∇u) = f on the unit cube; default a = 1 + γu².

    3D twin of :class:`QuasilinearDiffusionProblem` (same Picard–Jacobi
    coarsest treatment; at coarsest_level=3 the grid is 9³)."""

    config: MultigridConfig
    gamma: float = 1.0
    a: Callable = None
    da: Callable = None
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1

    def __post_init__(self):
        if self.a is None:
            g = float(self.gamma)
            self.a = lambda u: 1.0 + g * u * u
            self.da = lambda u: 2.0 * g * u
        self.hierarchy: Hierarchy = jax.device_put(
            build_quasilinear_hierarchy3(self.config, self.a, self.da,
                                         align=self.align,
                                         min_pad_level=self.min_pad_level,
                                         lane_align=self.lane_align))

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> jnp.ndarray:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson3d_rhs(op.n, op.grid_shape, self.forcing, dt)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]


@dataclasses.dataclass
class QuasilinearDiffusionProblem:
    """−∇·(a(u)∇u) = f, homogeneous Dirichlet BCs; default a = 1 + γu².

    The coarsest FAS level is solved by Picard–Jacobi sweeps
    (``cfg.coarse_smooth_sweeps``; the operator has no constant dense form,
    so use a deep-enough ``coarse_smooth_sweeps`` or a small coarsest
    level — at the default 3 the grid is 9², where 40 sweeps reach the
    smoother's fixed point to f32 roundoff).
    """

    config: MultigridConfig
    gamma: float = 1.0
    a: Callable = None
    da: Callable = None
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99

    def __post_init__(self):
        if self.a is None:
            g = float(self.gamma)
            self.a = lambda u: 1.0 + g * u * u
            self.da = lambda u: 2.0 * g * u
        self.hierarchy: Hierarchy = jax.device_put(
            build_quasilinear_hierarchy(self.config, self.a, self.da,
                                        align=self.align,
                                        min_pad_level=self.min_pad_level))

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> jnp.ndarray:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
