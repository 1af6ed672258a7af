"""Nonlinear Poisson problems with pointwise nonlinearities (FAS tier).

Canonical member: the Bratu problem  −Δu − λ eᵘ = f  on the unit square
with homogeneous Dirichlet BCs — the standard nonlinear-multigrid test
problem (solutions exist for λ below the Frank-Kamenetskii critical value
λ* ≈ 6.81 on the unit square).  :class:`NonlinearPoissonProblem` takes an
arbitrary pointwise φ(u):  −Δu + φ(u) = f.

Capability surplus over the linear-only reference
(``Poissons_SYCL.cpp:119-123``); discretization follows the framework's
FEM scaling — the discrete system is  A u + h² φ(u) = h² f  with the
h-independent 5-point A, so every hierarchy level re-discretizes with its
own h (nested-P1 variational, as in ``grids.build_poisson_hierarchy``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax
import jax.numpy as jnp

from ..config import MultigridConfig
from ..core.grids import Hierarchy, level_sizes
from ..core.nonlinear import PointwiseNonlinearOp, dense_poisson_matrix
from ..core.operators import ConstStencilOp3D, poisson_op
from .poisson import poisson_rhs
from .poisson3d import poisson3d_rhs


def build_pointwise_hierarchy(config: MultigridConfig, phi: Callable,
                              dphi: Callable, *, align: int = 1,
                              min_pad_level: int = 99) -> Hierarchy:
    """Per-level ``PointwiseNonlinearOp`` stack over the constant stencil.

    The coarsest level carries the dense interior A for the exact-Jacobian
    Newton coarse solve (``coarse_solver="direct"``); with
    ``coarse_solver="smooth"`` FAS falls back to Jacobi–Newton sweeps
    there (reference-v1 coarsest behavior, ``Poissons_SYCL.cpp:583-587``).
    """
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    levels = []
    for idx, (n, S) in enumerate(sizes):
        a_dense = None
        if idx == len(sizes) - 1 and config.coarse_solver == "direct":
            a_dense = jnp.asarray(dense_poisson_matrix(n), config.dtype)
        levels.append(PointwiseNonlinearOp(poisson_op(n, S), phi, dphi,
                                           diag=4.0, a_dense=a_dense))
    return Hierarchy(tuple(levels), None)


def build_pointwise_hierarchy3(config: MultigridConfig, phi: Callable,
                               dphi: Callable, *, align: int = 1,
                               min_pad_level: int = 99,
                               lane_align: int = 1) -> Hierarchy:
    """3D per-level ``PointwiseNonlinearOp`` stack over the 7-point
    constant stencil (diag 6); same coarsest Newton treatment as 2D.

    Default layout: cubic (S, S, S) with S = n + 1; ``align`` and
    ``lane_align`` pad it like
    ``problems.poisson3d.build_poisson3d_hierarchy``."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    rup = lambda v, q: (v + q - 1) // q * q
    levels = []
    for idx, (n, S) in enumerate(sizes):
        a_dense = None
        if idx == len(sizes) - 1 and config.coarse_solver == "direct":
            a_dense = jnp.asarray(dense_poisson_matrix(n, ndim=3),
                                  config.dtype)
        Sx = rup(n + 1, lane_align) if lane_align > 1 else S
        levels.append(PointwiseNonlinearOp(ConstStencilOp3D(n, S, Sx), phi,
                                           dphi, diag=6.0,
                                           a_dense=a_dense))
    return Hierarchy(tuple(levels), None)


@dataclasses.dataclass
class NonlinearPoissonProblem:
    """−Δu + φ(u) = f on the unit square, homogeneous Dirichlet BCs."""

    config: MultigridConfig
    phi: Callable = None
    dphi: Callable = None
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99

    def __post_init__(self):
        if self.phi is None or self.dphi is None:
            raise ValueError("NonlinearPoissonProblem needs phi and dphi")
        self.hierarchy: Hierarchy = jax.device_put(build_pointwise_hierarchy(
            self.config, self.phi, self.dphi, align=self.align,
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


@dataclasses.dataclass
class NonlinearPoisson3DProblem:
    """−Δu + φ(u) = f on the unit cube, homogeneous Dirichlet BCs."""

    config: MultigridConfig
    phi: Callable = None
    dphi: Callable = None
    forcing: Union[float, Callable] = 6.0
    align: int = 1
    min_pad_level: int = 99
    lane_align: int = 1

    def __post_init__(self):
        if self.phi is None or self.dphi is None:
            raise ValueError("NonlinearPoisson3DProblem needs phi and dphi")
        self.hierarchy: Hierarchy = jax.device_put(
            build_pointwise_hierarchy3(self.config, self.phi, self.dphi,
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


def Bratu3DProblem(config: MultigridConfig, lam: float = 1.0,
                   forcing: Union[float, Callable] = 0.0, *,
                   align: int = 1, min_pad_level: int = 99,
                   lane_align: int = 1) -> NonlinearPoisson3DProblem:
    """3D Bratu −Δu − λ eᵘ = f (unit cube; λ* ≈ 9.9 for the cube)."""
    lam = float(lam)

    def phi(u):
        return -lam * jnp.exp(u)

    return NonlinearPoisson3DProblem(config, phi=phi, dphi=phi,
                                     forcing=forcing, align=align,
                                     min_pad_level=min_pad_level,
                                     lane_align=lane_align)


def BratuProblem(config: MultigridConfig, lam: float = 1.0,
                 forcing: Union[float, Callable] = 0.0, *, align: int = 1,
                 min_pad_level: int = 99) -> NonlinearPoissonProblem:
    """Bratu problem −Δu − λ eᵘ = f (φ(u) = −λ eᵘ).

    For f = 0 and λ < λ* ≈ 6.81 this is the classical Gelfand/Bratu
    equation; the Jacobi–Newton denominator 4 − λ h² eᵘ stays positive on
    the lower solution branch."""
    lam = float(lam)

    def phi(u):
        return -lam * jnp.exp(u)

    return NonlinearPoissonProblem(config, phi=phi, dphi=phi,
                                   forcing=forcing, align=align,
                                   min_pad_level=min_pad_level)
