"""Reaction-diffusion / shifted-Poisson problems: -lap(u) + c u = f.

Extension beyond the reference's pure Poisson model
(``Poissons_SYCL.cpp:119-123``): a zeroth-order reaction term ``c(x, y)
>= 0`` (or a mildly negative Helmholtz shift with ``c > -2 pi^2``, where
the operator stays positive definite).  In the framework's h-independent
FEM scaling the discrete operator is

    (4 + c(x) h^2) u_ij - sum(neighbors) = f h^2 ,

i.e. the Poisson stencil with the reaction folded into the diagonal —
each level re-discretizes with its own ``h`` (for constant ``c`` this
equals the Galerkin product up to O(h^2) mass lumping).  The problem is
expressed as a :class:`~tpu_multigrid.core.operators.VarStencilOp`
hierarchy, so the whole existing machinery applies unchanged: all
cycle/FMG/until-tol drivers, CG preconditioning, checkpointing.

A positive shift only strengthens the diagonal (the weighted-Jacobi /
Chebyshev smoothing factors improve), so multigrid convergence is at
least as fast as for Poisson; this is NOT an indefinite-Helmholtz solver
(large negative shifts need wave-ray/complex-shifted methods).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core.operators import VarStencilOp
from .poisson import poisson_rhs


def _node_shift_values(n: int, S: int, c, dtype) -> np.ndarray:
    """(S, S) nodal c(x, y) values in numpy (host-side setup)."""
    if callable(c):
        h = 1.0 / n
        idx = np.arange(S, dtype=np.float64) * h
        x = np.broadcast_to(idx[None, :], (S, S))
        y = np.broadcast_to(idx[:, None], (S, S))
        return np.asarray(c(x, y), dtype)
    return np.full((S, S), float(c), dtype)


def helmholtz_op_host(n: int, S: int, c, dtype=np.float32) -> VarStencilOp:
    """5-point shifted-Poisson operator with diag 4 + c h² (host numpy)."""
    vals = _node_shift_values(n, S, c, dtype)
    h2 = np.asarray(1.0 / n, np.float64) ** 2
    diag = (4.0 + vals.astype(np.float64) * h2).astype(dtype)
    if float(diag[1: n, 1: n].min()) <= 0.0:
        raise ValueError(
            "shift makes the diagonal non-positive (4 + c h^2 <= 0): the "
            "operator is far outside the positive-definite regime this "
            "solver supports")
    coef = np.zeros((3, 3, S, S), dtype)
    interior = np.zeros((S, S), bool)
    interior[1: n, 1: n] = True
    coef[1, 1][interior] = diag[interior]
    for di, dj in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        coef[di + 1, dj + 1][interior] = -1.0
    inv_diag = np.zeros((S, S), dtype)
    inv_diag[interior] = 1.0 / diag[interior]
    return VarStencilOp(coef, inv_diag, n, S)


def build_helmholtz_hierarchy(config: MultigridConfig, c, *, align: int = 1,
                              min_pad_level: int = 99) -> Hierarchy:
    """Re-discretized hierarchy: every level gets diag 4 + c h_l²."""
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    np_dt = np.dtype(jnp.dtype(config.dtype).name)
    levels = tuple(helmholtz_op_host(n, S, c, np_dt) for n, S in sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(levels, coarse_inv)


@dataclasses.dataclass
class HelmholtzProblem:
    """-lap(u) + c u = f on the unit square, homogeneous Dirichlet BCs."""

    config: MultigridConfig
    shift: Union[float, Callable] = 1.0
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99

    def __post_init__(self):
        hier = build_helmholtz_hierarchy(
            self.config, self.shift, align=self.align,
            min_pad_level=self.min_pad_level)
        self.hierarchy: Hierarchy = jax.device_put(hier)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> jnp.ndarray:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt)

    def rhs_all_levels(self, dtype=None):
        return [self.rhs(k, dtype) for k in range(self.hierarchy.num_levels)]
