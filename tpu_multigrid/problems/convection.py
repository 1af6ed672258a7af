"""Convection-diffusion: -eps lap(u) + b . grad(u) = f (upwind FD).

Extension beyond the pure-Poisson reference (``Poissons_SYCL.cpp:119-123``):
a NONSYMMETRIC operator family.  The convection term is discretized with
first-order upwinding (donor-cell), which keeps the operator an M-matrix
at every mesh Peclet number — the textbook robust choice (central
differences turn oscillatory once ``|b| h / (2 eps) > 1``).

In the framework's h-independent scaling (stencil x h^2, RHS f * h^2) the
assembled stencil is

    eps * [[0,-1,0],[-1,4,-1],[0,-1,0]]
    + h * ( |bx| + |by| at center,
            -max(bx,0) W,  -max(-bx,0) E,
            -max(by,0) N,  -max(-by,0) S )       (N = smaller y = row i-1)

so convection scales with h relative to diffusion — exactly the mesh
Peclet ``|b| h / eps``.  Hierarchies are **re-discretized per level**
(each level gets the upwind stencil at its own h): Galerkin R A P with
the symmetric FW/bilinear pair degrades for strongly nonsymmetric
operators, while re-discretization keeps every coarse level an upwind
M-matrix (``hierarchy="galerkin"`` remains available for comparison).

Smoothing: damped point Jacobi remains convergent on M-matrices, but
red-black Gauss-Seidel (``smoother="rbgs"``) is the robust default at
high Peclet.  The operators are plain :class:`VarStencilOp`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from ..core import ops
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core.operators import VarStencilOp


def _field(v, n: int, S: int, dtype):
    """Sample a constant or callable v(x, y) at the (S, S) grid nodes."""
    if callable(v):
        h = 1.0 / n
        c = np.arange(S, dtype=np.float64) * h
        x = np.broadcast_to(c[None, :], (S, S))
        y = np.broadcast_to(c[:, None], (S, S))
        return np.asarray(v(x, y), np.float64)
    return np.full((S, S), float(v), np.float64)


def convection_diffusion_op(n: int, S: int, eps: float, bx, by,
                            dtype=np.float32) -> VarStencilOp:
    """Upwind 5-point stencil of -eps lap(u) + b . grad(u), h = 1/n.

    ``bx``/``by`` are constants or callables ``b(x, y)`` sampled at nodes
    (host numpy; uploaded once when the hierarchy enters jit).
    """
    h = 1.0 / n
    BX = _field(bx, n, S, dtype)
    BY = _field(by, n, S, dtype)
    bxp, bxm = np.maximum(BX, 0.0), np.maximum(-BX, 0.0)
    byp, bym = np.maximum(BY, 0.0), np.maximum(-BY, 0.0)

    coef = np.zeros((3, 3, S, S), np.float64)
    coef[1, 1] = 4.0 * eps + h * (bxp + bxm + byp + bym)
    coef[1, 0] = -eps - h * bxp          # west  (j-1): donor when bx > 0
    coef[1, 2] = -eps - h * bxm          # east  (j+1): donor when bx < 0
    coef[0, 1] = -eps - h * byp          # row i-1 (smaller y): by > 0 donor
    coef[2, 1] = -eps - h * bym          # row i+1 (larger y):  by < 0 donor

    i = np.arange(S)
    mrow = (i >= 1) & (i <= n - 1)
    m = mrow[:, None] & mrow[None, :]
    coef = np.where(m[None, None], coef, 0.0)
    diag = coef[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0)
    dt = np.dtype(jnp.dtype(dtype).name)
    return VarStencilOp(coef.astype(dt), inv_diag.astype(dt), n, S)


def build_convection_hierarchy(config: MultigridConfig, eps: float, bx, by,
                               *, method: str = "rediscretize",
                               align: int = 1,
                               min_pad_level: int = 99) -> Hierarchy:
    """Per-level hierarchy for the upwind operator.

    ``method="rediscretize"`` (default): every level is the upwind
    stencil at its own h — coarse operators stay M-matrices at any
    Peclet.  ``"galerkin"``: R A P with the symmetric transfer pair
    (adequate at low Peclet; kept as an independent oracle/option).
    """
    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    dt = np.dtype(jnp.dtype(config.dtype).name)
    if method == "rediscretize":
        levels = [convection_diffusion_op(n, S, eps, bx, by, dtype=dt)
                  for (n, S) in sizes]
    elif method == "galerkin":
        from ..core.operators import galerkin_coarsen_host
        levels = [convection_diffusion_op(sizes[0][0], sizes[0][1], eps,
                                          bx, by, dtype=dt)]
        for (_, Sc) in sizes[1:]:
            levels.append(galerkin_coarsen_host(levels[-1], Sc))
    else:
        raise ValueError(f'method must be "rediscretize" or "galerkin", '
                         f'got {method!r}')
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class ConvectionDiffusionProblem:
    """-eps lap(u) + b . grad(u) = forcing, homogeneous Dirichlet.

    ``smoother="rbgs"`` is the robust choice at high mesh Peclet; damped
    Jacobi/Chebyshev work at moderate Peclet.
    """

    config: MultigridConfig
    eps: float = 1.0
    bx: Union[float, Callable] = 0.0
    by: Union[float, Callable] = 0.0
    forcing: Union[float, Callable] = 4.0
    hierarchy_method: str = "rediscretize"
    align: int = 1
    min_pad_level: int = 99

    def __post_init__(self):
        import jax

        hier = build_convection_hierarchy(
            self.config, self.eps, self.bx, self.by,
            method=self.hierarchy_method, align=self.align,
            min_pad_level=self.min_pad_level)
        self.hierarchy: Hierarchy = jax.device_put(hier)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        op = self.finest
        dt = dtype if dtype is not None else self.config.dtype
        h2 = (1.0 / op.n) ** 2
        if callable(self.forcing):
            from ..core.grids import node_coordinates
            x, y = node_coordinates(op.n, op.S, dt)
            vals = self.forcing(x, y).astype(dt) * h2
        else:
            vals = jnp.full((op.S, op.S), float(self.forcing) * h2, dt)
        return ops.mask_interior(vals, op.n)
