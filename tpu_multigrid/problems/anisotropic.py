"""Anisotropic Poisson: -(eps_x u_xx + eps_y u_yy) = f.

Extension beyond the isotropic-only reference.  Point smoothers degrade as
the anisotropy grows (the smoothing factor tends to 1 for the weak-axis
modes); the robust configuration on the standard fully-coarsened hierarchy
is **zebra line relaxation along the strong axis** (``smoother="zebra_x"``
when eps_x >> eps_y; see core/lines.py) with Galerkin coarse operators.
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


def anisotropic_poisson_op(n: int, S: int, eps_x: float = 1.0,
                           eps_y: float = 1.0, angle: float = 0.0,
                           dtype=np.float32) -> VarStencilOp:
    """h-independent stencil of ``-div(K grad u)`` with the constant
    tensor ``K = R(angle) diag(eps_x, eps_y) R(angle)^T``.

    ``angle = 0``: the classical axis-aligned 5-point stencil (diagonal
    ``2(eps_x + eps_y)``, E/W ``-eps_x``, N/S ``-eps_y``).  ``angle != 0``
    adds the mixed derivative ``-2 K_xy u_xy`` via the centered 4-corner
    stencil — the classic ROTATED anisotropy test problem, which defeats
    both axis-aligned remedies at 45 degrees and is the standard
    robustness stressor for Galerkin coarsening + line smoothers.
    The RHS carries ``f * h^2`` as usual (host numpy arrays).
    """
    ct, st = np.cos(angle), np.sin(angle)
    a = eps_x * ct * ct + eps_y * st * st         # K_xx
    bb = eps_x * st * st + eps_y * ct * ct        # K_yy
    c = (eps_x - eps_y) * st * ct                 # K_xy
    coef = np.zeros((3, 3, S, S), dtype)
    coef[1, 1] = 2.0 * (a + bb)
    coef[1, 0] = -a
    coef[1, 2] = -a
    coef[0, 1] = -bb
    coef[2, 1] = -bb
    # -2c u_xy: centered cross stencil (+-c/2 on the four corners);
    # rows are the y index, so NE = (i+1, j+1).
    coef[2, 2] += -0.5 * c
    coef[0, 0] += -0.5 * c
    coef[2, 0] += +0.5 * c
    coef[0, 2] += +0.5 * c
    i = np.arange(S)
    mrow = (i >= 1) & (i <= n - 1)
    m = mrow[:, None] & mrow[None, :]
    coef = np.where(m[None, None], coef, np.zeros((), dtype))
    diag = coef[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0).astype(dtype)
    return VarStencilOp(coef, inv_diag, n, S)


def build_anisotropic_hierarchy(config: MultigridConfig, eps_x: float,
                                eps_y: float, angle: float = 0.0,
                                align: int = 1,
                                min_pad_level: int = 99) -> Hierarchy:
    """Galerkin hierarchy (R A P in closed form on the host).

    ``align``/``min_pad_level``: per-level padded sizes — padding is
    per-level independent and the Galerkin formula carries it
    transparently."""
    from ..core.operators import galerkin_coarsen_host

    sizes = level_sizes(config, align=align, min_pad_level=min_pad_level)
    dt = np.dtype(jnp.dtype(config.dtype).name)
    fine = anisotropic_poisson_op(sizes[0][0], sizes[0][1], eps_x, eps_y,
                                  angle=angle, dtype=dt)
    levels = [fine]
    for (_, S) in sizes[1:]:
        levels.append(galerkin_coarsen_host(levels[-1], S))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class AnisotropicPoissonProblem:
    """-(eps_x u_xx + eps_y u_yy) = forcing, homogeneous Dirichlet.

    Two robust configurations (the textbook anisotropy remedies):

    * ``coarsening="full"`` (default) with ``smoother="zebra_x"`` when
      eps_x >> eps_y (lines along x; ``"zebra_y"`` for the transpose) —
      line relaxation on the standard hierarchy;
    * ``coarsening="semi"`` with plain point smoothing — the hierarchy
      coarsens only the strongly coupled axis per level
      (core.semicoarsen), equilibrating to full coarsening as the
      coarsened axis's h grows.

    Point smoothers on ``"full"`` remain available for mild anisotropy.
    """

    config: MultigridConfig
    eps_x: float = 1.0
    eps_y: float = 1.0
    forcing: Union[float, Callable] = 4.0
    coarsening: str = "full"
    angle: float = 0.0
    # Level padding (only meaningful for coarsening="full").
    align: int = 1
    min_pad_level: int = 99

    def __post_init__(self):
        if self.coarsening == "semi":
            if self.angle != 0.0:
                raise ValueError(
                    "axis-aligned semi-coarsening does not treat ROTATED "
                    "anisotropy (the strong direction is off-grid); use "
                    'coarsening="full" with zebra line smoothing')
            from ..core.semicoarsen import build_semicoarsened_hierarchy
            self.hierarchy: Hierarchy = build_semicoarsened_hierarchy(
                self.config, self.eps_x, self.eps_y)
        elif self.coarsening == "full":
            self.hierarchy = build_anisotropic_hierarchy(
                self.config, self.eps_x, self.eps_y, angle=self.angle,
                align=self.align, min_pad_level=self.min_pad_level)
        else:
            raise ValueError(
                f'coarsening must be "full" or "semi", got '
                f'{self.coarsening!r}')

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        op = self.finest
        n, S = op.n, op.S
        dt = dtype if dtype is not None else self.config.dtype
        h2 = (1.0 / n) ** 2
        if callable(self.forcing):
            from ..core.grids import node_coordinates
            x, y = node_coordinates(n, S, dt)
            vals = self.forcing(x, y).astype(dt) * h2
        else:
            vals = jnp.full((S, S), float(self.forcing) * h2, dt)
        return ops.mask_interior(vals, n)
