"""Mixed Dirichlet/Neumann boundary conditions for the Poisson problem.

Extension beyond the reference, which hard-eliminates homogeneous Dirichlet
boundaries on all four sides (``Poissons_SYCL.cpp:188-198,224,263``).  Any
subset of the four sides may instead carry a (possibly inhomogeneous)
Neumann condition ``du/dn = g``:

* Neumann-side boundary nodes become unknowns — the operator's unknown set
  is a general inclusive **box** (``VarStencilOp.box``) instead of the
  Dirichlet interior ``1..n-1``.
* The boundary rows use the second-order ghost-reflection closure: the
  ghost value ``u(-h) = u(h) + 2 h g`` eliminates into a doubled inward
  coefficient and a ``2 h g`` RHS term — then the whole row (RHS included)
  is scaled by 1/2 per Neumann side the node lies on (1/4 at double-Neumann
  corners).  The scaling is the FEM half-cell normalization: without it the
  operator is non-symmetric (boundary->inward -2 vs inward->boundary -1),
  Galerkin coarsening loses variational consistency, and the measured
  V-cycle factor drifts with depth.  With it A is SPD and R A P-based
  convergence is mesh-independent (tests pin both).
* Transfers need no new operators: the conv-based full-weighting
  restriction's zero padding IS the adjoint of the truncated bilinear
  prolongation on boxes (``ops.restrict_fw(box=...)``), and the coarse
  unknown boxes nest (fine boundary node 0 <-> coarse boundary node 0).
* Coarse levels re-discretize the same mixed-BC stencil (for the
  constant-coefficient Laplacian this is the standard geometric-MG
  hierarchy; tests pin mesh-independent convergence and O(h^2) accuracy
  against manufactured solutions).

At least one side must stay Dirichlet (all-Neumann Poisson is singular).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, FrozenSet, Iterable, Optional, Union

import jax.numpy as jnp
import numpy as np

from ..config import MultigridConfig
from ..core import ops
from ..core.grids import Hierarchy, coarse_dense_inverse, level_sizes
from ..core.operators import VarStencilOp

SIDES = ("bottom", "top", "left", "right")   # i=0, i=n, j=0, j=n


def _box_of(n: int, neumann: FrozenSet[str]):
    i0 = 0 if "bottom" in neumann else 1
    i1 = n if "top" in neumann else n - 1
    j0 = 0 if "left" in neumann else 1
    j1 = n if "right" in neumann else n - 1
    return (i0, i1, j0, j1)


def mixed_poisson_op(n: int, S: int, neumann: Iterable[str],
                     dtype=np.float32) -> VarStencilOp:
    """Laplacian stencil with ghost-reflection Neumann closures (host numpy;
    the hierarchy uploads once when it enters jit)."""
    neumann = frozenset(neumann)
    bad = neumann - set(SIDES)
    if bad:
        raise ValueError(f"unknown sides {sorted(bad)}; valid: {SIDES}")
    if neumann == set(SIDES):
        raise ValueError("all-Neumann Poisson is singular; keep at least "
                         "one Dirichlet side")
    box = _box_of(n, neumann)
    i0, i1, j0, j1 = box

    coef = np.zeros((3, 3, S, S), dtype)
    coef[1, 1] = 4.0
    coef[0, 1] = -1.0   # north  (i-1)
    coef[2, 1] = -1.0   # south  (i+1)
    coef[1, 0] = -1.0   # west   (j-1)
    coef[1, 2] = -1.0   # east   (j+1)
    # Ghost reflection: at a Neumann boundary row the outward neighbor
    # reflects onto the inward one (coefficient doubled, outward zeroed).
    if "bottom" in neumann:
        coef[2, 1, 0, :] = -2.0
        coef[0, 1, 0, :] = 0.0
    if "top" in neumann:
        coef[0, 1, n, :] = -2.0
        coef[2, 1, n, :] = 0.0
    if "left" in neumann:
        coef[1, 2, :, 0] = -2.0
        coef[1, 0, :, 0] = 0.0
    if "right" in neumann:
        coef[1, 0, :, n] = -2.0
        coef[1, 2, :, n] = 0.0

    # FEM half-cell row scaling: x1/2 per Neumann side the node lies on.
    w = _row_weights(n, S, neumann, dtype)
    coef = coef * w[None, None]

    i = np.arange(S)
    mi = (i >= i0) & (i <= i1)
    mj = (i >= j0) & (i <= j1)
    m = mi[:, None] & mj[None, :]
    coef = np.where(m[None, None], coef, np.zeros((), dtype))
    diag = coef[1, 1]
    inv_diag = np.where(m, 1.0 / np.where(m, diag, 1.0), 0.0).astype(dtype)
    return VarStencilOp(coef, inv_diag, n, S, box=box)


def _row_weights(n: int, S: int, neumann: FrozenSet[str], dtype=np.float64):
    """(S, S) row scaling: 0.5 per Neumann side the node sits on."""
    w = np.ones((S, S), dtype)
    if "bottom" in neumann:
        w[0, :] *= 0.5
    if "top" in neumann:
        w[n, :] *= 0.5
    if "left" in neumann:
        w[:, 0] *= 0.5
    if "right" in neumann:
        w[:, n] *= 0.5
    return w


def build_mixed_hierarchy(config: MultigridConfig,
                          neumann: Iterable[str],
                          coarsening: str = "galerkin",
                          align: int = 1,
                          min_pad_level: int = 99) -> Hierarchy:
    """Mixed-BC hierarchy (boxes nest: fine 2i <-> coarse i, so every level
    keeps the Neumann sides' boundary unknowns).

    ``coarsening="galerkin"`` (default) builds coarse operators as the true
    R A P via the box-aware closed-form host product — required for
    mesh-independent convergence: with ``"rediscretize"`` (same reflection
    stencil every level) the boundary rows are not variationally consistent
    and the measured V(2,2) factor drifts 0.29 -> 0.40 over levels 4 -> 6,
    while Galerkin holds it flat (test_mixedbc.py pins this).
    """
    from ..core.operators import galerkin_coarsen_host

    neumann = frozenset(neumann)
    sizes = level_sizes(config, align=align,
                        min_pad_level=min_pad_level)
    fine = mixed_poisson_op(sizes[0][0], sizes[0][1], neumann,
                            dtype=np.dtype(jnp.dtype(config.dtype).name))
    levels = [fine]
    for (n, S) in sizes[1:]:
        if coarsening == "galerkin":
            levels.append(galerkin_coarsen_host(levels[-1], S))
        else:
            levels.append(mixed_poisson_op(n, S, neumann,
                                           dtype=fine.coef.dtype))
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(levels[-1])
    return Hierarchy(tuple(levels), coarse_inv)


@dataclasses.dataclass
class MixedBCPoissonProblem:
    """-lap(u) = forcing, Dirichlet (u = 0) on some sides, Neumann
    (du/dn = neumann_value) on the rest."""

    config: MultigridConfig
    neumann: Iterable[str] = ()
    forcing: Union[float, Callable] = 4.0
    neumann_value: Union[float, Callable] = 0.0
    align: int = 1
    min_pad_level: int = 99

    def __post_init__(self):
        self.neumann = frozenset(self.neumann)
        self.hierarchy: Hierarchy = build_mixed_hierarchy(
            self.config, self.neumann, align=self.align,
            min_pad_level=self.min_pad_level)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, dtype=None) -> jnp.ndarray:
        op = self.finest
        dt = dtype if dtype is not None else self.config.dtype
        return mixed_rhs(op.n, op.S, self.neumann, self.forcing,
                         self.neumann_value, dt)


def mixed_rhs(n: int, S: int, neumann, forcing, neumann_value=0.0,
              dtype=jnp.float32) -> jnp.ndarray:
    """Global mixed-BC RHS on an (S, S) padded grid (standalone so the
    distributed tier can assemble it once and pass it via
    ``sharded_solve(b0=...)``)."""
    neumann = frozenset(neumann)
    dt = dtype
    h = 1.0 / n
    from ..core.grids import node_coordinates
    if callable(forcing):
        x, y = node_coordinates(n, S, dt)
        vals = forcing(x, y).astype(dt) * (h * h)
    else:
        vals = jnp.full((S, S), float(forcing) * h * h, dt)
    # Inhomogeneous Neumann: + 2 h g per Neumann side the node sits on.
    if callable(neumann_value) or float(neumann_value) != 0.0:
        x, y = node_coordinates(n, S, dt)
        g = (neumann_value(x, y).astype(dt) if callable(neumann_value)
             else jnp.full((S, S), float(neumann_value), dt))
        i = jnp.arange(S)
        two_h_g = jnp.asarray(2.0 * h, dt) * g
        for side, axis, idx in (("bottom", 0, 0), ("top", 0, n),
                                ("left", 1, 0), ("right", 1, n)):
            if side not in neumann:
                continue
            on = (i == idx)
            m = on[:, None] if axis == 0 else on[None, :]
            vals = vals + jnp.where(m, two_h_g, jnp.zeros((), dt))
    # The operator's FEM half-cell row scaling applies to the RHS too.
    w = jnp.asarray(_row_weights(n, S, neumann), dt)
    return ops.mask_box(vals * w, _box_of(n, neumann))
