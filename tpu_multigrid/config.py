"""Multigrid configuration.

The reference hard-codes every parameter as a compile-time global
(``Poissons_SYCL.cpp:17-22,119-123,127``; ``Multigrid_functions.cpp:43-48``),
so changing the problem means recompiling the C++.  Here the whole schedule is
a frozen dataclass that is *static with respect to jit*: the level hierarchy,
sweep counts and cycle shape are Python-level constants, so XLA compiles the
entire multigrid cycle once as a single fused program.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class MultigridConfig:
    """Static configuration for a multigrid solve.

    Mirrors (and generalizes) the reference's compile-time constants:

    * ``finest_level`` / ``coarsest_level``: grid hierarchy; level ``l`` has
      ``2**l`` cells per side on the unit square (reference:
      ``Poissons_SYCL.cpp:17-18`` uses 10 and 7).
    * ``nu1`` / ``nu2``: pre-/post-smoothing sweeps (reference ``mu1=mu2=10``,
      ``Poissons_SYCL.cpp:20-22``).
    * ``nu0``: V-cycles per FMG level.  The reference runs ``mu0+1 = 31``
      cycles due to its ``i<=mu0`` loop (``Poissons_SYCL.cpp:635,646``); here
      ``nu0`` is the literal count.
    * ``omega``: weighted-Jacobi damping (reference ``2.0/3.0``,
      ``Poissons_SYCL.cpp:127``; the WIP variant's ``4/5`` integer-division
      bug at ``Multigrid_functions.cpp:48`` is *not* reproduced).
    * ``coarse_solver``: ``"direct"`` = dense solve with a precomputed
      factor (the WIP variant's Eigen SparseLU intent,
      ``Multigrid_functions.cpp:63-72``); ``"smooth"`` = extra smoothing
      sweeps at the coarsest level (compiled reference behavior,
      ``Poissons_SYCL.cpp:583-587``).
    * ``fmg_rhs``: ``"restrict"`` restricts the fine RHS downward
      (``Poissons_SYCL.cpp:641``); ``"assemble"`` re-assembles the RHS per
      level (``Multigrid_functions.cpp:184``).  They differ at discretization
      order, so both are exposed.
    """

    finest_level: int = 10
    coarsest_level: int = 3
    nu1: int = 2
    nu2: int = 2
    nu0: int = 1
    omega: float = 2.0 / 3.0
    # "jacobi" | "rbgs" | "chebyshev" | "zebra_x" | "zebra_y" (line
    # relaxation along the strong-coupling axis — anisotropic operators)
    smoother: str = "jacobi"
    # Chebyshev smoothing interval lower bound on the D^-1 A spectrum
    # (upper bound is 2.0 for the 5-point stencil).  The smoother runs
    # Jacobi steps with the Chebyshev root reciprocals as per-step weights —
    # identical kernel cost to plain Jacobi, far better smoothing factor.
    cheb_lo: float = 0.4
    cycle: str = "V"                  # "V" | "W" | "F"
    coarse_solver: str = "direct"     # "direct" | "smooth"
    coarse_smooth_sweeps: int = 10
    fmg_rhs: str = "restrict"         # "restrict" | "assemble"
    # Transfer operators.  "fw" + "bilinear" are the textbook (and fused-
    # kernel) pair; "injection" + "p1" reproduce the reference's WIP library
    # semantics (Multigrid_functions.cpp:98-130).
    restriction: str = "fw"           # "fw" | "injection"
    prolongation: str = "bilinear"    # "bilinear" | "p1"
    dtype: Any = jnp.float32          # residual / correction / transfer dtype
    smooth_dtype: Optional[Any] = None  # e.g. jnp.bfloat16 for mixed precision
    # Fused CUDA level-visit kernels for the constant 2D stencil
    # (kernels/level2d.py); GPU only.
    use_kernels: bool = False
    # Distributed: mesh shape (my, mx) over which the grid is domain-
    # decomposed; None = single device.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Coarse levels whose per-shard extent would drop below this many cells
    # are gathered and computed replicated on every device.
    replicate_below: int = 3

    def __post_init__(self):
        if self.coarsest_level < 1:
            raise ValueError("coarsest_level must be >= 1 (3x3 grid)")
        if self.finest_level < self.coarsest_level:
            raise ValueError("finest_level must be >= coarsest_level")
        if self.smoother not in ("jacobi", "rbgs", "chebyshev",
                                 "zebra_x", "zebra_y"):
            raise ValueError(f"unknown smoother {self.smoother!r}")
        if not (0.0 < self.cheb_lo < 2.0):
            raise ValueError("cheb_lo must be in (0, 2)")
        if self.cycle not in ("V", "W", "F"):
            raise ValueError(f"unknown cycle {self.cycle!r}")
        if self.coarse_solver not in ("direct", "smooth"):
            raise ValueError(f"unknown coarse_solver {self.coarse_solver!r}")
        if self.fmg_rhs not in ("restrict", "assemble"):
            raise ValueError(f"unknown fmg_rhs {self.fmg_rhs!r}")
        if self.restriction not in ("fw", "injection"):
            raise ValueError(f"unknown restriction {self.restriction!r}")
        if self.prolongation not in ("bilinear", "p1"):
            raise ValueError(f"unknown prolongation {self.prolongation!r}")

    @property
    def num_levels(self) -> int:
        return self.finest_level - self.coarsest_level + 1

    @property
    def effective_smooth_dtype(self):
        return self.smooth_dtype if self.smooth_dtype is not None else self.dtype

    def level_cells(self, level: int) -> int:
        """Cells per side at hierarchy level `level` (grid is (n+1)^2 nodes)."""
        return 2 ** level


# Reference schedule: FMG with 31 V-cycles per level and (10,10) smoothing
# (Poissons_SYCL.cpp:17-22,635,646).
REFERENCE_CONFIG = MultigridConfig(
    finest_level=10,
    coarsest_level=7,
    nu1=10,
    nu2=10,
    nu0=31,
    omega=2.0 / 3.0,
    smoother="jacobi",
    coarse_solver="smooth",
    coarse_smooth_sweeps=10,
    fmg_rhs="restrict",
)
