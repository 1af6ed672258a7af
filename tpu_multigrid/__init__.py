"""tpu-multigrid: geometric multigrid for structured grids in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference SYCL/oneMKL solver ``nikhilTkur/Multigrid_Nikhil_C-`` (see
SURVEY.md): 2D Poisson / variable-coefficient diffusion on the unit square,
weighted-Jacobi and red-black Gauss-Seidel smoothers, V/W/F cycles and full
multigrid, full-weighting restriction and bilinear prolongation — matrix-free
over device-resident grids, with fused CUDA level-visit kernels for the
constant 2D stencil and 2D ``shard_map`` domain decomposition.
"""

from .api import (extract_solution, solve_anisotropic,
                  solve_anisotropic3d, solve_bratu,
                  solve_convection_diffusion,
                  solve_convection_diffusion3d, solve_diffusion,
                  solve_diffusion3d, solve_helmholtz,
                  solve_nonlinear_poisson, solve_poisson,
                  solve_poisson3d, solve_quasilinear_diffusion)
from .config import REFERENCE_CONFIG, MultigridConfig
from .core import (ConstStencilOp, Hierarchy, VarStencilOp,
                   build_galerkin_hierarchy, build_poisson_hierarchy, ops)
from .cycles import SolveResult, cycle, fmg, solve_fixed, solve_until_tol
from .cycles.fas import (fas_cycle, fas_solve_fixed, fas_solve_until_tol,
                         fmg_fas)
from .eigen import smallest_eigenpair
from .krylov import bicgstab_solve, pcg_solve
from .problems import (AnisotropicPoissonProblem,
                       ConvectionDiffusionProblem, Diffusion3DProblem,
                       DiffusionProblem, HelmholtzProblem,
                       MixedBCPoissonProblem, MixedBC3DPoissonProblem,
                       PeriodicPoissonProblem,
                       Poisson3DProblem, Poisson4Problem, PoissonProblem,
                       poisson3d_rhs, poisson_rhs)
from .topo import (EllOp, TopoHierarchy, TopoTransfer,
                   build_structured_topo_hierarchy, fmg_topo, solve_permuted,
                   solve_topo, vcycle_topo)

__version__ = "0.1.0"

__all__ = [
    "MultigridConfig", "REFERENCE_CONFIG",
    "solve_poisson", "solve_diffusion", "solve_poisson3d",
    "solve_helmholtz", "solve_anisotropic", "solve_anisotropic3d",
    "solve_convection_diffusion",
    "solve_convection_diffusion3d",
    "solve_bratu", "solve_nonlinear_poisson", "solve_quasilinear_diffusion",
    "fas_cycle", "fas_solve_fixed", "fas_solve_until_tol", "fmg_fas",
    "extract_solution",
    "SolveResult", "cycle", "fmg", "solve_fixed", "solve_until_tol",
    "pcg_solve", "bicgstab_solve", "smallest_eigenpair",
    "PoissonProblem", "DiffusionProblem", "poisson_rhs",
    "Poisson3DProblem", "poisson3d_rhs", "MixedBCPoissonProblem",
    "MixedBC3DPoissonProblem",
    "HelmholtzProblem", "Diffusion3DProblem", "solve_diffusion3d",
    "AnisotropicPoissonProblem", "ConvectionDiffusionProblem",
    "Poisson4Problem", "PeriodicPoissonProblem",
    "Hierarchy", "ConstStencilOp", "VarStencilOp",
    "build_poisson_hierarchy", "build_galerkin_hierarchy", "ops",
    "TopoHierarchy", "TopoTransfer", "EllOp",
    "build_structured_topo_hierarchy", "vcycle_topo", "fmg_topo",
    "solve_permuted",
    "solve_topo",
]
