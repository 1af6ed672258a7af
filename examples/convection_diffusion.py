"""Convection-diffusion: -eps lap(u) + b . grad(u) = f (nonsymmetric).

A recirculating wind b = (y - 1/2, 1/2 - x) at eps = 0.005 — mesh Peclet
~10 on the 129^2 grid, where central differences would oscillate.  Upwind
multigrid with red-black Gauss-Seidel smoothing converges
mesh-independently; MG-preconditioned BiCGStab wraps the same cycle for
extra robustness (CG would be invalid — the operator is nonsymmetric).

Run: python examples/convection_diffusion.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from tpu_multigrid import (ConvectionDiffusionProblem, MultigridConfig,
                           bicgstab_solve, solve_convection_diffusion)

LEVEL, EPS = 7, 0.005


def wind_x(x, y):
    return y - 0.5


def wind_y(x, y):
    return 0.5 - x


if __name__ == "__main__":
    cfg = MultigridConfig(finest_level=LEVEL, coarsest_level=3,
                          smoother="rbgs", nu1=2, nu2=2,
                          dtype=jnp.float64)

    # Recirculating (closed-streamline) winds are the classic hard case
    # for convection-dominated multigrid: the asymptotic factor degrades
    # to ~0.56 here, so plain cycles need ~40 of them for 1e-10 — while
    # MG-BiCGStab wraps the same cycle and needs ~10.
    res = solve_convection_diffusion(LEVEL, eps=EPS, bx=wind_x, by=wind_y,
                                     config=cfg, tol=1e-10, max_cycles=60)
    h = np.asarray(res.res_history)
    n = int(res.iterations)
    print(f"plain V-cycles:  {n} cycles, rho/cycle "
          f"{(h[n] / h[0]) ** (1 / max(n, 1)):.3f}, "
          f"converged={bool(res.converged)}")

    prob = ConvectionDiffusionProblem(cfg, eps=EPS, bx=wind_x, by=wind_y)
    kres = jax.jit(lambda hh, bb: bicgstab_solve(
        hh, cfg, bb, tol=1e-10, max_iters=40))(prob.hierarchy, prob.rhs())
    print(f"MG-BiCGStab:     {int(kres.iterations)} iterations, "
          f"converged={bool(kres.converged)}")
