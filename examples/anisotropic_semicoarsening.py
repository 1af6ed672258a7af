"""Anisotropic Poisson: semi-coarsening vs line smoothing vs naive.

-(eps_x u_xx + u_yy) = f at eps_x = 100.  Three configurations:

1. full coarsening + point Chebyshev  — the naive setup; the two-grid
   factor degrades toward 1 as the anisotropy grows;
2. full coarsening + zebra lines      — remedy 1 (core/lines.py);
3. semi-coarsening + point Chebyshev  — remedy 2 (core/semicoarsen.py):
   only the strongly coupled axis coarsens, so plain point smoothing
   stays mesh-independent.

Run: python examples/anisotropic_semicoarsening.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from tpu_multigrid import MultigridConfig, solve_anisotropic

EPS_X, LEVEL = 100.0, 6


def run(label, coarsening, smoother):
    cfg = MultigridConfig(finest_level=LEVEL, coarsest_level=3,
                          smoother=smoother, nu1=3, nu2=2,
                          dtype=jnp.float64)
    res = solve_anisotropic(LEVEL, eps_x=EPS_X, eps_y=1.0,
                            coarsening=coarsening, config=cfg,
                            tol=1e-10, max_cycles=40)
    h = np.asarray(res.res_history)
    n = int(res.iterations)
    rho = (h[n] / h[0]) ** (1 / max(n, 1))
    print(f"{label:42s} cycles={n:3d}  rho/cycle={rho:.3f}  "
          f"converged={bool(res.converged)}")


if __name__ == "__main__":
    print(f"-(100 u_xx + u_yy) = 4 at {2**LEVEL + 1}^2, tol 1e-10\n")
    run("full coarsening + point Chebyshev", "full", "chebyshev")
    run("full coarsening + zebra_x lines", "full", "zebra_x")
    run("semi-coarsening + point Chebyshev", "semi", "chebyshev")
