#!/usr/bin/env python
"""Mixed Dirichlet/Neumann boundary conditions.

Solve -lap(u) = 2x on the unit square with insulated (du/dn = 0) top,
bottom, and right walls and Dirichlet u = 0 on the left.  The Neumann
sides keep their boundary nodes as unknowns (problems/mixedbc.py: box
unknown sets + ghost-reflection rows).

Manufactured check: u(x, y) = x - x**3/3 solves -u_xx = 2x with
u(0, y) = 0 and u_x(1, y) = 0, independent of y, so with insulated top
and bottom it is the exact continuum solution.

The tolerance stays above the f32 residual floor: Neumann problems carry
an O(1) solution scale, flooring relative reductions near ~1e-3 at this
level; deeper tolerances need f64 or refined mode.
"""

import jax.numpy as jnp
import numpy as np

import tpu_multigrid as mg

LEVEL = 7
n = 2 ** LEVEL

config = mg.MultigridConfig(finest_level=LEVEL, coarsest_level=4)
result = mg.solve_poisson(
    LEVEL, config=config,
    forcing=lambda x, y: 2.0 * x,
    neumann=("top", "bottom", "right"),
    tol=2e-3,
)
u = np.asarray(mg.extract_solution(result.u, n))
h = np.asarray(result.res_history)
print(f"converged={bool(result.converged)} in {int(result.iterations)} "
      f"cycles; |r|: {h[0]:.3e} -> {h[int(result.iterations)]:.3e}")

x = np.linspace(0.0, 1.0, n + 1)
u_exact = x - x ** 3 / 3.0
err = np.abs(u[n // 2, :] - u_exact).max()
print(f"max |u - (x - x^3/3)| along the midline = {err:.2e} "
      f"(O(h^2) ~ {1.0 / n ** 2:.1e})")
