#!/usr/bin/env python
"""3D end-to-end example: solve -lap(u) = 6 on the unit cube.

The 7-point hierarchy runs through the same drivers as 2D, on the plain
XLA path.  Runs on JAX's default device (GPU or CPU).
"""

import time

import jax
import numpy as np

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpu_multigrid as mg

LEVEL = 7  # 129^3

t0 = time.time()
# The f32 residual floor at level l is ~eps * n^2 relative;
# 3e-4 is comfortably reachable at level 7.
result = mg.solve_poisson3d(LEVEL, tol=3e-4, max_cycles=30)
jax.block_until_ready(result.u)
n = 2 ** LEVEL
u = np.asarray(mg.extract_solution(result.u, n))

iters = int(result.iterations)
hist = np.asarray(result.res_history)[: iters + 1]
status = "converged" if bool(result.converged) else (
    "stalled at the f32 residual floor" if result.stalled else "cycle budget")
print(f"grid {n + 1}^3, {status} in {iters} cycles "
      f"({time.time() - t0:.2f}s incl. compile)")
print(f"residual: {hist[0]:.3e} -> {hist[-1]:.3e} "
      f"({(hist[-1] / hist[0]) ** (1 / max(iters, 1)):.3f} per cycle)")
print(f"u center = {u[n // 2, n // 2, n // 2]:.6f} "
      f"(continuum value ~0.3372)")
