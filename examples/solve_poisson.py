#!/usr/bin/env python
"""Minimal end-to-end example: solve -lap(u) = 4 on the unit square.

Runs on JAX's default device: an NVIDIA GPU (with the fused CUDA level
visits) or the CPU (set JAX_PLATFORMS=cpu).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

import sys, os
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tpu_multigrid as mg

LEVEL = 10  # 1025 x 1025 — the reference's largest problem

on_gpu = jax.devices()[0].platform == "gpu"
cfg = mg.MultigridConfig(
    finest_level=LEVEL, coarsest_level=5,
    nu1=2, nu2=2, smoother="jacobi", omega=2.0 / 3.0,
    use_kernels=on_gpu)

t0 = time.time()
# f32 can resolve only ~2 decades of residual reduction at this grid size
# (FEM scaling: b ~ h^2) — until-tol stops at the stall.
result = mg.solve_poisson(LEVEL, config=cfg, tol=1e-2, max_cycles=40)
jax.block_until_ready(result.u)
n = 2 ** LEVEL
u = np.asarray(mg.extract_solution(result.u, n))

iters = int(result.iterations)
hist = np.asarray(result.res_history)[: iters + 1]
status = "converged" if bool(result.converged) else (
    "stalled at the f32 residual floor" if result.stalled else "cycle budget")
print(f"grid {n + 1}x{n + 1}, {status} "
      f"in {iters} V-cycles ({time.time() - t0:.2f}s incl. compile)")
print(f"residual: {hist[0]:.3e} -> {hist[-1]:.3e} "
      f"({(hist[-1] / hist[0]) ** (1 / max(iters, 1)):.3f} per cycle)")
print(f"u_max = {u.max():.6f} (continuum value for this problem: ~0.2947)")
