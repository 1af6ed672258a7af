"""Device mesh + sharding helpers for 2D spatial domain decomposition.

The reference is single-process/single-device (one SYCL ``queue``,
``Poissons_SYCL.cpp:659``; no MPI/NCCL anywhere — SURVEY.md §2.3).  Scaling
here is the accelerator-native analogue: the grid is sharded (y, x) over a
2D ``jax.sharding.Mesh``, and XLA inserts the neighbor halo exchanges
(NCCL collectives between GPUs).

Two distributed code paths exist:

* **auto (this module + plain jit)** — arrays carry a ``NamedSharding``;
  the stock jnp operators are jit-compiled and GSPMD partitions the stencils
  (shifted slices become halo exchanges).  Works for any grid size, including
  the odd (2^k + 1) node counts.
* **explicit (dist.shard_cycle)** — ``shard_map`` + ``jax.lax.ppermute``
  halo rings, for hand-controlled communication (BASELINE config 5).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

GRID_AXES = ("gy", "gx")


def _factor2(n: int) -> Tuple[int, int]:
    """Most-square factorization (a, b) with a*b = n, a <= b."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_grid_mesh(shape: Optional[Tuple[int, int]] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """2D device mesh with axes ("gy", "gx") for spatial decomposition
    (most-square factorization of the device count by default)."""
    devs = list(devices) if devices is not None else list(jax.devices())
    if shape is None:
        shape = _factor2(len(devs))
    my, mx = shape
    if my * mx != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    return Mesh(np.asarray(devs).reshape(my, mx), GRID_AXES)


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for an (S, S) grid array: rows over gy, cols over gx."""
    return NamedSharding(mesh, P("gy", "gx"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def place(x, mesh: Mesh):
    """Put a grid array on the mesh with (gy, gx) sharding."""
    return jax.device_put(x, grid_sharding(mesh))


def _shard_leaf(x, mesh: Mesh, grid_ndim: int = 2):
    """Grid-shard two spatial axes of a hierarchy leaf when they divide
    the mesh; replicate otherwise (tiny coarse levels, dense inverses).

    ``grid_ndim=2``: the trailing two axes (2D (S, S) grids and
    (C, S, S) coefficient slabs).  ``grid_ndim=3``: axes (-3, -2) —
    (Sz, Sy) of 3D (Sz, Sy, Sx) grids and (C, Sz, Sy, Sx) coefficient
    volumes; the lane-aligned Sx minor dim stays whole (matching the
    explicit 3D tier's P(gz, gy, None) layout)."""
    if not hasattr(x, "ndim") or x.ndim < grid_ndim:
        return jax.device_put(x, replicated(mesh))
    my, mx = mesh.devices.shape
    a0 = x.ndim - grid_ndim
    r, c = x.shape[a0], x.shape[a0 + 1]
    if r % my == 0 and c % mx == 0:
        spec = [None] * x.ndim
        spec[a0], spec[a0 + 1] = GRID_AXES
        return jax.device_put(x, NamedSharding(mesh, P(*spec)))
    return jax.device_put(x, replicated(mesh))


def gspmd_solve_hierarchy(hier, config, b, mesh: Mesh, *,
                          tol: float = 1e-6, max_cycles: int = 100,
                          num_cycles=None, u0=None, jit: bool = True,
                          grid_ndim=None, use_fmg: bool = False):
    """GSPMD-partition ANY stock-jnp hierarchy solve over a 2D mesh.

    The generic distribution vehicle for families whose level geometry
    does not fit the explicit shard_map tier (rectangular SEMI-COARSENED
    levels, whose per-level aspect ratios change as one axis coarsens
    ahead of the other; 19-point rotated 3D tensors; upwind 3D
    convection): arrays carry ``NamedSharding`` and XLA inserts the halo
    collectives for the plain jnp operators.  Leaves whose sharded axes
    don't divide the mesh stay replicated (coarse levels).
    ``grid_ndim`` (default: ``b.ndim``) picks which leaf axes shard —
    see :func:`_shard_leaf`.  ``use_fmg=True`` seeds the fixed/until-tol
    iteration with a distributed FMG pass (the jnp transfers partition
    like the cycle ops); an explicit ``u0`` takes precedence — when both
    are given the caller's ``u0`` is used and the FMG seed is skipped.
    Returns a ``SolveResult``.
    """
    import dataclasses as _dc

    from ..cycles import fmg, solve_fixed, solve_until_tol

    nd = int(b.ndim) if grid_ndim is None else int(grid_ndim)
    cfg = _dc.replace(config, use_kernels=False)
    hier_s = jax.tree.map(lambda x: _shard_leaf(x, mesh, nd), hier)
    b_s = _shard_leaf(b, mesh, nd)
    u0_s = None if u0 is None else _shard_leaf(u0, mesh, nd)

    def _seed(h, bb, uu):
        if use_fmg and uu is None:
            return fmg(h, cfg, bb)
        return uu

    if num_cycles is not None:
        fn = lambda h, bb, uu: solve_fixed(h, cfg, bb, num_cycles,
                                           u0=_seed(h, bb, uu))
    else:
        fn = lambda h, bb, uu: solve_until_tol(h, cfg, bb, tol=tol,
                                               max_cycles=max_cycles,
                                               u0=_seed(h, bb, uu))
    if jit:
        fn = jax.jit(fn)
    return fn(hier_s, b_s, u0_s)


def gspmd_fas_solve_hierarchy(hier, config, b, mesh: Mesh, *,
                              tol: float = 1e-8, max_cycles: int = 100,
                              num_cycles=None, u0=None, jit: bool = True,
                              grid_ndim=None):
    """FAS twin of :func:`gspmd_solve_hierarchy`: GSPMD-partition a
    nonlinear (FAS) hierarchy solve.  The quasilinear flux operators and
    pointwise φ evaluations are matrix-free jnp (rolls + elementwise), so
    XLA partitions them exactly like the linear tier; solution injection
    (coarse[i,j] = fine[2i,2j]) is a strided gather GSPMD handles on
    sharded inputs (correctness tier — the explicit shard_map FAS path
    in ``dist.fas`` is the performance route for pointwise 2D)."""
    from ..cycles.fas import fas_solve_fixed, fas_solve_until_tol

    nd = int(b.ndim) if grid_ndim is None else int(grid_ndim)
    cfg = config
    hier_s = jax.tree.map(lambda x: _shard_leaf(x, mesh, nd), hier)
    b_s = _shard_leaf(b, mesh, nd)
    u0_s = None if u0 is None else _shard_leaf(u0, mesh, nd)
    if num_cycles is not None:
        fn = lambda h, bb, uu: fas_solve_fixed(h, cfg, bb, num_cycles,
                                               u0=uu)
    else:
        fn = lambda h, bb, uu: fas_solve_until_tol(h, cfg, bb, tol=tol,
                                                   max_cycles=max_cycles,
                                                   u0=uu)
    if jit:
        fn = jax.jit(fn)
    return fn(hier_s, b_s, u0_s)


def gspmd_solve(config, mesh: Mesh, *, forcing=4.0, coefficient=None,
                u0=None, tol: float = 1e-5, max_cycles: int = 100,
                num_cycles=None, replicate_below: int = 64,
                levels_hier=None, jit: bool = True):
    """GSPMD auto-partitioned solve on the explicit path's padded layout.

    The stock jnp cycle is jit-compiled over ``NamedSharding`` inputs and
    XLA inserts the halo collectives.  The hierarchy is the SAME
    ``build_sharded_problem`` layout the shard_map path uses (one shared
    padded layout — ROADMAP #11 / VERDICT r2 #10; previously this path
    re-padded the grid per mesh shape with its own ``PoissonProblem``):
    pass ``levels_hier=(levels, hier)`` to share a single construction, or
    let this build one.  Returns ``(SolveResult, ShardedLevels)`` like
    :func:`dist.shard_cycle.sharded_solve`.
    """
    import dataclasses

    import jax.numpy as jnp

    from ..cycles import solve_fixed, solve_until_tol
    from ..problems.poisson import poisson_rhs
    from .shard_cycle import build_sharded_problem

    if levels_hier is None:
        levels, hier = build_sharded_problem(
            config, mesh, coefficient=coefficient,
            replicate_below=replicate_below)
    else:
        levels, hier = levels_hier
    n0, S0 = levels.sizes[0]
    dt = jnp.dtype(config.dtype)
    # GSPMD partitions the plain jnp operators (the fused CUDA kernels
    # are single-device).
    cfg = dataclasses.replace(config, use_kernels=False)
    gs = grid_sharding(mesh)
    b = jax.device_put(poisson_rhs(n0, S0, forcing, dt), gs)
    u0p = None if u0 is None else jax.device_put(jnp.asarray(u0, dt), gs)
    if num_cycles is not None:
        fn = lambda h, bb, uu: solve_fixed(h, cfg, bb, num_cycles, u0=uu)
    else:
        fn = lambda h, bb, uu: solve_until_tol(h, cfg, bb, tol=tol,
                                               max_cycles=max_cycles, u0=uu)
    if jit:
        fn = jax.jit(fn, static_argnums=())
    return fn(hier, b, u0p), levels
