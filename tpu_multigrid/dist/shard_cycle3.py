"""Explicit-communication distributed 3D multigrid: shard_map + ppermute.

3D extension of ``dist.shard_cycle``: (S, S, S) cubes are domain-
decomposed (gz, gy) over a 2D device mesh (x stays shard-local — the
single-chip kernel axis layout); fine levels run shard-local 7-point
operators with halo exchanges (``dist.local_ops3``), and once per-shard
blocks would degenerate the residual is all-gathered and the remaining
coarse hierarchy runs replicated on every device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import MultigridConfig
from ..core.grids import Hierarchy, coarse_dense_inverse, round_up
from ..core.operators import ConstStencilOp3D
from ..cycles import SolveResult, _coarsest_solve, cycle
from . import local_ops3 as L3

GRID_AXES3 = ("gz", "gy")


def make_grid_mesh3(shape: Optional[Tuple[int, int]] = None,
                    devices=None) -> Mesh:
    """2D device mesh with axes ("gz", "gy"); x stays unsharded."""
    from .mesh import _factor2
    devs = list(devices) if devices is not None else list(jax.devices())
    if shape is None:
        shape = _factor2(len(devs))
    mz, my = shape
    if mz * my != len(devs):
        raise ValueError(f"mesh shape {shape} != {len(devs)} devices")
    return Mesh(np.asarray(devs).reshape(mz, my), GRID_AXES3)


@dataclasses.dataclass(frozen=True)
class ShardedLevels3:
    sizes: Tuple[Tuple[int, int], ...]      # (n, S) per level, finest first
    num_sharded: int


def sharded_level_sizes3(config: MultigridConfig,
                         mesh_shape: Tuple[int, int], *, align: int = 8,
                         replicate_below: int = 8) -> ShardedLevels3:
    """Cubic (n, S) per level; sharded levels use exact halving so local
    fine blocks map onto half-sized local coarse blocks."""
    mz, my = mesh_shape
    m = max(mz, my, 1)
    n0 = 2 ** config.finest_level
    S0 = round_up(n0 + 1, max(align, 2 * m))
    sizes: List[Tuple[int, int]] = []
    num_sharded = 0
    S = S0
    for i, lvl in enumerate(range(config.finest_level,
                                  config.coarsest_level - 1, -1)):
        n = 2 ** lvl
        local = S // m
        halvable = S % 2 == 0 and (S // 2) % mz == 0 and (S // 2) % my == 0
        if (num_sharded == i and S % mz == 0 and S % my == 0
                and local >= replicate_below and S >= n + 1 and halvable):
            sizes.append((n, S))
            num_sharded += 1
            S //= 2
        elif num_sharded == i:
            sizes.append((n, max(S, n + 1)))
        else:
            sizes.append((n, n + 1))
    num_sharded = min(num_sharded, len(sizes) - 1)
    return ShardedLevels3(tuple(sizes), num_sharded)


def build_sharded_poisson3(config: MultigridConfig, mesh: Mesh, *,
                           replicate_below: int = 8):
    mz, my = mesh.devices.shape
    levels = sharded_level_sizes3(config, (mz, my),
                                  replicate_below=replicate_below)
    hops = tuple(ConstStencilOp3D(n, S) for (n, S) in levels.sizes)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(hops[-1])
    return levels, Hierarchy(hops, coarse_inv)


def build_sharded_diffusion3(config: MultigridConfig, mesh: Mesh,
                             coefficient, *, replicate_below: int = 8):
    """Variable-coefficient hierarchy on the sharded cubic level sizes.

    Mirrors ``problems.diffusion3d.build_diffusion3d_hierarchy`` (7-point
    flux stencils, 2x2x2 cell-averaged coarse re-discretization) at the
    mesh-aligned cubic sizes (Sx = S: the sharded path is plain jnp, so
    no lane alignment is needed).  All host numpy until device placement.
    """
    from ..core.operators import diffusion_op3_host
    from ..problems.diffusion3d import cell_coefficients3, coarsen_cells3

    mz, my = mesh.devices.shape
    levels = sharded_level_sizes3(config, (mz, my),
                                  replicate_below=replicate_below)
    np_dt = np.dtype(jnp.dtype(config.dtype).name)
    cells = cell_coefficients3(2 ** config.finest_level, coefficient)
    hops = []
    for (n, S) in levels.sizes:
        hops.append(diffusion_op3_host(cells.astype(np_dt), n, S, S))
        if n > 2 ** config.coarsest_level:
            cells = coarsen_cells3(cells)
    coarse_inv = None
    if config.coarse_solver == "direct":
        coarse_inv = coarse_dense_inverse(hops[-1])
    return levels, Hierarchy(tuple(hops), coarse_inv)


def _split_hier3(levels: ShardedLevels3, hier: Hierarchy, mesh: Mesh):
    """(svar, hier_repl) for shard_map argument passing.

    ``svar[k]`` holds a sharded var level's (tz, ty, tx, inv_diag) planes
    pre-placed with (gz, gy, None) sharding — jit ARGUMENTS, never
    closures (closed-over arrays embed as compile-request constants,
    CLAUDE.md); ``hier_repl`` replaces sharded var slots with array-free
    placeholders and passes the replicated coarse tail (including its
    coefficient planes) as a replicated argument.
    """
    from ..core.operators import VarStencilOp3D

    ns = levels.num_sharded
    spec = NamedSharding(mesh, P(*GRID_AXES3, None))
    svar = []
    repl_ops = []
    for k, op in enumerate(hier.levels):
        if k < ns and isinstance(op, VarStencilOp3D):
            if getattr(op, "c2", None) is not None:
                raise ValueError(
                    "sharded 3D levels recompute diagonals from the t "
                    "planes and cannot carry a reaction shift (c2)")
            svar.append(tuple(jax.device_put(t, spec)
                              for t in (op.tz, op.ty, op.tx, op.inv_diag)))
            repl_ops.append(ConstStencilOp3D(op.n, op.S, op.Sx))
        else:
            if k < ns:
                svar.append(None)
            repl_ops.append(op)
    return tuple(svar), Hierarchy(tuple(repl_ops), hier.coarse_inv)


def _replicated_cycle3(hier, cfg, k0, u, b):
    return cycle(hier, cfg, u, b, k=k0)


def _local_smooth3(cfg: MultigridConfig, lv, n: int, u, b, sweeps: int):
    """Shard-local smoothing: 7-point Poisson (``lv=None``) or a var
    level's flux planes (``lv=(tz, ty, tx, inv_diag)``)."""
    from ..cycles import _sm
    smoother, omega = _sm(cfg, sweeps)
    if lv is None:
        if smoother == "jacobi":
            return L3.jacobi_local3(u, b, n, omega, sweeps)
        return L3.rbgs_local3(u, b, n, sweeps)
    from . import local_var3 as V3
    if smoother == "jacobi":
        return V3.var3_jacobi_local(u, b, *lv, n, omega, sweeps)
    return V3.var3_rbgs_local(u, b, *lv, n, sweeps)


def _local_residual3(lv, n: int, u, b):
    if lv is None:
        return L3.residual_local3(u, b, n)
    from . import local_var3 as V3
    return V3.var3_residual_local(u, b, *lv, n)


def _vcycle_local3(levels: ShardedLevels3, hier: Hierarchy,
                   cfg: MultigridConfig, k: int, u, b, svar=()):
    n, S = levels.sizes[k]
    lv = svar[k] if k < len(svar) else None

    u = _local_smooth3(cfg, lv, n, u, b, sweeps=cfg.nu1)
    r = _local_residual3(lv, n, u, b)
    rc = L3.restrict_fw_local3(r, n)

    recurse_cnt = 2 if cfg.cycle in ("W", "F") else 1
    if k + 1 < levels.num_sharded:
        ec = jnp.zeros_like(rc)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            ec = _vcycle_local3(levels, hier, sub, k + 1, ec, rc, svar)
    else:
        rc_full = L3.gather_full3(rc)
        ec_full = jnp.zeros_like(rc_full)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            if k + 1 == len(levels.sizes) - 1:
                ec_full = _coarsest_solve(hier, sub, ec_full, rc_full)
            else:
                ec_full = _replicated_cycle3(hier, sub, k + 1, ec_full,
                                             rc_full)
        ec = L3.local_slice3(ec_full, rc.shape)

    u = u + L3.prolong_local3(ec, n // 2)
    u = _local_smooth3(cfg, lv, n, u, b, sweeps=cfg.nu2)
    return u


def sharded_solve3(config: MultigridConfig, mesh: Mesh, *,
                   forcing: float = 6.0, coefficient=None,
                   tol: float = 1e-5, max_cycles: int = 100,
                   num_cycles: Optional[int] = None,
                   replicate_below: int = 8, jit: bool = True):
    """Distributed 3D solve with explicit halo-exchange communication.

    ``coefficient=None`` solves Poisson (matrix-free 7-point stencil);
    a float / callable ``a(x, y, z)`` / (n, n, n) cell array solves
    variable-coefficient diffusion with per-level 2x2x2 cell-averaged
    flux stencils, the transmissibility planes domain-decomposed
    alongside u/b (dist.local_var3).
    """
    if coefficient is None:
        levels, hier = build_sharded_poisson3(
            config, mesh, replicate_below=replicate_below)
    else:
        levels, hier = build_sharded_diffusion3(
            config, mesh, coefficient, replicate_below=replicate_below)
    n0, S0 = levels.sizes[0]
    h2 = (1.0 / n0) ** 2
    spec = P(*GRID_AXES3, None)

    svar, hier_repl = _split_hier3(levels, hier, mesh)
    svar_specs = jax.tree.map(lambda _: spec, svar)

    b = jax.device_put(np.zeros((S0, S0, S0), np.float32),
                       NamedSharding(mesh, spec))

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(spec, svar_specs, P()),
                       out_specs=(spec, P(), P(), P()),
                       check_vma=False)
    def run(b_loc, svar_loc, hier_loc):
        m = L3.interior_mask_local3(b_loc.shape, n0)
        b_loc = jnp.where(m, jnp.asarray(forcing * h2, jnp.float32),
                          jnp.zeros((), jnp.float32))
        lv0 = svar_loc[0] if len(svar_loc) > 0 else None
        u = jnp.zeros_like(b_loc)
        r0 = L3.norm2_local3(_local_residual3(lv0, n0, u, b_loc))
        target = jnp.asarray(tol, jnp.float32) * r0
        ncyc = num_cycles if num_cycles is not None else max_cycles
        hist = jnp.full((ncyc + 1,), jnp.nan, jnp.float32).at[0].set(r0)

        def cond(carry):
            _, i, rnorm, stalls, _ = carry
            keep = i < ncyc
            if num_cycles is None:
                keep &= (rnorm > target) & (stalls < 2)
            return keep

        def body(carry):
            u, i, rnorm, stalls, hist = carry
            u = _vcycle_local3(levels, hier_loc, config, 0, u, b_loc,
                               svar_loc)
            rnew = L3.norm2_local3(_local_residual3(lv0, n0, u, b_loc))
            hist = hist.at[i + 1].set(rnew)
            stalls = jnp.where(rnew > 0.9 * rnorm, stalls + 1,
                               jnp.zeros_like(stalls))
            return u, i + 1, rnew, stalls, hist

        u, iters, rnorm, _, hist = lax.while_loop(
            cond, body, (u, jnp.asarray(0, jnp.int32), r0,
                         jnp.asarray(0, jnp.int32), hist))
        return u, hist, iters, rnorm <= target

    if jit:
        run = jax.jit(run)
    u, hist, iters, conv = run(b, svar, hier_repl)
    return SolveResult(u=u, res_history=hist, iterations=iters,
                       converged=conv), levels
