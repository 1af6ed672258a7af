"""Distributed periodic (torus) Poisson: shard_map + ppermute wrap halos.

VERDICT r3 next #5: the periodic family on shards.  This is the case the
explicit halo machinery fits MOST naturally: ``lax.ppermute`` rings wrap
(shard 0 receives from shard N-1), which on the torus is not an artifact
to be masked away — it IS the topology.  Every local operator here is the
Dirichlet tier's twin with the interior masks simply deleted:

* neighbor sums / Jacobi / red-black GS: ``with_halo1`` wrap ghosts are
  the true periodic neighbors (global parity stays consistent because n
  is even);
* transfers are the torus variational pair of ``problems.periodic``
  (separable blur + even decimation; 2x replication + averaging), each
  needing one ghost ring;
* the mean-zero gauge is preserved by every ingredient, so only the RHS
  is projected (one global ``psum``), exactly like the single-chip tier;
* the replicated coarse tail runs the stock ``PeriodicOp`` cycle with
  the dense pseudo-inverse coarsest solve.

Grids are (n, n) unique-node arrays (no padding!) sharded (gy, gx);
levels halve while the local block stays even and large enough.
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
from ..core.grids import Hierarchy
from ..cycles import SolveResult, _coarsest_solve, _sm, cycle
from ..problems.periodic import PeriodicOp, periodic_coarse_pinv
from . import local_ops as L
from .mesh import GRID_AXES
from .shard_cycle import ShardedLevels

GY, GX = GRID_AXES


def periodic_level_sizes(config: MultigridConfig,
                         mesh_shape: Tuple[int, int], *,
                         replicate_below: int = 16) -> ShardedLevels:
    """(n, n) per level; sharded while local blocks divide evenly."""
    my, mx = mesh_shape
    sizes: List[Tuple[int, int]] = []
    num_sharded = 0
    for i, lvl in enumerate(range(config.finest_level,
                                  config.coarsest_level - 1, -1)):
        n = 2 ** lvl
        sizes.append((n, n))
        local_ok = (n % my == 0 and n % mx == 0
                    and (n // max(my, mx)) % 2 == 0
                    and n // max(my, mx) >= replicate_below)
        if num_sharded == i and local_ok:
            num_sharded += 1
    num_sharded = min(num_sharded, len(sizes) - 1)
    return ShardedLevels(tuple(sizes), num_sharded)


def build_periodic_tail(levels: ShardedLevels,
                        cfg: MultigridConfig) -> Hierarchy:
    ops_ = tuple(PeriodicOp(n) for (n, _) in levels.sizes)
    coarse_inv = None
    if cfg.coarse_solver == "direct":
        coarse_inv = periodic_coarse_pinv(ops_[-1].n, cfg.dtype)
    return Hierarchy(ops_, coarse_inv)


# ---------------------------------------------------------------------------
# Shard-local torus operators (inside shard_map) — NO interior masks
# ---------------------------------------------------------------------------

def nbr_wrap_local(u):
    h = L.with_halo1(u)
    return h[:-2, 1:-1] + h[2:, 1:-1] + h[1:-1, :-2] + h[1:-1, 2:]


def residual_wrap_local(u, b):
    return (b - 4.0 * u + nbr_wrap_local(u)).astype(u.dtype)


def jacobi_wrap_local(u, b, omega, sweeps):
    if sweeps <= 0:
        return u
    ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
    ws = tuple(ws[i % len(ws)] for i in range(sweeps))
    v = u
    for w in ws:
        v = (jnp.asarray(1.0 - w, u.dtype) * v
             + jnp.asarray(0.25 * w, u.dtype)
             * (b + nbr_wrap_local(v))).astype(u.dtype)
    return v


def rbgs_wrap_local(u, b, sweeps):
    if sweeps <= 0:
        return u
    r0, c0 = L._local_offsets(u.shape)
    gi = lax.broadcasted_iota(jnp.int32, u.shape, 0) + r0
    gj = lax.broadcasted_iota(jnp.int32, u.shape, 1) + c0
    par = (gi + gj) % 2
    quarter = jnp.asarray(0.25, u.dtype)
    v = u
    for _ in range(sweeps):
        for parity in (0, 1):
            vn = quarter * (b + nbr_wrap_local(v))
            v = jnp.where(par == parity, vn.astype(u.dtype), v)
    return v


def restrict_wrap_local(r):
    """Torus full weighting (R = P^T): separable blur + even decimation.
    One ghost ring; wrap ghosts are the periodic neighbors."""
    h = L.with_halo1(r)
    tx = h[:, 1:-1] + 0.5 * (h[:, :-2] + h[:, 2:])        # (rows+2, c)
    ty = tx[1:-1] + 0.5 * (tx[:-2] + tx[2:])              # (rows, c)
    return ty[::2, ::2].astype(r.dtype)


def prolong_add_wrap_local(u, ec):
    """u + P ec on the torus: local 2x replication, then averaging with
    the +1 neighbors via one ghost ring of the replicated block."""
    e = PeriodicOp._double_rows(ec)
    e = PeriodicOp._double_rows(e.mT).mT
    h = L.with_halo1(e)
    e1 = 0.5 * (e + h[2:, 1:-1])                  # rows: e[i] + e[i+1]
    e1r = 0.5 * (h[1:-1, 2:] + h[2:, 2:])         # e1 shifted one col right
    e2 = 0.5 * (e1 + e1r)
    return (u + e2.astype(u.dtype)).astype(u.dtype)


def _smooth_wrap(cfg, u, b, sweeps):
    sm, om = _sm(cfg, sweeps)
    if sm == "jacobi":
        return jacobi_wrap_local(u, b, om, sweeps)
    if sm == "rbgs":
        return rbgs_wrap_local(u, b, sweeps)
    raise ValueError(f"periodic shards support jacobi/chebyshev/rbgs, "
                     f"not {sm!r}")


def _vcycle_periodic_local(levels: ShardedLevels, tail: Hierarchy,
                           cfg: MultigridConfig, k: int, u, b):
    u = _smooth_wrap(cfg, u, b, cfg.nu1)
    r = residual_wrap_local(u, b)
    rc = restrict_wrap_local(r)

    recurse_cnt = 2 if cfg.cycle in ("W", "F") else 1
    if k + 1 < levels.num_sharded:
        ec = jnp.zeros_like(rc)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            ec = _vcycle_periodic_local(levels, tail, sub, k + 1, ec, rc)
    else:
        rc_full = L.gather_full(rc)
        ec_full = jnp.zeros_like(rc_full)
        for i in range(recurse_cnt):
            sub = cfg if (cfg.cycle != "F" or i == 0) else \
                dataclasses.replace(cfg, cycle="V")
            if k + 1 == len(levels.sizes) - 1:
                ec_full = _coarsest_solve(tail, sub, ec_full, rc_full)
            else:
                ec_full = cycle(tail, sub, ec_full, rc_full, k=k + 1)
        ec = L.local_slice(ec_full, rc.shape)

    u = prolong_add_wrap_local(u, ec)
    return _smooth_wrap(cfg, u, b, cfg.nu2)


def periodic_sharded_solve(config: MultigridConfig, mesh: Mesh, *,
                           forcing, tol: Optional[float] = 1e-6,
                           max_cycles: int = 100,
                           num_cycles: Optional[int] = None, u0=None,
                           replicate_below: int = 16, jit: bool = True):
    """Distributed torus Poisson solve (mean-zero gauge).

    ``forcing`` must be a (zero-mean) callable ``f(x, y)``; the RHS is
    mean-projected globally (one psum), after which every ingredient
    preserves the gauge.  Returns ``(SolveResult, ShardedLevels)``.
    """
    if not callable(forcing):
        raise ValueError("periodic problems need a (zero-mean) callable "
                         "forcing")
    if tol is None and num_cycles is None:
        raise ValueError("need tol or num_cycles")
    my, mx = mesh.devices.shape
    levels = periodic_level_sizes(config, (my, mx),
                                  replicate_below=replicate_below)
    tail = jax.device_put(build_periodic_tail(levels, config))
    n0 = levels.sizes[0][0]
    dt = jnp.dtype(config.dtype)
    spec = P(*GRID_AXES)
    gspec = NamedSharding(mesh, spec)
    fixed = num_cycles is not None
    ncyc = num_cycles if fixed else max_cycles

    u0_glob = jax.device_put(
        np.zeros((n0, n0), dt) if u0 is None else np.asarray(u0, dt), gspec)

    @functools.partial(shard_map, mesh=mesh, in_specs=(spec, P()),
                       out_specs=(spec, P(), P(), P()), check_vma=False)
    def run(u_loc, tail_loc):
        r0_, c0_ = L._local_offsets(u_loc.shape)
        gi = lax.broadcasted_iota(jnp.int32, u_loc.shape, 0) + r0_
        gj = lax.broadcasted_iota(jnp.int32, u_loc.shape, 1) + c0_
        h = 1.0 / n0
        x = gj.astype(dt) * jnp.asarray(h, dt)
        y = gi.astype(dt) * jnp.asarray(h, dt)
        b = forcing(x, y).astype(dt) * jnp.asarray(h * h, dt)
        # global mean projection (compatibility; exact gauge)
        s = lax.psum(lax.psum(jnp.sum(b), GY), GX)
        b = (b - s / (n0 * n0)).astype(dt)

        r0 = L.norm2_local(residual_wrap_local(u_loc, b))
        target = (jnp.asarray(tol, jnp.float32) * r0 if tol is not None
                  else jnp.asarray(0.0, jnp.float32))
        hist = jnp.full((ncyc + 1,), jnp.nan, jnp.float32).at[0].set(r0)

        def cond(carry):
            _, i, rnorm, stalls, _ = carry
            keep = i < ncyc
            if not fixed:
                keep &= (rnorm > target) & (stalls < 2)
            return keep

        def body(carry):
            u, i, rnorm, stalls, hist = carry
            if levels.num_sharded > 0:
                u = _vcycle_periodic_local(levels, tail_loc, config, 0,
                                           u, b)
            else:
                u_full = L.gather_full(u)
                b_full = L.gather_full(b)
                u_full = cycle(tail_loc, config, u_full, b_full)
                u = L.local_slice(u_full, u.shape)
            rnew = L.norm2_local(residual_wrap_local(u, b))
            hist = hist.at[i + 1].set(rnew)
            stalls = jnp.where(rnew > 0.9 * rnorm, stalls + 1,
                               jnp.zeros_like(stalls))
            return u, i + 1, rnew, stalls, hist

        u, iters, rnorm, _, hist = lax.while_loop(
            cond, body, (u_loc, jnp.asarray(0, jnp.int32), r0,
                         jnp.asarray(0, jnp.int32), hist))
        return u, hist, iters, rnorm <= target

    if jit:
        run = jax.jit(run)
    u, hist, iters, conv = run(u0_glob, tail)
    return SolveResult(u=u, res_history=hist, iterations=iters,
                       converged=conv), levels
