"""Distributed compensated iterative refinement (double-/triple-single).

VERDICT r3 next #1: BASELINE config 5 (sharded 16385^2) cannot reach 1e-8
in plain f32 at all — A(round_f32(u*)) deviates by ~2*||b|| — so the
distributed tier needs the same compensated machinery the single chip has
(``tpu_multigrid.precision``): a double-single (or triple-single) outer
iterate, residuals evaluated with TwoSum error-free transformations, and
(for deep tolerances) double-single corrections through the finest cycle
levels with exact-pair prolongation.

The port is natural because every compensated ingredient is elementwise or
stencil-local (ds_add/ts_add are pointwise; the compensated neighbor sums
need one ghost ring; the exact-pair prolongation is the same 1-ring
bilinear stencil as ``dist.local_ops.prolong_local``), so the existing
ppermute halo machinery carries it:

* :func:`ds_residual_local` / :func:`ts_residual_local` — shard-local
  compensated residuals sharing the exact TwoSum cascades with the
  single-chip versions (``precision._ds_cascade`` / ``_ts_cascade``), so
  1-device mesh results are bitwise-comparable to the single-chip path;
* :func:`prolong_comp_local` — bilinear prolongation with an exact error
  term on local blocks (dyadic weights: only the 2-/4-point sums round,
  captured by TwoSum);
* :func:`cycle_ds_local` — the ds correction V-cycle
  (``precision.cycle_ds``) over sharded levels: plain pre-smooth +
  shard-local restrict, ds pair back up with exact-pair prolongation,
  delta-form post-smoothing against the compensated defect;
* :func:`refined_sharded_solve` — the outer ds/ts refinement driver
  inside one ``shard_map`` (one XLA program per solve, matching
  ``dist.shard_cycle.sharded_solve``'s contract).

Reference anchor: the v2 library's f64 intent
(``Multigrid_functions.cpp:19-38``) — compensated f32 reaches it with
f32 storage.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..config import MultigridConfig
from ..core.grids import Hierarchy
from ..cycles import SolveResult, _coarsest_solve
from ..precision import (_ds_cascade, _ts_cascade, _two_sum, ds_add,
                         ts_add)
from . import local_ops as L
from .mesh import GRID_AXES
from .shard_cycle import (ShardedLevels, _local_residual, _local_smooth,
                          _replicated_cycle, _vcycle_local,
                          build_sharded_poisson)


# ---------------------------------------------------------------------------
# Shard-local compensated residuals (inside shard_map)
# ---------------------------------------------------------------------------

def _nbr_comp_local(u):
    """Compensated 4-neighbor sum on a local block (one ppermute halo ring).

    Term order matches ``precision._neighbor_sum_compensated`` ([up, down,
    left, right]) so the TwoSum cascade is arithmetic-identical."""
    h = L.with_halo1(u)
    terms = [h[:-2, 1:-1], h[2:, 1:-1], h[1:-1, :-2], h[1:-1, 2:]]
    s = terms[0]
    c = jnp.zeros_like(u)
    for t in terms[1:]:
        s, e = _two_sum(s, t)
        c = c + e
    return s, c


def _mask_local(r, n):
    return jnp.where(L.interior_mask_local(r.shape, n), r,
                     jnp.zeros((), r.dtype))


def ds_residual_local(b, u_hi, u_lo, n):
    """r = b - A(u_hi + u_lo) to ~eps^2 on local blocks (2 halo rings)."""
    nbr_hi, nbr_c = _nbr_comp_local(u_hi)
    a_lo = 4.0 * u_lo - L.neighbor_sum_local(u_lo)
    r = _ds_cascade(b, u_hi, nbr_hi, nbr_c, a_lo)
    return _mask_local(r.astype(b.dtype), n)


def ts_residual_local(b, u_hi, u_mid, u_lo, n):
    """r = b - A(u_hi + u_mid + u_lo) to ~eps^3 on local blocks."""
    nbr_h, c_h = _nbr_comp_local(u_hi)
    nbr_m, c_m = _nbr_comp_local(u_mid)
    a_l = 4.0 * u_lo - L.neighbor_sum_local(u_lo)
    r = _ts_cascade(b, u_hi, u_mid, nbr_h, c_h, nbr_m, c_m, a_l)
    return _mask_local(r.astype(b.dtype), n)


# ---------------------------------------------------------------------------
# Exact-pair prolongation on local blocks
# ---------------------------------------------------------------------------

def prolong_comp_local(ec, nc: int):
    """Bilinear prolongation with an exact error term on local blocks:
    P ec == hi + err (same TwoSum splits as ``precision.prolong_comp``;
    same halo/scatter layout as ``local_ops.prolong_local``)."""
    nf = 2 * nc
    h = L.with_halo1(ec)
    c = h[1:-1, 1:-1]
    cdn = h[2:, 1:-1]
    crt = h[1:-1, 2:]
    cdr = h[2:, 2:]
    # odd-row even-col: 0.5*(c + down); TwoSum the add, halve both (exact)
    sv, tv = _two_sum(c, cdn)
    # even-row odd-col: 0.5*(c + right)
    sh, th = _two_sum(c, crt)
    # odd-odd: 0.25*(c + right + down + downright), compensated 4-term sum
    s1, t1 = _two_sum(c, crt)
    s2, t2 = _two_sum(cdn, cdr)
    sq, t3 = _two_sum(s1, s2)
    r, cc = c.shape
    hi = jnp.zeros((2 * r, 2 * cc), ec.dtype)
    er = jnp.zeros((2 * r, 2 * cc), ec.dtype)
    hi = hi.at[0::2, 0::2].set(c)
    hi = hi.at[1::2, 0::2].set(0.5 * sv)
    er = er.at[1::2, 0::2].set(0.5 * tv)
    hi = hi.at[0::2, 1::2].set(0.5 * sh)
    er = er.at[0::2, 1::2].set(0.5 * th)
    hi = hi.at[1::2, 1::2].set(0.25 * sq)
    er = er.at[1::2, 1::2].set(0.25 * (t1 + t2 + t3))
    return _mask_local(hi, nf), _mask_local(er, nf)


# ---------------------------------------------------------------------------
# ds correction cycle over sharded levels
# ---------------------------------------------------------------------------

def _plain_correction(levels: ShardedLevels, hier: Hierarchy,
                      cfg: MultigridConfig, k: int, rc):
    """Zero-guess correction at sharded-level index k (local block in,
    local block out): local V-cycle while sharded, else the all-gather +
    replicated-tail transition (same as ``_vcycle_local``'s switch)."""
    if k < levels.num_sharded:
        return _vcycle_local(levels, hier, cfg, k, jnp.zeros_like(rc), rc)
    rc_full = L.gather_full(rc)
    ec_full = jnp.zeros_like(rc_full)
    if k == len(levels.sizes) - 1:
        ec_full = _coarsest_solve(hier, cfg, ec_full, rc_full)
    else:
        ec_full = _replicated_cycle(hier, cfg, k, ec_full, rc_full)
    return L.local_slice(ec_full, rc.shape)


def cycle_ds_local(levels: ShardedLevels, hier: Hierarchy,
                   cfg: MultigridConfig, r, k: int = 0, ds_levels: int = 3):
    """One V-cycle on A e = r returning e as a ds pair (local blocks).

    The distributed twin of ``precision.cycle_ds``: on the finest
    ``ds_levels`` (sharded) levels the sub-level correction comes back as
    a ds pair, is prolonged with an exact error term, and post-smoothing
    runs in delta form against the compensated defect.  Below that (or at
    the replication switch) the plain correction cycle runs unchanged.
    Only the V shape is supported (the refinement driver's inner solve).
    """
    ds_limit = min(ds_levels, levels.num_sharded)
    if k >= ds_limit:
        return _plain_correction(levels, hier, cfg, k, r), jnp.zeros_like(r)

    n, S = levels.sizes[k]
    e0 = _local_smooth(cfg, None, n, jnp.zeros_like(r), r, cfg.nu1)
    r1 = _local_residual(None, n, e0, r)
    rc = L.restrict_fw_local(r1, n)
    ec_hi, ec_lo = cycle_ds_local(levels, hier, cfg, rc, k + 1, ds_levels)
    p_hi, p_err = prolong_comp_local(ec_hi, n // 2)
    p_lo = L.prolong_local(ec_lo, n // 2) + p_err
    e_hi, e_lo = ds_add(p_hi, p_lo, e0)
    d0 = ds_residual_local(r, e_hi, e_lo, n)
    delta = _local_smooth(cfg, None, n, jnp.zeros_like(d0), d0, cfg.nu2)
    return ds_add(e_hi, e_lo, delta)


# ---------------------------------------------------------------------------
# Outer refinement driver
# ---------------------------------------------------------------------------

def refined_sharded_solve(config: MultigridConfig, mesh: Mesh, *,
                          forcing=4.0, tol: Optional[float] = 1e-8,
                          max_iters: int = 60, stall_factor: float = 0.9,
                          num_cycles: Optional[int] = None,
                          ds_levels: int = 0, ts: bool = False,
                          replicate_below: int = 64, jit: bool = True,
                          u0=None, u0_lo=None, r0_norm=None,
                          return_parts: bool = False):
    """Distributed compensated iterative refinement for Poisson.

    The ``mesh=`` twin of ``precision.solve_refined_ds`` /
    ``solve_refined_ts``: the outer iterate is a sharded ds pair (or ts
    triple with ``ts=True``), residuals are evaluated compensated on local
    blocks, and each iteration's correction comes from one multigrid
    V-cycle on the defect — plain f32 (``ds_levels=0``) or with ds
    corrections on the finest ``ds_levels`` sharded levels.

    Returns ``(SolveResult, ShardedLevels)``; ``result.u`` is the sharded
    high-order component.  Constant-coefficient Poisson only (the
    compensated cascades are 5-point-specialized, exactly like the
    single-chip tier).
    """
    if tol is None and num_cycles is None:
        raise ValueError("refined solve needs tol or num_cycles")
    levels, hier = build_sharded_poisson(config, mesh,
                                         replicate_below=replicate_below)
    n0, S0 = levels.sizes[0]
    h2 = (1.0 / n0) ** 2
    dt = jnp.dtype(config.dtype)
    spec = P(*GRID_AXES)
    gspec = NamedSharding(mesh, spec)
    fixed = num_cycles is not None
    ncyc = num_cycles if fixed else max_iters
    ncomp = 3 if ts else 2

    u0_glob = jax.device_put(
        np.zeros((S0, S0), dt) if u0 is None else np.asarray(u0, dt), gspec)
    u0lo_glob = jax.device_put(
        np.zeros((S0, S0), dt) if u0_lo is None else np.asarray(u0_lo, dt),
        gspec)
    have_u0 = u0 is not None

    @functools.partial(
        shard_map, mesh=mesh, in_specs=(spec, spec, P()),
        out_specs=(tuple([spec] * ncomp), P(), P(), P()),
        check_vma=False)
    def run(u0_loc, u0lo_loc, hier_loc):
        # Shard-local RHS assembly (same as shard_cycle.sharded_solve).
        m = L.interior_mask_local(u0_loc.shape, n0)
        if callable(forcing):
            r0_, c0_ = L._local_offsets(u0_loc.shape)
            gi = lax.broadcasted_iota(jnp.int32, u0_loc.shape, 0) + r0_
            gj = lax.broadcasted_iota(jnp.int32, u0_loc.shape, 1) + c0_
            h = 1.0 / n0
            x = gj.astype(dt) * jnp.asarray(h, dt)
            y = gi.astype(dt) * jnp.asarray(h, dt)
            vals = forcing(x, y).astype(dt) * jnp.asarray(h2, dt)
        else:
            vals = jnp.full(u0_loc.shape, float(forcing) * h2, dt)
        b = jnp.where(m, vals, jnp.zeros((), dt))

        def resid(comps):
            if ts:
                return ts_residual_local(b, *comps, n0)
            return ds_residual_local(b, *comps, n0)

        if have_u0:
            comps = ((u0_loc, u0lo_loc, jnp.zeros_like(u0_loc)) if ts
                     else (u0_loc, u0lo_loc))
            r = resid(comps)
        else:
            z = jnp.zeros_like(u0_loc)
            comps = (z, z, z) if ts else (z, z)
            r = b
        r0 = L.norm2_local(r)
        rbase = (jnp.asarray(r0_norm, jnp.float32)
                 if r0_norm is not None else r0)
        target = (jnp.asarray(tol, jnp.float32) * rbase if tol is not None
                  else jnp.asarray(0.0, jnp.float32))
        hist = jnp.full((ncyc + 1,), jnp.nan, jnp.float32).at[0].set(r0)

        def cond(carry):
            _, _, i, rnorm, prev, _ = carry
            keep = i < ncyc
            if not fixed:
                progressing = (rnorm < jnp.asarray(stall_factor,
                                                   jnp.float32) * prev)
                keep &= (rnorm > target) & progressing
            return keep

        def body(carry):
            comps, r, i, rnorm, _, hist = carry
            add = ts_add if ts else ds_add
            if ds_levels > 0:
                e_hi, e_lo = cycle_ds_local(levels, hier_loc, config, r,
                                            ds_levels=ds_levels)
                comps = add(*comps, e_hi)
                comps = add(*comps, e_lo)
            else:
                e = _plain_correction(levels, hier_loc, config, 0, r)
                comps = add(*comps, e)
            r = resid(comps)
            rnew = L.norm2_local(r)
            hist = hist.at[i + 1].set(rnew)
            return comps, r, i + 1, rnew, rnorm, hist

        inf = jnp.asarray(jnp.inf, jnp.float32)
        comps, r, iters, rnorm, _, hist = lax.while_loop(
            cond, body,
            (comps, r, jnp.asarray(0, jnp.int32), r0, inf, hist))
        conv = jnp.asarray(True) if fixed else rnorm <= target
        return comps, hist, iters, conv

    if jit:
        run = jax.jit(run)
    comps, hist, iters, conv = run(u0_glob, u0lo_glob, hier)
    res = SolveResult(u=comps[0], res_history=hist, iterations=iters,
                      converged=conv)
    if return_parts:
        # All iterate components (sharded global arrays) — needed to
        # resume without re-paying the f32 representation floor
        # (checkpoint/resume of distributed refined solves).
        return res, levels, comps
    return res, levels
