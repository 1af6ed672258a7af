"""FAS (Full Approximation Scheme) multigrid for nonlinear problems.

The nonlinear analogue of the linear cycles in :mod:`tpu_multigrid.cycles`
(reference: ``vcyclemultigrid``/``fullmultigrid``,
``Poissons_SYCL.cpp:575-650`` — linear-only; FAS is capability surplus).
FAS carries the FULL approximation to coarse levels instead of the error:

    pre-smooth          u ← S(u, b)
    restrict            û = I u   (literal injection),  r̂ = R (b − N(u))
    coarse equation     N_c(u_c) = N_c(û) + r̂,  solved from u_c = û
    correct             u ← u + P (u_c − û)
    post-smooth         u ← S(u, b)

For a LINEAR N this reduces algebraically to the correction scheme — the
coarse solve of N_c(u_c) = N_c(û) + r̂ from û is the linear coarse solve of
A_c e = r̂ shifted by û — which is the invariant `tests/test_fas.py`
verifies against :func:`tpu_multigrid.cycles.cycle`.

Like the linear tier, the recursion unrolls at trace time over the static
hierarchy, so an entire FAS solve is one XLA program: no host round trips,
data-independent control flow, static shapes throughout.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..config import MultigridConfig
from ..core import ops
from ..core.grids import Hierarchy
from ..core.nonlinear import inject_solution, inject_solution3
from . import SolveResult


def _gshape(op):
    return getattr(op, "grid_shape", (op.S, op.S))


def _restrict_pair(op, opc, u, r):
    """(solution injection, residual restriction) dispatched on ndim."""
    if getattr(op, "ndim", 2) == 3:
        from ..core import ops3d
        return (inject_solution3(u, op.n, _gshape(opc)),
                ops3d.restrict_fw3(r, op.n, _gshape(opc)))
    return (inject_solution(u, op.n, opc.S),
            ops.restrict_fw(r, op.n, opc.S))


def _prolong_err(e, opc, op):
    if getattr(op, "ndim", 2) == 3:
        from ..core import ops3d
        return ops3d.prolong3(e, opc.n, _gshape(op))
    return ops.prolong(e, opc.n, op.S)


def _nsmooth(op, u, b, cfg: MultigridConfig, sweeps: int):
    return op.nsmooth(u, b, omega=cfg.omega, sweeps=sweeps)


def _coarsest(hier: Hierarchy, cfg: MultigridConfig, u, b):
    op = hier.levels[-1]
    if cfg.coarse_solver == "direct" and getattr(op, "a_dense", None) is not None:
        return op.coarse_newton(u, b, steps=3)
    return _nsmooth(op, u, b, cfg, cfg.coarse_smooth_sweeps)


def fas_cycle(hier: Hierarchy, cfg: MultigridConfig, u, b, k: int = 0):
    """One FAS cycle (V, W, or F per ``cfg.cycle``) at level index k."""
    if k == hier.num_levels - 1:
        return _coarsest(hier, cfg, u, b)

    op = hier.levels[k]
    opc = hier.levels[k + 1]
    u = _nsmooth(op, u, b, cfg, cfg.nu1)
    r = op.residual(u, b)
    uc0, rc = _restrict_pair(op, opc, u, r)
    bc = opc.apply(uc0) + rc

    uc = uc0
    if cfg.cycle == "V":
        uc = fas_cycle(hier, cfg, uc, bc, k + 1)
    elif cfg.cycle == "W":
        uc = fas_cycle(hier, cfg, uc, bc, k + 1)
        uc = fas_cycle(hier, cfg, uc, bc, k + 1)
    elif cfg.cycle == "F":
        uc = fas_cycle(hier, cfg, uc, bc, k + 1)
        uc = _fas_vcycle_only(hier, cfg, uc, bc, k + 1)

    u = u + _prolong_err(uc - uc0, opc, op)
    return _nsmooth(op, u, b, cfg, cfg.nu2)


def _fas_vcycle_only(hier, cfg, u, b, k):
    vcfg = dataclasses.replace(cfg, cycle="V")
    return fas_cycle(hier, vcfg, u, b, k)


def fas_cycle_with_norm(hier: Hierarchy, cfg: MultigridConfig, u, b):
    """One finest-level FAS cycle + the post-cycle nonlinear residual norm
    (one residual + norm pass)."""
    op = hier.levels[0]
    if hier.num_levels == 1:
        u = _coarsest(hier, cfg, u, b)
        return u, ops.norm2(op.residual(u, b))
    u = fas_cycle(hier, cfg, u, b)
    return u, ops.norm2(op.residual(u, b))


def fas_solve_fixed(hier: Hierarchy, cfg: MultigridConfig, b,
                    num_cycles: int, u0=None) -> SolveResult:
    """Run exactly ``num_cycles`` FAS cycles, recording nonlinear residual
    norms (mirrors :func:`tpu_multigrid.cycles.solve_fixed`)."""
    op = hier.levels[0]
    u = u0 if u0 is not None else jnp.zeros(_gshape(op), b.dtype)
    hist = jnp.full((num_cycles + 1,), jnp.nan, jnp.float32)
    hist = hist.at[0].set(ops.norm2(op.residual(u, b)))

    def body(i, carry):
        u, hist = carry
        u, rnorm = fas_cycle_with_norm(hier, cfg, u, b)
        hist = hist.at[i + 1].set(rnorm)
        return u, hist

    u, hist = jax.lax.fori_loop(0, num_cycles, body, (u, hist))
    return SolveResult(u=u, res_history=hist,
                       iterations=jnp.asarray(num_cycles, jnp.int32),
                       converged=jnp.asarray(True))


def fas_solve_until_tol(hier: Hierarchy, cfg: MultigridConfig, b, *,
                        tol: float, max_cycles: int = 100,
                        relative: bool = True, u0=None,
                        stall_factor: float = 0.9) -> SolveResult:
    """FAS cycles until the nonlinear residual drops below ``tol``; same
    two-consecutive-flat-cycles stall rule as the linear driver."""
    op = hier.levels[0]
    u = u0 if u0 is not None else jnp.zeros(_gshape(op), b.dtype)
    r0 = ops.norm2(op.residual(u, b))
    target = tol * r0 if relative else jnp.asarray(tol, jnp.float32)
    target = jnp.maximum(target, jnp.asarray(0.0, jnp.float32))
    hist = jnp.full((max_cycles + 1,), jnp.nan, jnp.float32)
    hist = hist.at[0].set(r0)
    sf = jnp.asarray(stall_factor, jnp.float32)

    def cond(carry):
        _, i, rnorm, stalls, _ = carry
        return (i < max_cycles) & (rnorm > target) & (stalls < 2)

    def body(carry):
        u, i, rnorm, stalls, hist = carry
        u, rnew = fas_cycle_with_norm(hier, cfg, u, b)
        hist = hist.at[i + 1].set(rnew)
        stalls = jnp.where(rnew > sf * rnorm, stalls + 1,
                           jnp.zeros_like(stalls))
        return u, i + 1, rnew, stalls, hist

    u, iters, rnorm, _, hist = jax.lax.while_loop(
        cond, body, (u, jnp.asarray(0, jnp.int32), r0,
                     jnp.asarray(0, jnp.int32), hist))
    return SolveResult(u=u, res_history=hist, iterations=iters,
                       converged=rnorm <= target)


def fmg_fas(hier: Hierarchy, cfg: MultigridConfig, b_levels):
    """FMG-FAS (nested iteration): coarsest nonlinear solve, then per level
    prolong the SOLUTION and run ``cfg.nu0`` FAS cycles against that
    level's own RHS.

    Unlike linear FMG (which restricts the fine RHS), nested iteration for
    nonlinear problems wants each level's assembled RHS (the reference-v2
    ``fmg_rhs="assemble"`` semantics, ``Multigrid_functions.cpp:184``) —
    pass ``problem.rhs_all_levels()``.
    """
    kc = hier.num_levels - 1
    opc = hier.levels[kc]
    u = jnp.zeros(_gshape(opc), b_levels[0].dtype)
    u = _coarsest(hier, cfg, u, b_levels[kc])
    for k in range(kc - 1, -1, -1):
        op = hier.levels[k]
        u = _prolong_err(u, hier.levels[k + 1], op)
        for _ in range(cfg.nu0):
            u = fas_cycle(hier, cfg, u, b_levels[k], k)
    return u
