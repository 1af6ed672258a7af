"""Cycle orchestration: V / W / F cycles, FMG, and convergence-driven solves.

The reference implements these as host-side recursions that enqueue one MKL
op at a time with a blocking ``wait()`` per step (``vcyclemultigrid``,
``Poissons_SYCL.cpp:575-627``; ``fullmultigrid``, ``:629-650``).  Here the
recursion unrolls at trace time over the *static* hierarchy, so an entire
FMG solve is a single XLA program: no host round-trips, no per-op syncs, and
XLA fuses smoother sweeps with residual/transfer arithmetic.

Unlike the reference — which never measures convergence and runs a fixed 31
V-cycles per level (``Poissons_SYCL.cpp:635,646``) — every driver here can
track per-cycle residual norms and stop at a tolerance (``until_tol``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import jax
import jax.numpy as jnp

from ..config import MultigridConfig
from ..core import ops
from ..core.grids import Hierarchy, coarse_solve
from ..core.operators import ConstStencilOp


# ---------------------------------------------------------------------------
# Smoothing with optional mixed precision
# ---------------------------------------------------------------------------

def _sm(cfg: MultigridConfig, sweeps: int):
    """Resolve the configured smoother to (kernel_name, omega).

    ``"chebyshev"`` is weighted Jacobi with the degree-``sweeps`` Chebyshev
    weight schedule (core.ops.chebyshev_omegas) — every Jacobi code path
    takes the tuple as its static ``omega``.
    """
    if cfg.smoother == "chebyshev":
        return "jacobi", ops.chebyshev_omegas(max(sweeps, 1), cfg.cheb_lo)
    return cfg.smoother, cfg.omega


def _smooth(op, u, b, cfg: MultigridConfig, sweeps: int):
    """Smooth, optionally running the sweeps in a lower precision.

    Mixed-precision scheme (BASELINE config 3): the accumulated solution and
    RHS stay in ``cfg.dtype``; when ``smooth_dtype`` is lower precision the
    smoother runs on the *defect equation* — compute d = b - A u in full
    precision, smooth e = 0 against d in low precision, add e back.  For a
    linear smoother this is algebraically identical to smoothing u directly,
    but the accumulated iterate never loses mantissa bits to bf16.
    """
    if sweeps <= 0:
        return u
    sdt = cfg.effective_smooth_dtype
    if sdt == u.dtype:
        return _smooth_raw(op, u, b, cfg, sweeps)
    d = op.residual(u, b).astype(sdt)
    e = jnp.zeros_like(d)
    e = _smooth_raw(op, e, d, cfg, sweeps)
    return (u + e.astype(u.dtype)).astype(u.dtype)


def _smooth_raw(op, u, b, cfg: MultigridConfig, sweeps: int):
    smoother, omega = _sm(cfg, sweeps)
    return op.smooth(u, b, smoother=smoother, omega=omega, sweeps=sweeps)


def _smooth_residual(op, u, b, cfg: MultigridConfig, sweeps: int):
    """Pre-smooth + residual."""
    u = _smooth(op, u, b, cfg, sweeps)
    return u, op.residual(u, b)


# ---------------------------------------------------------------------------
# V / W / F cycles
# ---------------------------------------------------------------------------

def _coarsest_solve(hier: Hierarchy, cfg: MultigridConfig, u, b):
    op = hier.levels[-1]
    if cfg.coarse_solver == "direct":
        # Reference-v2 intent: SparseLU direct solve
        # (Multigrid_functions.cpp:63-72,137-140), here a precomputed dense
        # inverse applied as one tiny matvec.
        return coarse_solve(op, hier.coarse_inv, b)
    # Reference-v1 behavior: extra smoothing instead of a direct solve
    # (Poissons_SYCL.cpp:583-587).
    return _smooth(op, u, b, cfg, cfg.coarse_smooth_sweeps)


def _zeros(op, dtype):
    """Zero grid matching the operator's dimensionality (2D default)."""
    return jnp.zeros(getattr(op, "grid_shape", (op.S, op.S)), dtype)


def _tshape(op):
    """Transfer-target size argument: per-axis shape for 3D, S for 2D."""
    return op.grid_shape if getattr(op, "ndim", 2) == 3 else op.S


def _restrict(r, nf, Sc, cfg: MultigridConfig, ndim: int = 2, box=None):
    if ndim == 3:
        from ..core import ops3d
        return ops3d.restrict_fw3(r, nf, Sc, box=box)
    if cfg.restriction == "injection":
        return ops.restrict_injection(r, nf, Sc)
    return ops.restrict_fw(r, nf, Sc, box=box)


def _prolong(e, nc, Sf, cfg: MultigridConfig, box=None):
    if cfg.prolongation == "p1":
        return ops.prolong_p1(e, nc, Sf)
    return ops.prolong(e, nc, Sf, box=box)


def _prolong_add(u, e, nc, Sf, cfg: MultigridConfig, ndim: int = 2,
                 box=None):
    """u + P e."""
    if ndim == 3:
        from ..core import ops3d
        return u + ops3d.prolong3(e, nc, Sf, box=box)
    return u + _prolong(e, nc, Sf, cfg, box=box)


def _use_level_kernels(op, opc, cfg: MultigridConfig, dtype) -> bool:
    """Whether this level visit runs the fused CUDA kernels
    (``kernels.level2d``): the constant 5-point pair, Jacobi/Chebyshev
    sweeps in one precision, the FW/bilinear transfer pair, f32."""
    if not cfg.use_kernels:
        return False
    if not (type(op) is ConstStencilOp and type(opc) is ConstStencilOp):
        return False
    if cfg.smoother not in ("jacobi", "chebyshev"):
        return False
    if jnp.dtype(cfg.effective_smooth_dtype) != jnp.dtype(dtype):
        return False
    if cfg.restriction != "fw" or cfg.prolongation != "bilinear":
        return False
    from ..kernels import level2d
    return level2d.supported(cfg.nu1, cfg.nu2, dtype)


def _omegas(cfg: MultigridConfig, sweeps: int) -> tuple:
    _, omega = _sm(cfg, sweeps)
    if isinstance(omega, tuple):
        return tuple(omega[i % len(omega)] for i in range(sweeps))
    return (omega,) * sweeps


def _k1(op, opc, cfg: MultigridConfig, u, b):
    from ..kernels import level2d
    return level2d.smooth_restrict(u, b, op.n, opc.S, _omegas(cfg, cfg.nu1))


def _k2(op, cfg: MultigridConfig, u, b, ec, *, resnorm=False):
    from ..kernels import level2d
    return level2d.prolong_smooth(u, b, ec, op.n, _omegas(cfg, cfg.nu2),
                                  resnorm=resnorm)


def _coarse_correction(hier, cfg, rc, k):
    """Coarse-grid correction of the level-k visit: W/F-cycle recursion."""
    opc = hier.levels[k + 1]
    ec = _zeros(opc, rc.dtype)
    if cfg.cycle == "V":
        ec = cycle(hier, cfg, ec, rc, k + 1)
    elif cfg.cycle == "W":
        ec = cycle(hier, cfg, ec, rc, k + 1)
        ec = cycle(hier, cfg, ec, rc, k + 1)
    elif cfg.cycle == "F":
        ec = cycle(hier, cfg, ec, rc, k + 1)
        ec = _vcycle_only(hier, cfg, ec, rc, k + 1)
    return ec


def cycle(hier: Hierarchy, cfg: MultigridConfig, u, b, k: int = 0):
    """One multigrid cycle (V, W, or F per ``cfg.cycle``) at level index k.

    Level index 0 = finest.  Reference: ``vcyclemultigrid``
    (``Poissons_SYCL.cpp:575-627``), with the level inferred statically from
    the hierarchy instead of ``log2(sqrt(size)+1)`` size-sniffing (``:583``).

    With ``cfg.use_kernels`` a constant-coefficient level visit is two
    fused CUDA kernels (smooth+residual+restrict, then
    prolong+correct+smooth; ``kernels.level2d``).
    """
    if k == hier.num_levels - 1:
        return _coarsest_solve(hier, cfg, u, b)

    op = hier.levels[k]
    opc = hier.levels[k + 1]
    if _use_level_kernels(op, opc, cfg, u.dtype):
        u, rc = _k1(op, opc, cfg, u, b)
        return _k2(op, cfg, u, b, _coarse_correction(hier, cfg, rc, k))
    u, r = _smooth_residual(op, u, b, cfg, cfg.nu1)
    if hasattr(opc, "restrict_into"):
        # Operator-defined transfers (semi-coarsened SemiOp levels,
        # periodic torus levels): the coarse op owns the pair.
        rc = opc.restrict_into(r, op)
    else:
        rc = _restrict(r, op.n, _tshape(opc), cfg, getattr(op, "ndim", 2),
                       box=getattr(opc, "box", None))
    ec = _coarse_correction(hier, cfg, rc, k)
    if hasattr(opc, "prolong_add_into"):
        u = opc.prolong_add_into(u, ec, op)
    else:
        u = _prolong_add(u, ec, opc.n, _tshape(op), cfg,
                         getattr(op, "ndim", 2),
                         box=getattr(op, "box", None))
    return _smooth(op, u, b, cfg, cfg.nu2)


def _vcycle_only(hier, cfg, u, b, k):
    vcfg = dataclasses.replace(cfg, cycle="V")
    return cycle(hier, vcfg, u, b, k)


def cycle_with_norm(hier: Hierarchy, cfg: MultigridConfig, u, b):
    """One finest-level cycle + the post-cycle residual norm.

    With the fused kernels the norm comes out of the final
    prolong+correct+smooth kernel; otherwise it is one residual + norm
    pass.  Used by the until-tol/fixed solve drivers.
    """
    if hier.num_levels == 1:
        u = _coarsest_solve(hier, cfg, u, b)
        return u, ops.norm2(hier.levels[0].residual(u, b))
    op = hier.levels[0]
    opc = hier.levels[1]
    if _use_level_kernels(op, opc, cfg, u.dtype):
        u, rc = _k1(op, opc, cfg, u, b)
        ec = _coarse_correction(hier, cfg, rc, 0)
        return _k2(op, cfg, u, b, ec, resnorm=True)
    u = cycle(hier, cfg, u, b)
    return u, ops.norm2(op.residual(u, b))


# ---------------------------------------------------------------------------
# Full multigrid
# ---------------------------------------------------------------------------

def fmg_rhs_hierarchy(hier: Hierarchy, cfg: MultigridConfig, b_fine,
                      b_levels: Optional[Sequence] = None) -> List:
    """Per-level RHS list, finest first.

    ``cfg.fmg_rhs == "restrict"``: restrict the fine RHS down the hierarchy
    (reference v1, ``Poissons_SYCL.cpp:641``; variational, since R = P^T).
    ``"assemble"``: use caller-provided per-level assembled RHS (reference
    v2, ``Multigrid_functions.cpp:184``).
    """
    if cfg.fmg_rhs == "assemble":
        if b_levels is None:
            raise ValueError('fmg_rhs="assemble" requires b_levels')
        return list(b_levels)
    bs = [b_fine]
    for k in range(hier.num_levels - 1):
        opc = hier.levels[k + 1]
        if hasattr(opc, "restrict_into"):
            bs.append(opc.restrict_into(bs[-1], hier.levels[k]))
        else:
            bs.append(_restrict(bs[-1], hier.levels[k].n, _tshape(opc),
                                cfg, getattr(hier.levels[k], "ndim", 2),
                                box=getattr(opc, "box", None)))
    return bs


def fmg(hier: Hierarchy, cfg: MultigridConfig, b_fine,
        b_levels: Optional[Sequence] = None):
    """Full multigrid: coarsest solve, then prolong + nu0 cycles per level.

    Reference: ``fullmultigrid`` (``Poissons_SYCL.cpp:629-650``), which runs
    31 V-cycles per level; here the per-level cycle count is ``cfg.nu0``.
    """
    bs = fmg_rhs_hierarchy(hier, cfg, b_fine, b_levels)
    kc = hier.num_levels - 1
    opc = hier.levels[kc]
    u = _zeros(opc, b_fine.dtype)
    u = _coarsest_solve(hier, cfg, u, bs[kc])
    for _ in range(max(cfg.nu0 - 1, 0) if cfg.coarse_solver == "smooth" else 0):
        u = _coarsest_solve(hier, cfg, u, bs[kc])
    for k in range(kc - 1, -1, -1):
        # FMG solution interpolation (as 0 + P u).
        zero = _zeros(hier.levels[k], u.dtype)
        if hasattr(hier.levels[k + 1], "prolong_add_into"):
            u = hier.levels[k + 1].prolong_add_into(zero, u,
                                                    hier.levels[k])
        else:
            u = _prolong_add(zero, u, hier.levels[k + 1].n,
                             _tshape(hier.levels[k]),
                             cfg, getattr(hier.levels[k], "ndim", 2),
                             box=getattr(hier.levels[k], "box", None))
        for _ in range(cfg.nu0):
            u = cycle(hier, cfg, u, bs[k], k)
    return u


# ---------------------------------------------------------------------------
# Convergence-driven solve drivers
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SolveResult:
    """Solution + observability the reference never had (SURVEY.md §5).

    ``u``: padded (S, S) solution grid at the finest level.
    ``res_history``: residual L2 norm before the solve and after each cycle
    (length ``cycles + 1``; NaN-padded in until-tol mode).
    ``iterations``: cycles actually run.
    ``converged``: whether the tolerance was met (always True in fixed mode).
    """

    u: Any
    res_history: Any
    iterations: Any
    converged: Any

    @property
    def stalled(self):
        """True when the solve stopped from stall detection (the iterate hit
        its precision floor) rather than tolerance or the cycle budget."""
        import numpy as np
        hist = np.asarray(self.res_history)
        n = int(self.iterations)
        if bool(self.converged) or n + 1 >= hist.shape[0]:
            return False
        # the driver stops early only on stall
        return bool(np.isnan(hist[n + 1:]).all())


def solve_fixed(hier: Hierarchy, cfg: MultigridConfig, b, num_cycles: int,
                u0=None) -> SolveResult:
    """Run exactly ``num_cycles`` cycles, recording the residual history."""
    op = hier.levels[0]
    u = u0 if u0 is not None else _zeros(op, b.dtype)
    hist = jnp.full((num_cycles + 1,), jnp.nan, jnp.float32)
    hist = hist.at[0].set(ops.norm2(op.residual(u, b)))

    def body(i, carry):
        u, hist = carry
        u, rnorm = cycle_with_norm(hier, cfg, u, b)
        hist = hist.at[i + 1].set(rnorm)
        return u, hist

    u, hist = jax.lax.fori_loop(0, num_cycles, body, (u, hist))
    return SolveResult(u=u, res_history=hist,
                       iterations=jnp.asarray(num_cycles, jnp.int32),
                       converged=jnp.asarray(True))


def solve_until_tol(hier: Hierarchy, cfg: MultigridConfig, b, *, tol: float,
                    max_cycles: int = 100, relative: bool = True,
                    u0=None, stall_factor: float = 0.9,
                    r0_norm=None) -> SolveResult:
    """Cycle until the residual norm drops below ``tol`` (relative to the
    initial residual by default), stalls, or ``max_cycles`` is hit.

    This is the convergence criterion the reference lacks entirely — it runs
    a fixed cycle count and never computes a residual norm
    (``Poissons_SYCL.cpp:575-650``).

    Stall detection: when TWO CONSECUTIVE cycles each reduce the residual
    by less than ``stall_factor`` (i.e. ``r_new > stall_factor * r_old``
    twice in a row), the iterate has hit its precision floor (for f32
    storage: ~eps * ||u|| / h^2 relative to ||b||) and further cycles are
    wasted work; the loop exits with ``converged=False``.  Requiring two
    consecutive non-progressing cycles keeps one atypical cycle — e.g.
    the slow first cycle of recirculating convection-diffusion
    (rho_1 ~ 0.97, asymptotic rho ~ 0.56) — from killing a converging
    solve.  Set ``stall_factor=1.0`` to (effectively) disable.
    """
    op = hier.levels[0]
    u = u0 if u0 is not None else _zeros(op, b.dtype)
    r0 = ops.norm2(op.residual(u, b))
    # ``r0_norm`` overrides the reference norm for the relative target —
    # e.g. when resuming from a checkpoint, the original solve's initial
    # residual, so the tolerance doesn't rebaseline to the resumed iterate.
    rbase = jnp.asarray(r0_norm, jnp.float32) if r0_norm is not None else r0
    target = tol * rbase if relative else jnp.asarray(tol, jnp.float32)
    target = jnp.maximum(target, jnp.asarray(0.0, jnp.float32))

    hist = jnp.full((max_cycles + 1,), jnp.nan, jnp.float32)
    hist = hist.at[0].set(r0)
    sf = jnp.asarray(stall_factor, jnp.float32)

    def cond(carry):
        _, i, rnorm, stalls, _ = carry
        return (i < max_cycles) & (rnorm > target) & (stalls < 2)

    def body(carry):
        u, i, rnorm, stalls, hist = carry
        u, rnew = cycle_with_norm(hier, cfg, u, b)
        hist = hist.at[i + 1].set(rnew)
        stalls = jnp.where(rnew > sf * rnorm, stalls + 1,
                           jnp.zeros_like(stalls))
        return u, i + 1, rnew, stalls, hist

    u, iters, rnorm, _, hist = jax.lax.while_loop(
        cond, body, (u, jnp.asarray(0, jnp.int32), r0,
                     jnp.asarray(0, jnp.int32), hist))
    return SolveResult(u=u, res_history=hist, iterations=iters,
                       converged=rnorm <= target)
