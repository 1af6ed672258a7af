"""Compensated (double-single) iterative refinement for deep f32 solves.

With FEM scaling (b ~ h^2, u ~ O(1)), an f32-stored iterate has an inherent
residual-evaluation floor of ~eps_f32 * ||A|| * ||u|| — at 8193^2 that is
~0.5 *relative* to ||b||, so plain f32 cannot even measure convergence past
the first cycle, and 1e-8 relative targets are unreachable without a wider
iterate.

This module gets f64-like residual depth out of pure f32 storage:

* the iterate is kept in **double-single** form u = u_hi + u_lo (two f32
  arrays, an unevaluated sum with |u_lo| <~ eps*|u_hi|);
* the residual r = b - A(u_hi + u_lo) is evaluated with error-free
  transformations (TwoSum/Neumaier compensation; 4*u_hi is exact since
  multiplying by 4 only shifts the exponent), accurate to ~eps^2;
* the outer loop is classic iterative refinement with one multigrid cycle
  as the inner solver: e = MG(r); u += e (compensated accumulation).

Per-iteration convergence equals the cycle's factor; each iteration costs
one V-cycle plus one compensated residual (~8 f32 passes).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .config import MultigridConfig
from .core import ops
from .core.grids import Hierarchy
from .cycles import SolveResult, cycle


def _two_sum(a, b):
    """Knuth TwoSum: s + e == a + b exactly (6 flops)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a, b):
    """Fast TwoSum, requires |a| >= |b|: s + e == a + b exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def ds_add(hi, lo, y):
    """(hi + lo) + y in double-single form (y a plain f32 array)."""
    s, e = _two_sum(hi, y)
    lo2 = lo + e
    return _quick_two_sum(s, lo2)


def _neighbor_sum_compensated(u):
    """Sum of the 2d shifted copies of u with Neumaier compensation
    (four in 2D, six in 3D — dispatched on ``u.ndim``).

    Returns (s, c) with s + c == exact sum to ~eps^2.
    """
    axes = range(-u.ndim, 0) if u.ndim == 3 else (-2, -1)
    terms = []
    for ax in axes:
        terms.append(jnp.roll(u, 1, axis=ax))
        terms.append(jnp.roll(u, -1, axis=ax))
    s = terms[0]
    c = jnp.zeros_like(u)
    for t in terms[1:]:
        s, e = _two_sum(s, t)
        c = c + e
    return s, c


def _mask_nd(r, n):
    if r.ndim == 3:
        from .core import ops3d
        return ops3d.mask_interior3(r, n)
    return ops.mask_interior(r, n)


def _nbr_nd(u):
    if u.ndim == 3:
        from .core import ops3d
        return ops3d.neighbor_sum3(u)
    return ops.neighbor_sum(u)


def _diag_terms(u):
    """-(diag * u) as a list of EXACT products: [-4u] in 2D; [-4u, -2u]
    in 3D (6u itself rounds — 6 is not a power of two — but 4u and 2u are
    exponent shifts, so the cascade can keep the split exact)."""
    if u.ndim == 3:
        return [-4.0 * u, -2.0 * u]
    return [-4.0 * u]


def _ds_cascade(b, u_hi, nbr_hi, nbr_c, a_lo):
    """The ds-residual TwoSum cascade, given precomputed neighbor sums.

    Shared between the single-chip rolls path (:func:`ds_residual`) and
    the shard-local halo path (``dist.refine``) so both evaluate
    BITWISE-identical arithmetic.  Cascade with TwoSum: a plain sum
    rounds at eps*max|term| ~ eps^2*|diag*u| per node, which against
    b ~ f*h^2 floors the achievable reduction at ~eps^2*n^2*|u| (about
    5e-8 at 16385^2); the cascade leaves only
    eps-relative error in r itself.
    """
    # r = b + nbr_hi - diag*u_hi  (the large, cancelling terms)
    s, e1 = _two_sum(b, nbr_hi)
    errs = [e1]
    for t in _diag_terms(u_hi):
        s, e = _two_sum(s, t)
        errs.append(e)
    # Small corrections: compensation of the neighbor sum, the TwoSum
    # errors, and the full A(u_lo) term (u_lo is rough rounding noise, so
    # its f32 apply is eps-relative-accurate — no cancellation).
    cs = []
    for t in errs + [nbr_c, -a_lo]:
        s, c = _two_sum(s, t)
        cs.append(c)
    tail = cs[-1]
    for c in cs[-2::-1]:
        tail = c + tail
    return s + tail


def ds_residual(b, u_hi, u_lo, n):
    """r = b - A(u_hi + u_lo) with ~eps^2 accuracy, returned as f32.

    diag*u_hi enters as exact power-of-two products (2D: 4u; 3D: 4u + 2u
    — see :func:`_diag_terms`); the neighbor sum of u_hi is compensated;
    A(u_lo) in plain f32 contributes only an O(eps^2) error.  2D/3D
    dispatch on ``b.ndim``.
    """
    diag = 2.0 * b.ndim
    nbr_hi, nbr_c = _neighbor_sum_compensated(u_hi)
    a_lo = diag * u_lo - _nbr_nd(u_lo)
    r = _ds_cascade(b, u_hi, nbr_hi, nbr_c, a_lo)
    return _mask_nd(r.astype(b.dtype), n)


def _two_sum_arrays(a, b):
    return _two_sum(a, b)


def prolong_comp(ec, nc: int, Sf: int):
    """Bilinear prolongation with an exact error term: P ec == hi + err.

    All P weights are dyadic (1, 1/2, 1/4), so the only rounding happens in
    the 2- and 4-point neighbor sums — captured with TwoSum and returned as
    ``err``; the final scalings by 0.5/0.25 are exponent shifts (exact).
    This is what lets a double-single correction pass *up* the hierarchy
    without losing its low-order part to f32 storage rounding (ROADMAP r1
    #4: at 16385^2 the correction is ~1e7 x the defect, so plain-f32
    prolongation rounding alone injects noise above the defect scale).
    """
    from .core.ops import mask_interior

    Sc = ec.shape[-1]
    nf = 2 * nc
    m = min(Sc, (Sf + 1) // 2)
    e = ec[..., :m, :m]
    hi = jnp.zeros((Sf, Sf), ec.dtype)
    err = jnp.zeros((Sf, Sf), ec.dtype)
    lim = 2 * m - 1
    # even-even: injection, exact
    hi = hi.at[0:lim:2, 0:lim:2].set(e)
    # odd rows: 0.5*(a+b); TwoSum the add, halve both parts (exact)
    s, t = _two_sum(e[:-1, :], e[1:, :])
    hi = hi.at[1: lim - 1: 2, 0:lim:2].set(0.5 * s)
    err = err.at[1: lim - 1: 2, 0:lim:2].set(0.5 * t)
    s, t = _two_sum(e[:, :-1], e[:, 1:])
    hi = hi.at[0:lim:2, 1: lim - 1: 2].set(0.5 * s)
    err = err.at[0:lim:2, 1: lim - 1: 2].set(0.5 * t)
    # odd-odd: 0.25*(a+b+c+d) with compensated 4-term sum
    s1, t1 = _two_sum(e[:-1, :-1], e[:-1, 1:])
    s2, t2 = _two_sum(e[1:, :-1], e[1:, 1:])
    s, t3 = _two_sum(s1, s2)
    hi = hi.at[1: lim - 1: 2, 1: lim - 1: 2].set(0.25 * s)
    err = err.at[1: lim - 1: 2, 1: lim - 1: 2].set(
        0.25 * (t1 + t2 + t3))
    return mask_interior(hi, nf), mask_interior(err, nf)


def prolong_comp3(ec, nc: int, shape_f):
    """Trilinear prolongation with an exact error term: P ec == hi + err.

    3D analogue of :func:`prolong_comp`, built on the interleave machinery
    (``core.ops3d.prolong3``).  All P weights are dyadic (1, 1/2, 1/4,
    1/8): the corner sums are TwoSum-cascaded and the scalings are
    exponent shifts, so ``hi + err`` equals P ec to ~eps^2.
    """
    from .core import ops3d

    shf = ops3d._shape3(shape_f)
    nf = 2 * nc
    m = tuple(min(ec.shape[ax], (shf[ax] + 1) // 2) for ax in range(3))
    e = ec[: m[0], : m[1], : m[2]]

    def shifted(v, ax):
        lo = [slice(None)] * 3
        lo[ax] = slice(1, None)
        pad = [(0, 0)] * 3
        pad[ax] = (0, 1)
        return jnp.pad(v[tuple(lo)], pad)

    def phase(pz, py, px):
        terms = [e]
        for ax, pp in ((0, pz), (1, py), (2, px)):
            if pp:
                terms = terms + [shifted(t, ax) for t in terms]
        s = terms[0]
        errs = []
        for t in terms[1:]:
            s, e2 = _two_sum(s, t)
            errs.append(e2)
        scale = jnp.asarray(1.0 / len(terms), ec.dtype)
        err = scale * sum(errs) if errs else jnp.zeros_like(s)
        return scale * s, err

    def interleave(ph):
        ix = ops3d._interleave_axis
        s = []
        for pk in (0, 1):
            t0 = ix(ph[(0, 0, pk)], ph[(1, 0, pk)], 0)
            t1 = ix(ph[(0, 1, pk)], ph[(1, 1, pk)], 0)
            s.append(ix(t0, t1, 1))
        f = ix(s[0].transpose(2, 0, 1), s[1].transpose(2, 0, 1),
               0).transpose(1, 2, 0)
        f = f[tuple(slice(0, min(2 * m[ax], shf[ax])) for ax in range(3))]
        pad = [(0, shf[ax] - f.shape[ax]) for ax in range(3)]
        if any(p != (0, 0) for p in pad):
            f = jnp.pad(f, pad)
        return ops3d.mask_interior3(f, nf)

    his, errs = {}, {}
    for pz in (0, 1):
        for py in (0, 1):
            for px in (0, 1):
                his[(pz, py, px)], errs[(pz, py, px)] = phase(pz, py, px)
    return interleave(his), interleave(errs)


def cycle_ds(hier: Hierarchy, cfg: MultigridConfig, r, k: int = 0,
             ds_levels: int = 3):
    """One V-cycle on the defect equation A e = r, returning e as a
    double-single pair (e_hi, e_lo).

    Plain f32 cycles stall at 16385^2 because the correction's magnitude is
    up to ~n^2/(2 pi^2) times the defect's: (a) evaluating A(e + P e_c) for
    the post-smooth cancels catastrophically, and (b) merely *storing* the
    prolonged correction in f32 rounds in noise above the defect scale.
    Here, on the finest ``ds_levels``
    levels:

    * pre-smoothing and the restricted defect stay plain f32 (the
      pre-smoothed iterate is defect-scale — no cancellation);
    * the sub-level correction comes back as a ds pair, is prolonged with
      an exact error term (:func:`prolong_comp`), and accumulates via
      TwoSum;
    * post-smoothing runs in *delta form*: the defect of the accumulated
      pair is evaluated compensated (:func:`ds_residual`), then smoothed
      from zero in f32 (small scale), and the delta is ds-added.

    Below ``ds_levels`` the amplification ratio eps*n^2 is harmless and the
    plain cycle runs unchanged.  Cost: ~2x a plain cycle on the ds levels.
    Only the V-cycle shape is supported (the refined driver's inner solve).
    """
    from .cycles import _coarsest_solve, _restrict, _smooth, _smooth_residual
    from .cycles import cycle as plain_cycle

    op = hier.levels[k]
    if k >= ds_levels or k == hier.num_levels - 1:
        if k == hier.num_levels - 1:
            e = _coarsest_solve(hier, cfg, jnp.zeros_like(r), r)
        else:
            e = plain_cycle(hier, cfg, jnp.zeros_like(r), r, k=k)
        return e, jnp.zeros_like(e)

    opc = hier.levels[k + 1]
    ndim = getattr(op, "ndim", 2)
    e0, r1 = _smooth_residual(op, jnp.zeros_like(r), r, cfg, cfg.nu1)
    from .cycles import _tshape
    rc = _restrict(r1, op.n, _tshape(opc), cfg, ndim)
    ec_hi, ec_lo = cycle_ds(hier, cfg, rc, k + 1, ds_levels)
    # Prolong the pair.
    if ndim == 3:
        from .core import ops3d
        p_hi, p_err = prolong_comp3(ec_hi, opc.n, op.grid_shape)
        p_lo = ops3d.prolong3(ec_lo, opc.n, op.grid_shape) + p_err
    else:
        p_hi, p_err = prolong_comp(ec_hi, opc.n, op.S)
        p_lo = ops.prolong(ec_lo, opc.n, op.S) + p_err
    # accumulate: (p_hi, p_lo) + e0, exactly
    e_hi, e_lo = ds_add(p_hi, p_lo, e0)
    # post-smooth in delta form against the compensated defect
    d0 = ds_residual(r, e_hi, e_lo, op.n)
    delta = _smooth(op, jnp.zeros_like(d0), d0, cfg, cfg.nu2)
    return ds_add(e_hi, e_lo, delta)


def _ts_renorm(a, b, c):
    """Renormalize three roughly-ordered components to a ts triple."""
    s, t = _two_sum(b, c)
    hi, t2 = _two_sum(a, s)
    mid, lo = _quick_two_sum(t2, t)
    return hi, mid, lo


def ts_add(hi, mid, lo, y):
    """(hi + mid + lo) + y in triple-single form (y a plain f32 array)."""
    s1, e1 = _two_sum(hi, y)
    s2, e2 = _two_sum(mid, e1)
    s3 = lo + e2
    return _ts_renorm(s1, s2, s3)


def ts_residual(b, u_hi, u_mid, u_lo, n):
    """r = b - A(u_hi + u_mid + u_lo) to ~eps^3 accuracy, returned f32.

    Why triple-single: a double-single iterate represents u to ~eps^2*|u|
    per node; through A's per-node cancellation (b ~ f*h^2 while |u| ~ 1)
    that floors the measurable relative reduction at ~eps^2*|u|*n^2/4 —
    about 1.25e-8 at 8193^2 and ~5e-8 at 16385^2.
    The third component pushes the representation floor to ~eps^3*n^2,
    far below 1e-8 at any feasible grid.  A(u_mid) needs the compensated
    neighbor sum too (u_mid is rough, |A u_mid| ~ 8*eps*|u| evaluated in
    f32 would round at ~eps^2*|u| — exactly the old floor); A(u_lo) in
    plain f32 is eps-relative-accurate and harmless.  2D/3D dispatch on
    ``b.ndim`` (3D splits 6u into the exact 4u + 2u, _diag_terms).
    """
    diag = 2.0 * b.ndim
    nbr_h, c_h = _neighbor_sum_compensated(u_hi)
    nbr_m, c_m = _neighbor_sum_compensated(u_mid)
    a_l = diag * u_lo - _nbr_nd(u_lo)
    r = _ts_cascade(b, u_hi, u_mid, nbr_h, c_h, nbr_m, c_m, a_l)
    return _mask_nd(r.astype(b.dtype), n)


def _ts_cascade(b, u_hi, u_mid, nbr_h, c_h, nbr_m, c_m, a_l):
    """The ts-residual TwoSum cascade (see :func:`_ds_cascade`)."""
    s, e1 = _two_sum(b, nbr_h)
    errs = [e1]
    for t in _diag_terms(u_hi):
        s, e = _two_sum(s, t)
        errs.append(e)
    s, e3 = _two_sum(s, nbr_m)
    errs.append(e3)
    for t in _diag_terms(u_mid):
        s, e = _two_sum(s, t)
        errs.append(e)
    cs = []
    for t in errs + [c_h, c_m, -a_l]:
        s, c = _two_sum(s, t)
        cs.append(c)
    tail = cs[-1]
    for c in cs[-2::-1]:
        tail = c + tail
    return s + tail


def solve_refined_ts(hier: Hierarchy, cfg: MultigridConfig, b, *,
                     tol: Optional[float] = 1e-8, max_iters: int = 60,
                     stall_factor: float = 0.9,
                     num_cycles: Optional[int] = None,
                     ds_levels: int = 3):
    """Triple-single refinement: (u_hi, u_mid, u_lo, hist, iters, ok).

    The outer iterate is a ts triple (representation floor ~eps^3); the
    inner correction cycle runs with double-single corrections on the
    finest ``ds_levels`` levels (:func:`cycle_ds`).  This is what lets a
    pure-f32 solve measure 1e-8 relative reductions at 16385^2, past
    both the plain-f32 floor (~0.5 relative there) and the double-single
    floor (~5e-8).
    """
    if tol is None and num_cycles is None:
        raise ValueError("need tol or num_cycles")
    op = hier.levels[0]
    fixed = num_cycles is not None
    ncyc = num_cycles if fixed else max_iters
    u_hi = jnp.zeros(getattr(op, "grid_shape", (op.S, op.S)), b.dtype)
    u_mid = jnp.zeros_like(u_hi)
    u_lo = jnp.zeros_like(u_hi)
    r = b
    r0 = ops.norm2(r)
    target = (jnp.asarray(tol, jnp.float32) * r0 if tol is not None
              else jnp.asarray(0.0, jnp.float32))
    hist = jnp.full((ncyc + 1,), jnp.nan, jnp.float32).at[0].set(r0)

    def condf(carry):
        _, _, _, _, i, rnorm, prev, _ = carry
        keep = i < ncyc
        if not fixed:
            progressing = (rnorm
                           < jnp.asarray(stall_factor, jnp.float32) * prev)
            keep &= (rnorm > target) & progressing
        return keep

    def body(carry):
        u_hi, u_mid, u_lo, r, i, rnorm, _, hist = carry
        if ds_levels > 0:
            e_hi, e_lo = cycle_ds(hier, cfg, r, ds_levels=ds_levels)
            u_hi, u_mid, u_lo = ts_add(u_hi, u_mid, u_lo, e_hi)
            u_hi, u_mid, u_lo = ts_add(u_hi, u_mid, u_lo, e_lo)
        else:
            e = cycle(hier, cfg, jnp.zeros_like(r), r)
            u_hi, u_mid, u_lo = ts_add(u_hi, u_mid, u_lo, e)
        r = ts_residual(b, u_hi, u_mid, u_lo, op.n)
        rnew = ops.norm2(r)
        hist = hist.at[i + 1].set(rnew)
        return u_hi, u_mid, u_lo, r, i + 1, rnew, rnorm, hist

    inf = jnp.asarray(jnp.inf, jnp.float32)
    u_hi, u_mid, u_lo, r, iters, rnorm, _, hist = jax.lax.while_loop(
        condf, body,
        (u_hi, u_mid, u_lo, r, jnp.asarray(0, jnp.int32), r0, inf, hist))
    conv = jnp.asarray(True) if fixed else rnorm <= target
    return u_hi, u_mid, u_lo, hist, iters, conv


def solve_refined(hier: Hierarchy, cfg: MultigridConfig, b, *,
                  tol: Optional[float] = 1e-8, max_iters: int = 60,
                  stall_factor: float = 0.9,
                  num_cycles: Optional[int] = None,
                  u0=None, u0_lo=None, r0_norm=None) -> SolveResult:
    """Iterative refinement: MG cycle on the compensated defect equation.

    Reaches relative residual reductions far below the plain-f32 floor
    (~1e-10 at moderate grids) with pure f32 storage and f32 kernels.
    Returns a SolveResult whose ``u`` is the high-order part of the
    double-single iterate (use :func:`solve_refined_ds` for both parts).

    ``num_cycles`` forces a fixed iteration count (no tol/stall exit),
    matching :func:`cycles.solve_fixed` semantics.  ``u0``/``u0_lo`` seed the
    double-single iterate (e.g. an FMG initial guess / checkpoint resume);
    ``r0_norm`` keeps the original solve's relative-tolerance baseline when
    resuming.
    """
    u_hi, u_lo, hist, iters, conv = solve_refined_ds(
        hier, cfg, b, tol=tol, max_iters=max_iters,
        stall_factor=stall_factor, num_cycles=num_cycles,
        u0=u0, u0_lo=u0_lo, r0_norm=r0_norm)
    return SolveResult(u=u_hi, res_history=hist, iterations=iters,
                       converged=conv)


def solve_refined_ds(hier: Hierarchy, cfg: MultigridConfig, b, *,
                     tol: Optional[float] = 1e-8, max_iters: int = 60,
                     stall_factor: float = 0.9,
                     num_cycles: Optional[int] = None,
                     u0=None, u0_lo=None, r0_norm=None,
                     ds_levels: int = 0, inner_dtype=None):
    """Full double-single refinement state: (u_hi, u_lo, hist, iters, ok).

    ``ds_levels > 0`` runs the inner correction cycle with double-single
    corrections on that many finest levels (:func:`cycle_ds`) — required
    for deep tolerances at 16385^2+, where the plain-f32 inner cycle's
    storage rounding of the correction stalls the refinement.

    ``inner_dtype`` (e.g. ``jnp.bfloat16``) runs the inner correction
    cycle entirely in that storage dtype — BASELINE config 3's
    "low-precision smoothing with high-precision residual correction" in
    its strongest form: the bf16 cycle's ~0.4% relative correction error
    just becomes the next iteration's (exactly-evaluated) defect, so the
    per-iteration rate only degrades from ~0.11 to ~max(rate, 0.03) while
    the cycle's HBM traffic halves.  Incompatible with ``ds_levels``.
    """
    if inner_dtype is not None and ds_levels > 0:
        raise ValueError("inner_dtype and ds_levels are mutually exclusive")
    if tol is None and num_cycles is None:
        raise ValueError(
            "refined solve needs either tol (until-tol mode) or "
            "num_cycles (fixed-count mode); got tol=None, num_cycles=None")
    op = hier.levels[0]
    fixed = num_cycles is not None
    ncyc = num_cycles if fixed else max_iters

    if u0 is not None:
        u_hi = u0.astype(b.dtype)
        u_lo = (u0_lo.astype(b.dtype) if u0_lo is not None
                else jnp.zeros_like(u_hi))
        r = ds_residual(b, u_hi, u_lo, op.n)
    else:
        u_hi = jnp.zeros(getattr(op, "grid_shape", (op.S, op.S)), b.dtype)
        u_lo = jnp.zeros_like(u_hi)
        r = b
    r0 = ops.norm2(r)
    rbase = jnp.asarray(r0_norm, jnp.float32) if r0_norm is not None else r0
    target = (jnp.asarray(tol, jnp.float32) * rbase if tol is not None
              else jnp.asarray(0.0, jnp.float32))
    hist = jnp.full((ncyc + 1,), jnp.nan, jnp.float32).at[0].set(r0)

    def condf(carry):
        _, _, _, i, rnorm, prev, _ = carry
        keep = i < ncyc
        if not fixed:
            progressing = (rnorm
                           < jnp.asarray(stall_factor, jnp.float32) * prev)
            keep &= (rnorm > target) & progressing
        return keep

    def body(carry):
        u_hi, u_lo, r, i, rnorm, _, hist = carry
        if ds_levels > 0:
            e_hi, e_lo = cycle_ds(hier, cfg, r, ds_levels=ds_levels)
            u_hi, u_lo = ds_add(u_hi, u_lo, e_hi)
            u_hi, u_lo = ds_add(u_hi, u_lo, e_lo)
        elif inner_dtype is not None:
            import dataclasses as _dc
            icfg = _dc.replace(cfg, dtype=inner_dtype, smooth_dtype=None)

            # The FIRST iteration's defect (r = b) is smooth: the inner
            # solve amplifies it by ~n^2/2pi^2, so bf16 storage noise on
            # the correction (rough, ~0.4% relative) would blow past the
            # defect scale — run it in f32.  Later defects are rounding
            # noise (rough, O(1) amplification), where the bf16 cycle's
            # error merely floors the per-iteration rate at ~3%.
            def f32_cycle(r):
                return cycle(hier, cfg, jnp.zeros_like(r), r)

            def bf_cycle(r):
                rl = r.astype(inner_dtype)
                return cycle(hier, icfg, jnp.zeros_like(rl),
                             rl).astype(b.dtype)

            e = jax.lax.cond(i == 0, f32_cycle, bf_cycle, r)
            u_hi, u_lo = ds_add(u_hi, u_lo, e)
        else:
            e = cycle(hier, cfg, jnp.zeros_like(r), r)
            u_hi, u_lo = ds_add(u_hi, u_lo, e)
        r = ds_residual(b, u_hi, u_lo, op.n)
        rnew = ops.norm2(r)
        hist = hist.at[i + 1].set(rnew)
        return u_hi, u_lo, r, i + 1, rnew, rnorm, hist

    inf = jnp.asarray(jnp.inf, jnp.float32)
    u_hi, u_lo, r, iters, rnorm, _, hist = jax.lax.while_loop(
        condf, body,
        (u_hi, u_lo, r, jnp.asarray(0, jnp.int32), r0, inf, hist))
    conv = jnp.asarray(True) if fixed else rnorm <= target
    return u_hi, u_lo, hist, iters, conv
