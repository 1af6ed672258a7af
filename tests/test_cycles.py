"""Convergence tests (SURVEY.md §4 tier 2): per-cycle residual reduction,
grid-size-independent cycle counts, W/F/FMG schedules, mixed precision."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_multigrid import (MultigridConfig, PoissonProblem, fmg, solve_fixed,
                           solve_until_tol)
from tpu_multigrid.core import ops


def _cfg(**kw):
    base = dict(finest_level=6, coarsest_level=3, nu1=2, nu2=2,
                dtype=jnp.float64)
    base.update(kw)
    return MultigridConfig(**base)


def _reduction_factors(cfg, num_cycles=8):
    prob = PoissonProblem(cfg)
    b = prob.rhs()
    res = jax.jit(lambda b: solve_fixed(prob.hierarchy, cfg, b, num_cycles))(b)
    h = np.asarray(res.res_history)
    return h[1:] / h[:-1]


def test_vcycle_textbook_convergence_jacobi():
    """~0.1-0.2 residual reduction per V-cycle with (2,2) weighted Jacobi."""
    f = _reduction_factors(_cfg())
    assert np.all(f < 0.25), f
    assert np.mean(f) < 0.22, f


def test_vcycle_convergence_rbgs():
    """Red-black GS (1,1) beats Jacobi (2,2)."""
    f = _reduction_factors(_cfg(smoother="rbgs", nu1=1, nu2=1))
    assert np.all(f < 0.15), f


def test_wcycle_and_fcycle_converge():
    for c in ("W", "F"):
        f = _reduction_factors(_cfg(cycle=c))
        assert np.all(f < 0.25), (c, f)


def test_coarse_smooth_mode_converges():
    """Reference-v1 coarsest treatment: extra smoothing instead of a direct
    solve (Poissons_SYCL.cpp:583-587)."""
    f = _reduction_factors(_cfg(coarse_solver="smooth",
                                coarse_smooth_sweeps=20))
    # Smoothing never fully solves the coarsest problem, so the asymptotic
    # factor is worse than with a direct solve (~0.2) but still bounded.
    assert np.all(f < 0.45), f


def test_cycle_count_grid_independent():
    """O(N) optimality: cycles to 1e-8 must not grow with grid size."""
    iters = []
    for lvl in (5, 6, 7):
        cfg = _cfg(finest_level=lvl)
        prob = PoissonProblem(cfg)
        b = prob.rhs()
        res = jax.jit(lambda b: solve_until_tol(
            prob.hierarchy, cfg, b, tol=1e-8, max_cycles=40))(b)
        assert bool(res.converged)
        iters.append(int(res.iterations))
    assert max(iters) - min(iters) <= 2, iters


def test_fmg_then_vcycles_converges():
    cfg = _cfg()
    prob = PoissonProblem(cfg)
    b = prob.rhs()

    @jax.jit
    def run(b):
        u0 = fmg(prob.hierarchy, cfg, b)
        r0 = ops.norm2(prob.finest.residual(u0, b))
        res = solve_until_tol(prob.hierarchy, cfg, b, tol=1e-10,
                              max_cycles=30, u0=u0)
        return r0, res

    r0, res = run(b)
    # One FMG pass (nu0=1) already reduces the residual well below the
    # zero-guess residual norm.
    b0 = float(ops.norm2(b))
    assert float(r0) < 0.05 * b0
    assert bool(res.converged)


def test_fmg_assembled_rhs_mode():
    """Reference-v2 FMG semantics: per-level assembled RHS
    (Multigrid_functions.cpp:184)."""
    cfg = _cfg(fmg_rhs="assemble", nu0=2)
    prob = PoissonProblem(cfg)
    b = prob.rhs()
    bl = prob.rhs_all_levels()
    u = jax.jit(lambda b, bl: fmg(prob.hierarchy, cfg, b, b_levels=bl))(b, bl)
    rr = float(ops.norm2(prob.finest.residual(u, b)) / ops.norm2(b))
    assert rr < 1e-2


def test_mixed_precision_bf16_smoothing():
    """bf16 smoothing with f32 residual correction still converges in a
    comparable cycle count (BASELINE config 3 mixed-precision scheme).

    Tolerance is 1e-4 relative: with FEM scaling (b ~ h^2, u ~ O(1)) the
    f32 residual-evaluation floor is ~eps_f32 * ||u|| / h^2 relative to
    ||b|| — about 3e-5 at level 6 — regardless of smoother precision.
    Deeper targets use f64 accumulation (see test_oracle_parity).
    """
    cfg32 = _cfg(dtype=jnp.float32)
    cfgbf = _cfg(dtype=jnp.float32, smooth_dtype=jnp.bfloat16)
    iters = {}
    for name, cfg in (("f32", cfg32), ("bf16", cfgbf)):
        prob = PoissonProblem(cfg)
        b = prob.rhs()
        res = jax.jit(lambda b: solve_until_tol(
            prob.hierarchy, cfg, b, tol=1e-4, max_cycles=60))(b)
        assert bool(res.converged), name
        iters[name] = int(res.iterations)
    assert iters["bf16"] <= 2 * iters["f32"] + 2, iters


def test_until_tol_stops_at_max_cycles():
    cfg = _cfg()
    prob = PoissonProblem(cfg)
    b = prob.rhs()
    res = jax.jit(lambda b: solve_until_tol(
        prob.hierarchy, cfg, b, tol=1e-30, max_cycles=3))(b)
    assert int(res.iterations) == 3
    assert not bool(res.converged)


def test_padded_hierarchy_matches_tight():
    """Alignment padding must not change the computed solution."""
    cfg = _cfg()
    tight = PoissonProblem(cfg)
    padded = PoissonProblem(cfg, align=16, min_pad_level=6)
    assert padded.hierarchy.levels[0].S == 80  # 65 -> 80
    bt, bp = tight.rhs(), padded.rhs()
    rt = jax.jit(lambda b: solve_fixed(tight.hierarchy, cfg, b, 6))(bt)
    rp = jax.jit(lambda b: solve_fixed(padded.hierarchy, cfg, b, 6))(bp)
    n = 64
    np.testing.assert_allclose(
        np.asarray(rp.u)[: n + 1, : n + 1],
        np.asarray(rt.u)[: n + 1, : n + 1], rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(rp.res_history),
                               np.asarray(rt.res_history), rtol=1e-10)


def test_fmg_until_tol_with_history():
    """FMG + until-tol composition (ROADMAP r1 #9): the FMG initial guess
    shrinks the cycle count and the history baseline reflects it."""
    from tpu_multigrid import solve_poisson

    cfg = _cfg(finest_level=6)
    cold = solve_poisson(6, config=cfg, tol=1e-10, max_cycles=40)
    warm = solve_poisson(6, config=cfg, tol=1e-10, max_cycles=40,
                         use_fmg=True)
    assert bool(cold.converged) and bool(warm.converged)
    # the FMG head start can't cost cycles (deep f64 tolerances converge at
    # the same asymptotic rate, so allow equality)
    assert int(warm.iterations) <= int(cold.iterations)
    hw = np.asarray(warm.res_history)
    hc = np.asarray(cold.res_history)
    assert hw[0] < 0.1 * hc[0]  # history starts from the FMG iterate
    # both trajectories are recorded without holes up to their iteration count
    assert np.isfinite(hw[: int(warm.iterations) + 1]).all()


