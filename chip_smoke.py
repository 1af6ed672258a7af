#!/usr/bin/env python
"""Smoke test of the 2D Poisson solve on one NVIDIA GPU.

Drives the public entry point ``solve_poisson`` at the single-card size,
8193^2 (level 13), f32, Chebyshev (3,2), coarsest level 5, and checks:

1. the card (JAX's devices; ``nvidia-smi`` name and power limit);
2. the main solve: 10 fixed V-cycles and FMG to a tolerance, against an
   f64 solve of the same problem on the card;
3. the fused CUDA level-visit kernels (K1, K2) at 8193^2 against the plain
   jnp level visit, and ``memory_analysis()`` of the jitted cycle;
4. f64 parity with the scipy oracle on the host at 1025^2;
5. ``solve_poisson3d`` with its default configuration.

``--four`` runs only the sharded solve (``mesh=make_grid_mesh()``) at
16385^2 over four cards against the same solve on one card.

Each phase prints one line; any failure raises, so the exit code is
non-zero.  Without a GPU the script exits non-zero before any phase.  The
last line of a passing run is one JSON object with the device.

Run on a GPU machine:  python chip_smoke.py   (or ``--four`` on 4 cards)
"""

import argparse
import json
import subprocess
import sys
import time

import jax
import numpy as np

# Tolerances, with the reason for each:
# - RHO_MAX: a Chebyshev(3,2) V-cycle on the 5-point Poisson stencil reduces
#   the residual by about 0.1 per cycle at every size; 0.15 leaves room for
#   the first cycles' transient.  It bounds the mathematics, not the card,
#   so it is read from the f64 solve: at 8193^2 the f32 residual sits at its
#   rounding floor from the first cycle on.
# - REFINED_VS_F64: the FMG solve with f32 storage and double-single
#   refinement to a relative residual of 1e-6, against the f64 solve.  For
#   this smooth solution the error follows the residual (both are dominated
#   by the smoothest mode), so 1e-6 relative is the bound the tolerance
#   itself sets; a wrong operator, transfer or kernel misses it by orders.
# - F32_FIXED_VS_F64: ten plain f32 cycles against the f64 solve.  The f32
#   iterate stops at a rounding floor that grows about 4x per level (about
#   n^2: rounding noise in the residual amplified by A^-1); 7.4e-4 at 2049^2
#   extrapolates to about 1e-2 at 8193^2, and the unfused XLA path measures
#   more (2e-1 on the card; the fused kernels round less often).  0.5 only
#   says the iterate is a solution at all; REFINED_VS_F64 is the accuracy
#   check.
# - KERNEL_VS_JNP: the fused kernels evaluate the same f32 expressions as
#   the jnp operators in the same order; the compiler may contract a
#   multiply-add into an FMA, so results differ by a few ulps per sweep.
# - FOUR_F64: ten f64 cycles reduce the residual by about 1e-10, so the
#   sharded and the one-card f64 iterates are both within about 1e-10 of
#   the discrete solution; 1e-9 leaves a decade for the different order of
#   the sums.
# - ORACLE: the BASELINE accuracy target for an f64 solve against the
#   assembled scipy system.
RHO_MAX = 0.15
REFINED_VS_F64 = 1e-6
F32_FIXED_VS_F64 = 0.5
KERNEL_VS_JNP = 1e-5
FOUR_F64 = 1e-9
ORACLE = 1e-10

LEVEL = 13          # 8193^2
LEVEL_FOUR = 14     # 16385^2 over four cards
ORACLE_LEVEL = 10   # 1025^2


def nvidia_smi() -> str:
    """Card name and power limit, read by a child process that stays off
    JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def config(level: int, dtype, use_kernels: bool):
    import tpu_multigrid as mg
    return mg.MultigridConfig(finest_level=level, coarsest_level=5, nu1=3,
                              nu2=2, smoother="chebyshev", dtype=dtype,
                              use_kernels=use_kernels)


def phase_card(devices):
    print(f"[card] jax.devices() = {devices}", flush=True)
    smi = nvidia_smi()
    print(f"[card] nvidia-smi name, power.limit: {smi}", flush=True)


def phase_solve(use_kernels: bool):
    import jax.numpy as jnp

    import tpu_multigrid as mg
    n = 2 ** LEVEL
    cfg32 = config(LEVEL, jnp.float32, use_kernels)
    t0 = time.perf_counter()
    res = mg.solve_poisson(LEVEL, config=cfg32, num_cycles=10, tol=None)
    u32 = np.asarray(mg.extract_solution(res.u, n))
    t32 = time.perf_counter() - t0
    h32 = np.asarray(res.res_history, np.float64)

    cfg64 = config(LEVEL, jnp.float64, False)
    res64 = mg.solve_poisson(LEVEL, config=cfg64, num_cycles=10, tol=None)
    u64 = np.asarray(mg.extract_solution(res64.u, n))
    h64 = np.asarray(res64.res_history, np.float64)
    # f32 residuals sit at their rounding floor from the first cycle at
    # this size, so the rate comes from the f64 trajectory of the same
    # cycle, over its first five cycles (the f64 residual floor, about
    # eps_f64 * n^2 relative, is near 1e-9 here); the f32 first-cycle
    # factor is printed beside it.
    rho64 = float((h64[5] / h64[0]) ** 0.2)
    check(np.isfinite(u32).all() and u32.shape == (n + 1, n + 1),
          "f32 solution not finite or misshapen")
    check(rho64 <= RHO_MAX, f"reduction per cycle {rho64:.4f} > {RHO_MAX}")
    diff = rel_l2(u32, u64)
    check(diff <= F32_FIXED_VS_F64,
          f"f32 vs f64 rel L2 {diff:.3e} > {F32_FIXED_VS_F64}")
    print(f"[solve] {n + 1}^2 f32 {'kernels' if use_kernels else 'jnp'}: "
          f"{int(res.iterations)} fixed cycles ({t32:.1f} s incl. compile), "
          f"f32 first-cycle reduction {h32[1] / h32[0]:.4f}; f64 on card: "
          f"reduction per cycle {rho64:.4f} over 5 cycles (<= {RHO_MAX}), "
          f"|r|/|r0| after 10 {h64[10] / h64[0]:.3e}; f32 vs f64 rel L2 "
          f"{diff:.3e} "
          f"(<= {F32_FIXED_VS_F64}, the f32 floor)", flush=True)

    fmg = mg.solve_poisson(LEVEL, config=cfg32, use_fmg=True, tol=1e-6,
                           max_cycles=20)
    hf = np.asarray(fmg.res_history, np.float64)
    it = int(fmg.iterations)
    check(bool(fmg.converged), f"FMG solve did not converge: {hf[:it + 1]}")
    ufmg = np.asarray(mg.extract_solution(fmg.u, n))
    dfmg = rel_l2(ufmg, u64)
    check(dfmg <= REFINED_VS_F64, f"FMG f32 vs f64 rel L2 {dfmg:.3e}")
    print(f"[solve] FMG + double-single refinement to tol 1e-6: converged "
          f"in {it} iterations, |r|/|r0| {hf[it] / hf[0]:.3e}; vs f64 rel "
          f"L2 {dfmg:.3e} (<= {REFINED_VS_F64})", flush=True)
    return u64


def phase_kernels():
    import jax.numpy as jnp

    import tpu_multigrid as mg
    from tpu_multigrid.core import ops
    from tpu_multigrid.cycles import _omegas, solve_fixed
    from tpu_multigrid.kernels import level2d

    n, S = 2 ** LEVEL, 2 ** LEVEL + 1
    nc, Sc = n // 2, n // 2 + 1
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    u = ops.mask_interior(jax.random.normal(k1, (S, S), jnp.float32), n)
    b = ops.mask_interior(jax.random.normal(k2, (S, S), jnp.float32), n)
    ec = ops.mask_interior(jax.random.normal(k3, (Sc, Sc), jnp.float32), nc)
    cfg = config(LEVEL, jnp.float32, True)
    w1, w2 = _omegas(cfg, cfg.nu1), _omegas(cfg, cfg.nu2)

    got = jax.jit(lambda u, b: level2d.smooth_restrict(u, b, n, Sc, w1))(u, b)
    ref = jax.jit(lambda u, b: level2d.reference_smooth_restrict(
        u, b, n, Sc, w1))(u, b)
    e_u, e_r = rel_l2(got[0], ref[0]), rel_l2(got[1], ref[1])
    check(max(e_u, e_r) <= KERNEL_VS_JNP, f"K1 vs jnp {e_u:.2e} {e_r:.2e}")
    got2 = jax.jit(lambda u, b, e: level2d.prolong_smooth(
        u, b, e, n, w2, resnorm=True))(u, b, ec)
    ref2 = jax.jit(lambda u, b, e: level2d.reference_prolong_smooth(
        u, b, e, n, w2, resnorm=True))(u, b, ec)
    e_u2 = rel_l2(got2[0], ref2[0])
    e_n = abs(float(got2[1]) - float(ref2[1])) / float(ref2[1])
    check(max(e_u2, e_n) <= KERNEL_VS_JNP, f"K2 vs jnp {e_u2:.2e} {e_n:.2e}")
    print(f"[kernels] {S}^2 random data, rel L2 vs jnp: K1 u {e_u:.2e}, "
          f"K1 rc {e_r:.2e}, K2 u {e_u2:.2e}, K2 norm {e_n:.2e} "
          f"(<= {KERNEL_VS_JNP})", flush=True)

    prob = mg.PoissonProblem(cfg)
    step = jax.jit(lambda h, b: solve_fixed(h, cfg, b, 1))
    ma = step.lower(prob.hierarchy, prob.rhs()).compile().memory_analysis()
    print(f"[kernels] memory_analysis of the jitted cycle: {ma}", flush=True)


def phase_oracle():
    import jax.numpy as jnp

    import tpu_multigrid as mg
    from tpu_multigrid import oracle
    n = 2 ** ORACLE_LEVEL
    cfg = mg.MultigridConfig(finest_level=ORACLE_LEVEL, coarsest_level=3,
                             nu1=3, nu2=2, smoother="chebyshev",
                             dtype=jnp.float64)
    res = mg.solve_poisson(ORACLE_LEVEL, config=cfg, tol=1e-13,
                           max_cycles=40)
    ud = np.asarray(mg.extract_solution(res.u, n))
    t0 = time.perf_counter()
    uo = oracle.solve_poisson_oracle(n)
    t_or = time.perf_counter() - t0
    err = rel_l2(ud, uo)
    check(err <= ORACLE, f"oracle parity {err:.3e} > {ORACLE}")
    print(f"[oracle] {n + 1}^2 f64 on card ({int(res.iterations)} cycles) vs "
          f"scipy on host ({t_or:.1f} s): rel L2 {err:.3e} (<= {ORACLE})",
          flush=True)


def phase_3d():
    import tpu_multigrid as mg
    res = mg.solve_poisson3d(8, tol=1e-3)
    h = np.asarray(res.res_history, np.float64)
    it = int(res.iterations)
    check(bool(res.converged), f"3D default solve did not converge: "
          f"{h[:it + 1]}")
    print(f"[3d] solve_poisson3d(8) default config (chebyshev 3,2, jnp): "
          f"converged to 1e-3 in {it} cycles, |r|/|r0| {h[it] / h[0]:.3e}",
          flush=True)


def phase_four():
    """The users' sharded solve, ``solve_poisson(..., mesh=make_grid_mesh())``,
    at 16385^2 over four cards against the same solve on one card, in f32
    and in f64.

    Both f32 runs stop at the f32 rounding floor (see F32_FIXED_VS_F64), so
    their difference is bounded by that floor; the f64 runs converge, so
    they must agree to FOUR_F64 — that comparison checks the halo exchange
    and the sharded levels."""
    import jax.numpy as jnp

    import tpu_multigrid as mg
    from tpu_multigrid.dist import make_grid_mesh
    devs = jax.devices()
    check(len(devs) == 4, f"--four needs 4 GPUs, found {len(devs)}")
    n = 2 ** LEVEL_FOUR
    mesh = make_grid_mesh()
    for dtype, bound in ((jnp.float32, F32_FIXED_VS_F64),
                         (jnp.float64, FOUR_F64)):
        cfg = config(LEVEL_FOUR, dtype, False)
        t0 = time.perf_counter()
        res = mg.solve_poisson(LEVEL_FOUR, config=cfg, mesh=mesh,
                               num_cycles=10, tol=None)
        jax.block_until_ready(res.u)
        t4 = time.perf_counter() - t0
        placed = sorted({s.device.id for s in res.u.addressable_shards})
        check(placed == sorted(d.id for d in devs),
              f"shards on devices {placed}, not on all four")
        stats = [d.memory_stats() for d in devs]
        used = [st.get("peak_bytes_in_use", 0) if st else None
                for st in stats]
        if all(stats):   # every GPU reports its allocator's statistics
            grid_bytes = (n + 1) ** 2 * jnp.dtype(dtype).itemsize
            check(min(used) >= grid_bytes // 8,
                  f"a card holds no share of the grid: peak bytes {used}")
        u4 = np.asarray(mg.extract_solution(res.u, n))
        h4 = np.asarray(res.res_history, np.float64)
        del res
        with jax.default_device(devs[0]):
            t0 = time.perf_counter()
            res1 = mg.solve_poisson(LEVEL_FOUR, config=cfg, num_cycles=10,
                                    tol=None)
            u1 = np.asarray(mg.extract_solution(res1.u, n))
            t1 = time.perf_counter() - t0
            del res1
        check(np.isfinite(u4).all(), "sharded solution not finite")
        diff = rel_l2(u4, u1)
        check(diff <= bound, f"4-card vs 1-card rel L2 {diff:.3e} > {bound}")
        name = jnp.dtype(dtype).name
        print(f"[four] {n + 1}^2 {name} over mesh "
              f"{tuple(mesh.devices.shape)} (shards on devices {placed}, "
              f"peak bytes per card {used}): 10 cycles, |r|/|r0| "
              f"{h4[10] / h4[0]:.3e}, {t4:.1f} s incl. compile; one card "
              f"{t1:.1f} s; 4-card vs 1-card rel L2 {diff:.3e} "
              f"(<= {bound})", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="only the sharded 16385^2 solve over four cards")
    p.add_argument("--no-kernels", dest="kernels", action="store_false",
                   help="run the main solve on the plain XLA path")
    args = p.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    # f64 references run on the card; every f32 array names its dtype.
    jax.config.update("jax_enable_x64", True)
    from tpu_multigrid.utils.profiling import enable_compilation_cache
    enable_compilation_cache()

    phase_card(devices)
    if args.four:
        phase_four()
    else:
        phase_solve(args.kernels)
        if args.kernels:
            phase_kernels()
        phase_oracle()
        phase_3d()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
