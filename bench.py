#!/usr/bin/env python
"""Benchmark harness: 2D Poisson V-cycle time and convergence on one GPU.

Times one V-cycle of the 8193^2 Chebyshev (3,2) problem (coarsest level 5)
on the host clock around work that ends in ``block_until_ready``, warm,
and records the convergence factor.  ``--tier both`` times the plain XLA
path and the fused CUDA level-visit kernels (``kernels.level2d``) in turns
in one process, plus one finest-level visit of each.

Prints the card's name and power limit, then ONE JSON line.  Exits non-zero
when JAX finds no GPU: a number from another device is not this program's.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit, read by a child process that
    stays off JAX."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def require_gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform} "
                         f"({dev.device_kind}); refusing to measure")
    return dev


def _time(fn, *args, repeats: int):
    """Median host-clock seconds of ``fn(*args)``, warm."""
    import jax
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def build(level: int, coarsest: int, nu1: int, nu2: int, smoother: str,
          use_kernels: bool):
    import jax.numpy as jnp

    from tpu_multigrid import MultigridConfig, PoissonProblem
    cfg = MultigridConfig(finest_level=level, coarsest_level=coarsest,
                          nu1=nu1, nu2=nu2, smoother=smoother,
                          dtype=jnp.float32, use_kernels=use_kernels)
    prob = PoissonProblem(cfg)
    return cfg, prob.hierarchy, prob.rhs()


def tier_fns(cfg, hier, b, cycles: int):
    """(V-cycle loop, finest level visit) for one tier, both jitted."""
    import jax
    import jax.numpy as jnp

    from tpu_multigrid.cycles import cycle

    @jax.jit
    def run(u, b):
        return jax.lax.fori_loop(0, cycles,
                                 lambda _, v: cycle(hier, cfg, v, b), u)

    # One finest-level visit with the coarse correction fixed at zero:
    # pre-smooth + residual + restrict, then prolong + correct + post-smooth.
    from tpu_multigrid import cycles as C
    op, opc = hier.levels[0], hier.levels[1]

    def one_visit(u, b):
        if C._use_level_kernels(op, opc, cfg, u.dtype):
            u, rc = C._k1(op, opc, cfg, u, b)
            return C._k2(op, cfg, u, b, jnp.zeros_like(rc))
        u, r = C._smooth_residual(op, u, b, cfg, cfg.nu1)
        rc = C._restrict(r, op.n, opc.S, cfg)
        u = C._prolong_add(u, jnp.zeros_like(rc), opc.n, op.S, cfg)
        return C._smooth(op, u, b, cfg, cfg.nu2)

    @jax.jit
    def visit(u, b):
        return jax.lax.fori_loop(0, cycles, lambda _, v: one_visit(v, b), u)

    return run, visit


def convergence(cfg, hier, b, cycles: int = 10):
    """Residual reduction per cycle over ``cycles`` fixed f32 cycles
    (geometric mean over the first five, before the f32 floor)."""
    import jax
    import numpy as np

    from tpu_multigrid.cycles import solve_fixed
    res = jax.jit(lambda h, b: solve_fixed(h, cfg, b, cycles))(hier, b)
    h = np.asarray(res.res_history, np.float64)
    k = min(5, cycles)
    return float((h[k] / h[0]) ** (1.0 / k)), h.tolist()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--level", type=int, default=13,
                   help="finest level (13 -> 8193^2, the BASELINE config)")
    p.add_argument("--coarsest", type=int, default=5)
    p.add_argument("--cycles", type=int, default=10,
                   help="V-cycles per timed call")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--nu1", type=int, default=3)
    p.add_argument("--nu2", type=int, default=2)
    p.add_argument("--smoother", default="chebyshev")
    p.add_argument("--tier", choices=("jnp", "kernels", "both"),
                   default="jnp",
                   help="plain XLA path, fused CUDA kernels, or both in "
                        "turns")
    p.add_argument("--rounds", type=int, default=2,
                   help="alternations of the tiers with --tier both")
    args = p.parse_args(argv)

    dev = require_gpu()
    power = gpu_name_and_power_limit()
    print(f"device: {dev.device_kind} | nvidia-smi: {power}", flush=True)

    import jax
    import jax.numpy as jnp

    from tpu_multigrid.utils.profiling import enable_compilation_cache
    enable_compilation_cache()

    tiers = ["jnp", "kernels"] if args.tier == "both" else [args.tier]
    built, fns = {}, {}
    t0 = time.perf_counter()
    for t in tiers:
        built[t] = build(args.level, args.coarsest, args.nu1, args.nu2,
                         args.smoother, t == "kernels")
        cfg, hier, b = built[t]
        fns[t] = tier_fns(cfg, hier, b, args.cycles)
        u0 = jnp.zeros_like(b)
        jax.block_until_ready(fns[t][0](u0, b))
        jax.block_until_ready(fns[t][1](u0, b))
    setup_s = time.perf_counter() - t0

    samples = {t: {"vcycle": [], "visit": []} for t in tiers}
    rounds = args.rounds if len(tiers) > 1 else 1
    order = []
    for r in range(rounds):
        order += tiers if r % 2 == 0 else tiers[::-1]
    for t in order:
        cfg, hier, b = built[t]
        u0 = jnp.zeros_like(b)
        run, visit = fns[t]
        _, ts = _time(run, u0, b, repeats=args.repeats)
        samples[t]["vcycle"] += [x / args.cycles for x in ts]
        _, ts = _time(visit, u0, b, repeats=args.repeats)
        samples[t]["visit"] += [x / args.cycles for x in ts]

    out = {}
    for t in tiers:
        cfg, hier, b = built[t]
        rho, hist = convergence(cfg, hier, b)
        out[t] = {
            "vcycle_ms": statistics.median(samples[t]["vcycle"]) * 1e3,
            "vcycle_ms_samples": [x * 1e3 for x in samples[t]["vcycle"]],
            "finest_visit_ms": statistics.median(samples[t]["visit"]) * 1e3,
            "dof_per_sec": (2 ** args.level - 1) ** 2
            / statistics.median(samples[t]["vcycle"]),
            "reduction_per_cycle": rho,
            "res_history": hist,
        }
    n = 2 ** args.level
    print(json.dumps({
        "metric": f"poisson_vcycle_ms_{n + 1}x{n + 1}",
        "tiers": out,
        "config": {"level": args.level, "coarsest": args.coarsest,
                   "nu1": args.nu1, "nu2": args.nu2,
                   "smoother": args.smoother, "dtype": "float32"},
        "setup_s_including_compile": setup_s,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "nvidia_smi": power,
    }))


if __name__ == "__main__":
    sys.exit(main())
