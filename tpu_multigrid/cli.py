"""Command-line interface.

The reference's only "CLI" is a compiled console app that prints the solution
size and a static success string (``Poissons_SYCL.cpp:728-729``); every
parameter change required recompiling.  This CLI exposes the full config
surface and reports actual convergence.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p):
    p.add_argument("--level", type=int, default=10,
                   help="finest level: grid is (2^level+1)^2 nodes")
    p.add_argument("--coarsest", type=int, default=3)
    p.add_argument("--nu1", type=int, default=2)
    p.add_argument("--nu2", type=int, default=2)
    p.add_argument("--nu0", type=int, default=1, help="FMG cycles per level")
    p.add_argument("--omega", type=float, default=2.0 / 3.0)
    p.add_argument("--smoother",
                   choices=["jacobi", "rbgs", "chebyshev",
                            "zebra_x", "zebra_y"],
                   default="jacobi")
    p.add_argument("--cheb-lo", type=float, default=0.4,
                   help="Chebyshev smoothing interval lower bound on D^-1 A")
    p.add_argument("--cycle", choices=["V", "W", "F"], default="V")
    p.add_argument("--coarse-solver", choices=["direct", "smooth"],
                   default="direct")
    p.add_argument("--dtype", choices=["f32", "f64", "bf16"], default="f32")
    p.add_argument("--smooth-dtype", choices=["f32", "f64", "bf16"],
                   default=None)
    p.add_argument("--kernels", action="store_true",
                   help="fused CUDA level-visit kernels (GPU only)")
    p.add_argument("--fmg", action="store_true", help="FMG initial guess")
    p.add_argument("--refined", action="store_true",
                   help="compensated double-single refinement (deep f32 tolerances)")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="relative residual tolerance")
    p.add_argument("--max-cycles", type=int, default=100)
    p.add_argument("--cycles", type=int, default=None,
                   help="fixed cycle count (overrides --tol)")
    p.add_argument("--cpu", action="store_true", help="force CPU backend")
    p.add_argument("--x64", action="store_true", help="enable float64")
    p.add_argument("--json", action="store_true", help="JSON-line output")
    p.add_argument("--save", default=None,
                   help="save solution + solve state to this .npz file")
    p.add_argument("--boundary", type=float, default=None,
                   help="constant inhomogeneous Dirichlet value g "
                        "(callables g(x,y) via the Python API)")


def _dtype(name):
    import jax.numpy as jnp
    return {"f32": jnp.float32, "f64": jnp.float64, "bf16": jnp.bfloat16,
            None: None}[name]


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="tpu-multigrid",
        description="geometric multigrid solver for JAX accelerators")
    sub = parser.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("solve", help="solve -lap(u) = f (constant f=4)")
    _add_common(ps)
    ps.add_argument("--forcing", type=float, default=4.0)
    ps.add_argument("--neumann", nargs="+", default=(),
                    choices=["bottom", "top", "left", "right"],
                    help="sides carrying du/dn = --neumann-value instead "
                         "of Dirichlet")
    ps.add_argument("--neumann-value", type=float, default=0.0)

    pd = sub.add_parser("diffusion", help="solve -div(a grad u) = f")
    _add_common(pd)
    pd.add_argument("--forcing", type=float, default=4.0)
    pd.add_argument("--coefficient", type=float, default=1.0,
                    help="constant coefficient (use the Python API for fields)")

    p3 = sub.add_parser("solve3d",
                        help="solve -lap(u) = f on the unit cube (7-point)")
    _add_common(p3)
    p3.add_argument("--forcing", type=float, default=6.0)

    pa = sub.add_parser("anisotropic",
                        help="solve -(ex u_xx + ey u_yy) = f "
                             "(use --smoother zebra_x when ex >> ey)")
    _add_common(pa)
    pa.add_argument("--forcing", type=float, default=4.0)
    pa.add_argument("--eps-x", type=float, default=1.0)
    pa.add_argument("--eps-y", type=float, default=1.0)
    pa.add_argument("--coarsening", choices=["auto", "full", "semi"],
                    default="auto",
                    help="semi = coarsen the strong axis only "
                         "(point smoothing stays mesh-independent)")
    pa.add_argument("--angle", type=float, default=0.0,
                    help="rotation of the diffusion tensor in RADIANS "
                         "(rotated anisotropy; use full coarsening)")

    pc = sub.add_parser("convection",
                        help="solve -eps lap(u) + b.grad(u) = f "
                             "(upwind; use --smoother rbgs at high Peclet)")
    _add_common(pc)
    pc.add_argument("--forcing", type=float, default=4.0)
    pc.add_argument("--eps", type=float, default=1.0)
    pc.add_argument("--bx", type=float, default=0.0)
    pc.add_argument("--by", type=float, default=0.0)

    pb = sub.add_parser("bench", help="run the benchmark harness")
    pb.add_argument("args", nargs=argparse.REMAINDER)

    args = parser.parse_args(argv)

    if args.command == "bench":
        import subprocess
        return subprocess.call([sys.executable, "bench.py"] + args.args)

    import jax
    try:
        from .utils.profiling import enable_compilation_cache
        enable_compilation_cache()
    except Exception:
        pass
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.x64 or args.dtype == "f64":
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from .api import (extract_solution, solve_diffusion, solve_poisson,
                      solve_poisson3d)
    from .config import MultigridConfig

    cfg = MultigridConfig(
        finest_level=args.level, coarsest_level=args.coarsest,
        nu1=args.nu1, nu2=args.nu2, nu0=args.nu0, omega=args.omega,
        smoother=args.smoother, cheb_lo=args.cheb_lo, cycle=args.cycle,
        coarse_solver=args.coarse_solver, dtype=_dtype(args.dtype),
        smooth_dtype=_dtype(args.smooth_dtype), use_kernels=args.kernels)

    t0 = time.perf_counter()
    kw = dict(config=cfg, forcing=args.forcing, tol=args.tol,
              max_cycles=args.max_cycles, num_cycles=args.cycles,
              use_fmg=args.fmg)
    if args.command == "solve":
        res = solve_poisson(args.level, refined=args.refined,
                            boundary=args.boundary,
                            neumann=tuple(args.neumann),
                            neumann_value=args.neumann_value, **kw)
    elif args.command == "solve3d":
        res = solve_poisson3d(args.level, refined=args.refined, **kw)
    elif args.command == "anisotropic":
        from .api import solve_anisotropic
        res = solve_anisotropic(args.level, eps_x=args.eps_x,
                                eps_y=args.eps_y, angle=args.angle,
                                coarsening=args.coarsening,
                                boundary=args.boundary, **kw)
    elif args.command == "convection":
        from .api import solve_convection_diffusion
        res = solve_convection_diffusion(args.level, eps=args.eps,
                                         bx=args.bx, by=args.by,
                                         boundary=args.boundary, **kw)
    else:
        res = solve_diffusion(args.level, coefficient=args.coefficient,
                              boundary=args.boundary, **kw)
    jax.block_until_ready(res.u)
    wall = time.perf_counter() - t0

    n = 2 ** args.level
    iters = int(res.iterations)
    hist = np.asarray(res.res_history)[: iters + 1]
    out = {
        "grid": f"{n + 1}x{n + 1}",
        "iterations": iters,
        "converged": bool(res.converged),
        "residual_initial": float(hist[0]),
        "residual_final": float(hist[-1]),
        "reduction_per_cycle": float((hist[-1] / hist[0]) ** (1 / max(iters, 1))),
        "wall_s": round(wall, 4),
        "device": str(jax.devices()[0]),
    }
    if args.save:
        u = np.asarray(extract_solution(res.u, n))
        np.savez(args.save, u=u, res_history=hist,
                 iterations=iters, level=args.level)
        out["saved"] = args.save
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k:>22}: {v}")
    return 0 if out["converged"] or args.cycles else 1


if __name__ == "__main__":
    sys.exit(main())
