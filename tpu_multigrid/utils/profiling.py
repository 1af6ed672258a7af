"""Tracing / profiling (SURVEY.md §5).

The reference has zero instrumentation — its SYCL events order dependencies
but are never queried for timing (``Poissons_SYCL.cpp:132-136,600-603``).
This module provides:

* ``trace_annotate`` — named ``jax.profiler`` trace spans so cycle phases
  show up in TensorBoard/Perfetto traces;
* ``profile_solve`` — wall-clock + DOF-throughput accounting for a solve
  callable (host clock around work that ends in ``block_until_ready``);
* ``enable_compilation_cache`` — JAX's persistent compile cache at a fixed
  path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pathlib
import time
from typing import Callable, Optional

import jax

# Default persistent-cache directory: fixed, inside the checkout (listed in
# .gitignore), so a cache written by one run is found by the next.
DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


@contextlib.contextmanager
def trace_annotate(name: str):
    """Named profiler span (no-op overhead outside profiling sessions)."""
    with jax.profiler.TraceAnnotation(name):
        yield


@dataclasses.dataclass
class CycleStats:
    """Per-cycle performance report.

    ``bandwidth_fraction`` is None unless the caller supplied both a
    modelled byte count and the device's peak bandwidth."""
    cycle_ms: float
    dof_per_sec: float
    effective_gbps: float
    bandwidth_fraction: Optional[float]
    grid: str

    def __str__(self):
        s = (f"{self.grid}: {self.cycle_ms:.3f} ms/cycle, "
             f"{self.dof_per_sec / 1e9:.2f} GDOF/s, "
             f"{self.effective_gbps:.0f} GB/s effective")
        if self.bandwidth_fraction is not None:
            s += f" ({100 * self.bandwidth_fraction:.1f}% of peak)"
        return s


def profile_solve(step: Callable, *args, n: int, cycles: int = 8,
                  traffic_bytes: Optional[float] = None,
                  peak_gbps: Optional[float] = None) -> CycleStats:
    """Time ``step(*args)`` (one cycle) and report throughput.

    ``traffic_bytes``: modelled device bytes per cycle; when given, the
    effective bandwidth is reported, and its share of ``peak_gbps`` when
    the caller names the device's peak (no peak is assumed here).
    """
    jax.block_until_ready(step(*args))
    t0 = time.perf_counter()
    for _ in range(cycles):
        out = step(*args)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / cycles
    dofs = (n - 1) ** 2
    eff = (traffic_bytes or 0.0) / dt / 1e9
    frac = eff / peak_gbps if (traffic_bytes and peak_gbps) else None
    return CycleStats(
        cycle_ms=dt * 1e3,
        dof_per_sec=dofs / dt,
        effective_gbps=eff,
        bandwidth_fraction=frac,
        grid=f"{n + 1}x{n + 1}",
    )


def start_trace(logdir: str):
    """Begin a jax.profiler trace (view in TensorBoard / Perfetto)."""
    jax.profiler.start_trace(logdir)


def stop_trace():
    jax.profiler.stop_trace()


def compilation_cache_dir(platform: Optional[str] = None) -> Optional[str]:
    """Where the persistent compile cache lives: ``JAX_COMPILATION_CACHE_DIR``
    when set, else :data:`DEFAULT_CACHE_DIR`; None on the CPU platform.

    ``platform`` defaults to the first configured JAX platform.  CPU
    compiles are fast, and reading a cache shared across sessions from CPU
    runs has produced deserialization segfaults in the test suite, so the
    CPU platform gets no cache.
    """
    if platform is None:
        plats = (getattr(jax.config, "jax_platforms", None)
                 or os.environ.get("JAX_PLATFORMS", ""))
        platform = plats.split(",")[0].strip()
    if platform == "cpu":
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        DEFAULT_CACHE_DIR)


def enable_compilation_cache() -> Optional[str]:
    """Enable JAX's persistent compilation cache at
    :func:`compilation_cache_dir` (no-op on CPU); returns the directory."""
    p = compilation_cache_dir()
    if p is None:
        return None
    os.makedirs(p, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", p)
    return p
