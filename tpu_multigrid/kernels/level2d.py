"""Fused CUDA level visit for the constant-coefficient 2D Poisson cycle.

Two kernels (``level2d.cu``) replace the unfused chain of one level visit:

* :func:`smooth_restrict` (K1): k Jacobi/Chebyshev sweeps, the residual and
  its full-weighting restriction in one pass over the level;
* :func:`prolong_smooth` (K2): bilinear prolongation of the coarse
  correction, the correction itself and k sweeps in one pass, optionally
  with the residual norm of the result.

A block keeps a 128 x 64 tile in shared memory and runs the dependent
steps there (temporal blocking), so a visit moves about 6.5 grid passes
instead of about 21 for the chain of separate XLA kernels.

The kernels are compiled from the committed ``level2d.cu`` with ``nvcc``
for ``sm_90a`` at first use, into ``<checkout>/.build/`` (listed in
``.gitignore``), and called through ``jax.ffi``.  They run on an NVIDIA
GPU only: there is no interpret mode, and calling them on another backend
raises.  :func:`reference_smooth_restrict` and
:func:`reference_prolong_smooth` are the plain jnp compositions they must
match.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from ..core import ops

SRC = pathlib.Path(__file__).with_suffix(".cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".build"

TILE_W, TILE_H = 128, 64   # must match TW and TY * R in level2d.cu
MAX_SWEEPS = 8             # must match MAX_SWEEPS in level2d.cu

_K1 = "tmg_level2d_smooth_restrict"
_K2 = "tmg_level2d_prolong_smooth"
_lock = threading.Lock()
_registered = False


class LaunchGrid(NamedTuple):
    """Tile geometry of one launch: halo depth, written core, block grid."""
    halo: int
    core_w: int
    core_h: int
    blocks_x: int
    blocks_y: int


def launch_grid(S: int, Sc: int, sweeps: int, kind: str) -> LaunchGrid:
    """Geometry of a K1 (``kind="k1"``) or K2 / K2+norm (``"k2"``,
    ``"k2norm"``) launch on an (S, S) level with an (Sc, Sc) coarse grid.

    The halo is the number of dependent steps between a tile's inputs and
    its written core: the sweeps, plus the residual and the restriction
    blur for K1, plus the residual for the norm.  K1 covers rows up to
    ``max(S, 2 Sc)`` so every coarse node is written.
    """
    halo = sweeps + {"k1": 2, "k2": 0, "k2norm": 1}[kind]
    cw, ch = TILE_W - 2 * halo, TILE_H - 2 * halo
    rows = max(S, 2 * Sc) if kind == "k1" else S
    return LaunchGrid(halo, cw, ch, -(-rows // cw), -(-rows // ch))


def supported(nu1: int, nu2: int, dtype) -> bool:
    """Whether a level visit fits the kernels: f32, and 1..8 sweeps on each
    side (the platform is checked when they are called)."""
    return (jnp.dtype(dtype) == jnp.dtype(jnp.float32)
            and 1 <= nu1 <= MAX_SWEEPS and 1 <= nu2 <= MAX_SWEEPS)


def require_gpu() -> None:
    backend = jax.default_backend()
    if backend != "gpu":
        raise RuntimeError(
            "the fused CUDA level-visit kernels (MultigridConfig.use_kernels)"
            f" run on an NVIDIA GPU only; JAX's backend is {backend!r}. "
            "Use use_kernels=False for the plain XLA path.")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fused kernels are compiled from "
                       f"{SRC.name} at first use")


def library_path() -> pathlib.Path:
    """Where the compiled library lives; the name carries the source's
    hash, so an edited source builds anew."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liblevel2d_{digest}.so"


def build() -> pathlib.Path:
    """Compile ``level2d.cu`` unless the library for this source exists."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir(), "-o", str(tmp), str(SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, lib)
    return lib


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(str(build()))
        jax.ffi.register_ffi_target(
            _K1, jax.ffi.pycapsule(lib.TmgSmoothRestrict), platform="CUDA")
        jax.ffi.register_ffi_target(
            _K2, jax.ffi.pycapsule(lib.TmgProlongSmooth), platform="CUDA")
        _registered = True


def _weights(omegas: Sequence[float]) -> dict:
    ws = [float(w) for w in omegas]
    if not 1 <= len(ws) <= MAX_SWEEPS:
        raise ValueError(f"1..{MAX_SWEEPS} sweeps supported, got {len(ws)}")
    ws += [0.0] * (MAX_SWEEPS - len(ws))
    return {f"w{i}": w for i, w in enumerate(ws)}


def smooth_restrict(u, b, n: int, Sc: int, omegas: Sequence[float]):
    """K1: ``len(omegas)`` weighted-Jacobi sweeps (per-sweep weights), then
    ``(u, restrict_fw(b - A u))`` with the coarse grid (Sc, Sc)."""
    require_gpu()
    _register()
    S = u.shape[-1]
    call = jax.ffi.ffi_call(
        _K1, (jax.ShapeDtypeStruct((S, S), jnp.float32),
              jax.ShapeDtypeStruct((Sc, Sc), jnp.float32)))
    return call(u, b, n=int(n), k=len(omegas), **_weights(omegas))


def prolong_smooth(u, b, ec, n: int, omegas: Sequence[float], *,
                   resnorm: bool = False):
    """K2: ``u + prolong(ec)`` then ``len(omegas)`` sweeps; with
    ``resnorm`` also the L2 norm of the result's residual (f32)."""
    require_gpu()
    _register()
    S, Sc = u.shape[-1], ec.shape[-1]
    g = launch_grid(S, Sc, len(omegas), "k2norm" if resnorm else "k2")
    call = jax.ffi.ffi_call(
        _K2, (jax.ShapeDtypeStruct((S, S), jnp.float32),
              jax.ShapeDtypeStruct((g.blocks_x * g.blocks_y,),
                                   jnp.float32)))
    uo, partial = call(u, b, ec, n=int(n), k=len(omegas),
                       resnorm=int(resnorm), **_weights(omegas))
    if resnorm:
        return uo, jnp.sqrt(jnp.sum(partial)).astype(jnp.float32)
    return uo


def reference_smooth_restrict(u, b, n: int, Sc: int,
                              omegas: Sequence[float]):
    """The plain jnp composition K1 replaces."""
    u = ops.jacobi_sweeps(u, b, n, tuple(omegas), len(omegas))
    return u, ops.restrict_fw(ops.residual(u, b, n), n, Sc)


def reference_prolong_smooth(u, b, ec, n: int, omegas: Sequence[float], *,
                             resnorm: bool = False):
    """The plain jnp composition K2 replaces."""
    u = u + ops.prolong(ec, n // 2, u.shape[-1])
    u = ops.jacobi_sweeps(u, b, n, tuple(omegas), len(omegas))
    if resnorm:
        return u, ops.norm2(ops.residual(u, b, n))
    return u
