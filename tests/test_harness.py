"""The harness around the solver: compile-cache location, coarse-solve
precision, and the GPU-only entry scripts refusing to run elsewhere."""

import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid.core.grids import coarse_solve
from tpu_multigrid.core.operators import poisson_op
from tpu_multigrid.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.compilation_cache_dir("gpu") == str(tmp_path)


def test_cache_dir_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = pathlib.Path(profiling.compilation_cache_dir("gpu"))
    assert got == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_no_cache_on_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert profiling.compilation_cache_dir("cpu") is None
    assert profiling.enable_compilation_cache() is None   # tests run on CPU


def test_build_dirs_ignored():
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".build/" in ignored and "chiprun_out/" in ignored


def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    return [e.params["precision"] for e in jaxpr.eqns
            if e.primitive.name == "dot_general"]


def test_coarse_solve_asks_for_highest_precision():
    op = poisson_op(8, 9)
    m = 49
    inv = jnp.eye(m, dtype=jnp.float32)
    b = jnp.ones((9, 9), jnp.float32)
    precs = _dot_precisions(lambda i, b: coarse_solve(op, i, b), inv, b)
    assert precs and all(
        p == (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
        for p in precs), precs


def test_topo_coarse_apply_asks_for_highest_precision():
    from tpu_multigrid import topo
    hier = topo.build_structured_topo_hierarchy(3, 2, dtype=jnp.float32)
    b = jnp.ones((hier.coarse_inv.shape[0],), jnp.float32)
    precs = _dot_precisions(lambda b: topo._coarse_apply(hier, b), b)
    assert precs and all(
        p == (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
        for p in precs), precs


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_scripts_fail_without_gpu(script):
    out = _run([script], REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_coarse_solve_is_exact_in_f64():
    from tpu_multigrid.core.grids import coarse_dense_inverse
    op = poisson_op(8, 9)
    inv = coarse_dense_inverse(op, jnp.float64)
    rng = np.random.default_rng(0)
    b = np.zeros((9, 9))
    b[1:8, 1:8] = rng.standard_normal((7, 7))
    u = coarse_solve(op, inv, jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(op.residual(u, jnp.asarray(b))),
                               0.0, atol=1e-12)


@pytest.mark.parametrize("entry", ["poisson", "bratu", "quasilinear"])
def test_removed_dist_path_is_refused(entry):
    import tpu_multigrid as mg
    from tpu_multigrid.dist import make_grid_mesh
    mesh = make_grid_mesh(shape=(1, 2), devices=jax.devices()[:2])
    cfg = mg.MultigridConfig(finest_level=5, coarsest_level=3)
    solve = {"poisson": mg.solve_poisson, "bratu": mg.solve_bratu,
             "quasilinear": mg.solve_quasilinear_diffusion}[entry]
    with pytest.raises(ValueError, match='dist_path must be "jnp"'):
        solve(5, config=cfg, mesh=mesh, dist_path="pallas", num_cycles=1,
              tol=None)
