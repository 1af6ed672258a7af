"""The fused CUDA level visit (``kernels/level2d``) as far as the CPU can
check it.

The CUDA kernels have no interpret mode, so these tests cover what
surrounds them: the tile geometry, a numpy emulation of the kernels' tiled
dataflow (zero-filled tiles, halo shrink, core write-back, coarse
ownership) against the plain reference at several sizes and sweep counts,
the choice of tier in the cycle, and the refusal off the GPU.  The kernels
themselves are compared with the reference on the card by the tests marked
``gpu`` (skipped here) and by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import replicas as R
import tpu_multigrid as mg
from tpu_multigrid import cycles as C
from tpu_multigrid.core import ops
from tpu_multigrid.core.operators import (Const9Op, ConstStencilOp,
                                          poisson_op)
from tpu_multigrid.kernels import level2d

TW, TH = level2d.TILE_W, level2d.TILE_H


# ---------------------------------------------------------------------------
# numpy emulation of the kernels' tiled dataflow
# ---------------------------------------------------------------------------

def _tile(g, i0, j0):
    """(TH, TW) window of g at (i0, j0), zero outside the array."""
    out = np.zeros((TH, TW))
    S = g.shape[0]
    ia, ib = max(i0, 0), min(i0 + TH, S)
    ja, jb = max(j0, 0), min(j0 + TW, S)
    if ia < ib and ja < jb:
        out[ia - i0:ib - i0, ja - j0:jb - j0] = g[ia:ib, ja:jb]
    return out


def _tile_sweeps(v, bv, inter, ws):
    for w in ws:
        v = np.where(inter, (1 - w) * v + 0.25 * w * (bv + R.nbr5(v)), 0.0)
    return v


def _inter(n, i0, j0):
    gi = np.arange(i0, i0 + TH)[:, None]
    gj = np.arange(j0, j0 + TW)[None, :]
    return (gi >= 1) & (gi <= n - 1) & (gj >= 1) & (gj <= n - 1)


def emulate_k1(u, b, n, Sc, ws):
    S = u.shape[0]
    g = level2d.launch_grid(S, Sc, len(ws), "k1")
    H = g.halo
    uo, rc = np.full((S, S), np.nan), np.full((Sc, Sc), np.nan)
    nc = n // 2
    for by in range(g.blocks_y):
        for bx in range(g.blocks_x):
            i0, j0 = by * g.core_h - H, bx * g.core_w - H
            inter = _inter(n, i0, j0)
            v = _tile_sweeps(_tile(u, i0, j0), _tile(b, i0, j0), inter, ws)
            res = np.where(inter, (_tile(b, i0, j0) - 4.0 * v) + R.nbr5(v),
                           0.0)
            bx_ = res + 0.5 * (R.shift(res, 0, -1) + R.shift(res, 0, 1))
            by_ = bx_ + 0.5 * (R.shift(bx_, -1, 0) + R.shift(bx_, 1, 0))
            for tr in range(H, TH - H):
                gi = i0 + tr
                for tc in range(H, TW - H):
                    gj = j0 + tc
                    if gi < S and gj < S:
                        uo[gi, gj] = v[tr, tc]
                    if gi % 2 == 0 and gj % 2 == 0:
                        I, J = gi // 2, gj // 2
                        if I < Sc and J < Sc:
                            ok = 1 <= I <= nc - 1 and 1 <= J <= nc - 1
                            rc[I, J] = by_[tr, tc] if ok else 0.0
    return uo, rc


def emulate_k2(u, b, ec, n, ws, resnorm):
    S, Sc = u.shape[0], ec.shape[0]
    g = level2d.launch_grid(S, Sc, len(ws), "k2norm" if resnorm else "k2")
    H = g.halo
    e_full = R.prolong(ec, n // 2, S)
    uo = np.full((S, S), np.nan)
    partial = np.zeros(g.blocks_x * g.blocks_y)
    for by in range(g.blocks_y):
        for bx in range(g.blocks_x):
            i0, j0 = by * g.core_h - H, bx * g.core_w - H
            inter = _inter(n, i0, j0)
            bt = _tile(b, i0, j0)
            v = _tile(u, i0, j0) + _tile(e_full, i0, j0)
            v = _tile_sweeps(v, bt, inter, ws)
            core = (slice(H, TH - H), slice(H, TW - H))
            blk = v[core]
            ia, ja = i0 + H, j0 + H
            hi_i, hi_j = min(S - ia, blk.shape[0]), min(S - ja, blk.shape[1])
            if hi_i > 0 and hi_j > 0:
                uo[ia:ia + hi_i, ja:ja + hi_j] = blk[:hi_i, :hi_j]
            if resnorm:
                res = np.where(inter, (bt - 4.0 * v) + R.nbr5(v), 0.0)
                partial[by * g.blocks_x + bx] = np.sum(res[core] ** 2)
    if resnorm:
        return uo, np.sqrt(partial.sum())
    return uo


# (n, S, Sc): unpadded, padded fine, padded coarse, several tiles.
CASES = [(32, 33, 17), (64, 80, 40), (128, 129, 65), (256, 257, 129),
         (256, 300, 140)]
SCHEDULES = {"jacobi1": (2.0 / 3.0,),
             "cheb2": ops.chebyshev_omegas(2, 0.4),
             "cheb3": ops.chebyshev_omegas(3, 0.4)}


def _data(n, S, Sc, seed):
    rng = np.random.default_rng(seed)
    u = R.random_interior(n, S, rng)
    b = R.random_interior(n, S, rng)
    ec = R.random_interior(n // 2, Sc, rng)
    return u, b, ec


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("n,S,Sc", CASES)
def test_k1_tiling_matches_reference(n, S, Sc, sched):
    ws = SCHEDULES[sched]
    u, b, _ = _data(n, S, Sc, 1)
    uo, rc = emulate_k1(u, b, n, Sc, ws)
    ref_u, ref_rc = level2d.reference_smooth_restrict(
        jnp.asarray(u), jnp.asarray(b), n, Sc, ws)
    np.testing.assert_allclose(uo, np.asarray(ref_u), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(rc, np.asarray(ref_rc), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("resnorm", [False, True])
@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("n,S,Sc", CASES)
def test_k2_tiling_matches_reference(n, S, Sc, sched, resnorm):
    ws = SCHEDULES[sched]
    u, b, ec = _data(n, S, Sc, 2)
    got = emulate_k2(u, b, ec, n, ws, resnorm)
    ref = level2d.reference_prolong_smooth(
        jnp.asarray(u), jnp.asarray(b), jnp.asarray(ec), n, ws,
        resnorm=resnorm)
    if resnorm:
        # norm2 returns float32 (the history dtype)
        np.testing.assert_allclose(got[1], float(ref[1]), rtol=1e-6)
        got, ref = got[0], ref[0]
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-12,
                               atol=1e-12)


def test_halo_one_short_breaks_the_tiling():
    """The emulation is sensitive to the halo depth: with one ring fewer
    than launch_grid gives, the restriction at the core edges reads
    residuals outside the valid region."""
    n, S, Sc = 128, 129, 65
    ws = SCHEDULES["cheb3"]
    u, b, _ = _data(n, S, Sc, 3)
    real = level2d.launch_grid

    def short(S_, Sc_, k, kind):
        g = real(S_, Sc_, k, kind)
        h = g.halo - 1
        cw, ch = TW - 2 * h, TH - 2 * h
        return level2d.LaunchGrid(h, cw, ch, -(-S_ // cw), -(-S_ // ch))

    level2d.launch_grid = short
    try:
        _, rc = emulate_k1(u, b, n, Sc, ws)
    finally:
        level2d.launch_grid = real
    _, ref_rc = level2d.reference_smooth_restrict(
        jnp.asarray(u), jnp.asarray(b), n, Sc, ws)
    assert not np.allclose(rc, np.asarray(ref_rc), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# tile geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sweeps", [1, 2, 3, 8])
@pytest.mark.parametrize("kind,extra", [("k1", 2), ("k2", 0), ("k2norm", 1)])
def test_launch_grid_geometry(kind, extra, sweeps):
    S, Sc = 8193, 4097
    g = level2d.launch_grid(S, Sc, sweeps, kind)
    assert g.halo == sweeps + extra
    assert g.core_w == TW - 2 * g.halo and g.core_h == TH - 2 * g.halo
    # even cores start every block on an even fine index (coarse ownership)
    assert g.core_w % 2 == 0 and g.core_h % 2 == 0 and g.core_h > 0
    rows = max(S, 2 * Sc) if kind == "k1" else S
    assert g.blocks_x * g.core_w >= rows > (g.blocks_x - 1) * g.core_w
    assert g.blocks_y * g.core_h >= rows > (g.blocks_y - 1) * g.core_h


def test_launch_grid_k1_covers_padded_coarse_grid():
    g = level2d.launch_grid(33, 40, 3, "k1")
    assert g.blocks_y * g.core_h >= 2 * 40


# ---------------------------------------------------------------------------
# tier choice and refusal off the GPU
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(finest_level=6, coarsest_level=3, smoother="chebyshev",
                nu1=3, nu2=2, dtype=jnp.float32, use_kernels=True)
    base.update(kw)
    return mg.MultigridConfig(**base)


@pytest.mark.parametrize("kw,want", [
    ({}, True),
    ({"smoother": "jacobi"}, True),
    ({"use_kernels": False}, False),
    ({"smoother": "rbgs"}, False),
    ({"smooth_dtype": jnp.bfloat16}, False),
    ({"dtype": jnp.float64}, False),
    ({"restriction": "injection"}, False),
    ({"prolongation": "p1"}, False),
    ({"nu2": 0}, False),
    ({"nu1": 9}, False),
])
def test_level_kernel_choice(kw, want):
    cfg = _cfg(**kw)
    op, opc = poisson_op(64, 65), poisson_op(32, 33)
    assert C._use_level_kernels(op, opc, cfg, cfg.dtype) is want


def test_level_kernels_constant_5_point_pairs_only():
    cfg = _cfg()
    assert not C._use_level_kernels(Const9Op(64, 65), Const9Op(32, 33), cfg,
                                    jnp.float32)
    assert isinstance(poisson_op(8, 9), ConstStencilOp)


@pytest.mark.parametrize("which", ["k1", "k2"])
def test_kernels_refused_off_gpu(which):
    n, S, Sc = 32, 33, 17
    u = jnp.zeros((S, S), jnp.float32)
    with pytest.raises(RuntimeError, match="NVIDIA GPU only"):
        if which == "k1":
            level2d.smooth_restrict(u, u, n, Sc, (0.8,))
        else:
            level2d.prolong_smooth(u, u, jnp.zeros((Sc, Sc)), n, (0.8,))


def test_solve_with_kernels_refused_on_cpu():
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        mg.solve_poisson(6, config=_cfg(), num_cycles=1, tol=None)


def test_default_configs_select_no_kernel():
    """No default selects a kernel: the 2D and 3D front doors run the
    plain XLA path unless the caller asks for the CUDA kernels."""
    assert not mg.MultigridConfig().use_kernels
    res = mg.solve_poisson3d(3, num_cycles=1, tol=None)
    assert np.isfinite(np.asarray(res.u)).all()


def test_kernels_package_holds_only_the_cuda_level_visit():
    import pathlib
    pkg = pathlib.Path(level2d.__file__).parent
    names = sorted(p.name for p in pkg.iterdir()
                   if p.suffix in (".py", ".cu"))
    assert names == ["__init__.py", "level2d.cu", "level2d.py"]
    src = pathlib.Path(mg.__file__).parent
    for p in src.rglob("*.py"):
        text = p.read_text()
        assert "jax.experimental.pallas" not in text, p


def test_cycle_helpers_match_reference_composition():
    """The jnp tier's level visit equals the reference the kernels match."""
    n, S, Sc = 64, 65, 33
    cfg = dataclasses.replace(_cfg(use_kernels=False), dtype=jnp.float64)
    op, opc = poisson_op(n, S), poisson_op(n // 2, Sc)
    u, b, ec = (jnp.asarray(x) for x in _data(n, S, Sc, 4))
    u1, r = C._smooth_residual(op, u, b, cfg, cfg.nu1)
    rc = C._restrict(r, n, Sc, cfg)
    ref_u, ref_rc = level2d.reference_smooth_restrict(
        u, b, n, Sc, C._omegas(cfg, cfg.nu1))
    np.testing.assert_allclose(np.asarray(u1), np.asarray(ref_u),
                               rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(np.asarray(rc), np.asarray(ref_rc),
                               rtol=1e-13, atol=1e-13)
    u2 = C._smooth(op, C._prolong_add(u, ec, n // 2, S, cfg), b, cfg,
                   cfg.nu2)
    ref2 = level2d.reference_prolong_smooth(u, b, ec, n,
                                            C._omegas(cfg, cfg.nu2))
    np.testing.assert_allclose(np.asarray(u2), np.asarray(ref2),
                               rtol=1e-13, atol=1e-13)


# ---------------------------------------------------------------------------
# on the card (skipped without a GPU)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n,S,Sc", [(32, 33, 17), (1024, 1100, 560)])
def test_kernels_match_reference_on_gpu(gpu, n, S, Sc):
    ws = SCHEDULES["cheb3"]
    u, b, ec = (jnp.asarray(x, jnp.float32) for x in _data(n, S, Sc, 5))
    got = jax.jit(lambda u, b: level2d.smooth_restrict(u, b, n, Sc, ws))(
        u, b)
    ref = level2d.reference_smooth_restrict(u, b, n, Sc, ws)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    got = jax.jit(lambda u, b, e: level2d.prolong_smooth(
        u, b, e, n, ws, resnorm=True))(u, b, ec)
    ref = level2d.reference_prolong_smooth(u, b, ec, n, ws, resnorm=True)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got[1]), float(ref[1]), rtol=1e-5)


@pytest.mark.gpu
def test_fused_solve_matches_plain_on_gpu(gpu):
    cfg = _cfg(finest_level=9, coarsest_level=3)
    a = mg.solve_poisson(9, config=cfg, num_cycles=4, tol=None)
    b = mg.solve_poisson(9, config=dataclasses.replace(cfg,
                                                       use_kernels=False),
                         num_cycles=4, tol=None)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), rtol=1e-4,
                               atol=1e-6)
