"""Distributed tests on a virtual 8-device CPU mesh (SURVEY.md §4 tier 4):
shard_map + ppermute halo exchange is exercised without accelerators via
xla_force_host_platform_device_count (set in conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import PartitionSpec as P

from tpu_multigrid import MultigridConfig
from tpu_multigrid.core import ops
from tpu_multigrid.dist import local_ops as L
from tpu_multigrid.dist.mesh import make_grid_mesh, place
from tpu_multigrid.dist.shard_cycle import sharded_level_sizes, sharded_solve

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _shard_apply(mesh, fn, *arrays):
    """Run fn under shard_map on (gy, gx)-sharded inputs, return global."""
    spec = P("gy", "gx")
    from jax import shard_map
    f = shard_map(fn, mesh=mesh, in_specs=(spec,) * len(arrays),
                  out_specs=spec, check_vma=False)
    return jax.jit(f)(*[place(a, mesh) for a in arrays])


@pytest.mark.parametrize("mesh_shape", [(2, 4), (4, 2), (1, 8), (2, 2)])
def test_local_ops_match_global(mesh_shape, rng):
    """Every shard-local operator == the single-device global operator."""
    my, mx = mesh_shape
    mesh = make_grid_mesh(shape=mesh_shape,
                          devices=jax.devices()[: my * mx])
    n, S = 60, 64
    u = np.zeros((S, S), np.float64)
    b = np.zeros((S, S), np.float64)
    u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    b[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    u, b = jnp.asarray(u), jnp.asarray(b)

    cases = [
        ("apply", lambda ul, bl: L.apply_poisson_local(ul, n),
         ops.apply_poisson(u, n)),
        ("residual", lambda ul, bl: L.residual_local(ul, bl, n),
         ops.residual(u, b, n)),
        ("jacobi3", lambda ul, bl: L.jacobi_local(ul, bl, n, 2 / 3, 3),
         ops.jacobi_sweeps(u, b, n, 2 / 3, 3)),
        ("rbgs2", lambda ul, bl: L.rbgs_local(ul, bl, n, 2),
         ops.redblack_gs_sweeps(u, b, n, 2)),
    ]
    for name, fn, want in cases:
        got = _shard_apply(mesh, fn, u, b)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-12, atol=1e-13, err_msg=name)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2)])
def test_local_transfers_match_global(mesh_shape, rng):
    my, mx = mesh_shape
    mesh = make_grid_mesh(shape=mesh_shape, devices=jax.devices()[: my * mx])
    nf, Sf = 60, 64
    r = np.zeros((Sf, Sf))
    r[1:nf, 1:nf] = rng.standard_normal((nf - 1, nf - 1))
    r = jnp.asarray(r)

    from jax import shard_map
    spec = P("gy", "gx")
    f = shard_map(lambda rl: L.restrict_fw_local(rl, nf), mesh=mesh,
                  in_specs=(spec,), out_specs=spec, check_vma=False)
    got = jax.jit(f)(place(r, mesh))
    want = ops.restrict_fw(r, nf, 32)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-12, atol=1e-13)

    nc, Sc = 30, 32
    e = np.zeros((Sc, Sc))
    e[1:nc, 1:nc] = rng.standard_normal((nc - 1, nc - 1))
    e = jnp.asarray(e)
    g = shard_map(lambda el: L.prolong_local(el, nc), mesh=mesh,
                  in_specs=(spec,), out_specs=spec, check_vma=False)
    gotp = jax.jit(g)(place(e, mesh))
    wantp = ops.prolong(e, nc, 64)
    np.testing.assert_allclose(np.asarray(gotp), np.asarray(wantp),
                               rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("mesh_shape", [(2, 4), (2, 2), (1, 1)])
def test_sharded_solve_matches_single_device(mesh_shape):
    """End-to-end: N-chip sharded solve == 1-chip solve on the same grid."""
    my, mx = mesh_shape
    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          dtype=jnp.float32)
    mesh = make_grid_mesh(shape=mesh_shape, devices=jax.devices()[: my * mx])
    res, _ = sharded_solve(cfg, mesh, num_cycles=6, tol=0.0,
                           replicate_below=8)
    mesh1 = make_grid_mesh(shape=(1, 1), devices=jax.devices()[:1])
    ref, _ = sharded_solve(cfg, mesh1, num_cycles=6, tol=0.0,
                           replicate_below=8)
    np.testing.assert_allclose(np.asarray(res.res_history),
                               np.asarray(ref.res_history),
                               rtol=2e-4)
    n = 64
    np.testing.assert_allclose(np.asarray(res.u)[: n + 1, : n + 1],
                               np.asarray(ref.u)[: n + 1, : n + 1],
                               rtol=1e-4, atol=1e-7)


def test_sharded_solve_converges_textbook():
    cfg = MultigridConfig(finest_level=7, coarsest_level=3,
                          dtype=jnp.float32)
    mesh = make_grid_mesh(shape=(2, 4), devices=jax.devices()[:8])
    res, levels = sharded_solve(cfg, mesh, num_cycles=4, tol=0.0,
                                replicate_below=16)
    assert levels.num_sharded >= 2
    h = np.asarray(res.res_history)[:5]
    factors = h[1:] / h[:-1]
    assert np.all(factors < 0.25), factors


def test_sharded_level_sizes_split():
    cfg = MultigridConfig(finest_level=10, coarsest_level=3)
    lv = sharded_level_sizes(cfg, (2, 4), replicate_below=64)
    assert lv.sizes[0][1] % 8 == 0
    for (n, S) in lv.sharded:
        assert S % 2 == 0 and S % 4 == 0
    assert lv.num_sharded < len(lv.sizes)


@pytest.mark.parametrize("cyc", ["W", "F"])
def test_sharded_wf_cycles_match_single_device(cyc):
    """W- and F-cycles on the sharded path match the 1-device run (ADVICE r1:
    the distributed F-cycle silently degenerated to a V-shaped recursion)."""
    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          dtype=jnp.float32, cycle=cyc)
    mesh = make_grid_mesh(shape=(2, 2), devices=jax.devices()[:4])
    res, _ = sharded_solve(cfg, mesh, num_cycles=4, tol=0.0,
                           replicate_below=8)
    mesh1 = make_grid_mesh(shape=(1, 1), devices=jax.devices()[:1])
    ref, _ = sharded_solve(cfg, mesh1, num_cycles=4, tol=0.0,
                           replicate_below=8)
    np.testing.assert_allclose(np.asarray(res.res_history),
                               np.asarray(ref.res_history), rtol=2e-4)


def test_sharded_fcycle_matches_global_cycle():
    """The distributed F-cycle matches cycles.cycle semantics (not a V)."""
    from tpu_multigrid.cycles import solve_fixed
    from tpu_multigrid.dist.shard_cycle import build_sharded_poisson

    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          dtype=jnp.float32, cycle="F")
    mesh1 = make_grid_mesh(shape=(1, 1), devices=jax.devices()[:1])
    res, _ = sharded_solve(cfg, mesh1, num_cycles=3, tol=0.0,
                           replicate_below=8)
    # Same padded hierarchy, global single-device driver.
    _, hier = build_sharded_poisson(cfg, mesh1, replicate_below=8)
    n0, S0 = hier.levels[0].n, hier.levels[0].S
    b = np.zeros((S0, S0), np.float32)
    b[1:n0, 1:n0] = 4.0 * (1.0 / n0) ** 2
    ref = solve_fixed(hier, cfg, jnp.asarray(b), 3)
    np.testing.assert_allclose(np.asarray(res.res_history),
                               np.asarray(ref.res_history), rtol=2e-4)


def test_sharded_fixed_count_runs_to_completion():
    """A fixed cycle count must not exit early on the stall heuristic: the
    history has no NaN holes even when cycles stop making progress (ADVICE
    r1: weak_scaling reads hist[cycles] unconditionally)."""
    # f32 at level 6 hits its precision floor well before 30 cycles.
    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          dtype=jnp.float32)
    mesh = make_grid_mesh(shape=(2, 2), devices=jax.devices()[:4])
    res, _ = sharded_solve(cfg, mesh, num_cycles=30, tol=0.0,
                           replicate_below=8)
    h = np.asarray(res.res_history)
    assert int(res.iterations) == 30
    assert np.isfinite(h).all(), h


def test_gspmd_solve_shares_layout_and_matches_explicit():
    """GSPMD auto path on the explicit path's padded layout (VERDICT r2
    #10): one build_sharded_problem hierarchy serves both, and the two
    communication strategies produce the same solve."""
    from tpu_multigrid.dist.mesh import gspmd_solve
    from tpu_multigrid.dist.shard_cycle import build_sharded_problem

    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          dtype=jnp.float32)
    mesh = make_grid_mesh(shape=(2, 4), devices=jax.devices()[:8])
    levels_hier = build_sharded_problem(cfg, mesh, replicate_below=8)
    gres, glevels = gspmd_solve(cfg, mesh, num_cycles=5,
                                levels_hier=levels_hier)
    assert glevels == levels_hier[0]
    eres, elevels = sharded_solve(cfg, mesh, num_cycles=5, tol=0.0,
                                  replicate_below=8)
    assert elevels == glevels
    # The two communication strategies (GSPMD-inserted collectives vs
    # explicit ppermute halos) reorder f32 reductions, so late-cycle
    # residual norms agree only to a few e-4 relative; anchor the atol to
    # the initial residual scale instead of chasing tiny absolute values.
    gh = np.asarray(gres.res_history)
    eh = np.asarray(eres.res_history)
    np.testing.assert_allclose(gh, eh, rtol=2e-3, atol=1e-5 * eh[0])
    np.testing.assert_allclose(np.asarray(gres.u), np.asarray(eres.u),
                               rtol=1e-3, atol=1e-6)
