"""Cross-shard zebra line relaxation via tiled all_to_all
(dist/local_var.var_zebra_alltoall; VERDICT r3 next #6): line smoothing
on genuinely 2D meshes — each half-sweep re-decomposes so every device
owns full lines, PCR runs shard-locally, and the solution scatters back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.core.lines import zebra_sweeps
from tpu_multigrid.dist import local_var as V
from tpu_multigrid.dist.mesh import make_grid_mesh, place
from tpu_multigrid.problems.anisotropic import anisotropic_poisson_op

SPEC = P("gy", "gx")
CSPEC = P(None, None, "gy", "gx")


@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("axis", [0, 1])
def test_zebra_alltoall_matches_global(mesh_shape, axis, rng):
    my, mx = mesh_shape
    mesh = make_grid_mesh(shape=mesh_shape, devices=jax.devices()[: my * mx])
    n, S = 60, 64
    op = anisotropic_poisson_op(n, S, 1.0, 0.01, dtype=np.float64)
    u = np.zeros((S, S))
    b = np.zeros((S, S))
    u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    b[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
    u, b = jnp.asarray(u), jnp.asarray(b)
    coef = jnp.asarray(op.coef)

    f = shard_map(lambda ul, bl, cl: V.var_zebra_alltoall(
        ul, bl, cl, n, 2, axis=axis), mesh=mesh,
        in_specs=(SPEC, SPEC, CSPEC), out_specs=SPEC, check_vma=False)
    cplace = jax.device_put(coef, NamedSharding(mesh, CSPEC))
    got = jax.jit(f)(place(u, mesh), place(b, mesh), cplace)
    want = zebra_sweeps(op, u, b, 2, axis=axis)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-11, atol=1e-12)


def test_anisotropic_zebra_on_2x2_mesh():
    """solve_anisotropic(mesh=(2,2), smoother=zebra_x) — the gate is
    gone; convergence matches the band-mesh solve."""
    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          dtype=jnp.float32, smoother="zebra_x")
    mesh22 = make_grid_mesh(shape=(2, 2), devices=jax.devices()[:4])
    res = mg.solve_anisotropic(6, eps_x=1.0, eps_y=0.01,
                               coarsening="full", config=cfg,
                               mesh=mesh22, num_cycles=5, tol=None)
    meshb = make_grid_mesh(shape=(4, 1), devices=jax.devices()[:4])
    ref = mg.solve_anisotropic(6, eps_x=1.0, eps_y=0.01,
                               coarsening="full", config=cfg,
                               mesh=meshb, num_cycles=5, tol=None)
    h = np.asarray(res.res_history)
    hr = np.asarray(ref.res_history)
    # zebra converges ~1.5 decades/cycle: entries past 1e-3 relative sit
    # at/near the f32 floor where roundoff dominates the comparison
    shallow = hr / hr[0] >= 1e-3
    np.testing.assert_allclose((h / h[0])[shallow], (hr / hr[0])[shallow],
                               rtol=2e-3)
    np.testing.assert_allclose((h / h[0])[~shallow],
                               (hr / hr[0])[~shallow], rtol=0.2)
    n = 64
    np.testing.assert_allclose(np.asarray(res.u)[: n + 1, : n + 1],
                               np.asarray(ref.u)[: n + 1, : n + 1],
                               rtol=1e-4, atol=1e-7)


def test_zebra_y_on_2d_mesh_api():
    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          dtype=jnp.float32, smoother="zebra_y")
    mesh = make_grid_mesh(shape=(2, 2), devices=jax.devices()[:4])
    res = mg.solve_anisotropic(6, eps_x=0.01, eps_y=1.0,
                               coarsening="full", config=cfg, mesh=mesh,
                               tol=1e-4, max_cycles=30)
    assert bool(res.converged)
