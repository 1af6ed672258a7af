"""3D variable-coefficient diffusion (problems/diffusion3d.py):
flux-stencil correctness, SPD, O(h²) manufactured order, and
mesh-independent convergence with a coefficient contrast."""

import math

import numpy as np
import jax.numpy as jnp
import pytest

import tpu_multigrid as mg
from tpu_multigrid import MultigridConfig
from tpu_multigrid.core.operators import ConstStencilOp3D, diffusion_op3_host
from tpu_multigrid.cycles import solve_until_tol
from tpu_multigrid.problems import Diffusion3DProblem
from tpu_multigrid.utils import debug


def test_unit_coefficient_reduces_to_poisson(rng):
    n, S, Sx = 8, 16, 128
    op = diffusion_op3_host(np.ones((n, n, n)), n, S, Sx)
    pop = ConstStencilOp3D(n, S, Sx)
    u = np.zeros((S, S, Sx))
    u[1:n, 1:n, 1:n] = rng.standard_normal((n - 1,) * 3)
    u = jnp.asarray(u)
    np.testing.assert_allclose(np.asarray(op.apply(u)),
                               np.asarray(pop.apply(u)), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(op.smooth(u, pop.apply(u), smoother="jacobi",
                             omega=2 / 3, sweeps=3)),
        np.asarray(pop.smooth(u, pop.apply(u), smoother="jacobi",
                              omega=2 / 3, sweeps=3)), atol=1e-12)


def test_operator_spd(rng):
    n, S, Sx = 8, 16, 128
    cells = np.exp(rng.standard_normal((n, n, n)))
    op = diffusion_op3_host(cells, n, S, Sx)
    debug.check_operator(op, rng)


def test_manufactured_solution_order():
    """a = 1 + x, u = sin(pi x) sin(pi y) sin(pi z):
    f = -div(a grad u) = 3 pi^2 a u - pi cos(pi x) sin(pi y) sin(pi z)."""
    def a(x, y, z):
        return 1.0 + x

    def forcing(x, y, z):
        s = (jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
             * jnp.sin(math.pi * z))
        return (3 * math.pi ** 2 * (1.0 + x) * s
                - math.pi * jnp.cos(math.pi * x) * jnp.sin(math.pi * y)
                * jnp.sin(math.pi * z))

    errs = []
    for lvl in (3, 4, 5):
        n = 2 ** lvl
        cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        prob = Diffusion3DProblem(cfg, coefficient=a, forcing=forcing)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-11,
                              max_cycles=60)
        assert bool(res.converged)
        from tpu_multigrid.problems.poisson3d import node_coordinates3
        x, y, z = node_coordinates3(n, prob.finest.grid_shape, jnp.float64)
        exact = (jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
                 * jnp.sin(math.pi * z))
        err = (np.asarray(res.u) - np.asarray(exact))[1:n, 1:n, 1:n]
        errs.append(np.sqrt((err ** 2).mean()))
    assert errs[0] / errs[1] > 3.0
    assert errs[1] / errs[2] > 3.3


def test_convergence_mesh_independent_with_contrast():
    """Smooth 10:1 coefficient contrast: flat rho in depth."""
    def a(x, y, z):
        return 1.0 + 9.0 * x * y * z

    rhos = []
    for lvl in (3, 4, 5):
        cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        prob = Diffusion3DProblem(cfg, coefficient=a)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-10,
                              max_cycles=40)
        h = np.asarray(res.res_history)
        it = int(res.iterations)
        rhos.append((h[it] / h[0]) ** (1.0 / it))
    assert max(rhos) < 0.30
    assert max(rhos) - min(rhos) < 0.12


def test_api_entry():
    cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                          smoother="chebyshev", nu1=3, nu2=2,
                          dtype=jnp.float64)
    res = mg.solve_diffusion3d(4, coefficient=lambda x, y, z: 1.0 + x,
                               config=cfg, tol=1e-9)
    assert bool(res.converged)
    u = mg.extract_solution(res.u, 16)
    assert u.shape == (17, 17, 17)
    assert float(u[8, 8, 8]) > 0


def test_apply_matches_dense_assembly(rng):
    """The flux stencil equals a dense assembly built independently from
    the four-cell edge-transmissibility definition (random coefficients —
    the a=1 reduction cannot catch direction/sign errors)."""
    n, S, Sx = 4, 8, 128
    cells = np.exp(rng.standard_normal((n, n, n)))
    op = diffusion_op3_host(cells, n, S, Sx)

    def edge_t(P, Q):
        (z1, y1, x1), (z2, y2, x2) = P, Q
        vals = []
        if x1 != x2:
            xm = min(x1, x2)
            corners = [(cz, cy, xm) for cz in (z1 - 1, z1)
                       for cy in (y1 - 1, y1)]
        elif y1 != y2:
            ym = min(y1, y2)
            corners = [(cz, ym, cx) for cz in (z1 - 1, z1)
                       for cx in (x1 - 1, x1)]
        else:
            zm = min(z1, z2)
            corners = [(zm, cy, cx) for cy in (y1 - 1, y1)
                       for cx in (x1 - 1, x1)]
        for c in corners:
            ok = all(0 <= v < n for v in c)
            vals.append(cells[c] if ok else 0.0)
        return sum(vals) / 4.0

    m1 = n - 1
    m = m1 ** 3
    nodes = [(z, y, x) for z in range(1, n) for y in range(1, n)
             for x in range(1, n)]
    index = {p: i for i, p in enumerate(nodes)}
    A = np.zeros((m, m))
    for P, r in index.items():
        z, y, x = P
        diag = 0.0
        for dz, dy, dx in ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                           (0, 0, 1), (0, 0, -1)):
            Q = (z + dz, y + dy, x + dx)
            t = edge_t(P, Q)
            diag += t
            if Q in index:
                A[r, index[Q]] -= t
        A[r, r] = diag

    u = np.zeros((S, S, Sx))
    u[1:n, 1:n, 1:n] = rng.standard_normal((m1,) * 3)
    got = np.asarray(op.apply(jnp.asarray(u)))[1:n, 1:n, 1:n].ravel()
    want = A @ u[1:n, 1:n, 1:n].ravel()
    np.testing.assert_allclose(got, want, atol=1e-12)


class TestReactionShift3D:
    """3D reaction-diffusion -div(a grad u) + c u = f
    (Diffusion3DProblem(shift=...), the 3D analogue of solve_helmholtz)."""

    def test_zero_shift_is_plain_diffusion(self):
        cfg = MultigridConfig(finest_level=3, coarsest_level=2,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        p = Diffusion3DProblem(cfg, coefficient=1.0, shift=0.0,
                               lane_align=1, align=1, min_pad_level=99)
        assert p.hierarchy.levels[0].c2 is None

    def test_manufactured_o_h2(self):
        import math

        import tpu_multigrid as mg

        pi = math.pi
        c = 5.0
        errs = {}
        for lvl in (3, 4):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  smoother="chebyshev", nu1=3, nu2=2,
                                  dtype=jnp.float64)
            f = lambda x, y, z: ((3 * pi ** 2 + c) * jnp.sin(pi * x)
                                 * jnp.sin(pi * y) * jnp.sin(pi * z))
            r = mg.solve_diffusion3d(lvl, coefficient=1.0, shift=c,
                                     forcing=f, config=cfg, num_cycles=12)
            S = n + 1
            idx = np.arange(S) / n
            want = (np.sin(pi * idx)[:, None, None]
                    * np.sin(pi * idx)[None, :, None]
                    * np.sin(pi * idx)[None, None, :])
            errs[lvl] = np.abs(np.asarray(r.u)[:S, :S, :S]
                               - want)[1:n, 1:n, 1:n].max()
        assert 3.0 < errs[3] / errs[4] < 5.2, errs

    def test_variable_shift_converges_at_least_like_diffusion(self):
        cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                              smoother="chebyshev", nu1=3, nu2=2,
                              dtype=jnp.float64)
        from tpu_multigrid.cycles import solve_fixed
        p0 = Diffusion3DProblem(cfg, coefficient=1.0, lane_align=1,
                                align=1, min_pad_level=99)
        pc = Diffusion3DProblem(cfg, coefficient=1.0,
                                shift=lambda x, y, z: 50.0 * x * y,
                                lane_align=1, align=1, min_pad_level=99)
        h0 = np.asarray(solve_fixed(p0.hierarchy, cfg, p0.rhs(),
                                    8).res_history)
        hc = np.asarray(solve_fixed(pc.hierarchy, cfg, pc.rhs(),
                                    8).res_history)
        # positive shift strengthens the diagonal: at least as fast
        assert hc[8] / hc[0] <= 2.0 * (h0[8] / h0[0]), (hc, h0)

    def test_negative_shift_rejected_when_indefinite(self):
        cfg = MultigridConfig(finest_level=3, coarsest_level=2,
                              dtype=jnp.float64)
        with pytest.raises(ValueError):
            Diffusion3DProblem(cfg, coefficient=1.0, shift=-1e6,
                               lane_align=1, align=1, min_pad_level=99)

    def test_sharded_levels_refuse_shift(self):
        """The sharded 3D path recomputes diagonals from the t planes, so
        a shifted level must be rejected rather than silently dropping c."""
        import jax as _jax

        from tpu_multigrid.core.grids import Hierarchy
        from tpu_multigrid.dist.shard_cycle3 import (ShardedLevels3,
                                                     _split_hier3,
                                                     make_grid_mesh3)
        from tpu_multigrid.problems.diffusion3d import (
            build_diffusion3d_hierarchy)

        cfg = MultigridConfig(finest_level=3, coarsest_level=2)
        hier = build_diffusion3d_hierarchy(cfg, 1.0, shift=3.0,
                                           lane_align=1, align=1,
                                           min_pad_level=99)
        assert hier.levels[0].c2 is not None
        mesh = make_grid_mesh3(shape=(1, 1), devices=_jax.devices()[:1])
        levels = ShardedLevels3(sizes=tuple((op.n, op.S)
                                            for op in hier.levels),
                                num_sharded=1)
        with pytest.raises(ValueError):
            _split_hier3(levels, hier, mesh)
