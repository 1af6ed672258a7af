"""Mixed Dirichlet/Neumann boundary conditions (problems/mixedbc.py).

Extension beyond the all-Dirichlet reference: box unknown sets,
ghost-reflection Neumann rows, box-aware transfers and coarse solve,
inhomogeneous du/dn = g.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_multigrid import MultigridConfig, MixedBCPoissonProblem
from tpu_multigrid.core import ops
from tpu_multigrid.cycles import solve_until_tol
from tpu_multigrid.problems.mixedbc import mixed_poisson_op, _box_of


def dense_mixed(n, neumann):
    """Independent dense assembly of the mixed-BC Laplacian (row-major over
    the inclusive unknown box)."""
    i0, i1, j0, j1 = _box_of(n, frozenset(neumann))
    ri, rj = i1 - i0 + 1, j1 - j0 + 1
    m = ri * rj
    A = np.zeros((m, m))

    def uid(i, j):
        if i0 <= i <= i1 and j0 <= j <= j1:
            return (i - i0) * rj + (j - j0)
        return -1

    for i in range(i0, i1 + 1):
        for j in range(j0, j1 + 1):
            r = uid(i, j)
            # FEM half-cell row weight: 0.5 per Neumann side the node is on.
            w = 1.0
            if "bottom" in neumann and i == 0:
                w *= 0.5
            if "top" in neumann and i == n:
                w *= 0.5
            if "left" in neumann and j == 0:
                w *= 0.5
            if "right" in neumann and j == n:
                w *= 0.5
            A[r, r] = 4.0 * w
            nbrs = {(-1, 0): -1.0, (1, 0): -1.0, (0, -1): -1.0, (0, 1): -1.0}
            if "bottom" in neumann and i == 0:
                nbrs[(1, 0)] = -2.0
                nbrs[(-1, 0)] = 0.0
            if "top" in neumann and i == n:
                nbrs[(-1, 0)] = -2.0
                nbrs[(1, 0)] = 0.0
            if "left" in neumann and j == 0:
                nbrs[(0, 1)] = -2.0
                nbrs[(0, -1)] = 0.0
            if "right" in neumann and j == n:
                nbrs[(0, -1)] = -2.0
                nbrs[(0, 1)] = 0.0
            for (di, dj), v in nbrs.items():
                c = uid(i + di, j + dj)
                if c >= 0 and v != 0.0:
                    A[r, c] += v * w
    return A, (i0, i1, j0, j1)


def to_vec(g, box):
    i0, i1, j0, j1 = box
    return np.asarray(g)[i0:i1 + 1, j0:j1 + 1].reshape(-1)


class TestOperator:
    @pytest.mark.parametrize("neumann", [("left",), ("left", "right"),
                                         ("bottom", "left", "top")])
    def test_apply_matches_dense(self, rng, neumann):
        n, S = 8, 9
        op = mixed_poisson_op(n, S, neumann, dtype=np.float64)
        A, box = dense_mixed(n, neumann)
        u = np.zeros((S, S))
        i0, i1, j0, j1 = box
        u[i0:i1 + 1, j0:j1 + 1] = rng.standard_normal(
            (i1 - i0 + 1, j1 - j0 + 1))
        got = to_vec(op.apply(jnp.asarray(u)), box)
        np.testing.assert_allclose(got, A @ to_vec(u, box), atol=1e-12)

    def test_operator_spd(self):
        """The half-cell row scaling makes the mixed operator SPD — the
        property Galerkin coarsening needs for mesh-independent rates."""
        A, _ = dense_mixed(8, ("left", "bottom"))
        np.testing.assert_allclose(A, A.T, atol=1e-14)
        assert np.linalg.eigvalsh(A).min() > 0

    def test_all_neumann_rejected(self):
        with pytest.raises(ValueError):
            mixed_poisson_op(8, 9, ("bottom", "top", "left", "right"))

    def test_jacobi_fixed_point(self, rng):
        n, S = 8, 9
        op = mixed_poisson_op(n, S, ("left", "top"), dtype=np.float64)
        box = op.box
        u = np.zeros((S, S))
        i0, i1, j0, j1 = box
        u[i0:i1 + 1, j0:j1 + 1] = rng.standard_normal(
            (i1 - i0 + 1, j1 - j0 + 1))
        u = jnp.asarray(u)
        b = op.apply(u)
        out = op.smooth(u, b, smoother="jacobi", omega=2 / 3, sweeps=4)
        np.testing.assert_allclose(np.asarray(out), np.asarray(u),
                                   atol=1e-12)


class TestSolve:
    def test_matches_dense_solve(self):
        n = 16
        neumann = ("left", "bottom")
        cfg = MultigridConfig(finest_level=4, coarsest_level=2,
                              dtype=jnp.float64)
        prob = MixedBCPoissonProblem(cfg, neumann=neumann)
        res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(), tol=1e-12,
                              max_cycles=60)
        A, box = dense_mixed(n, neumann)
        want = np.linalg.solve(A, to_vec(prob.rhs(), box))
        np.testing.assert_allclose(to_vec(res.u, box), want, rtol=1e-9)

    @pytest.mark.parametrize("neumann", [("left",), ("left", "right"),
                                         ("bottom", "top", "left")])
    def test_convergence_mesh_independent(self, neumann):
        rhos = []
        for lvl in (4, 5, 6):
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  nu1=2, nu2=2, dtype=jnp.float64)
            prob = MixedBCPoissonProblem(cfg, neumann=neumann)
            res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                  tol=1e-10, max_cycles=40)
            assert bool(res.converged)
            hist = np.asarray(res.res_history)
            n_it = int(res.iterations)
            rhos.append((hist[n_it] / hist[0]) ** (1.0 / n_it))
        assert max(rhos) < 0.22, rhos
        assert max(rhos) - min(rhos) < 0.04, rhos

    def test_manufactured_homogeneous_neumann_order(self):
        """u = cos(pi x) sin(pi y), du/dx = 0 at x in {0, 1}: O(h^2)."""
        def forcing(x, y):
            return (2 * math.pi ** 2 * jnp.cos(math.pi * x)
                    * jnp.sin(math.pi * y))

        errs = []
        for lvl in (4, 5, 6):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  dtype=jnp.float64)
            prob = MixedBCPoissonProblem(cfg, neumann=("left", "right"),
                                         forcing=forcing)
            res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                  tol=1e-11, max_cycles=60)
            from tpu_multigrid.core.grids import node_coordinates
            x, y = node_coordinates(n, n + 1, jnp.float64)
            exact = ops.mask_box(
                jnp.cos(math.pi * x) * jnp.sin(math.pi * y),
                prob.finest.box)
            err = np.asarray(res.u - exact)
            errs.append(np.sqrt((err ** 2).mean()))
        assert errs[0] / errs[1] > 3.3, errs
        assert errs[1] / errs[2] > 3.3, errs

    def test_manufactured_inhomogeneous_neumann_exact(self):
        """u = (x^2 + x) y(1-y); Neumann left/right with nonzero g.

        Separable quadratics are differenced *exactly* by the 5-point
        stencil, and the ghost-reflection closure is exact for quadratics
        too — so the discrete solution must equal the manufactured one to
        solver tolerance (a stronger check than an O(h^2) trend, and it
        exercises the inhomogeneous 2hg RHS terms and their row scaling
        end to end)."""
        def forcing(x, y):
            return -2.0 * y * (1 - y) + 2.0 * (x * x + x)

        def g(x, y):
            # outward-normal derivative: left (x=0): -(2x+1) y(1-y) = -y(1-y)
            # right (x=1): +(2x+1) y(1-y) = 3 y(1-y)
            return jnp.where(x < 0.5, -y * (1 - y), 3.0 * y * (1 - y))

        for lvl in (4, 6):
            n = 2 ** lvl
            cfg = MultigridConfig(finest_level=lvl, coarsest_level=2,
                                  dtype=jnp.float64)
            prob = MixedBCPoissonProblem(cfg, neumann=("left", "right"),
                                         forcing=forcing, neumann_value=g)
            res = solve_until_tol(prob.hierarchy, cfg, prob.rhs(),
                                  tol=1e-11, max_cycles=60)
            from tpu_multigrid.core.grids import node_coordinates
            x, y = node_coordinates(n, n + 1, jnp.float64)
            exact = ops.mask_box((x * x + x) * y * (1 - y),
                                 prob.finest.box)
            err = np.asarray(res.u - exact)
            assert np.sqrt((err ** 2).mean()) < 1e-11, lvl

    def test_api_entry_and_guards(self):
        import tpu_multigrid as mg
        res = mg.solve_poisson(4, config=MultigridConfig(
            finest_level=4, coarsest_level=2, dtype=jnp.float64),
            neumann=("left",), tol=1e-9)
        assert bool(res.converged)
        # Neumann-side boundary nodes are unknowns (nonzero solution there)
        assert abs(float(res.u[8, 0])) > 1e-6
        with pytest.raises(ValueError):
            mg.solve_poisson(4, neumann=("left",), boundary=1.0)
        with pytest.raises(ValueError):
            mg.solve_poisson(4, neumann=("left",), refined=True)

    def test_fmg_mixed(self):
        cfg = MultigridConfig(finest_level=5, coarsest_level=2, nu0=2,
                              dtype=jnp.float64)
        prob = MixedBCPoissonProblem(cfg, neumann=("left",))
        from tpu_multigrid.cycles import fmg
        u = fmg(prob.hierarchy, cfg, prob.rhs())
        r = prob.finest.residual(u, prob.rhs())
        b = prob.rhs()
        assert float(ops.norm2(r) / ops.norm2(b)) < 5e-3


