"""Multigrid-preconditioned Krylov tests (CG + BiCGStab)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_multigrid import MultigridConfig, PoissonProblem, solve_until_tol
from tpu_multigrid.krylov import bicgstab_solve, pcg_solve
from tpu_multigrid.problems import (ConvectionDiffusionProblem,
                                    DiffusionProblem)
from tpu_multigrid import oracle
from tpu_multigrid.api import extract_solution


def test_pcg_poisson_matches_oracle():
    cfg = MultigridConfig(finest_level=5, coarsest_level=3, dtype=jnp.float64)
    prob = PoissonProblem(cfg)
    b = prob.rhs()
    res = jax.jit(lambda h, b: pcg_solve(h, cfg, b, tol=1e-12,
                                         max_iters=40))(prob.hierarchy, b)
    assert bool(res.converged)
    u = np.asarray(extract_solution(res.u, 32))
    uo = oracle.solve_poisson_oracle(32)
    rel = np.linalg.norm(u - uo) / np.linalg.norm(uo)
    assert rel < 1e-10, rel


def test_pcg_converges_faster_than_plain_cycles():
    """PCG accelerates plain V-cycle iteration (same work per iteration)."""
    cfg = MultigridConfig(finest_level=6, coarsest_level=3, dtype=jnp.float64)
    prob = PoissonProblem(cfg)
    b = prob.rhs()
    plain = solve_until_tol(prob.hierarchy, cfg, b, tol=1e-10, max_cycles=50)
    pcg = jax.jit(lambda h, b: pcg_solve(h, cfg, b, tol=1e-10,
                                         max_iters=50))(prob.hierarchy, b)
    assert bool(pcg.converged)
    assert int(pcg.iterations) <= int(plain.iterations)


def test_pcg_robust_on_hard_coefficients():
    """4-orders-of-magnitude checkerboard coefficient: PCG converges."""
    a = lambda x, y: jnp.where((x > 0.5) ^ (y > 0.5), 1e2, 1e-2)
    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          smoother="rbgs", nu1=1, nu2=1, dtype=jnp.float64)
    prob = DiffusionProblem(cfg, coefficient=a)
    b = prob.rhs()
    res = jax.jit(lambda h, b: pcg_solve(h, cfg, b, tol=1e-10,
                                         max_iters=60))(prob.hierarchy, b)
    assert bool(res.converged), np.asarray(res.res_history)


def test_bicgstab_poisson_matches_oracle():
    """BiCGStab reduces to a valid SPD solver too: oracle-grade answer."""
    cfg = MultigridConfig(finest_level=5, coarsest_level=3,
                          dtype=jnp.float64)
    prob = PoissonProblem(cfg)
    b = prob.rhs()
    res = jax.jit(lambda h, b: bicgstab_solve(
        h, cfg, b, tol=1e-12, max_iters=40))(prob.hierarchy, b)
    assert bool(res.converged)
    u = np.asarray(extract_solution(res.u, 32))
    uo = oracle.solve_poisson_oracle(32)
    rel = np.linalg.norm(u - uo) / np.linalg.norm(uo)
    assert rel < 1e-10, rel


def test_bicgstab_nonsymmetric_convection():
    """The Krylov wrapper CG cannot provide: MG-preconditioned BiCGStab
    on the upwind convection-diffusion operator at high mesh Peclet."""
    cfg = MultigridConfig(finest_level=6, coarsest_level=3,
                          smoother="rbgs", nu1=2, nu2=2,
                          dtype=jnp.float64)
    prob = ConvectionDiffusionProblem(cfg, eps=0.002, bx=1.0, by=0.5)
    b = prob.rhs()
    res = jax.jit(lambda h, bb: bicgstab_solve(
        h, cfg, bb, tol=1e-10, max_iters=30))(prob.hierarchy, b)
    assert bool(res.converged), np.asarray(res.res_history)
    # verify against a dense direct solve of the same operator
    op = prob.finest
    n, S = op.n, op.S
    from tpu_multigrid.core.grids import coarse_dense_inverse

    inv = np.asarray(coarse_dense_inverse(op, dtype=jnp.float64))
    want = (inv @ np.asarray(b)[1:n, 1:n].ravel()).reshape(n - 1, n - 1)
    got = np.asarray(res.u)[1:n, 1:n]
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    # residual -> error amplification is ~1/eps for convection-dominated
    # operators, so a 1e-10 residual reduction bounds the error near 1e-6
    assert rel < 1e-5, rel
