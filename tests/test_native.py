"""Native C++ host library vs scipy oracle and the matrix-free ops."""

import numpy as np
import pytest

from tpu_multigrid import native, oracle


@pytest.fixture(autouse=True)
def _native_library():
    # Decided per test, never at import: every xdist worker must collect
    # the same tests.
    if not native.available():
        pytest.skip("native library unavailable (no g++)")


def test_native_poisson_assembly_matches_scipy():
    import scipy.sparse as sp
    n = 32
    indptr, indices, data = native.assemble_csr(n)
    a = sp.csr_matrix((data, indices, indptr),
                      shape=((n - 1) ** 2, (n - 1) ** 2))
    want = oracle.poisson_matrix(n)
    assert (a != want).nnz == 0 or abs(a - want).max() < 1e-14


def test_native_diffusion_assembly_matches_scipy(rng):
    import scipy.sparse as sp
    n = 16
    cells = 1.0 + rng.random((n, n))
    indptr, indices, data = native.assemble_csr(n, cells)
    a = sp.csr_matrix((data, indices, indptr),
                      shape=((n - 1) ** 2, (n - 1) ** 2))
    want = oracle.diffusion_matrix(n, cells)
    assert abs(a - want).max() < 1e-13


def test_native_coo_to_csr_merges_duplicates():
    # Duplicate entries must be SUMMED in double precision — the reference's
    # merge truncated float values to int (Poissons_SYCL.cpp:93).
    rows = 3
    coo_i = [0, 0, 1, 2, 2, 2]
    coo_j = [1, 1, 0, 2, 2, 0]
    coo_v = [0.25, 0.5, 1.5, 0.1, 0.2, -1.0]
    indptr, indices, data = native.coo_to_csr(rows, coo_i, coo_j, coo_v)
    assert list(indptr) == [0, 1, 2, 4]
    assert list(indices) == [1, 0, 0, 2]
    np.testing.assert_allclose(data, [0.75, 1.5, -1.0, 0.30000000000000004])


def test_native_rhs_matches_reference_semantics():
    n = 16
    b = native.assemble_rhs(n)
    np.testing.assert_allclose(b, 4.0 / n**2)
    f = np.arange((n - 1) ** 2, dtype=np.float64)
    b2 = native.assemble_rhs(n, f)
    np.testing.assert_allclose(b2, f / n**2)


def test_native_spmv_and_residual(rng):
    n = 16
    m = (n - 1) ** 2
    indptr, indices, data = native.assemble_csr(n)
    x = rng.standard_normal(m)
    y = native.spmv(indptr, indices, data, x)
    want = oracle.poisson_matrix(n) @ x
    np.testing.assert_allclose(y, want, rtol=1e-13)
    b = rng.standard_normal(m)
    rn = native.residual_norm(indptr, indices, data, x, b)
    np.testing.assert_allclose(rn, np.linalg.norm(b - want), rtol=1e-13)


def test_native_solve_matches_framework():
    """End-to-end: CG-free sanity — direct-solve the native CSR system and
    compare with the framework's multigrid solution."""
    import jax.numpy as jnp
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from tpu_multigrid import MultigridConfig, solve_poisson
    from tpu_multigrid.api import extract_solution

    n = 32
    indptr, indices, data = native.assemble_csr(n)
    a = sp.csr_matrix((data, indices, indptr),
                      shape=((n - 1) ** 2, (n - 1) ** 2))
    b = native.assemble_rhs(n)
    direct = spla.spsolve(a.tocsc(), b).reshape(n - 1, n - 1)

    cfg = MultigridConfig(finest_level=5, coarsest_level=3, dtype=jnp.float64)
    res = solve_poisson(5, config=cfg, tol=1e-12, max_cycles=50)
    u = np.asarray(extract_solution(res.u, n))[1:n, 1:n]
    rel = np.linalg.norm(u - direct) / np.linalg.norm(direct)
    assert rel < 1e-10, rel


class TestStencil9Oracle:
    """tmg_assemble_stencil9: the native CSR oracle for the whole
    VarStencilOp family — cross-validated against each operator's
    masked apply()."""

    @pytest.mark.parametrize("make_op", [
        lambda n, S: __import__(
            "tpu_multigrid.problems.anisotropic",
            fromlist=["anisotropic_poisson_op"]).anisotropic_poisson_op(
                n, S, 25.0, 1.0, dtype=np.float64),
        lambda n, S: __import__(
            "tpu_multigrid.problems.anisotropic",
            fromlist=["anisotropic_poisson_op"]).anisotropic_poisson_op(
                n, S, 1.0, 0.05, angle=0.5, dtype=np.float64),
        lambda n, S: __import__(
            "tpu_multigrid.problems.convection",
            fromlist=["convection_diffusion_op"]).convection_diffusion_op(
                n, S, 0.01, 1.0, -0.5, dtype=np.float64),
        lambda n, S: __import__(
            "tpu_multigrid.problems.helmholtz",
            fromlist=["helmholtz_op_host"]).helmholtz_op_host(
                n, S, lambda x, y: 10.0 * x, dtype=np.float64),
    ])
    def test_matches_op_apply(self, make_op, rng):
        if not native.available():
            pytest.skip("no g++ / native lib")
        import jax.numpy as jnp

        n, S = 12, 13
        op = make_op(n, S)
        indptr, indices, data = native.assemble_stencil9(
            np.asarray(op.coef, np.float64), n)
        u = np.zeros((S, S))
        u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1))
        want = np.asarray(op.apply(jnp.asarray(u)))[1:n, 1:n].ravel()
        got = native.spmv(indptr, indices, data, u[1:n, 1:n].ravel())
        np.testing.assert_allclose(got, want, atol=1e-13)

    def test_galerkin_coarse_op(self, rng):
        """The Galerkin coarse operator's stencil assembles identically."""
        if not native.available():
            pytest.skip("no g++ / native lib")
        import jax.numpy as jnp

        from tpu_multigrid.core.operators import galerkin_coarsen_host
        from tpu_multigrid.problems.anisotropic import (
            anisotropic_poisson_op)

        fine = anisotropic_poisson_op(16, 17, 7.0, 1.0, dtype=np.float64)
        opc = galerkin_coarsen_host(fine, 9)
        nc = 8
        indptr, indices, data = native.assemble_stencil9(
            np.asarray(opc.coef, np.float64), nc)
        u = np.zeros((9, 9))
        u[1:nc, 1:nc] = rng.standard_normal((nc - 1, nc - 1))
        want = np.asarray(opc.apply(jnp.asarray(u)))[1:nc, 1:nc].ravel()
        got = native.spmv(indptr, indices, data, u[1:nc, 1:nc].ravel())
        np.testing.assert_allclose(got, want, atol=1e-13)
