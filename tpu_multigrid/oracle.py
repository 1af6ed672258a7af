"""CPU oracle: assembled sparse P1-FEM system + scipy direct solve.

Replicates the reference's *intended* semantics — the assembled 5-point CSR
system of ``globalstiffenssmatrix`` (``Poissons_SYCL.cpp:200-281``, with its
float-to-int CSR-merge truncation at ``:93`` fixed) — so the matrix-free
device operators and full solves can be validated against an independent
sparse-matrix code path (SURVEY.md §4 test pyramid, tier 3).
"""

from __future__ import annotations

import numpy as np

try:
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    HAVE_SCIPY = True
except ImportError:  # pragma: no cover
    HAVE_SCIPY = False


def poisson_matrix(n: int):
    """FEM-scaled 5-point stiffness on the (n-1)^2 interior, CSR.

    Same operator the reference assembles triangle-by-triangle and splits
    into D and L+U COO streams (``Poissons_SYCL.cpp:200-281``): diagonal 4,
    off-diagonal -1 to the four grid neighbors, Dirichlet rows/cols
    eliminated.
    """
    if not HAVE_SCIPY:
        raise RuntimeError("scipy is required for the oracle")
    m = n - 1
    one = sp.eye(m, format="csr")
    t = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(m, m), format="csr")
    return sp.kron(t, one) + sp.kron(one, t) + 0 * sp.eye(m * m)


def diffusion_matrix(n: int, cell_coeff: np.ndarray):
    """Variable-coefficient flux stencil on the interior, CSR (FEM scaling).

    Matches ``tpu_multigrid.core.operators.diffusion_op``: face
    transmissibilities are arithmetic means of the two adjacent cells.
    """
    if not HAVE_SCIPY:
        raise RuntimeError("scipy is required for the oracle")
    m = n - 1
    c = np.zeros((n + 2, n + 2))
    c[1 : n + 1, 1 : n + 1] = cell_coeff
    rows, cols, vals = [], [], []

    def dof(i, j):  # interior node (i, j), 1-based grid indices
        return (i - 1) * m + (j - 1)

    for i in range(1, n):
        for j in range(1, n):
            # cells around node (i, j): (i-1|i, j-1|j) in cell indexing,
            # shifted +1 into the padded array
            c_mm = c[i, j]        # cell (i-1, j-1)
            c_mp = c[i, j + 1]    # cell (i-1, j)
            c_pm = c[i + 1, j]    # cell (i, j-1)
            c_pp = c[i + 1, j + 1]  # cell (i, j)
            t_e = 0.5 * (c_mp + c_pp)
            t_w = 0.5 * (c_mm + c_pm)
            t_s = 0.5 * (c_pm + c_pp)
            t_n = 0.5 * (c_mm + c_mp)
            k = dof(i, j)
            rows.append(k); cols.append(k); vals.append(t_e + t_w + t_s + t_n)
            for (ii, jj, t) in ((i, j + 1, t_e), (i, j - 1, t_w),
                                (i + 1, j, t_s), (i - 1, j, t_n)):
                if 1 <= ii <= n - 1 and 1 <= jj <= n - 1:
                    rows.append(k); cols.append(dof(ii, jj)); vals.append(-t)
    return sp.csr_matrix((vals, (rows, cols)), shape=(m * m, m * m))


def solve_poisson_oracle(n: int, f=4.0) -> np.ndarray:
    """Direct sparse solve; returns the full (n+1, n+1) node grid (f64)."""
    a = poisson_matrix(n).astype(np.float64)
    h = 1.0 / n
    m = n - 1
    if callable(f):
        # (i, j) = (row, col) layout: x varies along columns, y along rows,
        # matching core.grids.node_coordinates.
        x1 = np.arange(1, n) * h
        xv = np.broadcast_to(x1[None, :], (m, m))
        yv = np.broadcast_to(x1[:, None], (m, m))
        rhs = (np.asarray(f(xv, yv)) * h * h).reshape(-1)
    else:
        rhs = np.full(m * m, float(f) * h * h)
    sol = spla.spsolve(a.tocsc(), rhs)
    out = np.zeros((n + 1, n + 1))
    out[1:n, 1:n] = sol.reshape(m, m)
    return out


def solve_diffusion_oracle(n: int, cell_coeff: np.ndarray, f=4.0) -> np.ndarray:
    a = diffusion_matrix(n, np.asarray(cell_coeff, np.float64))
    h = 1.0 / n
    m = n - 1
    if callable(f):
        x1 = np.arange(1, n) * h
        xv = np.broadcast_to(x1[None, :], (m, m))
        yv = np.broadcast_to(x1[:, None], (m, m))
        rhs = (np.asarray(f(xv, yv)) * h * h).reshape(-1)
    else:
        rhs = np.full(m * m, float(f) * h * h)
    sol = spla.spsolve(a.tocsc(), rhs)
    out = np.zeros((n + 1, n + 1))
    out[1:n, 1:n] = sol.reshape(m, m)
    return out
