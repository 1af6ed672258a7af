// Native host-side assembly / sparse kernels for tpu-multigrid.
//
// The reference's entire setup path is host C++: triangle-by-triangle P1
// stiffness assembly into COO (globalstiffenssmatrix,
// Poissons_SYCL.cpp:200-281), load-vector assembly (globalforcefunction,
// :283-335), and a serial COO->CSR conversion with duplicate merging
// (coo_to_csr, :55-116 — which truncates float data to int at :93).  This
// library provides the same capabilities as a clean C++17 implementation
// with a C ABI for ctypes binding:
//
//   * P1 FEM assembly of the unit-square Poisson stiffness (Dirichlet
//     boundary eliminated) directly into CSR — element loop over the two
//     triangles per cell, exact duplicate merging in double precision;
//   * variable-coefficient 5-point flux-stencil assembly (per-cell
//     coefficients, arithmetic face means) matching
//     tpu_multigrid.core.operators.diffusion_op;
//   * load-vector assembly b = f*h^2 (force_function_element semantics:
//     six triangles of area h^2/2 contribute f*area/3 per interior node);
//   * CSR SpMV and residual for host-side verification.
//
// The device compute path never uses these (it is matrix-free); this is the
// native runtime's independent oracle and setup layer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// Interior-node id for grid node (i, j), 1-based interior indexing;
// -1 for boundary nodes.  Row-major over the (n-1)x(n-1) interior.
inline std::int64_t dof(std::int64_t i, std::int64_t j, std::int64_t n) {
  if (i < 1 || i > n - 1 || j < 1 || j > n - 1) return -1;
  return (i - 1) * (n - 1) + (j - 1);
}

struct Csr {
  std::vector<std::int64_t> indptr;
  std::vector<std::int64_t> indices;
  std::vector<double> data;
};

// Dense-per-row accumulation buffer sized 5 (self + 4 neighbors) is enough
// for the 5-point patterns assembled here.
void assemble_rows(std::int64_t n,
                   const double* cell_coeff,  // (n*n) or nullptr => 1.0
                   Csr* out) {
  const std::int64_t m = (n - 1) * (n - 1);
  out->indptr.assign(m + 1, 0);
  out->indices.clear();
  out->data.clear();
  out->indices.reserve(5 * m);
  out->data.reserve(5 * m);

  auto cc = [&](std::int64_t ci, std::int64_t cj) -> double {
    if (ci < 0 || ci >= n || cj < 0 || cj >= n) return 0.0;
    return cell_coeff ? cell_coeff[ci * n + cj] : 1.0;
  };

  for (std::int64_t i = 1; i <= n - 1; ++i) {
    for (std::int64_t j = 1; j <= n - 1; ++j) {
      // Face transmissibilities at node (i, j): arithmetic mean of the two
      // cells sharing each edge (cells indexed by their min corner).
      const double t_e = 0.5 * (cc(i - 1, j) + cc(i, j));
      const double t_w = 0.5 * (cc(i - 1, j - 1) + cc(i, j - 1));
      const double t_s = 0.5 * (cc(i, j - 1) + cc(i, j));
      const double t_n = 0.5 * (cc(i - 1, j - 1) + cc(i - 1, j));

      const std::int64_t row = dof(i, j, n);
      struct Ent { std::int64_t col; double val; };
      Ent ents[5];
      int k = 0;
      ents[k++] = {row, t_e + t_w + t_s + t_n};
      if (std::int64_t c = dof(i, j + 1, n); c >= 0) ents[k++] = {c, -t_e};
      if (std::int64_t c = dof(i, j - 1, n); c >= 0) ents[k++] = {c, -t_w};
      if (std::int64_t c = dof(i + 1, j, n); c >= 0) ents[k++] = {c, -t_s};
      if (std::int64_t c = dof(i - 1, j, n); c >= 0) ents[k++] = {c, -t_n};
      // insertion-sort by column (<= 5 entries)
      for (int a = 1; a < k; ++a) {
        Ent e = ents[a];
        int b = a - 1;
        while (b >= 0 && ents[b].col > e.col) { ents[b + 1] = ents[b]; --b; }
        ents[b + 1] = e;
      }
      for (int a = 0; a < k; ++a) {
        out->indices.push_back(ents[a].col);
        out->data.push_back(ents[a].val);
      }
      out->indptr[row + 1] = out->indices.size();
    }
  }
}

}  // namespace

extern "C" {

// ---- COO -> CSR with duplicate merging (double precision). ----
// Returns nnz of the merged matrix.  Caller provides output buffers of at
// least `nnz_in` capacity (merged nnz <= nnz_in).  Reference equivalent:
// coo_to_csr (Poissons_SYCL.cpp:55-116), with the float->int truncation
// bug (:93) fixed by accumulating in double.
std::int64_t tmg_coo_to_csr(std::int64_t rows, std::int64_t nnz_in,
                            const std::int64_t* coo_i,
                            const std::int64_t* coo_j, const double* coo_v,
                            std::int64_t* indptr, std::int64_t* indices,
                            double* data) {
  std::vector<std::vector<std::pair<std::int64_t, double>>> rowbuf(rows);
  for (std::int64_t k = 0; k < nnz_in; ++k) {
    rowbuf[coo_i[k]].push_back({coo_j[k], coo_v[k]});
  }
  std::int64_t nnz = 0;
  indptr[0] = 0;
  for (std::int64_t r = 0; r < rows; ++r) {
    auto& rb = rowbuf[r];
    std::sort(rb.begin(), rb.end());
    for (std::size_t k = 0; k < rb.size();) {
      double acc = 0.0;
      std::size_t k2 = k;
      while (k2 < rb.size() && rb[k2].first == rb[k].first) {
        acc += rb[k2].second;
        ++k2;
      }
      indices[nnz] = rb[k].first;
      data[nnz] = acc;
      ++nnz;
      k = k2;
    }
    indptr[r + 1] = nnz;
  }
  return nnz;
}

// ---- P1 FEM / flux-stencil assembly into caller buffers. ----
// cell_coeff: (n*n) per-cell coefficients or nullptr for Poisson (a=1),
// in which case the stencil is exactly [[0,-1,0],[-1,4,-1],[0,-1,0]].
// Buffers: indptr[(n-1)^2+1], indices[5*(n-1)^2], data[5*(n-1)^2].
// Returns nnz.
std::int64_t tmg_assemble(std::int64_t n, const double* cell_coeff,
                          std::int64_t* indptr, std::int64_t* indices,
                          double* data) {
  Csr csr;
  assemble_rows(n, cell_coeff, &csr);
  std::memcpy(indptr, csr.indptr.data(),
              csr.indptr.size() * sizeof(std::int64_t));
  std::memcpy(indices, csr.indices.data(),
              csr.indices.size() * sizeof(std::int64_t));
  std::memcpy(data, csr.data.data(), csr.data.size() * sizeof(double));
  return static_cast<std::int64_t>(csr.data.size());
}

// ---- General 9-point stencil assembly from coefficient planes. ----
// coef: (3*3*S*S) row-major planes, coef[((di+1)*3+(dj+1))*S*S + i*S + j]
// multiplying u[i+di, j+dj] in (A u)[i, j]; unknowns are the Dirichlet
// interior 1..n-1 (columns at non-unknown nodes are dropped — they
// multiply hard zeros on the padded grids).  Serves as the independent
// host oracle for EVERY stencil family the Python side builds
// (anisotropic/rotated tensors, Helmholtz shifts, upwind convection,
// Galerkin coarse operators).  Buffers: indptr[(n-1)^2+1],
// indices/data[9*(n-1)^2].  Returns nnz.
std::int64_t tmg_assemble_stencil9(std::int64_t n, std::int64_t S,
                                   const double* coef, std::int64_t* indptr,
                                   std::int64_t* indices, double* data) {
  const std::int64_t m1 = n - 1;
  std::int64_t nnz = 0;
  indptr[0] = 0;
  std::int64_t row = 0;
  for (std::int64_t i = 1; i <= m1; ++i) {
    for (std::int64_t j = 1; j <= m1; ++j, ++row) {
      for (int di = -1; di <= 1; ++di) {
        for (int dj = -1; dj <= 1; ++dj) {
          const std::int64_t ii = i + di, jj = j + dj;
          if (ii < 1 || ii > m1 || jj < 1 || jj > m1) continue;
          const double v =
              coef[((di + 1) * 3 + (dj + 1)) * S * S + i * S + j];
          if (v == 0.0) continue;
          indices[nnz] = (ii - 1) * m1 + (jj - 1);
          data[nnz] = v;
          ++nnz;
        }
      }
      indptr[row + 1] = nnz;
    }
  }
  return nnz;
}

// ---- Load vector b = f * h^2 over the interior (row-major (n-1)^2). ----
// f_values: per-node forcing sampled at interior nodes, or nullptr for the
// reference's constant f = 4 (Poissons_SYCL.cpp:121).
void tmg_assemble_rhs(std::int64_t n, const double* f_values, double* out) {
  const double h2 = 1.0 / (static_cast<double>(n) * n);
  const std::int64_t m = (n - 1) * (n - 1);
  for (std::int64_t k = 0; k < m; ++k) {
    out[k] = (f_values ? f_values[k] : 4.0) * h2;
  }
}

// ---- CSR SpMV: y = A x. ----
void tmg_spmv(std::int64_t rows, const std::int64_t* indptr,
              const std::int64_t* indices, const double* data,
              const double* x, double* y) {
  for (std::int64_t r = 0; r < rows; ++r) {
    double acc = 0.0;
    for (std::int64_t k = indptr[r]; k < indptr[r + 1]; ++k) {
      acc += data[k] * x[indices[k]];
    }
    y[r] = acc;
  }
}

// ---- Residual: r = b - A x; returns ||r||_2. ----
double tmg_residual(std::int64_t rows, const std::int64_t* indptr,
                    const std::int64_t* indices, const double* data,
                    const double* x, const double* b, double* r) {
  double ss = 0.0;
  for (std::int64_t row = 0; row < rows; ++row) {
    double acc = b[row];
    for (std::int64_t k = indptr[row]; k < indptr[row + 1]; ++k) {
      acc -= data[k] * x[indices[k]];
    }
    if (r) r[row] = acc;
    ss += acc * acc;
  }
  return std::sqrt(ss);
}

}  // extern "C"
