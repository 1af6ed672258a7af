// Fused level visit of the constant-coefficient 2D Poisson V-cycle.
//
// Two kernels, each one pass over the level's grid:
//
//   K1  u <- k weighted-Jacobi/Chebyshev sweeps of u against b, then
//       r = b - A u and rc = R r (full weighting, FEM scaling /4).
//       Reads u and b, writes u and the coarse rc.
//   K2  u <- u + P ec (bilinear), then k sweeps; optionally the squared
//       residual of the result, summed per block.
//       Reads u, b and the coarse ec, writes u.
//
// Grids are (S, S) row-major float32; the unknowns are 1..n-1 on each axis
// and everything else is zero on input and on output (the invariant of
// tpu_multigrid.core.ops).  The arithmetic follows the jnp operators in
// that module term by term, so results differ from them only by the
// compiler's contractions.
//
// Temporal blocking: a block owns a 128 x 64 tile in shared memory, of
// which the core (tile minus a halo of H on every side) is written back.
// Every step (sweep, residual, blur) shrinks the valid region by one ring,
// so H is the number of dependent steps.  Each thread owns one tile
// column and a segment of R rows of it in registers and updates it in
// place; its left and right neighbours come from shared memory, its upper
// and lower neighbours from its own registers except at the segment ends.
// At most 64 registers a thread let two blocks share an SM, so one block's
// loads overlap the other's sweeps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I <jax.ffi.include_dir()> level2d.cu
// (tpu_multigrid/kernels/level2d.py does this at first use).

#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int TW = 128;        // tile width = threads in x
constexpr int TY = 4;          // row segments = threads in y
constexpr int R = 16;          // rows per segment
constexpr int TH = TY * R;     // tile height
constexpr int MAX_SWEEPS = 8;

struct Weights {
  float one_minus[MAX_SWEEPS];  // 1 - w
  float quarter[MAX_SWEEPS];    // w / 4
};

struct Tile {
  float sm[TH][TW];
};

// Which rows of a thread's segment are unknowns: rows lo..hi of the
// segment (inclusive) when the column is an interior one.
struct Rows {
  int lo, hi;
  __device__ bool operator()(int r) const { return r >= lo && r <= hi; }
};

__device__ __forceinline__ Rows interior(int n, int i0, int gj, int ty) {
  const int g0 = i0 + ty * R;  // global row of the segment's first row
  if (gj < 1 || gj > n - 1) return Rows{1, 0};
  return Rows{1 - g0, n - 1 - g0};
}

// Publish the segment to shared memory and read the rows just above and
// below it (owned by the neighbouring segments).
__device__ __forceinline__ void publish(const float (&v)[R], Tile& t, int tx,
                                        int ty, float& up, float& dn) {
  const int r0 = ty * R;
#pragma unroll
  for (int r = 0; r < R; ++r) t.sm[r0 + r][tx] = v[r];
  __syncthreads();
  up = ty > 0 ? t.sm[r0 - 1][tx] : 0.f;
  dn = ty < TY - 1 ? t.sm[r0 + R][tx] : 0.f;
}

__device__ __forceinline__ float left(const Tile& t, int row, int tx) {
  return tx > 0 ? t.sm[row][tx - 1] : 0.f;
}

__device__ __forceinline__ float right(const Tile& t, int row, int tx) {
  return tx < TW - 1 ? t.sm[row][tx + 1] : 0.f;
}

// One weighted-Jacobi step, in place: the update of row r reads the old
// rows r-1 (kept in `prev`) and r+1 (not yet updated).  The neighbour sum
// keeps the jnp order ((u[i-1] + u[i+1]) + u[j-1]) + u[j+1].
__device__ __forceinline__ void sweep(float (&v)[R], const float (&bv)[R],
                                      Rows inter, float om, float q, Tile& t,
                                      int tx, int ty) {
  float prev, dn;
  publish(v, t, tx, ty, prev, dn);
  const int r0 = ty * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float cur = v[r];
    const float nxt = r == R - 1 ? dn : v[r + 1];
    const float nsum = ((prev + nxt) + left(t, r0 + r, tx))
                       + right(t, r0 + r, tx);
    const float x = om * cur + q * (bv[r] + nsum);
    v[r] = inter(r) ? x : 0.f;
    prev = cur;
  }
  __syncthreads();
}

// v <- b - A v on the unknowns, zero elsewhere, in place.
__device__ __forceinline__ void residual(float (&v)[R], const float (&bv)[R],
                                         Rows inter, Tile& t, int tx,
                                         int ty) {
  float prev, dn;
  publish(v, t, tx, ty, prev, dn);
  const int r0 = ty * R;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float cur = v[r];
    const float nxt = r == R - 1 ? dn : v[r + 1];
    const float nsum = ((prev + nxt) + left(t, r0 + r, tx))
                       + right(t, r0 + r, tx);
    const float x = (bv[r] - 4.f * cur) + nsum;
    v[r] = inter(r) ? x : 0.f;
    prev = cur;
  }
  __syncthreads();
}

__device__ __forceinline__ void load(const float* __restrict__ g, int S,
                                     int i0, int gj, int ty,
                                     float (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int gi = i0 + ty * R + r;
    const bool in = gi >= 0 && gi < S && gj >= 0 && gj < S;
    v[r] = in ? g[(int64_t)gi * S + gj] : 0.f;
  }
}

__device__ __forceinline__ void store_core(float* __restrict__ g, int S,
                                           int H, int i0, int gj, int tx,
                                           int ty, const float (&v)[R]) {
  if (tx < H || tx >= TW - H || gj >= S) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int tr = ty * R + r;
    const int gi = i0 + tr;
    if (tr >= H && tr < TH - H && gi < S) g[(int64_t)gi * S + gj] = v[r];
  }
}

__global__ void __launch_bounds__(TW * TY, 2)
smooth_restrict_kernel(const float* __restrict__ u,
                       const float* __restrict__ b, float* __restrict__ uo,
                       float* __restrict__ rc, int S, int n, int Sc, int k,
                       Weights w) {
  __shared__ Tile t;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int H = k + 2;  // k sweeps, the residual, the restriction blur
  const int CW = TW - 2 * H, CH = TH - 2 * H;
  const int i0 = blockIdx.y * CH - H, j0 = blockIdx.x * CW - H;
  const int gj = j0 + tx;

  float v[R], bv[R];
  load(u, S, i0, gj, ty, v);
  load(b, S, i0, gj, ty, bv);
  const Rows inter = interior(n, i0, gj, ty);
  for (int s = 0; s < k; ++s)
    sweep(v, bv, inter, w.one_minus[s], w.quarter[s], t, tx, ty);
  store_core(uo, S, H, i0, gj, tx, ty, v);

  residual(v, bv, inter, t, tx, ty);
  // Full weighting = [1/2, 1, 1/2] blur along x, then along y, then keep
  // the even fine nodes (core.ops.restrict_fw); in place in v.
  const int r0 = ty * R;
  {
    float up, dn;
    publish(v, t, tx, ty, up, dn);
#pragma unroll
    for (int r = 0; r < R; ++r)
      v[r] = v[r] + 0.5f * (left(t, r0 + r, tx) + right(t, r0 + r, tx));
    __syncthreads();
    float prev;
    publish(v, t, tx, ty, prev, dn);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float cur = v[r];
      const float nxt = r == R - 1 ? dn : v[r + 1];
      v[r] = cur + 0.5f * (prev + nxt);
      prev = cur;
    }
  }
  // The core starts at an even fine index (CW, CH are even), so the even
  // fine nodes of the core are exactly the coarse nodes this block owns.
  const int nc = n / 2;
  if (tx < H || tx >= TW - H || (gj & 1)) return;
  const int J = gj >> 1;
  if (J >= Sc) return;
  const bool jin = J >= 1 && J <= nc - 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int tr = r0 + r;
    const int gi = i0 + tr;
    if (tr < H || tr >= TH - H || (gi & 1)) continue;
    const int I = gi >> 1;
    if (I >= Sc) continue;
    const bool in = jin && I >= 1 && I <= nc - 1;
    rc[(int64_t)I * Sc + J] = in ? v[r] : 0.f;
  }
}

__global__ void __launch_bounds__(TW * TY, 2)
prolong_smooth_kernel(const float* __restrict__ u,
                      const float* __restrict__ b,
                      const float* __restrict__ ec, float* __restrict__ uo,
                      float* __restrict__ partial, int S, int n, int Sc,
                      int k, int resnorm, Weights w) {
  __shared__ Tile t;
  __shared__ float red[TW * TY / 32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int H = k + resnorm;
  const int CW = TW - 2 * H, CH = TH - 2 * H;
  const int i0 = blockIdx.y * CH - H, j0 = blockIdx.x * CW - H;
  const int gj = j0 + tx;

  float v[R], bv[R];
  load(u, S, i0, gj, ty, v);
  load(b, S, i0, gj, ty, bv);
  const Rows inter = interior(n, i0, gj, ty);

  // u += P ec (core.ops.prolong phases; interior fine nodes read coarse
  // nodes 0..nc only, which lie inside the (Sc, Sc) array).
  const int J = gj >> 1;
  const bool jodd = gj & 1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!inter(r)) continue;
    const int gi = i0 + ty * R + r;
    const int I = gi >> 1;
    const float* e0 = ec + (int64_t)I * Sc + J;
    float e;
    if (!(gi & 1)) {
      e = jodd ? 0.5f * (e0[0] + e0[1]) : e0[0];
    } else {
      const float* e1 = e0 + Sc;
      e = jodd ? 0.25f * (((e0[0] + e0[1]) + e1[0]) + e1[1])
               : 0.5f * (e0[0] + e1[0]);
    }
    v[r] = v[r] + e;
  }

  for (int s = 0; s < k; ++s)
    sweep(v, bv, inter, w.one_minus[s], w.quarter[s], t, tx, ty);
  store_core(uo, S, H, i0, gj, tx, ty, v);
  if (!resnorm) return;

  residual(v, bv, inter, t, tx, ty);
  float acc = 0.f;
  if (tx >= H && tx < TW - H) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int tr = ty * R + r;
      if (tr >= H && tr < TH - H) acc += v[r] * v[r];
    }
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  const int lane = tx & 31, warp = (ty * TW + tx) >> 5;
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tx == 0 && ty == 0) {
    float s = 0.f;
    for (int i = 0; i < TW * TY / 32; ++i) s += red[i];
    partial[blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

ffi::Error make_weights(int64_t k, double w0, double w1, double w2,
                        double w3, double w4, double w5, double w6,
                        double w7, Weights* out) {
  if (k < 0 || k > MAX_SWEEPS)
    return ffi::Error::InvalidArgument("sweeps must be in [0, 8]");
  const double ws[MAX_SWEEPS] = {w0, w1, w2, w3, w4, w5, w6, w7};
  for (int i = 0; i < MAX_SWEEPS; ++i) {
    out->one_minus[i] = static_cast<float>(1.0 - ws[i]);
    out->quarter[i] = static_cast<float>(0.25 * ws[i]);
  }
  return ffi::Error::Success();
}

ffi::Error SmoothRestrictImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> u,
                              ffi::Buffer<ffi::F32> b,
                              ffi::ResultBuffer<ffi::F32> uo,
                              ffi::ResultBuffer<ffi::F32> rc, int64_t n,
                              int64_t k, double w0, double w1, double w2,
                              double w3, double w4, double w5, double w6,
                              double w7) {
  const int S = static_cast<int>(u.dimensions()[0]);
  const int Sc = static_cast<int>(rc->dimensions()[0]);
  Weights w;
  ffi::Error err = make_weights(k, w0, w1, w2, w3, w4, w5, w6, w7, &w);
  if (err.failure()) return err;
  const int H = static_cast<int>(k) + 2;
  const int rows = S > 2 * Sc ? S : 2 * Sc;
  dim3 grid(ceil_div(rows, TW - 2 * H), ceil_div(rows, TH - 2 * H));
  smooth_restrict_kernel<<<grid, dim3(TW, TY), 0, stream>>>(
      u.typed_data(), b.typed_data(), uo->typed_data(), rc->typed_data(), S,
      static_cast<int>(n), Sc, static_cast<int>(k), w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

ffi::Error ProlongSmoothImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> u,
                             ffi::Buffer<ffi::F32> b,
                             ffi::Buffer<ffi::F32> ec,
                             ffi::ResultBuffer<ffi::F32> uo,
                             ffi::ResultBuffer<ffi::F32> partial, int64_t n,
                             int64_t k, int64_t resnorm, double w0,
                             double w1, double w2, double w3, double w4,
                             double w5, double w6, double w7) {
  const int S = static_cast<int>(u.dimensions()[0]);
  const int Sc = static_cast<int>(ec.dimensions()[0]);
  Weights w;
  ffi::Error err = make_weights(k, w0, w1, w2, w3, w4, w5, w6, w7, &w);
  if (err.failure()) return err;
  const int H = static_cast<int>(k) + (resnorm ? 1 : 0);
  dim3 grid(ceil_div(S, TW - 2 * H), ceil_div(S, TH - 2 * H));
  if (static_cast<int64_t>(grid.x) * grid.y !=
      static_cast<int64_t>(partial->element_count()))
    return ffi::Error::InvalidArgument("partial-sum buffer size mismatch");
  prolong_smooth_kernel<<<grid, dim3(TW, TY), 0, stream>>>(
      u.typed_data(), b.typed_data(), ec.typed_data(), uo->typed_data(),
      partial->typed_data(), S, static_cast<int>(n), Sc, static_cast<int>(k),
      resnorm ? 1 : 0, w);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TmgSmoothRestrict, SmoothRestrictImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int64_t>("n")
        .Attr<int64_t>("k")
        .Attr<double>("w0")
        .Attr<double>("w1")
        .Attr<double>("w2")
        .Attr<double>("w3")
        .Attr<double>("w4")
        .Attr<double>("w5")
        .Attr<double>("w6")
        .Attr<double>("w7"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    TmgProlongSmooth, ProlongSmoothImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int64_t>("n")
        .Attr<int64_t>("k")
        .Attr<int64_t>("resnorm")
        .Attr<double>("w0")
        .Attr<double>("w1")
        .Attr<double>("w2")
        .Attr<double>("w3")
        .Attr<double>("w4")
        .Attr<double>("w5")
        .Attr<double>("w6")
        .Attr<double>("w7"));
