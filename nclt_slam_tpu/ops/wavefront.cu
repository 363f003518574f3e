// Wavefront potential relaxation for NVIDIA Hopper (sm_90a), called from
// JAX through the XLA FFI (nclt_slam_tpu/ops/wavefront_cuda.py).
//
// Computes exactly what planning/wavefront.py:relax_xla computes: n_iter
// Jacobi sweeps of the 8-neighbour min-plus update
//
//   phi'[r,c] = min(phi[r,c], phi[n] + tc[r,c] (4 edge neighbours),
//                             phi[n] + tc[r,c] * 1.4142135 (4 diagonals))
//
// with out-of-window neighbours read as BIG.  Every candidate is one f32
// add (diagonals: one f32 multiply, then the add, never contracted into an
// FMA, as XLA computes it) and min is exact, so the result is bit-identical
// to the XLA loop on the GPU (checked by chip_smoke.py and the gpu tests;
// an FMA-contracted variant differed on 17 % of reachable cells).
//
// Layout: one thread-block cluster of kCluster CTAs per window.  CTA k of
// the cluster owns a band of ceil(R / kCluster) rows and keeps two copies
// of its band's potential in shared memory (read one, write the other, one
// cluster barrier per sweep).  A band's first and last rows read the rows
// beyond its edge straight from the neighbouring CTA's shared memory
// (distributed shared memory).  Each thread owns a short column segment;
// its traversal costs stay in registers and it walks down the segment with
// a rolling 3x3 window, so a cell costs three shared-memory loads and one
// store per sweep.  All sweeps run in one launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "xla/ffi/api/ffi.h"

namespace cg = cooperative_groups;
namespace ffi = xla::ffi;

namespace {

constexpr int kCluster = 8;      // CTAs per window (portable cluster size)
constexpr int kSegMax = 16;      // rows per thread, held in registers
constexpr int kSegTarget = 8;    // preferred rows per thread
constexpr int kMaxThreads = 1024;
constexpr float kBig = 1e9f;
constexpr float kDiag = 1.4142135f;

struct Row3 {
  float l, m, r;
};

__device__ __forceinline__ Row3 load_row(const float* row, int col, int C) {
  if (row == nullptr) return {kBig, kBig, kBig};
  Row3 v;
  v.m = row[col];
  v.l = col > 0 ? row[col - 1] : kBig;
  v.r = col < C - 1 ? row[col + 1] : kBig;
  return v;
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
relax_kernel(const float* __restrict__ tc_g, const float* __restrict__ phi0_g,
             float* __restrict__ out_g, int R, int C, int band, int seg,
             int n_iter) {
  extern __shared__ float smem[];  // [2][band][C]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int win = blockIdx.x / kCluster;
  const int row0 = rank * band;                       // first window row
  const int rows = max(0, min(band, R - row0));       // rows in this band
  const int col = threadIdx.x % C;
  const int lr0 = (threadIdx.x / C) * seg;            // first local row
  const int nr = max(0, min(seg, rows - lr0));        // rows of this thread
  const size_t base = static_cast<size_t>(win) * R * C;

  float* const buf0 = smem;
  float* const buf1 = smem + band * C;
  const bool has_up = rank > 0 && rows > 0;
  const bool has_dn = rank + 1 < kCluster && row0 + rows < R && rows > 0;
  // the neighbouring bands' edge rows, in their CTAs' shared memory
  const float* up0 = has_up ? cluster.map_shared_rank(buf0, rank - 1) + (band - 1) * C : nullptr;
  const float* up1 = has_up ? cluster.map_shared_rank(buf1, rank - 1) + (band - 1) * C : nullptr;
  const float* dn0 = has_dn ? cluster.map_shared_rank(buf0, rank + 1) : nullptr;
  const float* dn1 = has_dn ? cluster.map_shared_rank(buf1, rank + 1) : nullptr;

  float tc[kSegMax];
#pragma unroll
  for (int i = 0; i < kSegMax; ++i) {
    if (i < nr) {
      const size_t g = base + static_cast<size_t>(row0 + lr0 + i) * C + col;
      tc[i] = tc_g[g];
      buf0[(lr0 + i) * C + col] = phi0_g[g];
    }
  }
  cluster.sync();

  for (int it = 0; it < n_iter; ++it) {
    const bool odd = it & 1;
    const float* src = odd ? buf1 : buf0;
    float* dst = odd ? buf0 : buf1;
    const float* up = odd ? up1 : up0;
    const float* dn = odd ? dn1 : dn0;
    if (nr > 0) {
      auto row_ptr = [&](int lr) -> const float* {
        if (lr < 0) return up;
        if (lr >= rows) return dn;
        return src + lr * C;
      };
      Row3 a = load_row(row_ptr(lr0 - 1), col, C);
      Row3 b = load_row(row_ptr(lr0), col, C);
#pragma unroll
      for (int i = 0; i < kSegMax; ++i) {
        if (i < nr) {
          const Row3 c = load_row(row_ptr(lr0 + i + 1), col, C);
          const float t = tc[i];
          const float td = __fmul_rn(t, kDiag);
          float best = b.m;
          best = fminf(best, __fadd_rn(a.m, t));
          best = fminf(best, __fadd_rn(c.m, t));
          best = fminf(best, __fadd_rn(b.l, t));
          best = fminf(best, __fadd_rn(b.r, t));
          best = fminf(best, __fadd_rn(a.l, td));
          best = fminf(best, __fadd_rn(a.r, td));
          best = fminf(best, __fadd_rn(c.l, td));
          best = fminf(best, __fadd_rn(c.r, td));
          dst[(lr0 + i) * C + col] = best;
          a = b;
          b = c;
        }
      }
    }
    cluster.sync();
  }

  const float* fin = (n_iter & 1) ? buf1 : buf0;
#pragma unroll
  for (int i = 0; i < kSegMax; ++i) {
    if (i < nr) {
      out_g[base + static_cast<size_t>(row0 + lr0 + i) * C + col] =
          fin[(lr0 + i) * C + col];
    }
  }
}

ffi::Error RelaxImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> tc,
                     ffi::Buffer<ffi::F32> phi0,
                     ffi::ResultBuffer<ffi::F32> out, int32_t n_iter) {
  const auto dims = tc.dimensions();
  const auto pdims = phi0.dimensions();
  if (dims.size() < 2 || pdims.size() != dims.size()) {
    return ffi::Error::InvalidArgument(
        "wavefront_relax: tc and phi0 must be (..., R, C) of equal rank");
  }
  int64_t batch = 1;
  for (size_t i = 0; i < dims.size(); ++i) {
    if (dims[i] != pdims[i]) {
      return ffi::Error::InvalidArgument(
          "wavefront_relax: tc and phi0 shapes differ");
    }
    if (i + 2 < dims.size()) batch *= dims[i];
  }
  const int R = static_cast<int>(dims[dims.size() - 2]);
  const int C = static_cast<int>(dims[dims.size() - 1]);
  if (n_iter < 0) {
    return ffi::Error::InvalidArgument("wavefront_relax: n_iter < 0");
  }
  if (batch == 0 || R == 0 || C == 0) return ffi::Error::Success();

  const int band = (R + kCluster - 1) / kCluster;
  if (C > kMaxThreads) {
    return ffi::Error::InvalidArgument("wavefront_relax: more than 1024 columns");
  }
  const int max_segs = kMaxThreads / C;
  int segs = (band + kSegTarget - 1) / kSegTarget;
  if (segs > max_segs) segs = max_segs;
  const int seg = (band + segs - 1) / segs;
  segs = (band + seg - 1) / seg;
  if (seg > kSegMax) {
    return ffi::Error::InvalidArgument(
        "wavefront_relax: window too large for one cluster");
  }
  const size_t smem = 2 * static_cast<size_t>(band) * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        relax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) {
      return ffi::Error::Internal(cudaGetErrorString(e));
    }
  }
  relax_kernel<<<static_cast<unsigned>(batch * kCluster), C * segs, smem,
                 stream>>>(tc.typed_data(), phi0.typed_data(),
                           out->typed_data(), R, C, band, seg, n_iter);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(e));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(WavefrontRelax, RelaxImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("n_iter"));
