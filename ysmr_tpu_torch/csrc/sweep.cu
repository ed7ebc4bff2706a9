// Rotated extents of each component's hull corners, per component and
// direction, read from the row tables.
//
// Replaces ysmr_tpu/ops/pallas_sweep.py::sweep_extents (Pallas) and the
// plain XLA around it: the candidate points of the stats tail
// (ysmr_tpu/ops/labeling.py::_stats_tail_from_tables, :459) and the (1, 0)
// direction that _min_area_rect_exact (:877) appends. Same contract and
// bits as the plain version ysmr_tpu_torch/ops/labeling.py::
// sweep_tables_plain: for component c and direction (dx, dy), the K - 1
// edge candidates and then (1, 0), the min and max over its strict chain
// corners (x, y) (a left corner at row_min_x, a right one at row_max_x,
// y = min_y + row) of
//   u = x*dx + y*dy   and   v = y*dx - x*dy,
// and (+big, -big) when the component has no corner. The extents of a
// point set are reached at its hull's vertices, and the hull kernel flags
// each of them as a corner (the plain version's docstring gives the
// precondition), so these are the extents over every valid point. Points
// and directions are integers and every product and sum stays below 2^24,
// so each value is an exact float32 integer: rounding mode and contraction
// cannot change a bit, nor can the order in which the corners are taken.
//
// Design: one warp per component, kWarps components a block. Lane l owns
// the directions e = e0 + l + 32 i (i < kDirs), reads its (dx, dy) once
// (the last direction, (1, 0), is formed, not read) and keeps its four
// bounds in registers. The warp reads the component's rows 32 at a time:
// row_valid first (a component with no valid row writes its +-big
// extents and reads nothing else), then the corner flags of the valid
// rows and the x extreme of each corner. A ballot gives the chunk's
// corner rows; for each, in turn, the warp takes its x extremes from the
// row's lane by a shuffle, forms y = min_y + row, and every lane folds the
// one or two points into its directions. Above 32 kDirs directions (K >
// 128, R > 64) the warp makes more passes over the rows.
//
// What bounds it on an H100: bytes. Every component writes its 4 K float32
// extents (1,520 bytes at K = 95); a component with a valid row reads its
// K - 1 directions (752 bytes), min_y, its row flags and corner flags and
// the x of its corners. At the dense batch (262,144 components x 48 rows,
// K = 95) the extents are 398 MB of the about 0.6 GB the data needs
// (chip_smoke.py computes the bound of each run). The arithmetic, six
// float operations and four min/max per corner and direction, is a few
// percent of the card's float32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kBig = 3.0e38f;

template <int kDirs>
__global__ void __launch_bounds__(kWarps * 32)
sweep_kernel(const int32_t* __restrict__ row_min_x,
             const int32_t* __restrict__ row_max_x,
             const uint8_t* __restrict__ row_valid,
             const int32_t* __restrict__ min_y,
             const uint8_t* __restrict__ corner_l,
             const uint8_t* __restrict__ corner_r,
             const float* __restrict__ dx, const float* __restrict__ dy,
             float* __restrict__ min_u, float* __restrict__ max_u,
             float* __restrict__ min_v, float* __restrict__ max_v, int d,
             int r, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (c >= d) return;  // whole warps leave together
  const int64_t base = c * r;
  const int64_t out = c * k;
  bool any = false;
  for (int j0 = 0; j0 < r && !any; j0 += 32) {
    const int j = j0 + lane;
    any = __any_sync(kAll, j < r && row_valid[base + j]);
  }
  if (!any) {
    for (int e = lane; e < k; e += 32) {
      min_u[out + e] = kBig;
      max_u[out + e] = -kBig;
      min_v[out + e] = kBig;
      max_v[out + e] = -kBig;
    }
    return;
  }
  const int y0 = min_y[c];
  const int64_t dbase = c * (k - 1);
  for (int e0 = 0; e0 < k; e0 += 32 * kDirs) {
    float ex[kDirs], ey[kDirs], mnu[kDirs], mxu[kDirs], mnv[kDirs],
        mxv[kDirs];
#pragma unroll
    for (int i = 0; i < kDirs; ++i) {
      const int e = e0 + lane + 32 * i;
      ex[i] = e < k - 1 ? dx[dbase + e] : 1.0f;
      ey[i] = e < k - 1 ? dy[dbase + e] : 0.0f;
      mnu[i] = mnv[i] = kBig;
      mxu[i] = mxv[i] = -kBig;
    }
    auto fold = [&](float x, float y) {
#pragma unroll
      for (int i = 0; i < kDirs; ++i) {
        const float u = __fadd_rn(__fmul_rn(x, ex[i]), __fmul_rn(y, ey[i]));
        const float v = __fsub_rn(__fmul_rn(y, ex[i]), __fmul_rn(x, ey[i]));
        mnu[i] = fminf(mnu[i], u);
        mxu[i] = fmaxf(mxu[i], u);
        mnv[i] = fminf(mnv[i], v);
        mxv[i] = fmaxf(mxv[i], v);
      }
    };
    for (int j0 = 0; j0 < r; j0 += 32) {
      const int j = j0 + lane;
      const int64_t g = base + j;
      const bool v = j < r && row_valid[g];
      const bool cl = v && corner_l[g];
      const bool cr = v && corner_r[g];
      const int xl = cl ? row_min_x[g] : 0;
      const int xr = cr ? row_max_x[g] : 0;
      const unsigned bl = __ballot_sync(kAll, cl);
      const unsigned br = __ballot_sync(kAll, cr);
      for (unsigned m = bl | br; m; m &= m - 1) {
        const int src = __ffs(m) - 1;
        const float x_l = static_cast<float>(__shfl_sync(kAll, xl, src));
        const float x_r = static_cast<float>(__shfl_sync(kAll, xr, src));
        const float y = static_cast<float>(y0 + j0 + src);
        if ((bl >> src) & 1u) fold(x_l, y);
        if ((br >> src) & 1u) fold(x_r, y);
      }
    }
#pragma unroll
    for (int i = 0; i < kDirs; ++i) {
      const int e = e0 + lane + 32 * i;
      if (e < k) {
        min_u[out + e] = mnu[i];
        max_u[out + e] = mxu[i];
        min_v[out + e] = mnv[i];
        max_v[out + e] = mxv[i];
      }
    }
  }
}

template <int kDirs>
cudaError_t launch(const void* row_min_x, const void* row_max_x,
                   const void* row_valid, const void* min_y,
                   const void* corner_l, const void* corner_r,
                   const void* dx, const void* dy, void* min_u, void* max_u,
                   void* min_v, void* max_v, int d, int r, int k,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((d + kWarps - 1) / kWarps);
  sweep_kernel<kDirs><<<blocks, kWarps * 32, 0, stream>>>(
      static_cast<const int32_t*>(row_min_x),
      static_cast<const int32_t*>(row_max_x),
      static_cast<const uint8_t*>(row_valid),
      static_cast<const int32_t*>(min_y),
      static_cast<const uint8_t*>(corner_l),
      static_cast<const uint8_t*>(corner_r), static_cast<const float*>(dx),
      static_cast<const float*>(dy), static_cast<float*>(min_u),
      static_cast<float*>(max_u), static_cast<float*>(min_v),
      static_cast<float*>(max_v), d, r, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// row_min_x, row_max_x: (D, R) int32; row_valid, corner_l, corner_r:
// (D, R) uint8; min_y: (D,) int32; dx, dy: (D, K - 1) float32 (the edge
// candidates; the K-th direction is (1, 0)); the four outputs (D, K)
// float32; all contiguous on CUDA device `device`, launched on `stream`.
// Returns a cudaError_t (0 = launched).
int ysmr_sweep_extents(const void* row_min_x, const void* row_max_x,
                       const void* row_valid, const void* min_y,
                       const void* corner_l, const void* corner_r,
                       const void* dx, const void* dy, void* min_u,
                       void* max_u, void* min_v, void* max_v, int d, int r,
                       int k, int device, void* stream) {
  if (d <= 0 || k <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  // the fewest directions a lane that cover K in one pass, four at most
  auto fn = k <= 32 ? launch<1> : k <= 64 ? launch<2> : k <= 96 ? launch<3>
                                                                 : launch<4>;
  return static_cast<int>(fn(row_min_x, row_max_x, row_valid, min_y,
                             corner_l, corner_r, dx, dy, min_u, max_u,
                             min_v, max_v, d, r, k, s));
}

}  // extern "C"
