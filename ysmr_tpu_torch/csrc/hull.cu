// Hull-edge candidates of the per-row extreme points, both chains.
//
// Replaces ysmr_tpu/ops/pallas_hull.py::hull_edge_vectors (Pallas, kernel
// _make_kernel). Same contract as the plain version
// ysmr_tpu_torch/ops/labeling.py::hull_edge_vectors_plain, the slope-matrix
// closed form of ysmr_tpu/ops/labeling.py::_hull_edge_data (:794-833) before
// the angle finishing. For component c and bbox row i (a valid row):
//   - left chain (row x minima): the minimum outgoing slope
//     (x_k - x_i) / (y_k - y_i) over valid rows k below i, with the edge
//     vector of the LARGEST k attaining it (the farthest collinear endpoint),
//     and the maximum incoming slope over valid rows k above i;
//   - right chain (row x maxima): the same on the negated slopes;
//   - edge flag = valid & out_min >= in_max & out_min < big, strict corner
//     flag = valid & out_min > in_max; the edge vector is 0 where the edge
//     flag is False.
// Slopes are correctly rounded float32 quotients (__fdiv_rn) of exact
// integer differences, so the kernel equals the plain version bit for bit.
// The TPU kernel's (R, D) lane layout and its fori_loop over rows existed
// for Mosaic; here each thread owns one (component, row) and loops over the
// component's rows.
//
// What bounds it on an H100: instruction throughput, not bytes. The tables
// are 13 bytes per (component, row) in and 18 bytes out; each valid row does
// up to 2R divisions. Invalid rows (most of the max_bh-row box of a small
// component, and every row of an empty slot) exit at once, and invalid k
// are skipped, so the work scales with the rows components really have. The
// R loads of a component's rows come from L1 (the component's rows are
// contiguous and shared by the warp).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.0e38f;

__global__ void __launch_bounds__(kThreads)
hull_kernel(const int32_t* __restrict__ row_min_x,
            const int32_t* __restrict__ row_max_x,
            const uint8_t* __restrict__ row_valid,
            const int32_t* __restrict__ abs_y, float* __restrict__ dx_l,
            float* __restrict__ dy_l, uint8_t* __restrict__ edge_l,
            float* __restrict__ dx_r, float* __restrict__ dy_r,
            uint8_t* __restrict__ edge_r, uint8_t* __restrict__ corner_l,
            uint8_t* __restrict__ corner_r, int64_t total, int r) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int64_t base = idx - idx % r;  // row 0 of this component
  float omin_l = kBig, imax_l = -kBig, dxe_l = 0.f, dye_l = 0.f;
  float omin_r = kBig, imax_r = -kBig, dxe_r = 0.f, dye_r = 0.f;
  const bool vi = row_valid[idx] != 0;
  if (vi) {
    const float xl = static_cast<float>(row_min_x[idx]);
    const float xr = static_cast<float>(row_max_x[idx]);
    const float y = static_cast<float>(abs_y[idx]);
    for (int k = 0; k < r; ++k) {
      const int64_t kk = base + k;
      if (!row_valid[kk]) continue;
      const float dy = __fsub_rn(static_cast<float>(abs_y[kk]), y);
      if (dy == 0.f) continue;
      const float dxl = __fsub_rn(static_cast<float>(row_min_x[kk]), xl);
      const float dxr = __fsub_rn(static_cast<float>(row_max_x[kk]), xr);
      const float col_l = __fdiv_rn(dxl, dy);
      const float col_r = __fdiv_rn(-dxr, dy);
      if (dy > 0.f) {
        // ascending k with <=: the last (farthest) minimal k wins
        if (col_l <= omin_l) {
          omin_l = col_l;
          dxe_l = dxl;
          dye_l = dy;
        }
        if (col_r <= omin_r) {
          omin_r = col_r;
          dxe_r = dxr;
          dye_r = dy;
        }
      } else {
        imax_l = fmaxf(imax_l, col_l);
        imax_r = fmaxf(imax_r, col_r);
      }
    }
  }
  const bool el = vi && omin_l >= imax_l && omin_l < kBig;
  const bool er = vi && omin_r >= imax_r && omin_r < kBig;
  dx_l[idx] = el ? dxe_l : 0.f;
  dy_l[idx] = el ? dye_l : 0.f;
  edge_l[idx] = el;
  dx_r[idx] = er ? dxe_r : 0.f;
  dy_r[idx] = er ? dye_r : 0.f;
  edge_r[idx] = er;
  corner_l[idx] = vi && omin_l > imax_l;
  corner_r[idx] = vi && omin_r > imax_r;
}

}  // namespace

extern "C" {

// row_min_x, row_max_x, abs_y: (D, R) int32; row_valid: (D, R) uint8;
// outputs (D, R): float32 dx/dy, uint8 flags; all contiguous on CUDA device
// `device`, launched on `stream`. Returns a cudaError_t (0 = launched).
int ysmr_hull_edges(const void* row_min_x, const void* row_max_x,
                    const void* row_valid, const void* abs_y, void* dx_l,
                    void* dy_l, void* edge_l, void* dx_r, void* dy_r,
                    void* edge_r, void* corner_l, void* corner_r, int d,
                    int r, int device, void* stream) {
  if (d <= 0 || r <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(d) * r;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  hull_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_min_x),
      static_cast<const int32_t*>(row_max_x),
      static_cast<const uint8_t*>(row_valid),
      static_cast<const int32_t*>(abs_y), static_cast<float*>(dx_l),
      static_cast<float*>(dy_l), static_cast<uint8_t*>(edge_l),
      static_cast<float*>(dx_r), static_cast<float*>(dy_r),
      static_cast<uint8_t*>(edge_r), static_cast<uint8_t*>(corner_l),
      static_cast<uint8_t*>(corner_r), total, r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
