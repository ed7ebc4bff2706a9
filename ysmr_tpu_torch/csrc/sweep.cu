// Rotated extents of the hull candidate points, per component and direction.
//
// Replaces ysmr_tpu/ops/pallas_sweep.py::sweep_extents (Pallas). Same
// contract as the plain version
// ysmr_tpu_torch/ops/labeling.py::sweep_extents_plain
// (ysmr_tpu/ops/labeling.py:911-922): for component c and candidate
// direction (dx, dy), the min and max over the valid points (x, y) of
//   u = x*dx + y*dy   and   v = y*dx - x*dy,
// and (+big, -big) when the component has no valid point. Points and
// directions are integers and every product and sum stays below 2^24, so
// each value is an exact float32 integer: rounding mode and contraction
// cannot change a bit, and the kernel equals the plain version exactly. The
// TPU kernel pre-filled invalid slots and tiled components over lanes for
// Mosaic; here the validity test is a branch every thread of the block
// takes the same way.
//
// Design: one block per component. The block stages the P points and their
// flags in shared memory, then each thread owns one direction and reduces
// over the points. A component with no valid point only writes its +-big
// extents.
//
// What bounds it on an H100: arithmetic throughput on the valid points (six
// float ops and four min/max per point and direction); bytes are small
// (P*9 bytes in, 4*K*4 bytes out per component). The min_area_rect
// candidates are K = 2*(max_bh-1)+1 <= 191 directions and P = 2*max_bh
// points.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 3.0e38f;

__global__ void __launch_bounds__(kThreads)
sweep_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
             const float* __restrict__ dx, const float* __restrict__ dy,
             float* __restrict__ min_u, float* __restrict__ max_u,
             float* __restrict__ min_v, float* __restrict__ max_v, int p,
             int k) {
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + p;
  int* sv = reinterpret_cast<int*>(smem + 2 * p);
  const int64_t c = blockIdx.x;
  int any = 0;
  for (int j = threadIdx.x; j < p; j += blockDim.x) {
    const int64_t q = c * p + j;
    sx[j] = pts[2 * q];
    sy[j] = pts[2 * q + 1];
    sv[j] = valid[q];
    any |= sv[j];
  }
  any = __syncthreads_or(any);
  for (int e = threadIdx.x; e < k; e += blockDim.x) {
    const int64_t o = c * k + e;
    float mnu = kBig, mxu = -kBig, mnv = kBig, mxv = -kBig;
    if (any) {
      const float ex = dx[o], ey = dy[o];
      for (int j = 0; j < p; ++j) {
        if (!sv[j]) continue;
        const float u = __fadd_rn(__fmul_rn(sx[j], ex), __fmul_rn(sy[j], ey));
        const float v = __fsub_rn(__fmul_rn(sy[j], ex), __fmul_rn(sx[j], ey));
        mnu = fminf(mnu, u);
        mxu = fmaxf(mxu, u);
        mnv = fminf(mnv, v);
        mxv = fmaxf(mxv, v);
      }
    }
    min_u[o] = mnu;
    max_u[o] = mxu;
    min_v[o] = mnv;
    max_v[o] = mxv;
  }
}

}  // namespace

extern "C" {

// pts: (D, P, 2) float32; valid: (D, P) uint8; dx, dy and the four outputs:
// (D, K) float32; all contiguous on CUDA device `device`, launched on
// `stream`. Returns a cudaError_t (0 = launched).
int ysmr_sweep_extents(const void* pts, const void* valid, const void* dx,
                       const void* dy, void* min_u, void* max_u, void* min_v,
                       void* max_v, int d, int p, int k, int device,
                       void* stream) {
  if (d <= 0 || k <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t shared = static_cast<size_t>(p) * 3 * sizeof(float);
  sweep_kernel<<<d, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(dx), static_cast<const float*>(dy),
      static_cast<float*>(min_u), static_cast<float*>(max_u),
      static_cast<float*>(min_v), static_cast<float*>(max_v), p, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
