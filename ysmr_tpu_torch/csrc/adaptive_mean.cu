// The 11x11 Gaussian-weighted local mean of cv2.adaptiveThreshold.
//
// Replaces the plain-XLA ysmr_tpu/ops/preprocess.py::adaptive_gaussian_mean
// (no Pallas kernel: XLA fuses it on the TPU). Same contract and the same
// bits as the plain version
// ysmr_tpu_torch/ops/preprocess.py::adaptive_gaussian_mean_plain: int32
// (T, H, W) in and out; replicate border (index clamping); the float32
// taps of getGaussianKernel(11, 0), horizontal pass first, each 11-tap sum
// in XLA:CPU's contracted order
//   acc = fma(p0, k0, p1 * k1), then acc = fma(p_i, k_i, acc), i = 2..10,
// then the same chain vertically over the rounded row sums, and
// floor(acc + 0.5). Every product, fma and sum is an _rn intrinsic: nvcc
// contracts a plain a * b + c by default (-fmad=true), which would change
// which products are rounded. A halo row's horizontal sum is that of its
// clamped source row, bit for bit, so the tile computes it from the
// clamped row.
//
// Design: one block per (frame, 32-row x 64-column output tile). The block
// stages the clamped 42 x 74 input window in shared memory as float32,
// writes the 42 x 64 horizontal sums to a second shared buffer, and runs
// the vertical chain straight to global memory. Frames run on the grid's
// z axis (in launches of at most 65,535 frames). No allocation and no host
// synchronisation, so the launch can be captured in a CUDA graph.
//
// What bounds it on an H100: bytes. 4 bytes in and 4 out per pixel (the
// window's 1.52x re-read of the input mostly hits L2) against 22 fmas per
// pixel; at 64 x 922 x 1228 that is 579.7 MB, 0.173 ms at 3.35 TB/s, and
// 3.19 GFLOP, 0.048 ms at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kInH = kTileH + 2 * kRadius;
constexpr int kInW = kTileW + 2 * kRadius;
constexpr int kThreads = 256;
constexpr int kMaxFrames = 65535;

struct Taps {
  float k[kTaps];
};

// The 11-tap chain over p[0], p[stride], ..., p[10 * stride].
__device__ __forceinline__ float taps11(const float* p, int stride,
                                        const Taps& t) {
  float acc = __fmaf_rn(p[0], t.k[0], __fmul_rn(p[stride], t.k[1]));
#pragma unroll
  for (int i = 2; i < kTaps; ++i) acc = __fmaf_rn(p[i * stride], t.k[i], acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
mean_kernel(const int* __restrict__ img, int* __restrict__ out, Taps taps,
            int h, int w) {
  __shared__ float src[kInH][kInW];
  __shared__ float rows[kInH][kTileW];
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * h * w;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  for (int i = threadIdx.x; i < kInH * kInW; i += kThreads) {
    const int r = i / kInW, c = i % kInW;
    const int y = min(max(y0 + r - kRadius, 0), h - 1);
    const int x = min(max(x0 + c - kRadius, 0), w - 1);
    src[r][c] = __int2float_rn(img[frame + static_cast<int64_t>(y) * w + x]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kInH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    rows[r][c] = taps11(&src[r][c], 1, taps);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y < h && x < w) {
      const float acc = taps11(&rows[r][c], kTileW, taps);
      out[frame + static_cast<int64_t>(y) * w + x] =
          static_cast<int>(floorf(__fadd_rn(acc, 0.5f)));
    }
  }
}

}  // namespace

extern "C" {

// img, out: (T, H, W) int32, contiguous on CUDA device `device`; taps: 11
// float32 values in host memory (the Gaussian taps, passed by value to the
// kernel); launched on `stream`. Returns a cudaError_t (0 = launched).
int ysmr_adaptive_mean(const void* img, void* out, const float* taps, int t,
                       int h, int w, int device, void* stream) {
  if (t <= 0 || h <= 0 || w <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Taps k;
  for (int i = 0; i < kTaps; ++i) k.k[i] = taps[i];
  const int64_t plane = static_cast<int64_t>(h) * w;
  for (int z = 0; z < t; z += kMaxFrames) {
    const int frames = t - z < kMaxFrames ? t - z : kMaxFrames;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    frames);
    mean_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(img) + z * plane,
        static_cast<int*>(out) + z * plane, k, h, w);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
