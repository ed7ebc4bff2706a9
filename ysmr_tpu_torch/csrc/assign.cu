// Per-row nearest detection for the tracker's greedy matching.
//
// Replaces ysmr_tpu/ops/pallas_assign.py::row_min_argmin (Pallas). Same
// contract as the plain version
// ysmr_tpu_torch/ops/assignment.py::row_min_argmin_plain, which is
// ysmr_tpu/ops/assignment.py::pairwise_distances followed by min and the
// first argmin along the detections: for each tracker row, over the valid
// detections, the minimum distance and the first column attaining it;
// (3e38, 0) for an invalid row or a row with no valid detection.
//
// Bits: XLA on the CPU evaluates the K-component distance as
//   sqrtf(fmaf(dz, dz, fmaf(dy, dy, dx*dx)))      (K = 3; K = 2 drops dz)
// (measured on jax.jit(pairwise_distances), 100% of random pairs), so the
// kernel spells that order out with round-to-nearest intrinsics; nvcc's own
// contraction cannot move it. The plain version reproduces the same fmas
// exactly in float64.
//
// Design: one thread per row. The block stages chunks of kThreads
// detections (coordinates and flags) in shared memory and every thread
// scans them in column order with a strict <, so the first minimal column
// wins. The TPU kernel's (rows, 128-lane) tiles and per-lane running minima
// existed for the vector unit; nothing of the (R, C) matrix is stored here
// either.
//
// What bounds it on an H100: instruction throughput, ~8 float ops per
// (row, column) pair, sqrt included; each detection chunk is read once per
// block from L2.
// R = 4096 rows make 32 blocks of 128 threads, fewer than the 132 SMs:
// splitting the columns across blocks with a second reduction pass is later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kBig = 3.0e38f;

template <int K>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ obj, const uint8_t* __restrict__ ov,
              const float* __restrict__ det, const uint8_t* __restrict__ dv,
              float* __restrict__ row_min, int32_t* __restrict__ cand, int r,
              int c) {
  __shared__ float sd[K][kThreads];
  __shared__ int sdv[kThreads];
  const int row = blockIdx.x * kThreads + threadIdx.x;
  const bool rv = row < r && ov[row];
  float o[K];
#pragma unroll
  for (int q = 0; q < K; ++q) {
    o[q] = rv ? obj[static_cast<int64_t>(row) * K + q] : 0.f;
  }
  float best = kBig;
  int besti = 0;
  for (int c0 = 0; c0 < c; c0 += kThreads) {
    const int j = c0 + threadIdx.x;
    if (j < c) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        sd[q][threadIdx.x] = det[static_cast<int64_t>(j) * K + q];
      }
      sdv[threadIdx.x] = dv[j];
    } else {
      sdv[threadIdx.x] = 0;
    }
    __syncthreads();
    if (rv) {
      const int n = min(kThreads, c - c0);
      for (int t = 0; t < n; ++t) {
        if (!sdv[t]) continue;
        const float d0 = __fsub_rn(o[0], sd[0][t]);
        float acc = __fmul_rn(d0, d0);
#pragma unroll
        for (int q = 1; q < K; ++q) {
          const float dq = __fsub_rn(o[q], sd[q][t]);
          acc = __fmaf_rn(dq, dq, acc);
        }
        const float dist = __fsqrt_rn(acc);
        if (dist < best) {
          best = dist;
          besti = c0 + t;
        }
      }
    }
    __syncthreads();
  }
  if (row < r) {
    row_min[row] = best;
    cand[row] = besti;
  }
}

}  // namespace

extern "C" {

// obj: (R, K) float32; ov: (R,) uint8; det: (C, K) float32; dv: (C,) uint8;
// row_min: (R,) float32; cand: (R,) int32; K in {2, 3}; all contiguous on
// CUDA device `device`, launched on `stream`. Returns a cudaError_t
// (0 = launched; cudaErrorInvalidValue for another K).
int ysmr_row_min_argmin(const void* obj, const void* ov, const void* det,
                        const void* dv, void* row_min, void* cand, int r,
                        int c, int k, int device, void* stream) {
  if (r <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((r + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* o = static_cast<const float*>(obj);
  const uint8_t* ovp = static_cast<const uint8_t*>(ov);
  const float* d = static_cast<const float*>(det);
  const uint8_t* dvp = static_cast<const uint8_t*>(dv);
  float* rm = static_cast<float*>(row_min);
  int32_t* cd = static_cast<int32_t*>(cand);
  if (k == 2) {
    assign_kernel<2><<<blocks, kThreads, 0, s>>>(o, ovp, d, dvp, rm, cd, r,
                                                  c);
  } else if (k == 3) {
    assign_kernel<3><<<blocks, kThreads, 0, s>>>(o, ovp, d, dvp, rm, cd, r,
                                                  c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
