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
// Batched form: a leading video axis V (the multi-video step's tracker,
// the counterpart of jax.vmap over pallas_call, whose batching rule puts
// the video axis in front of the grid) is the grid's y dimension: block
// (x, y) takes row tile x of video y, with the video's problem at strides
// R*K / C*K / R / C into obj, det, ov/dv and the outputs. Each row's
// arithmetic is the unbatched one, so a launch over V videos gives, bit for
// bit, the V separate launches' results. V = 1 is the unbatched call.
//
// Design: one launch, a block of 256 threads per tile of 16 rows. The
// columns of a tile are split across the block: thread (g, s) takes rows
// 4g .. 4g + 3 of the tile and the columns s, s + 64, s + 128, ... The
// block stages the detections in chunks of 1024 in shared memory (each
// thread issues its loads of a chunk at once) and every thread runs four
// independent distance chains on each staged detection, so an R = 4096
// call is 256 blocks of eight warps on 132 SMs. Each thread keeps, per
// row, the smallest squared sum `acc` seen and the first column with the
// smallest rounded distance; it takes __fsqrt_rn only when `acc` is
// strictly below that smallest sum (sqrtf is monotone, so a larger or
// equal `acc` can never give a strictly smaller distance), which leaves a
// few square roots per thread and row instead of one per pair, behind one
// rarely taken branch a column. The partial results of the 64 threads of a
// row merge as 64-bit keys (float bits of the distance << 32 | column):
// distances are non-negative, so their bits order like their values and
// the smaller column wins a tie, which is the first minimal column
// whatever the merge order (shuffles within a warp, then shared memory
// across the row's two warps). No atomics, no scratch, no host
// synchronisation: the launch depends on the shapes only and can be
// captured in a CUDA graph.
//
// What bounds it on an H100: instruction issue, 2K float operations and a
// compare per (row, column) pair on 132 SMs x 4 schedulers; the inputs are
// a few hundred kB. At R = C = 4096 the 256 blocks fill under two blocks
// an SM, so their latency shows too. The TPU kernel's (rows, 128-lane)
// tiles and per-lane running minima existed for the vector unit; nothing
// of the (R, C) matrix is stored here either.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlices = 64;                       // threads per row
constexpr int kRowsPerThread = 4;
constexpr int kGroups = kThreads / kSlices;       // row groups per block
constexpr int kRowsPerBlock = kGroups * kRowsPerThread;
constexpr int kWarpsPerRow = kSlices / 32;
constexpr int kChunk = 1024;                      // columns staged at once
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ uint64_t pack(float dist, int col) {
  return (static_cast<uint64_t>(__float_as_uint(dist)) << 32) |
         static_cast<uint32_t>(col);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ obj, const uint8_t* __restrict__ ov,
              const float* __restrict__ det, const uint8_t* __restrict__ dv,
              float* __restrict__ row_min, int32_t* __restrict__ cand, int r,
              int c) {
  // video blockIdx.y: its rows, detections and outputs
  const int64_t v = blockIdx.y;
  obj += v * r * K;
  ov += v * r;
  det += v * c * K;
  dv += v * c;
  row_min += v * r;
  cand += v * r;
  __shared__ uint64_t part[kRowsPerBlock][kWarpsPerRow];
  __shared__ float sd[K][kChunk];
  __shared__ uint8_t sdv[kChunk];
  const int s = threadIdx.x % kSlices;
  const int g = threadIdx.x / kSlices;
  const int row0 = blockIdx.x * kRowsPerBlock + g * kRowsPerThread;
  float o[kRowsPerThread][K];
  float best_acc[kRowsPerThread], best[kRowsPerThread];
  int besti[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int row = row0 + i;
    const bool rv = row < r && ov[row];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      o[i][q] = rv ? obj[static_cast<int64_t>(row) * K + q] : 0.f;
    }
    // an invalid row never takes a square root, so it keeps (3e38, 0)
    best_acc[i] = rv ? INFINITY : -INFINITY;
    best[i] = kBig;
    besti[i] = 0;
  }
  for (int c0 = 0; c0 < c; c0 += kChunk) {
    // the block stages a chunk of detections: every thread issues its
    // loads at once, and the row groups read the chunk from shared memory
    const int n = min(kChunk, c - c0);
    __syncthreads();
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const int64_t j = c0 + t;
#pragma unroll
      for (int q = 0; q < K; ++q) sd[q][t] = det[j * K + q];
      sdv[t] = dv[j];
    }
    __syncthreads();
    for (int t = s; t < n; t += kSlices) {
      if (!sdv[t]) continue;
      const int j = c0 + t;
      float d[K];
#pragma unroll
      for (int q = 0; q < K; ++q) d[q] = sd[q][t];
      float acc[kRowsPerThread];
      bool lower = false;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float d0 = __fsub_rn(o[i][0], d[0]);
        acc[i] = __fmul_rn(d0, d0);
#pragma unroll
        for (int q = 1; q < K; ++q) {
          const float dq = __fsub_rn(o[i][q], d[q]);
          acc[i] = __fmaf_rn(dq, dq, acc[i]);
        }
        lower |= acc[i] < best_acc[i];
      }
      // one branch a column, taken rarely once the minima have settled:
      // the square roots stay off the common path
      if (__builtin_expect(lower, 0)) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          if (acc[i] < best_acc[i]) {
            best_acc[i] = acc[i];
            const float dist = __fsqrt_rn(acc[i]);
            if (dist < best[i]) {
              best[i] = dist;
              besti[i] = j;
            }
          }
        }
      }
    }
  }
  const int lane = threadIdx.x % 32;
  const int warp_in_row = s / 32;
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    uint64_t key = pack(best[i], besti[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const uint64_t other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other < key ? other : key;
    }
    if (lane == 0) part[g * kRowsPerThread + i][warp_in_row] = key;
  }
  __syncthreads();
  if (threadIdx.x < kRowsPerBlock) {
    const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
    uint64_t key = part[threadIdx.x][0];
#pragma unroll
    for (int q = 1; q < kWarpsPerRow; ++q) {
      key = part[threadIdx.x][q] < key ? part[threadIdx.x][q] : key;
    }
    if (row < r) {
      row_min[row] = __uint_as_float(static_cast<uint32_t>(key >> 32));
      cand[row] = static_cast<int32_t>(key & 0xffffffffu);
    }
  }
}

}  // namespace

extern "C" {

// obj: (V, R, K) float32; ov: (V, R) uint8; det: (V, C, K) float32;
// dv: (V, C) uint8; row_min: (V, R) float32; cand: (V, R) int32; K in
// {2, 3}; V <= 65535 (the grid's y limit); all contiguous on CUDA device
// `device`, launched on `stream`. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue for another K or V).
int ysmr_row_min_argmin(const void* obj, const void* ov, const void* det,
                        const void* dv, void* row_min, void* cand, int v,
                        int r, int c, int k, int device, void* stream) {
  if (v > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (r <= 0 || v <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 blocks(
      static_cast<unsigned>((r + kRowsPerBlock - 1) / kRowsPerBlock),
      static_cast<unsigned>(v));
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
