// The run wire expanded to the (T, F) pixel table, for the pixel-table
// branch with `run cc = off`: each pixel's lin (y*w + x) in raster order
// and, with the double threshold, its run's marker bit. Replaces the plain
// XLA expansion of ysmr_tpu/pipeline/detect_pixels.py:149-183 (a scatter
// of each run's jump at its first slot and a cumsum over the slots) and
// :184-198 (_marker_from_runs: each run's id scattered at its first slot,
// a cummax and a gather); it has no Pallas kernel. The plain PyTorch
// version, ops/run_cc.py::expand_runs_plain, is that sequence (an
// index_add_, two cumsums, a cummax and a gather: about 2 ms of a dense
// 64 x 131072 batch's 3.7 ms detect, over half).
//
// A wire word: bits 0..25 the run's first lin, bit 26 its marker, bits
// 27..31 its length (1-31 below the frame's count: the encoder's
// contract). Design: one block of 1024 threads a frame walks the frame's
// runs in chunks of 1024, a thread a run: a warp scan and a scan of the
// 32 warp sums give each run's first slot (the lengths' exclusive prefix
// sum, carried over the chunks), and the thread writes its run's slots
// below F (lin = first lin + offset, the marker). The slots past the
// frame's pixels get what the plain version's cumsum and cummax leave
// there: the last run's lin continued one a slot and its marker (lin =
// slot + 1 and the first word's marker bit where the frame has no run).
// Bound: the wire in (4 bytes a run) and the table out (5 bytes a slot):
// 42 MB at the dense batch (64 x 32768 runs, F = 131072), ~13 us; a block
// a frame keeps 64 of the 132 SMs busy at T = 64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kStartMask = 0x03FFFFFFu;

__global__ void __launch_bounds__(kThreads)
expand_runs_kernel(const uint32_t* __restrict__ runs,
                   const int32_t* __restrict__ counts,
                   int32_t* __restrict__ lin, uint8_t* __restrict__ marker,
                   int r, int f, int marks) {
  __shared__ int32_t warp_sums[kWarps];
  const int frame = blockIdx.x;
  const uint32_t* row = runs + static_cast<int64_t>(frame) * r;
  int32_t* out = lin + static_cast<int64_t>(frame) * f;
  uint8_t* mk = marker + static_cast<int64_t>(frame) * f;
  const int rc = min(max(counts[frame], 0), r);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int32_t carry = 0;                       // the slots of earlier chunks
  for (int c0 = 0; c0 < rc; c0 += kThreads) {
    const int ri = c0 + static_cast<int>(threadIdx.x);
    const uint32_t word = ri < rc ? row[ri] : 0u;
    const int32_t len = static_cast<int32_t>(word >> 27);
    int32_t incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int32_t v = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += y;
      }
      warp_sums[lane] = v;
    }
    __syncthreads();
    const int32_t off = carry + (warp > 0 ? warp_sums[warp - 1] : 0) +
                        incl - len;
    if (len > 0 && off < f) {
      const int32_t start = static_cast<int32_t>(word & kStartMask);
      const uint8_t m = marks ? static_cast<uint8_t>((word >> 26) & 1u) : 0;
      const int32_t end = min(off + len, f);
      for (int32_t s = off; s < end; ++s) {
        out[s] = start + (s - off);
        mk[s] = m;
      }
    }
    carry += warp_sums[kWarps - 1];
    __syncthreads();                       // warp_sums is reused
  }
  if (carry >= f) return;
  int32_t base = 1;                        // lin = slot + base
  uint32_t last = r > 0 ? row[0] : 0u;
  if (rc > 0) {
    last = row[rc - 1];
    base = static_cast<int32_t>(last & kStartMask) -
           (carry - static_cast<int32_t>(last >> 27));
  }
  const uint8_t m = marks ? static_cast<uint8_t>((last >> 26) & 1u) : 0;
  for (int32_t s = carry + static_cast<int32_t>(threadIdx.x); s < f;
       s += kThreads) {
    out[s] = base + s;
    mk[s] = m;
  }
}

}  // namespace

extern "C" {

// runs: (T, R) uint32 wire words; counts: (T,) int32 runs a frame; lin:
// (T, F) int32 out; marker: (T, F) uint8 out (0 without marks). Returns a
// cudaError_t (0 = launched).
int ysmr_expand_runs(const void* runs, const void* counts, void* lin,
                     void* marker, int t, int r, int f, int marks,
                     int device, void* stream) {
  if (t <= 0 || f <= 0) return 0;
  if (r < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  expand_runs_kernel<<<t, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(runs), static_cast<const int32_t*>(counts),
      static_cast<int32_t*>(lin), static_cast<uint8_t*>(marker), r, f,
      marks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
