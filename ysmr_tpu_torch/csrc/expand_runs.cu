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
// contract; a length-0 word below the count writes no slot). Design, two
// launches over the slots rather than one block a frame over its runs:
//   - expand_sums: a block a chunk of 2048 runs below the frame's count
//     sums their lengths (chunks past the count return at once); a wire
//     of one chunk (R <= 2048, the bench batch) skips this launch;
//   - expand_tiles: a block a tile of 2048 output slots. Its first warp
//     scans the frame's chunk sums (16 at the dense batch) for the frame's
//     total and the first chunk that reaches into the tile (with one chunk
//     its scan gives the total); the block then
//     takes each chunk that covers part of the tile: the chunk's words in
//     shared memory and their inclusive length prefix (a block scan),
//     and each slot's run by a search of that prefix (a binary search for
//     the first slot of a thread's four, then a step a slot). A thread
//     owns two groups of four consecutive slots, 1024 apart, and writes
//     each as one 16-byte lin store and one 4-byte marker store (a warp's
//     stores are 512 contiguous bytes). The slots past the frame's pixels
//     get what the plain version's cumsum and cummax leave there: the
//     last word's lin continued one a slot and its marker (lin = slot + 1
//     and the first word's marker bit where the frame has no run); tiles
//     wholly past them write that alone.
// Bound: the counts and the wire's words below them in (4 bytes each) and
// the table out (5 bytes a slot): 47 MB at the dense batch (64 x 32768
// runs, F = 131072), ~14 us. The chunk sums are T x ceil(R / 2048) int32
// (4 KB dense).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;                     // runs a chunk, 8 a thread
constexpr int kPer = kChunk / kThreads;
constexpr int kTile = 2048;                      // slots a tile, 8 a thread
constexpr int kGroups = kTile / (4 * kThreads);  // groups of 4 a thread
constexpr uint32_t kStartMask = 0x03FFFFFFu;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t word_len(uint32_t word) {
  return static_cast<int32_t>(word >> 27);
}

// the sum of v over the block (every thread gets it); red: kWarps ints
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* red) {
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int32_t s = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) s += red[q];
  __syncthreads();
  return s;
}

// grid: x the chunks of the (T, R) wire, y the frames (strided)
__global__ void __launch_bounds__(kThreads)
expand_sums(const uint32_t* __restrict__ runs,
            const int32_t* __restrict__ counts, int32_t* __restrict__ sums,
            int t, int r, int nc) {
  __shared__ int32_t red[kWarps];
  const int c0 = static_cast<int>(blockIdx.x) * kChunk;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int rc = min(max(counts[frame], 0), r);
    if (c0 >= rc) continue;                // the expansion reads no sum here
    const uint32_t* row = runs + static_cast<int64_t>(frame) * r;
    const int end = min(c0 + kChunk, rc);
    int32_t acc = 0;
    for (int j = c0 + static_cast<int>(threadIdx.x); j < end; j += kThreads) {
      acc += word_len(row[j]);
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) {
      sums[static_cast<int64_t>(frame) * nc + blockIdx.x] = acc;
    }
  }
}

// grid: x the tiles of kTile slots of a frame, y the frames (strided)
__global__ void __launch_bounds__(kThreads)
expand_tiles(const uint32_t* __restrict__ runs,
             const int32_t* __restrict__ counts,
             const int32_t* __restrict__ sums, int32_t* __restrict__ lin,
             uint8_t* __restrict__ marker, int t, int r, int f, int nc,
             int marks) {
  __shared__ uint32_t s_word[kChunk];
  __shared__ int32_t s_incl[kChunk];     // the chunk's inclusive prefix
  __shared__ int32_t s_red[kWarps];
  __shared__ int32_t s_first, s_off, s_total;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int32_t s0 = static_cast<int32_t>(blockIdx.x) * kTile;
  const int32_t s1 = min(s0 + kTile, f);
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const uint32_t* row = runs + static_cast<int64_t>(frame) * r;
    const int rc = min(max(counts[frame], 0), r);
    const int nce = (rc + kChunk - 1) / kChunk;
    __syncthreads();                       // the last frame's tables are read
    if (nc <= 1) {
      // one chunk: its own scan below gives the total
      if (threadIdx.x == 0) {
        s_first = 0;
        s_off = 0;
      }
    } else if (warp == 0) {
      // the frame's total and the first chunk whose slots reach past s0
      const int32_t* fs = sums + static_cast<int64_t>(frame) * nc;
      int32_t carry = 0, off = 0;
      int first = nce;
      for (int b = 0; b < nce; b += 32) {
        const int c = b + lane;
        const int32_t v = c < nce ? fs[c] : 0;
        int32_t x = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int32_t y = __shfl_up_sync(kFull, x, o);
          if (lane >= o) x += y;
        }
        x += carry;
        const unsigned past = __ballot_sync(kFull, c < nce && x > s0);
        if (first == nce && past != 0u) {
          const int q = __ffs(past) - 1;
          first = b + q;
          off = __shfl_sync(kFull, x - v, q);
        }
        carry = __shfl_sync(kFull, x, 31);
      }
      if (lane == 0) {
        s_first = first;
        s_off = off;
        s_total = carry;
      }
    }
    __syncthreads();
    int32_t total = nc <= 1 ? 0 : s_total;
    int32_t o_lin[4 * kGroups];
    uint8_t o_mk[4 * kGroups];
    int32_t coff = s_off;
    for (int c = s_first; c < nce && (coff < s1 || nc <= 1); ++c) {
      // the chunk's words, then each thread's eight consecutive lengths
      // and their place in the chunk's inclusive prefix
      const int g0 = c * kChunk;
      for (int j = static_cast<int>(threadIdx.x); j < kChunk; j += kThreads) {
        s_word[j] = g0 + j < rc ? row[g0 + j] : 0u;
      }
      __syncthreads();
      int32_t part[kPer];
      int32_t acc = 0;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        acc += word_len(s_word[kPer * threadIdx.x + q]);
        part[q] = acc;
      }
      int32_t x = acc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (lane == 31) s_red[warp] = x;
      __syncthreads();
      int32_t before = x - acc;
      for (int q = 0; q < warp; ++q) before += s_red[q];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        s_incl[kPer * threadIdx.x + q] = before + part[q];
      }
      __syncthreads();
      const int32_t cend = coff + s_incl[kChunk - 1];
      if (nc <= 1) total = cend;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int32_t sg = s0 + g * 4 * kThreads + 4 * threadIdx.x;
        int j = -1;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int32_t sl = sg + q;
          if (sl < coff || sl >= cend || sl >= s1) continue;
          const int32_t rel = sl - coff;
          if (j < 0) {
            // the first word whose inclusive end passes the slot
            int lo = 0, hi = kChunk - 1;
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (s_incl[mid] > rel) {
                hi = mid;
              } else {
                lo = mid + 1;
              }
            }
            j = lo;
          }
          while (s_incl[j] <= rel) ++j;
          const uint32_t word = s_word[j];
          o_lin[4 * g + q] = static_cast<int32_t>(word & kStartMask) + rel -
                             (s_incl[j] - word_len(word));
          o_mk[4 * g + q] = marks ? static_cast<uint8_t>((word >> 26) & 1u)
                                  : 0;
        }
      }
      coff = cend;
      __syncthreads();                     // the chunk's tables are reused
    }
    // the slots past the frame's pixels: the last word's lin continued
    int32_t tail_base = 1;
    uint32_t last = r > 0 ? row[0] : 0u;
    if (rc > 0) {
      last = row[rc - 1];
      tail_base = static_cast<int32_t>(last & kStartMask) + word_len(last) -
                  total;
    }
    const uint8_t tail_mk = marks ? static_cast<uint8_t>((last >> 26) & 1u)
                                  : 0;
    const int64_t base = static_cast<int64_t>(frame) * f;
    const bool vec = (f & 3) == 0;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const int32_t sg = s0 + g * 4 * kThreads + 4 * threadIdx.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (sg + q >= total) {
          o_lin[4 * g + q] = tail_base + sg + q;
          o_mk[4 * g + q] = tail_mk;
        }
      }
      if (vec && sg + 3 < s1) {
        *reinterpret_cast<int4*>(lin + base + sg) =
            make_int4(o_lin[4 * g], o_lin[4 * g + 1], o_lin[4 * g + 2],
                      o_lin[4 * g + 3]);
        *reinterpret_cast<uint32_t*>(marker + base + sg) =
            static_cast<uint32_t>(o_mk[4 * g]) |
            (static_cast<uint32_t>(o_mk[4 * g + 1]) << 8) |
            (static_cast<uint32_t>(o_mk[4 * g + 2]) << 16) |
            (static_cast<uint32_t>(o_mk[4 * g + 3]) << 24);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (sg + q < s1) {
            lin[base + sg + q] = o_lin[4 * g + q];
            marker[base + sg + q] = o_mk[4 * g + q];
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// runs: (T, R) uint32 wire words; counts: (T,) int32 runs a frame; sums:
// (T, ceil(R / 2048)) int32 scratch; lin: (T, F) int32 out; marker: (T,
// F) uint8 out (0 without marks). Returns a cudaError_t (0 = launched).
int ysmr_expand_runs(const void* runs, const void* counts, void* sums,
                     void* lin, void* marker, int t, int r, int f, int marks,
                     int device, void* stream) {
  if (t <= 0 || f <= 0) return 0;
  if (r < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned ty = static_cast<unsigned>(t < 65535 ? t : 65535);
  const int nc = (r + kChunk - 1) / kChunk;
  const uint32_t* w = static_cast<const uint32_t*>(runs);
  const int32_t* c = static_cast<const int32_t*>(counts);
  int32_t* cs = static_cast<int32_t*>(sums);
  if (nc > 1) {
    expand_sums<<<dim3(static_cast<unsigned>(nc), ty), kThreads, 0, s>>>(
        w, c, cs, t, r, nc);
  }
  expand_tiles<<<dim3(static_cast<unsigned>((f + kTile - 1) / kTile), ty),
                 kThreads, 0, s>>>(w, c, cs, static_cast<int32_t*>(lin),
                                   static_cast<uint8_t*>(marker), t, r, f, nc,
                                   marks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
