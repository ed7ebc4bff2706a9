// The pixel-table branch's finish after the labels: dense component ids,
// the component count and, on request, the host-rect batch's int16
// readback plane, the ids themselves and the device rects' row tables.
//
// Replaces no Pallas kernel: ysmr_tpu/pipeline/detect_pixels.py:273
// compact_ids (the roots ranked in raster order, the rank read back at
// each pixel's root) and the row tables of ysmr_tpu/ops/labeling.py:381
// component_stats (their segment-reduction branch), plain XLA, and the
// int16 slice, casts and concatenation the host-rect path reads. Same
// contract as the plain version ysmr_tpu_torch/ops/cc.py::
// pixel_finish_plain, bit for bit, on ysmr_cc_pixels' outputs (csrc/cc.cu):
// per frame a list of F pixels (x, y, valid) whose valid pixels are a
// prefix in strictly ascending lin = y * w + x, inside the frame; lab_fg
// the minimum lin of the pixel's 8-connected component among the kept
// pixels, keep the kept flag (a kept pixel is valid). Then:
//   - a root is a kept pixel whose label is its own lin: its component's
//     first pixel in raster order; rank = the roots before it in its
//     frame; n_components = the frame's roots;
//   - comp = n_components - 1 - rank(root of the pixel) at a kept pixel
//     (cv2's contour order: the last root first), F elsewhere;
//   - the plane (T, f + 2) int16: comp where kept and comp < max_det, else
//     -1, for the first f slots; min(n_components, 32767); 0 (the pixel
//     table has no step count);
//   - the row tables over (T * max_det, max_bh): for component c < max_det
//     and bbox row r = clamp(y - min_y(c), 0, max_bh - 1) the least and
//     greatest x of its pixels (2^30 and -2^30 where none) and the row's
//     flag; min_y(c) = the component's least y, which is its root's row
//     (2^30 for a slot with no component).
//
// Design: three launches.
//   - roots, over tiles of 2048 slots, a block of 256 threads a (tile,
//     frame), slot q * 256 + thread of the tile: each thread loads its
//     eight slots at once, the tile's root flags are ranked by warp ballots
//     and one scan of the 64 (pass, warp) counts, and each root writes its
//     lin at its in-tile rank in the tile's list (a scratch of the tile's
//     own 2048 slots: the list ascends, as the lins do); the tile's count
//     goes to a (T, tiles) table and the lin of its first slot to another.
//     A tile whose first slot is not valid holds no root (the valid slots
//     are a prefix) and writes its count 0 at once. With the row tables,
//     blocks past the roots' fill them, 16 bytes a store, so the ids
//     launch's atomics find them filled.
//   - offsets: a warp a frame turns the tile counts into exclusive offsets
//     in place (global memory: no bound on the tiles a frame) and writes
//     the count and the plane's two last columns.
//   - ids, four slots a thread (slot q * 256 + thread of a block's 1024,
//     their loads first): a kept pixel's root lies between s - (lin(s) -
//     label) and s (the lins are distinct ascending integers); its tile is
//     the last of those tiles whose first lin is at most the label (most
//     often the pixel's own: no probe), and its rank that tile's offset +
//     the label's place in the tile's list (a binary search of a few dozen
//     ascending lins, which the frame's warps share in the L1). Then each
//     lane writes what was asked. The row tables take one atomicMin at the
//     first pixel and one atomicMax at the last of each run of a warp's
//     lanes with the same component and y (raster order: the run's least
//     and greatest x), the row flag at the first; the root writes min_y.
//     With only the plane, the launch covers the plane's f slots; with only
//     the count, it does not run.
// No frame-sized buffer: the lists are read twice (roots, ids).
//
// What bounds it on an H100: the lists' bytes (lab_fg, x, y int32, keep
// and valid bytes: 14 a slot) read once, the outputs written once: the
// plane's 2 bytes a slot, comp's 4, and the row tables' 9 bytes a (slot,
// row) with min_y's 4 a slot. The dense batch's tables (64 x 4096 x 48)
// are 113 MB, most of it the fill of rows that hold no pixel: the tables'
// contract (the plain version's bytes) writes every entry.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 2048;                  // slots a roots block
constexpr int kThreads = 256;
constexpr int kPasses = kTile / kThreads;    // slots a thread
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int32_t kBig = 1 << 30;            // the plain version's BIG_I
constexpr int kFillPerThread = 4;            // int4 stores a fill thread
constexpr int kIdPasses = 4;                 // slots a thread of the ids

// The row tables' fill: row_min 2^30, row_max -2^30, row_valid 0 over
// `entries`, min_y 2^30 over `comps`, 16 bytes a store (the tensors are
// 16-byte aligned), the tails a value a store.
__device__ void fill_tables(int64_t block, int64_t blocks,
                            int32_t* __restrict__ row_min,
                            int32_t* __restrict__ row_max,
                            uint8_t* __restrict__ row_valid,
                            int32_t* __restrict__ min_y, int64_t entries,
                            int64_t comps) {
  const int4 big = make_int4(kBig, kBig, kBig, kBig);
  const int4 neg = make_int4(-kBig, -kBig, -kBig, -kBig);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int64_t n4 = entries / 4, n16 = entries / 16, m4 = comps / 4;
  const int64_t stride = blocks * kThreads;
  for (int64_t i = block * kThreads + threadIdx.x; i < n4; i += stride) {
    reinterpret_cast<int4*>(row_min)[i] = big;
    reinterpret_cast<int4*>(row_max)[i] = neg;
    if (i < n16) reinterpret_cast<int4*>(row_valid)[i] = zero;
    if (i < m4) reinterpret_cast<int4*>(min_y)[i] = big;
  }
  if (block == 0 && threadIdx.x < 16) {
    const int64_t k = threadIdx.x;
    if (n4 * 4 + k < entries) {
      row_min[n4 * 4 + k] = kBig;
      row_max[n4 * 4 + k] = -kBig;
    }
    if (n16 * 16 + k < entries) row_valid[n16 * 16 + k] = 0;
    if (m4 * 4 + k < comps) min_y[m4 * 4 + k] = kBig;
  }
}

__global__ void __launch_bounds__(kThreads)
finish_roots(const int32_t* __restrict__ lab, const uint8_t* __restrict__ keep,
             const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
             const uint8_t* __restrict__ valid,
             int32_t* __restrict__ tile_roots,
             int32_t* __restrict__ tile_count,
             int32_t* __restrict__ tile_first, int32_t* __restrict__ row_min,
             int32_t* __restrict__ row_max, uint8_t* __restrict__ row_valid,
             int32_t* __restrict__ min_y, int64_t root_blocks,
             int64_t entries, int64_t comps, int f, int tiles, int w) {
  __shared__ int32_t s_count[kPasses * kWarpsPerBlock];
  __shared__ int32_t s_before[kPasses * kWarpsPerBlock];
  const int64_t bid = blockIdx.x;
  if (bid >= root_blocks) {
    fill_tables(bid - root_blocks, gridDim.x - root_blocks, row_min, row_max,
                row_valid, min_y, entries, comps);
    return;
  }
  const int frame = static_cast<int>(bid / tiles);
  const int tile = static_cast<int>(bid % tiles);
  const int t0 = tile * kTile;
  const int64_t base = static_cast<int64_t>(frame) * f;
  if (!valid[base + t0]) {
    if (threadIdx.x == 0) {
      tile_count[bid] = 0;
      tile_first[bid] = INT32_MAX;
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the eight slots' loads first, all in flight together
  bool root[kPasses];
  int32_t lin[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    const int i = t0 + q * kThreads + threadIdx.x;
    root[q] = false;
    lin[q] = 0;
    if (i < f) {
      const int64_t g = base + i;
      const bool v = valid[g], k = keep[g];
      const int32_t l = lab[g];
      lin[q] = static_cast<int32_t>(static_cast<uint32_t>(ys[g]) *
                                        static_cast<uint32_t>(w) +
                                    static_cast<uint32_t>(xs[g]));
      root[q] = v && k && l == lin[q];
    }
  }
  if (threadIdx.x == 0) tile_first[bid] = lin[0];
  unsigned bits[kPasses];
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    bits[q] = __ballot_sync(kAll, root[q]);
    if (lane == 0) s_count[q * kWarpsPerBlock + warp] = __popc(bits[q]);
  }
  __syncthreads();
  if (warp == 0) {
    // the 64 counts in slot order, two a lane
    const int32_t a = s_count[2 * lane], b = s_count[2 * lane + 1];
    int32_t inc = a + b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kAll, inc, o);
      if (lane >= o) inc += u;
    }
    s_before[2 * lane] = inc - a - b;
    s_before[2 * lane + 1] = inc - b;
    if (lane == 31) tile_count[bid] = inc;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kPasses; ++q) {
    if (root[q]) {
      tile_roots[base + t0 + s_before[q * kWarpsPerBlock + warp] +
                 __popc(bits[q] & below)] = lin[q];
    }
  }
}

__global__ void finish_offsets(int32_t* __restrict__ tile_count,
                               int32_t* __restrict__ n_components,
                               int16_t* __restrict__ plane, int plane_f,
                               int tiles) {
  const int frame = blockIdx.x;
  const int lane = threadIdx.x;
  int32_t* row = tile_count + static_cast<int64_t>(frame) * tiles;
  int32_t carry = 0;
  for (int k0 = 0; k0 < tiles; k0 += 32) {
    const int k = k0 + lane;
    const int32_t v = k < tiles ? row[k] : 0;
    int32_t inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kAll, inc, o);
      if (lane >= o) inc += u;
    }
    if (k < tiles) row[k] = carry + inc - v;
    carry += __shfl_sync(kAll, inc, 31);
  }
  if (lane == 0) {
    n_components[frame] = carry;
    if (plane != nullptr) {
      int16_t* out = plane + static_cast<int64_t>(frame) * (plane_f + 2);
      out[plane_f] = static_cast<int16_t>(min(carry, 32767));
      out[plane_f + 1] = 0;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
finish_ids(const int32_t* __restrict__ lab, const uint8_t* __restrict__ keep,
           const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
           const int32_t* __restrict__ tile_roots,
           const int32_t* __restrict__ tile_off,
           const int32_t* __restrict__ tile_first,
           const int32_t* __restrict__ n_components,
           int32_t* __restrict__ comp_out, int16_t* __restrict__ plane,
           int plane_f, int plane_max_det, int32_t* __restrict__ row_min,
           int32_t* __restrict__ row_max, uint8_t* __restrict__ row_valid,
           int32_t* __restrict__ min_y, int f, int tiles, int w, int max_det,
           int max_bh) {
  const int frame = blockIdx.y;
  const int64_t base = static_cast<int64_t>(frame) * f;
  const int lane = threadIdx.x & 31;
  const int i0 = blockIdx.x * kThreads * kIdPasses + threadIdx.x;
  // the slots' loads first, all in flight together
  int32_t label[kIdPasses], x[kIdPasses], y[kIdPasses];
  bool kept[kIdPasses];
#pragma unroll
  for (int q = 0; q < kIdPasses; ++q) {
    const int i = i0 + q * kThreads;
    label[q] = x[q] = y[q] = 0;
    kept[q] = false;
    if (i < f) {
      const int64_t g = base + i;
      label[q] = lab[g];
      kept[q] = keep[g];
      x[q] = xs[g];
      y[q] = ys[g];
    }
  }
  const int32_t n_comp = n_components[frame];
  const int32_t* first = tile_first + static_cast<int64_t>(frame) * tiles;
  const int32_t* off = tile_off + static_cast<int64_t>(frame) * tiles;
#pragma unroll
  for (int q = 0; q < kIdPasses; ++q) {
    const int i = i0 + q * kThreads;
    const int64_t g = base + i;
    const int32_t own = static_cast<int32_t>(static_cast<uint32_t>(y[q]) *
                                                 static_cast<uint32_t>(w) +
                                             static_cast<uint32_t>(x[q]));
    int32_t c = f;
    if (kept[q]) {
      // the root's tile: the last between those of slots i - (own -
      // label) and i whose first lin is at most the label
      const int64_t back = static_cast<int64_t>(i) - own + label[q];
      int32_t hi = i / kTile;
      int32_t lo = static_cast<int32_t>(min(max(back, int64_t(0)) / kTile,
                                            static_cast<int64_t>(hi)));
      while (lo < hi) {
        const int32_t mid = (lo + hi + 1) >> 1;
        if (first[mid] <= label[q]) {
          lo = mid;
        } else {
          hi = mid - 1;
        }
      }
      // the label's place in the tile's ascending list of root lins
      const int32_t o = off[lo];
      const int32_t* list =
          tile_roots + base + static_cast<int64_t>(lo) * kTile;
      int32_t a = 0, b = (lo + 1 < tiles ? off[lo + 1] : n_comp) - o - 1;
      while (a < b) {
        const int32_t mid = (a + b) >> 1;
        if (list[mid] < label[q]) {
          a = mid + 1;
        } else {
          b = mid;
        }
      }
      c = n_comp - 1 - (o + a);
      if (min_y != nullptr && own == label[q] && c < max_det) {
        min_y[static_cast<int64_t>(frame) * max_det + c] = y[q];
      }
    }
    if (comp_out != nullptr && i < f) comp_out[g] = c;
    if (plane != nullptr && i < plane_f) {
      plane[static_cast<int64_t>(frame) * (plane_f + 2) + i] =
          kept[q] && c < plane_max_det ? static_cast<int16_t>(c)
                                       : static_cast<int16_t>(-1);
    }
    if (row_min != nullptr) {
      // a run of lanes with the same component and y: its first lane
      // holds the least x, its last the greatest (raster order)
      const bool tabled = kept[q] && c < max_det;
      const int32_t key_c = tabled ? c : -1;
      const int32_t up_c = __shfl_up_sync(kAll, key_c, 1);
      const int32_t up_y = __shfl_up_sync(kAll, y[q], 1);
      const int32_t dn_c = __shfl_down_sync(kAll, key_c, 1);
      const int32_t dn_y = __shfl_down_sync(kAll, y[q], 1);
      if (tabled) {
        const bool first_x = lane == 0 || up_c != c || up_y != y[q];
        const bool last_x = lane == 31 || dn_c != c || dn_y != y[q];
        const int32_t root_y = label[q] / w;
        const int32_t r = min(max(y[q] - root_y, 0), max_bh - 1);
        const int64_t e =
            (static_cast<int64_t>(frame) * max_det + c) * max_bh + r;
        if (first_x) {
          atomicMin(row_min + e, x[q]);
          row_valid[e] = 1;
        }
        if (last_x) atomicMax(row_max + e, x[q]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Scratch words (int32) of ysmr_pixel_finish: the tiles' lists of root
// lins (T * F), the tile counts, then offsets, and the tiles' first lins
// (T * tiles each).
long long ysmr_pixel_finish_scratch_words(int t, int f) {
  const long long tiles = (static_cast<long long>(f) + kTile - 1) / kTile;
  return static_cast<long long>(t) * (f + 2 * tiles);
}

// lab_fg, px_x, px_y: (T, F) int32; keep, valid: (T, F) uint8 (0/1);
// scratch: ysmr_pixel_finish_scratch_words(T, F) int32; n_components: (T,)
// int32 out. Optional outputs (null where not asked): comp (T, F) int32;
// plane (T, plane_f + 2) int16 with its own max_det; row_min, row_max
// (T * max_det, max_bh) int32, row_valid the same uint8, min_y
// (T * max_det) int32 (all four or none, each 16-byte aligned). Returns a
// cudaError_t (cudaErrorInvalidValue for a table not 16-byte aligned).
int ysmr_pixel_finish(const void* lab_fg, const void* keep, const void* px_x,
                      const void* px_y, const void* valid, void* scratch,
                      void* n_components, void* comp, void* plane,
                      void* row_min, void* row_max, void* row_valid,
                      void* min_y, int t, int f, int w, int plane_f,
                      int plane_max_det, int max_det, int max_bh, int device,
                      void* stream) {
  if (t <= 0 || f <= 0) return 0;
  const bool tables = row_min != nullptr;
  if (tables) {
    for (const void* p : {static_cast<const void*>(row_min),
                          static_cast<const void*>(row_max),
                          static_cast<const void*>(row_valid),
                          static_cast<const void*>(min_y)}) {
      if (reinterpret_cast<uintptr_t>(p) % 16 != 0) {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>((static_cast<int64_t>(f) + kTile - 1) /
                                     kTile);
  int32_t* tile_roots = static_cast<int32_t*>(scratch);
  int32_t* counts = tile_roots + static_cast<int64_t>(t) * f;
  int32_t* firsts = counts + static_cast<int64_t>(t) * tiles;
  const int32_t* lab = static_cast<const int32_t*>(lab_fg);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  const int32_t* xs = static_cast<const int32_t*>(px_x);
  const int32_t* ys = static_cast<const int32_t*>(px_y);
  const int64_t root_blocks = static_cast<int64_t>(t) * tiles;
  int64_t entries = 0, comps = 0, fill_blocks = 0;
  if (tables) {
    comps = static_cast<int64_t>(t) * max_det;
    entries = comps * max_bh;
    const int64_t per_block = static_cast<int64_t>(kThreads) * kFillPerThread;
    fill_blocks = (entries / 4 + per_block - 1) / per_block;
    if (fill_blocks < 1) fill_blocks = 1;
  }
  if (root_blocks + fill_blocks > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  finish_roots<<<static_cast<unsigned>(root_blocks + fill_blocks), kThreads,
                 0, s>>>(
      lab, kp, xs, ys, static_cast<const uint8_t*>(valid), tile_roots,
      counts, firsts, static_cast<int32_t*>(row_min),
      static_cast<int32_t*>(row_max), static_cast<uint8_t*>(row_valid),
      static_cast<int32_t*>(min_y), root_blocks, entries, comps, f, tiles, w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finish_offsets<<<t, 32, 0, s>>>(counts,
                                  static_cast<int32_t*>(n_components),
                                  static_cast<int16_t*>(plane), plane_f,
                                  tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // with the plane alone, its first plane_f slots; with no output of its
  // own, no ids launch (the count is the offsets launch's)
  if (comp == nullptr && !tables && plane == nullptr) return 0;
  int id_slots = f;
  if (comp == nullptr && !tables && plane_f < f) id_slots = plane_f;
  const int id_blocks =
      (id_slots + kThreads * kIdPasses - 1) / (kThreads * kIdPasses);
  finish_ids<<<dim3(id_blocks, t), kThreads, 0, s>>>(
      lab, kp, xs, ys, tile_roots, counts, firsts,
      static_cast<const int32_t*>(n_components), static_cast<int32_t*>(comp),
      static_cast<int16_t*>(plane), plane_f, plane_max_det,
      static_cast<int32_t*>(row_min), static_cast<int32_t*>(row_max),
      static_cast<uint8_t*>(row_valid), static_cast<int32_t*>(min_y), f,
      tiles, w, max_det, max_bh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
