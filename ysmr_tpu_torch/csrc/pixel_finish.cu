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
// Design: two launches over tiles of 2048 slots, a block of 256 threads a
// (tile, frame), slot q * 256 + thread of the tile (a warp's lanes hold 32
// consecutive slots).
//   - roots: the tile's root flags, ranked by warp ballots and a block scan
//     over the eight passes; each root's in-tile rank goes to a scratch at
//     its slot, the tile's count to a (T, tiles) table. With the row tables
//     the same launch fills them first (blocks past the frame's tiles only
//     fill), so the second launch's atomics find them filled. A tile whose
//     first slot is not valid holds no root (the valid slots are a prefix)
//     and writes its count 0 at once.
//   - ids: each block turns its frame's tile counts into offsets in shared
//     memory (warp 0's shuffle scan), then each kept pixel finds its root's
//     slot by a binary search of the frame's lin between s - (lin(s) -
//     label) and s (the lins are distinct ascending integers, so the root
//     lies no further back), reads the root's rank, and writes what was
//     asked. The row tables take one atomicMin at the first pixel and one
//     atomicMax at the last of each run of a warp's lanes with the same
//     component and y (raster order: the run's least and greatest x), the
//     row flag at the first; the root writes min_y. Block (0, frame) writes
//     the count and the plane's two last columns. With only the plane, the
//     launch covers the plane's f slots.
// No frame-sized buffer: the lists are read twice (roots, ids) and the
// searches read them again, mostly from the L1 (a warp's pixels share
// their roots).
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

constexpr int kTile = 2048;                  // slots a block
constexpr int kThreads = 256;
constexpr int kPasses = kTile / kThreads;    // slots a thread
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int32_t kBig = 1 << 30;            // the plain version's BIG_I
constexpr int kFillPerBlock = kThreads * 16; // table entries a fill block

__device__ __forceinline__ int32_t lin_at(const int32_t* __restrict__ xs,
                                          const int32_t* __restrict__ ys,
                                          int64_t g, int w) {
  // y * w + x wrapping as the plain version's int32 tensors
  return static_cast<int32_t>(static_cast<uint32_t>(ys[g]) *
                                  static_cast<uint32_t>(w) +
                              static_cast<uint32_t>(xs[g]));
}

__global__ void __launch_bounds__(kThreads)
finish_roots(const int32_t* __restrict__ lab, const uint8_t* __restrict__ keep,
             const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
             const uint8_t* __restrict__ valid, int32_t* __restrict__ rank,
             int32_t* __restrict__ tile_count, int32_t* __restrict__ row_min,
             int32_t* __restrict__ row_max, uint8_t* __restrict__ row_valid,
             int32_t* __restrict__ min_y, int f, int tiles, int w,
             int max_det, int max_bh) {
  __shared__ int32_t s_warp[kWarpsPerBlock];
  const int frame = blockIdx.y;
  if (row_min != nullptr) {
    // this block's share of the frame's tables
    const int64_t per = static_cast<int64_t>(max_det) * max_bh;
    const int64_t t0 = static_cast<int64_t>(frame) * per;
    const int64_t lo = per * blockIdx.x / gridDim.x;
    const int64_t hi = per * (blockIdx.x + 1) / gridDim.x;
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
      row_min[t0 + i] = kBig;
      row_max[t0 + i] = -kBig;
      row_valid[t0 + i] = 0;
    }
    const int64_t m0 = static_cast<int64_t>(frame) * max_det;
    const int64_t mlo = static_cast<int64_t>(max_det) * blockIdx.x / gridDim.x;
    const int64_t mhi =
        static_cast<int64_t>(max_det) * (blockIdx.x + 1) / gridDim.x;
    for (int64_t i = mlo + threadIdx.x; i < mhi; i += kThreads) {
      min_y[m0 + i] = kBig;
    }
  }
  if (static_cast<int>(blockIdx.x) >= tiles) return;
  const int t0 = blockIdx.x * kTile;
  const int64_t base = static_cast<int64_t>(frame) * f;
  if (!valid[base + t0]) {
    if (threadIdx.x == 0) tile_count[frame * tiles + blockIdx.x] = 0;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t running = 0;
  for (int q = 0; q < kPasses; ++q) {
    const int i = t0 + q * kThreads + threadIdx.x;
    bool root = false;
    if (i < f) {
      const int64_t g = base + i;
      root = keep[g] && lab[g] == lin_at(xs, ys, g, w);
    }
    const unsigned bits = __ballot_sync(kAll, root);
    if (lane == 0) s_warp[warp] = __popc(bits);
    __syncthreads();
    int32_t before = running;
    for (int k = 0; k < warp; ++k) before += s_warp[k];
    if (root) {
      rank[base + i] = before + __popc(bits & ((1u << lane) - 1u));
    }
    for (int k = 0; k < kWarpsPerBlock; ++k) running += s_warp[k];
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_count[frame * tiles + blockIdx.x] = running;
}

__global__ void __launch_bounds__(kThreads)
finish_ids(const int32_t* __restrict__ lab, const uint8_t* __restrict__ keep,
           const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
           const int32_t* __restrict__ rank,
           const int32_t* __restrict__ tile_count,
           int32_t* __restrict__ n_components, int32_t* __restrict__ comp_out,
           int16_t* __restrict__ plane, int plane_f, int plane_max_det,
           int32_t* __restrict__ row_min, int32_t* __restrict__ row_max,
           uint8_t* __restrict__ row_valid, int32_t* __restrict__ min_y,
           int f, int tiles, int w, int max_det, int max_bh) {
  extern __shared__ int32_t s_off[];         // the frame's tile offsets
  __shared__ int32_t s_total;
  const int frame = blockIdx.y;
  const int64_t base = static_cast<int64_t>(frame) * f;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int32_t carry = 0;
    for (int k0 = 0; k0 < tiles; k0 += 32) {
      const int k = k0 + lane;
      const int32_t v = k < tiles ? tile_count[frame * tiles + k] : 0;
      int32_t inc = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t u = __shfl_up_sync(kAll, inc, o);
        if (lane >= o) inc += u;
      }
      if (k < tiles) s_off[k] = carry + inc - v;
      carry += __shfl_sync(kAll, inc, 31);
    }
    if (lane == 0) s_total = carry;
  }
  __syncthreads();
  const int32_t n_comp = s_total;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    n_components[frame] = n_comp;
    if (plane != nullptr) {
      int16_t* row = plane + static_cast<int64_t>(frame) * (plane_f + 2);
      row[plane_f] = static_cast<int16_t>(min(n_comp, 32767));
      row[plane_f + 1] = 0;
    }
  }
  const int t0 = blockIdx.x * kTile;
  for (int q = 0; q < kPasses; ++q) {
    const int i = t0 + q * kThreads + threadIdx.x;
    const bool in = i < f;
    const int64_t g = base + i;
    const bool kept = in && keep[g];
    int32_t c = f;
    int32_t y = 0, x = 0, label = 0;
    if (kept) {
      label = lab[g];
      const int32_t own = lin_at(xs, ys, g, w);
      // the root: the first slot in [i - (own - label), i] whose lin is
      // >= label (it is equal there)
      int32_t lo = max(0, i - (own - label)), hi = i;
      while (lo < hi) {
        const int32_t mid = (lo + hi) >> 1;
        if (lin_at(xs, ys, base + mid, w) < label) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      c = n_comp - 1 - (s_off[lo / kTile] + rank[base + lo]);
      x = xs[g];
      y = ys[g];
      if (min_y != nullptr && lo == i && c < max_det) {
        min_y[static_cast<int64_t>(frame) * max_det + c] = y;
      }
    }
    if (comp_out != nullptr && in) comp_out[g] = c;
    if (plane != nullptr && i < plane_f) {
      plane[static_cast<int64_t>(frame) * (plane_f + 2) + i] =
          kept && c < plane_max_det ? static_cast<int16_t>(c)
                                    : static_cast<int16_t>(-1);
    }
    if (row_min != nullptr) {
      // a run of lanes with the same component and y: its first lane holds
      // the least x, its last the greatest (raster order)
      const bool tabled = kept && c < max_det;
      const int32_t key_c = tabled ? c : -1;
      const int32_t up_c = __shfl_up_sync(kAll, key_c, 1);
      const int32_t up_y = __shfl_up_sync(kAll, y, 1);
      const int32_t dn_c = __shfl_down_sync(kAll, key_c, 1);
      const int32_t dn_y = __shfl_down_sync(kAll, y, 1);
      if (tabled) {
        const bool first = lane == 0 || up_c != c || up_y != y;
        const bool last = lane == 31 || dn_c != c || dn_y != y;
        const int32_t root_y = label / w;
        const int32_t r = min(max(y - root_y, 0), max_bh - 1);
        const int64_t e =
            (static_cast<int64_t>(frame) * max_det + c) * max_bh + r;
        if (first) {
          atomicMin(row_min + e, x);
          row_valid[e] = 1;
        }
        if (last) atomicMax(row_max + e, x);
      }
    }
  }
}

}  // namespace

extern "C" {

// Scratch words (int32) of ysmr_pixel_finish: the in-tile ranks (T * F)
// and the tile counts (T * tiles).
long long ysmr_pixel_finish_scratch_words(int t, int f) {
  const long long tiles = (f + kTile - 1) / kTile;
  return static_cast<long long>(t) * f + static_cast<long long>(t) * tiles;
}

// Largest F of one frame: the tile offsets in a block's static-size
// dynamic shared memory (48 KB).
int ysmr_pixel_finish_max_f() { return (48 * 1024 / 4) * kTile; }

// lab_fg, px_x, px_y: (T, F) int32; keep, valid: (T, F) uint8 (0/1);
// scratch: ysmr_pixel_finish_scratch_words(T, F) int32; n_components: (T,)
// int32 out. Optional outputs (null where not asked): comp (T, F) int32;
// plane (T, plane_f + 2) int16 with its own max_det; row_min, row_max
// (T * max_det, max_bh) int32, row_valid the same uint8, min_y
// (T * max_det) int32 (all four or none). Returns a cudaError_t
// (cudaErrorInvalidValue for F above ysmr_pixel_finish_max_f()).
int ysmr_pixel_finish(const void* lab_fg, const void* keep, const void* px_x,
                      const void* px_y, const void* valid, void* scratch,
                      void* n_components, void* comp, void* plane,
                      void* row_min, void* row_max, void* row_valid,
                      void* min_y, int t, int f, int w, int plane_f,
                      int plane_max_det, int max_det, int max_bh, int device,
                      void* stream) {
  if (t <= 0 || f <= 0) return 0;
  if (f > ysmr_pixel_finish_max_f()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (f + kTile - 1) / kTile;
  int32_t* rank = static_cast<int32_t*>(scratch);
  int32_t* counts = rank + static_cast<int64_t>(t) * f;
  const bool tables = row_min != nullptr;
  const int32_t* lab = static_cast<const int32_t*>(lab_fg);
  const uint8_t* kp = static_cast<const uint8_t*>(keep);
  const int32_t* xs = static_cast<const int32_t*>(px_x);
  const int32_t* ys = static_cast<const int32_t*>(px_y);
  int grid_x = tiles;
  if (tables) {
    // enough blocks for the fill, however few the tiles
    const int64_t per = static_cast<int64_t>(max_det) * max_bh;
    const int64_t fill = (per + kFillPerBlock - 1) / kFillPerBlock;
    if (fill > grid_x) grid_x = static_cast<int>(fill);
  }
  finish_roots<<<dim3(grid_x, t), kThreads, 0, s>>>(
      lab, kp, xs, ys, static_cast<const uint8_t*>(valid), rank, counts,
      static_cast<int32_t*>(row_min), static_cast<int32_t*>(row_max),
      static_cast<uint8_t*>(row_valid), static_cast<int32_t*>(min_y), f,
      tiles, w, max_det, max_bh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // with the plane alone, the tiles of its first plane_f slots
  const int plane_slots = plane_f < f ? plane_f : f;
  int id_tiles = tiles;
  if (comp == nullptr && !tables) {
    id_tiles = (plane_slots + kTile - 1) / kTile;
    if (id_tiles < 1) id_tiles = 1;
  }
  finish_ids<<<dim3(id_tiles, t), kThreads,
               static_cast<size_t>(tiles) * 4, s>>>(
      lab, kp, xs, ys, rank, counts, static_cast<int32_t*>(n_components),
      static_cast<int32_t*>(comp), static_cast<int16_t*>(plane), plane_f,
      plane_max_det, static_cast<int32_t*>(row_min),
      static_cast<int32_t*>(row_max), static_cast<uint8_t*>(row_valid),
      static_cast<int32_t*>(min_y), f, tiles, w, max_det, max_bh);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
