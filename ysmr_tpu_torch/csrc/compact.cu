// Frames mode's compaction and row tables in one pass over the batch: the
// 8-connected labels of csrc/cc.cu's labeling and the mask in, each
// component's per-row x extremes, the row flags, its minimum y and each
// frame's component count out.
//
// Replaces the plain-XLA ysmr_tpu/ops/labeling.py:211 compact_labels and
// the row tables of :588 component_tables (no Pallas kernel: XLA fuses
// them). Same contract and the same bits as ysmr_tpu_torch/ops/
// labeling.py::compact_row_tables_plain, compact_labels followed by
// component_row_tables: a torch cumulative sum, gathers and wheres over
// every pixel of the batch, a (T, H, W) int32 plane of dense ids, a
// nonzero (a host synchronisation) and three scatter reductions.
//
// Facts it uses. A label is its component's minimum in-frame linear index
// (h w on the background), so a root is a mask pixel whose label is its
// own index, its y is the component's minimum y, and its rank among the
// frame's roots in raster order gives the id: n - 1 - rank (cv2's reverse
// order), ids of max_det and above dropped. Every output is an integer
// minimum, maximum, count or flag, so the order of the atomics does not
// change a bit.
//
// Design (three launches, no memset, nothing read back):
// 1. roots: a thread per 32-pixel word of the flattened batch (words do
//    not stop at frame edges): the mask's 32 bytes (two 16-byte loads
//    where aligned) packed into a foreground word; the warp then walks
//    its non-empty words, its lanes on a word's 32 pixels, reading the
//    labels only there (one 128-byte line a word), and ballots the
//    roots into a root word. A block's 256 words form a tile: the words'
//    exclusive root counts within the tile (a warp scan and the 8 warp
//    totals) and the tile's total go to scratch. The same threads fill
//    the output tables with their empty values (+-2^30, false).
// 2. scan: one block: the exclusive scan of the tile totals, then for
//    each frame t the count of roots before its first pixel, F(t) =
//    tile prefix + word prefix + popc(root word & below) at pixel t h w,
//    and n_components[t] = F(t + 1) - F(t) (uint32, modulo 2^32: exact
//    for any batch whose frames hold fewer than 2^32 roots).
// 3. tables: a warp per 32 foreground words; on each non-empty word the
//    lanes take its pixels: frame and (y, x) from a double reciprocal and
//    one correction, the label, the rank of the root pixel it names
//    (prefix + popc within its root word - F(t); a label that names no
//    root ranks 0, as the plain version's gather of a zero gives), the
//    id, the row y - y_root clamped to [0, max_bh - 1]. Lanes of one
//    table slot (a run of a row) find each other with __match_any_sync
//    and reduce x to a minimum and a maximum, so one atomicMin, one
//    atomicMax and one byte store stand for the run; the root pixel
//    writes its component's min_y.
// The (T, H, W) plane of ids is never written and the labels are read at
// foreground pixels only.
//
// What bounds it on an H100: bytes. The bench batch (64 x 922 x 1228,
// 512 components, max_bh 64) reads its 72.5 MB mask once and the labels
// at its foreground pixels, writes the 19 MB of tables and moves about
// 45 MB of words of its own (foreground, roots, prefixes: 12 bytes a
// word, written once, read once or twice): about 0.04 ms at 3.35 TB/s.
// The TPU had no kernel here; XLA fused the compaction and the segment
// reductions.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileWords = kThreads;  // words of a tile: one a thread
constexpr int kScanThreads = 1024;
constexpr int kBig = 1 << 30;  // ops/labeling.py's BIG_I

struct Scratch {
  uint32_t* fg;        // (nw,) foreground words
  uint32_t* root;      // (nw,) root words
  uint32_t* pre;       // (nw,) roots before the word within its tile
  uint32_t* tile;      // (tiles,) roots of a tile
  uint32_t* tile_pre;  // (tiles + 1,) roots before a tile; the total last
  uint32_t* frame;     // (T + 1,) roots before a frame's first pixel
};

struct Args {
  const uint8_t* mask;  // (T, H, W) bool
  const int* labels;    // (T, H, W) int32
  int* row_min;         // (T max_det, max_bh)
  int* row_max;
  uint8_t* row_valid;
  int* min_y;           // (T max_det,)
  int* n_comp;          // (T,)
  Scratch s;
  int64_t total;        // T h w
  int64_t n;            // h w
  int64_t nw;           // words: ceil(total / 32)
  int64_t tiles;        // ceil(nw / kTileWords)
  int64_t entries;      // T max_det max_bh
  int64_t comps;        // T max_det
  double inv_n, inv_w;  // 1 / n, 1 / w
  int t, w, max_det, max_bh;
  bool aligned;         // the mask 16-byte aligned
};

// q / d and q % d for 0 <= q < 2^52 and d >= 1: the double quotient is
// within one of the integer one
__device__ __forceinline__ int64_t div_mod(int64_t q, int64_t d, double inv,
                                           int64_t* rem) {
  int64_t t = static_cast<int64_t>(static_cast<double>(q) * inv);
  int64_t r = q - t * d;
  if (r < 0) {
    --t;
    r += d;
  } else if (r >= d) {
    ++t;
    r -= d;
  }
  *rem = r;
  return t;
}

// four bool bytes (0 or 1) to four bits, byte i in bit i
__device__ __forceinline__ uint32_t nibble(uint32_t q) {
  return (q * 0x01020408u) >> 24;
}

__device__ __forceinline__ uint32_t pack16(uint4 v) {
  return nibble(v.x) | nibble(v.y) << 4 | nibble(v.z) << 8 |
         nibble(v.w) << 12;
}

template <typename T>
__device__ __forceinline__ void fill(T* p, int64_t n, T v, int64_t i0,
                                     int64_t step) {
  for (int64_t i = i0; i < n; i += step) p[i] = v;
}

// the roots before pixel p (0 <= p <= total), modulo 2^32
__device__ __forceinline__ uint32_t roots_before(const Args& a, int64_t p) {
  const int64_t g = p >> 5;
  if (g >= a.nw) return a.s.tile_pre[a.tiles];
  const uint32_t below = (1u << (p & 31)) - 1u;
  return a.s.tile_pre[g / kTileWords] + a.s.pre[g] +
         __popc(a.s.root[g] & below);
}

__global__ void __launch_bounds__(kThreads) roots_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the tables' empty values, 16 bytes a store over their bodies
  {
    const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
    const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
    const int4 big = make_int4(kBig, kBig, kBig, kBig);
    const int4 neg = make_int4(-kBig, -kBig, -kBig, -kBig);
    fill(reinterpret_cast<int4*>(a.row_min), a.entries / 4, big, i0, step);
    fill(reinterpret_cast<int4*>(a.row_max), a.entries / 4, neg, i0, step);
    fill(reinterpret_cast<uint4*>(a.row_valid), a.entries / 16,
         make_uint4(0, 0, 0, 0), i0, step);
    fill(a.min_y, a.comps, kBig, i0, step);
    const int64_t t4 = a.entries / 4 * 4, t16 = a.entries / 16 * 16;
    fill(a.row_min + t4, a.entries - t4, kBig, i0, step);
    fill(a.row_max + t4, a.entries - t4, -kBig, i0, step);
    fill(a.row_valid + t16, a.entries - t16, uint8_t(0), i0, step);
  }
  const int64_t tile = blockIdx.x;
  if (tile >= a.tiles) return;  // a whole block: fill-only blocks
  const int64_t wbase = tile * kTileWords + warp * 32;
  const int64_t g = wbase + lane;
  uint32_t fg = 0;
  if (g < a.nw) {
    const int64_t p0 = g * 32;
    if (a.aligned && p0 + 32 <= a.total) {
      const uint4* src = reinterpret_cast<const uint4*>(a.mask + p0);
      fg = pack16(__ldcs(src)) | pack16(__ldcs(src + 1)) << 16;
    } else {
      for (int i = 0; i < 32 && p0 + i < a.total; ++i)
        fg |= static_cast<uint32_t>(a.mask[p0 + i] != 0) << i;
    }
  }
  // the warp's non-empty words, a lane a pixel: roots by their labels
  uint32_t root = 0;
  for (uint32_t todo = __ballot_sync(~0u, fg != 0); todo; todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const uint32_t bits = __shfl_sync(~0u, fg, j);
    bool is_root = false;
    if ((bits >> lane) & 1u) {
      const int64_t q = (wbase + j) * 32 + lane;
      int64_t local;
      div_mod(q, a.n, a.inv_n, &local);
      is_root = __ldg(a.labels + q) == local;
    }
    const uint32_t r = __ballot_sync(~0u, is_root);
    if (lane == j) root = r;
  }
  // the words' root counts within the tile
  __shared__ uint32_t warp_sum[kWarps];
  const uint32_t c = __popc(root);
  uint32_t inc = c;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  uint32_t before = 0, sum = 0;
  for (int i = 0; i < kWarps; ++i) {
    const uint32_t v = warp_sum[i];
    before += i < warp ? v : 0u;
    sum += v;
  }
  if (g < a.nw) {
    a.s.fg[g] = fg;
    a.s.root[g] = root;
    a.s.pre[g] = before + inc - c;
  }
  if (threadIdx.x == 0) a.s.tile[tile] = sum;
}

__global__ void __launch_bounds__(kScanThreads) scan_kernel(Args a) {
  __shared__ uint32_t warp_sum[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t per = (a.tiles + kScanThreads - 1) / kScanThreads;
  const int64_t lo = min(a.tiles, threadIdx.x * per);
  const int64_t hi = min(a.tiles, lo + per);
  uint32_t sum = 0;
  for (int64_t i = lo; i < hi; ++i) sum += a.s.tile[i];
  uint32_t inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_sum[warp] = inc;
  __syncthreads();
  uint32_t run = inc - sum, total = 0;
  for (int i = 0; i < kScanThreads / 32; ++i) {
    const uint32_t v = warp_sum[i];
    run += i < warp ? v : 0u;
    total += v;
  }
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t v = a.s.tile[i];
    a.s.tile_pre[i] = run;
    run += v;
  }
  if (threadIdx.x == 0) a.s.tile_pre[a.tiles] = total;
  __syncthreads();  // the block's prefixes, visible to the block
  for (int t = threadIdx.x; t <= a.t; t += kScanThreads) {
    const uint32_t f = roots_before(a, t * a.n);
    a.s.frame[t] = f;
    if (t < a.t)
      a.n_comp[t] = static_cast<int>(roots_before(a, (t + 1) * a.n) - f);
  }
}

__global__ void __launch_bounds__(kThreads) tables_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int64_t wbase =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) & ~31ll;
  if (wbase >= a.nw) return;  // a whole warp
  const int64_t g = wbase + lane;
  const uint32_t fg = g < a.nw ? a.s.fg[g] : 0u;
  for (uint32_t todo = __ballot_sync(~0u, fg != 0); todo; todo &= todo - 1) {
    const int j = __ffs(todo) - 1;
    const uint32_t bits = __shfl_sync(~0u, fg, j);
    bool on = false;
    int64_t slot = 0;
    int x = 0;
    if ((bits >> lane) & 1u) {
      const int64_t q = (wbase + j) * 32 + lane;
      int64_t local, rem;
      const int64_t t = div_mod(q, a.n, a.inv_n, &local);
      const int y = static_cast<int>(div_mod(local, a.w, a.inv_w, &rem));
      x = static_cast<int>(rem);
      // the plain version gathers at the label clamped into the frame
      const int lab = static_cast<int>(
          min(max(static_cast<int64_t>(__ldg(a.labels + q)), int64_t(0)),
              a.n - 1));
      const int64_t r = t * a.n + lab;
      const int64_t rg = r >> 5;
      const uint32_t rbit = 1u << (r & 31);
      const uint32_t rw = a.s.root[rg];
      const uint32_t pre = a.s.tile_pre[rg / kTileWords] + a.s.pre[rg] +
                           __popc(rw & (rbit - 1u));
      const int nt = a.n_comp[t];
      const int rank = (rw & rbit) ? static_cast<int>(pre - a.s.frame[t]) : 0;
      const int id = nt - 1 - rank;
      if (id >= 0 && id < a.max_det) {
        const int y_root = static_cast<int>(div_mod(lab, a.w, a.inv_w, &rem));
        const int rel = min(max(y - y_root, 0), a.max_bh - 1);
        const int64_t comp = t * a.max_det + id;
        slot = comp * a.max_bh + rel;
        on = true;
        if (lab == local) a.min_y[comp] = y;
      }
    }
    const uint32_t act = __ballot_sync(~0u, on);
    if (on) {
      const uint32_t run =
          __match_any_sync(act, static_cast<unsigned long long>(slot));
      const int lo = __reduce_min_sync(run, x);
      const int hi = __reduce_max_sync(run, x);
      if (lane == __ffs(run) - 1) {
        atomicMin(a.row_min + slot, lo);
        atomicMax(a.row_max + slot, hi);
        a.row_valid[slot] = 1;
      }
    }
  }
}

}  // namespace

extern "C" {

// labels (T, H, W) int32 and mask (T, H, W) bool, contiguous; row_min,
// row_max (T max_det, max_bh) int32, row_valid (T max_det, max_bh) bool,
// min_y (T max_det,) int32, n_comp (T,) int32, all contiguous and 16-byte
// aligned; scratch: 3 nw + 2 tiles + t + 2 uint32 (nw = ceil(T h w / 32),
// tiles = ceil(nw / 256)). All on CUDA device `device`, launched on
// `stream`. Returns a cudaError_t (0 = launched).
int ysmr_compact_row_tables(const void* labels, const void* mask,
                            void* row_min, void* row_max, void* row_valid,
                            void* min_y, void* n_comp, void* scratch, int t,
                            int h, int w, int max_det, int max_bh, int device,
                            void* stream) {
  if (t < 0 || h < 1 || w < 1 || max_det < 1 || max_bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (t == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a{};
  a.mask = static_cast<const uint8_t*>(mask);
  a.labels = static_cast<const int*>(labels);
  a.row_min = static_cast<int*>(row_min);
  a.row_max = static_cast<int*>(row_max);
  a.row_valid = static_cast<uint8_t*>(row_valid);
  a.min_y = static_cast<int*>(min_y);
  a.n_comp = static_cast<int*>(n_comp);
  a.n = static_cast<int64_t>(h) * w;
  a.total = a.n * t;
  a.nw = (a.total + 31) / 32;
  a.tiles = (a.nw + kTileWords - 1) / kTileWords;
  a.entries = static_cast<int64_t>(t) * max_det * max_bh;
  a.comps = static_cast<int64_t>(t) * max_det;
  a.inv_n = 1.0 / static_cast<double>(a.n);
  a.inv_w = 1.0 / static_cast<double>(w);
  a.t = t;
  a.w = w;
  a.max_det = max_det;
  a.max_bh = max_bh;
  a.aligned = (reinterpret_cast<uintptr_t>(mask) & 15) == 0;
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  a.s.fg = sc;
  a.s.root = sc + a.nw;
  a.s.pre = sc + 2 * a.nw;
  a.s.tile = sc + 3 * a.nw;
  a.s.tile_pre = a.s.tile + a.tiles;
  a.s.frame = a.s.tile_pre + a.tiles + 1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // at least a block a tile, and enough threads that the fill of the
  // tables takes a few stores each
  const int64_t fill_blocks = (a.entries / 4 + 4 * kThreads - 1) /
                              (4 * kThreads);
  const int64_t blocks =
      std::max<int64_t>(a.tiles, std::min<int64_t>(fill_blocks, 1 << 16));
  roots_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  scan_kernel<<<1, kScanThreads, 0, st>>>(a);
  const int64_t warps = (a.nw + 31) / 32;
  tables_kernel<<<static_cast<unsigned>((warps + kWarps - 1) / kWarps),
                  kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
