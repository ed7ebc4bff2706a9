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
// order), ids of max_det and above dropped. Every pixel of a horizontal
// run of foreground within a row has one label (the run is connected), so
// a run's table slot is one and its x extremes are its ends; a root, the
// first pixel of its component, starts its run. Every output is an
// integer minimum, maximum, count or flag, so the order of the atomics
// does not change a bit.
//
// Design (a memset of the tiles' status words and two launches, nothing
// read back):
// 1. roots: a block a tile of 1024 32-pixel words of the flattened batch
//    (words do not stop at frame edges), taken in order from a counter;
//    each thread takes four words of the mask as the labeling packed it
//    (frames mode's detect hands them over; else packed here from the
//    mask's bytes, 16-byte loads) and finds their run starts (a
//    foreground pixel whose left neighbour is background, or at x = 0);
//    the labels are read there only (where a lane has several, spread
//    over the warp's lanes), setting the root bits. The tile's root count
//    goes out by a decoupled look-back (each tile publishes its count,
//    then its inclusive prefix; the first warp reads 128 tiles back at a
//    time), so the tile knows the roots before it in the same launch; it
//    writes the root words (and the foreground words it packed), each
//    8-word group's root prefix and the root count before each frame that
//    starts in it. The same blocks fill the output tables with their
//    empty values (+-2^30, false).
// 2. tables: a warp on 128 words (loaded first); on each run start (where
//    a lane has several, the warp's runs spread over its lanes) a lane
//    walks to the run's end (the next background pixel or the row's end,
//    across words), reads the label once, ranks the root it names (the
//    group prefix, the group's words before it and its own word; a label
//    that names no root ranks 0, as the plain version's gather of a zero
//    gives) and, for an id below max_det, makes one atomicMin, one
//    atomicMax and one byte store for the run; the root's run writes the
//    component's min_y. The first block writes the frames' component
//    counts (uint32 differences, exact below 2^32 roots a frame).
// The (T, H, W) plane of ids is never written and the labels are read at
// run starts only.
//
// What bounds it on an H100: latency, not bytes. The bench batch (64 x
// 922 x 1228, 512 components, max_bh 64) reads 9 MB of packed mask,
// writes the 19 MB of tables and 10 MB of root words and prefixes; each
// launch's runs are chains of dependent loads (label, root word, prefix).
// The TPU had no kernel here; XLA fused the compaction and the segment
// reductions.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunks = 4;                           // words a thread
constexpr int kTileWords = kThreads * kChunks;       // words a tile
constexpr int kGroup = 8;                            // words a prefix
constexpr int kBig = 1 << 30;                        // ops/labeling.py's BIG_I
constexpr int kLook = 4;                             // tiles a lane looks back
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

struct Scratch {
  unsigned long long* status;  // (tiles,) flag << 32 | count, zeroed
  uint32_t* counter;           // the next tile, zeroed
  uint32_t* fg;                // (nw,) foreground words
  uint32_t* root;              // (nw,) root words
  uint32_t* gpre;              // (ceil(nw / 8),) roots before each group
  uint32_t* frame;             // (T + 1,) roots before a frame's first pixel
};

struct Args {
  const uint8_t* mask;  // (T, H, W) bool
  const uint32_t* bits; // (nw,) the mask packed by the labeling, or null
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

// the bits of word g whose pixel starts a row (x = 0)
__device__ __forceinline__ uint32_t row_starts(const Args& a, int64_t g) {
  int64_t x0;
  div_mod(g * 32, a.w, a.inv_w, &x0);
  uint32_t bits = 0;
  for (int64_t o = x0 ? a.w - x0 : 0; o < 32; o += a.w) bits |= 1u << o;
  return bits;
}

// foreground pixels whose left neighbour in the row is background
__device__ __forceinline__ uint32_t run_starts(uint32_t fg, uint32_t carry,
                                               uint32_t rows) {
  return fg & (~((fg << 1) | carry) | rows);
}

// word g of the mask: its two 16-byte halves (zero past the batch) where
// the mask is aligned and the word whole, else packed byte by byte
__device__ __forceinline__ bool mask_halves(const Args& a, int64_t g,
                                            uint4* lo, uint4* hi) {
  const int64_t p0 = g * 32;
  if (g < a.nw && a.aligned && p0 + 32 <= a.total) {
    const uint4* src = reinterpret_cast<const uint4*>(a.mask + p0);
    *lo = __ldcs(src);
    *hi = __ldcs(src + 1);
    return true;
  }
  *lo = *hi = make_uint4(0, 0, 0, 0);
  return false;
}

__device__ __forceinline__ uint32_t mask_word(const Args& a, int64_t g,
                                              bool loaded, uint4 lo,
                                              uint4 hi) {
  if (loaded) return pack16(lo) | pack16(hi) << 16;
  const int64_t p0 = g * 32;
  uint32_t fg = 0;
  for (int i = 0; g < a.nw && i < 32 && p0 + i < a.total; ++i)
    fg |= static_cast<uint32_t>(a.mask[p0 + i] != 0) << i;
  return fg;
}

// The warp's set bits of `bits` (a word a lane), 32 at a time, a lane a
// bit: for the k-th of `total` set bits in lane order, its lane and its
// bit in that lane's word (lanes past the total get -1). `excl` is the
// count of the set bits of the lanes below; every lane calls it.
__device__ __forceinline__ int nth_bit(uint32_t bits, uint32_t excl, int k,
                                       int* bit) {
  const uint32_t incl = excl + __popc(bits);
  const uint32_t total = __shfl_sync(~0u, incl, 31);
  int owner = 0;  // the lanes whose bits all come before the k-th
  for (int b = 16; b; b >>= 1) {
    const uint32_t v = __shfl_sync(~0u, incl, owner + b - 1);
    if (v <= static_cast<uint32_t>(k)) owner += b;
  }
  const uint32_t m = __shfl_sync(~0u, bits, owner);
  const uint32_t before = __shfl_sync(~0u, excl, owner);
  if (static_cast<uint32_t>(k) >= total) return -1;
  uint32_t rest = m;
  for (uint32_t n = k - before; n; --n) rest &= rest - 1;
  *bit = __ffs(rest) - 1;
  return owner;
}

// the warp's exclusive prefix of v (lane order) and its total
__device__ __forceinline__ uint32_t warp_excl(uint32_t v, uint32_t* total) {
  const int lane = threadIdx.x & 31;
  uint32_t inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += u;
  }
  *total = __shfl_sync(~0u, inc, 31);
  return inc - v;
}

// the sum of v over the warp
__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

// pixel q (a run start) is its component's root: its label is its own
// in-frame index
__device__ __forceinline__ bool is_root(const Args& a, int64_t q) {
  int64_t local;
  div_mod(q, a.n, a.inv_n, &local);
  return __ldg(a.labels + q) == local;
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
  if (blockIdx.x >= a.tiles) return;  // a whole block: fill-only blocks
  __shared__ int64_t s_tile;
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_root[kWarps][32];
  __shared__ uint32_t s_before;
  if (threadIdx.x == 0) s_tile = atomicAdd(a.s.counter, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t wbase = tile * kTileWords + warp * (32 * kChunks);
  uint32_t fg[kChunks], root[kChunks], inc[kChunks];
  if (a.bits) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int64_t g = wbase + c * 32 + lane;
      fg[c] = g < a.nw ? __ldg(a.bits + g) : 0u;
    }
  } else {
    // four chunks' loads in flight before they are used
#pragma unroll
    for (int c0 = 0; c0 < kChunks; c0 += 4) {
      uint4 lo[4], hi[4];
      bool loaded[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        loaded[c] = mask_halves(a, wbase + (c0 + c) * 32 + lane, lo + c,
                                hi + c);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        fg[c0 + c] = mask_word(a, wbase + (c0 + c) * 32 + lane, loaded[c],
                               lo[c], hi[c]);
    }
  }
  uint32_t prev = 0;  // lane 31's word of the previous chunk
  uint32_t sum = 0;   // the warp's roots before the chunk
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t g = wbase + c * 32 + lane;
    uint32_t left = __shfl_up_sync(~0u, fg[c], 1);
    if (lane == 0) {
      if (c > 0)
        left = prev;
      else if (g > 0 && g < a.nw)
        left = a.bits ? __ldg(a.bits + g - 1)
                      : static_cast<uint32_t>(a.mask[g * 32 - 1] != 0) << 31;
      else
        left = 0;
    }
    prev = __shfl_sync(~0u, fg[c], 31);
    uint32_t starts = 0;
    if (fg[c]) starts = run_starts(fg[c], left >> 31, row_starts(a, g));
    // the labels at the run starts: a lane its own where none has two,
    // else the warp's run starts a lane each (32 label loads at a time), a
    // root's bit to its word's lane
    uint32_t r = 0;
    if (__reduce_max_sync(~0u, __popc(starts)) <= 1) {
      if (starts && is_root(a, g * 32 + __ffs(starts) - 1)) r = starts;
    } else {
      uint32_t total;
      const uint32_t excl = warp_excl(__popc(starts), &total);
      s_root[warp][lane] = 0;
      __syncwarp();
      for (uint32_t k0 = 0; k0 < total; k0 += 32) {
        int i;
        const int owner = nth_bit(starts, excl, k0 + lane, &i);
        if (owner >= 0 && is_root(a, (wbase + c * 32 + owner) * 32 + i))
          atomicOr(&s_root[warp][owner], 1u << i);
      }
      __syncwarp();
      r = s_root[warp][lane];
    }
    root[c] = r;
    // the warp's inclusive root count through this word
    uint32_t v = __popc(r);
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(~0u, v, o);
      if (lane >= o) v += u;
    }
    inc[c] = sum + v;
    sum += __shfl_sync(~0u, v, 31);
  }
  if (lane == 31) s_warp[warp] = sum;
  __syncthreads();
  uint32_t warp_before = 0, agg = 0;
  for (int k = 0; k < kWarps; ++k) {
    warp_before += k < warp ? s_warp[k] : 0u;
    agg += s_warp[k];
  }
  // the roots before the tile: decoupled look-back over the tiles before,
  // the first warp's lanes on 32 kLook of them at a time (before tile 0, a
  // prefix of 0)
  if (warp == 0) {
    volatile unsigned long long* st = a.s.status;
    uint32_t before = 0;
    if (lane == 0)
      atomicExch(a.s.status + tile, (tile ? kAggregate : kPrefix) | agg);
    for (int64_t top = tile - 1; tile;) {
      // lane l reads the tiles kLook l to kLook l + kLook - 1 before `top`
      // (nearest first); the sum runs to the nearest prefix
      unsigned long long v[kLook];
      int first = kLook;  // this lane's nearest prefix
#pragma unroll
      for (int j = 0; j < kLook; ++j) {
        const int64_t k = top - kLook * lane - j;
        v[j] = kPrefix;
        if (k >= 0) do {
            v[j] = st[k];
          } while (!(v[j] >> 32));
        if (first == kLook && (v[j] >> 32) == 2) first = j;
      }
      const uint32_t found = __ballot_sync(~0u, first < kLook);
      const int stop = found ? __ffs(found) - 1 : 31;
      uint32_t part = 0;
#pragma unroll
      for (int j = 0; j < kLook; ++j)
        if (lane < stop || (lane == stop && j <= first))
          part += static_cast<uint32_t>(v[j]);
      before += warp_sum(part);
      if (found) break;
      top -= 32 * kLook;
    }
    if (lane == 0) {
      if (tile) {
        __threadfence();
        atomicExch(a.s.status + tile, kPrefix | (before + agg));
      }
      s_before = before;
    }
  }
  __syncthreads();
  const uint32_t base = s_before + warp_before;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t g = wbase + c * 32 + lane;
    if (g >= a.nw) break;
    const uint32_t excl = base + inc[c] - __popc(root[c]);
    if (!a.bits) a.s.fg[g] = fg[c];
    a.s.root[g] = root[c];
    if ((g & (kGroup - 1)) == 0) a.s.gpre[g / kGroup] = excl;
    // frames whose first pixel lies in this word (and the end of the
    // batch, when it does)
    int64_t rem;
    int64_t f = div_mod(g * 32, a.n, a.inv_n, &rem) + (rem != 0);
    for (; f <= a.t && f * a.n < g * 32 + 32; ++f)
      a.s.frame[f] = excl + __popc(root[c] & ((1u << (f * a.n - g * 32)) -
                                               1u));
  }
  if (threadIdx.x == 0 && tile == a.tiles - 1 && a.total == a.nw * 32)
    a.s.frame[a.t] = s_before + agg;
}

// the roots before pixel r of the batch (modulo 2^32)
__device__ __forceinline__ uint32_t roots_before(const Args& a, int64_t r) {
  const int64_t g = r >> 5;
  uint32_t n = a.s.gpre[g / kGroup];
  for (int64_t k = g & ~static_cast<int64_t>(kGroup - 1); k < g; ++k)
    n += __popc(a.s.root[k]);
  return n + __popc(a.s.root[g] & ((1u << (r & 31)) - 1u));
}

// the table update of the run that starts at bit i of word g (whose
// foreground word is fg)
__device__ __forceinline__ void table_run(const Args& a, int64_t g, int i,
                                          uint32_t fg) {
  const int64_t q0 = g * 32 + i;
  int64_t local, x0;
  const int64_t t = div_mod(q0, a.n, a.inv_n, &local);
  const int y = static_cast<int>(div_mod(local, a.w, a.inv_w, &x0));
  // the run's last pixel: before the next background pixel, at most the
  // row's last
  const int64_t row_end = q0 + (a.w - 1 - x0);
  int64_t wd = g;
  uint32_t gap = i == 31 ? 0u : ~fg & ~((2u << i) - 1u);
  while (!gap && (wd + 1) * 32 <= row_end) {
    ++wd;
    gap = wd < a.nw ? ~a.s.fg[wd] : ~0u;
  }
  const int64_t stop = wd * 32 + __ffs(gap) - 2;
  const int64_t q1 = gap && stop < row_end ? stop : row_end;
  // the plain version gathers at the label clamped into the frame
  const int lab = static_cast<int>(
      min(max(static_cast<int64_t>(__ldg(a.labels + q0)), int64_t(0)),
          a.n - 1));
  const int64_t r = t * a.n + lab;
  const uint32_t rbit = 1u << (r & 31);
  const uint32_t f0 = a.s.frame[t];
  const int nt = static_cast<int>(a.s.frame[t + 1] - f0);
  const int rank = (a.s.root[r >> 5] & rbit)
                       ? static_cast<int>(roots_before(a, r) - f0)
                       : 0;
  const int id = nt - 1 - rank;
  if (id < 0 || id >= a.max_det) return;
  int64_t rem;
  const int y_root = static_cast<int>(div_mod(lab, a.w, a.inv_w, &rem));
  const int rel = min(max(y - y_root, 0), a.max_bh - 1);
  const int64_t comp = t * a.max_det + id;
  const int64_t slot = comp * a.max_bh + rel;
  atomicMin(a.row_min + slot, static_cast<int>(x0));
  atomicMax(a.row_max + slot, static_cast<int>(x0 + (q1 - q0)));
  a.row_valid[slot] = 1;
  if (lab == local) a.min_y[comp] = y;
}

__global__ void __launch_bounds__(kThreads) tables_kernel(Args a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (blockIdx.x == 0)
    for (int f = threadIdx.x; f < a.t; f += kThreads)
      a.n_comp[f] = static_cast<int>(a.s.frame[f + 1] - a.s.frame[f]);
  // a warp on 32 kChunks words, a lane on one word of each chunk
  const int64_t wbase =
      (static_cast<int64_t>(blockIdx.x) * kWarps + warp) * (32 * kChunks);
  uint32_t fg[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int64_t g = wbase + c * 32 + lane;
    fg[c] = g < a.nw ? a.s.fg[g] : 0u;
  }
  const uint32_t first =
      lane == 0 && wbase > 0 && wbase <= a.nw ? a.s.fg[wbase - 1] : 0u;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint32_t left = __shfl_up_sync(~0u, fg[c], 1);
    const uint32_t prev = __shfl_sync(~0u, c ? fg[c - 1] : first, 31);
    if (lane == 0) left = c ? prev : first;
    const int64_t g = wbase + c * 32 + lane;
    const uint32_t starts =
        fg[c] ? run_starts(fg[c], left >> 31, row_starts(a, g)) : 0u;
    // a lane its own run where none has two, else the warp's runs a lane
    // each
    if (__reduce_max_sync(~0u, __popc(starts)) <= 1) {
      if (starts) table_run(a, g, __ffs(starts) - 1, fg[c]);
      continue;
    }
    uint32_t total;
    const uint32_t excl = warp_excl(__popc(starts), &total);
    for (uint32_t k0 = 0; k0 < total; k0 += 32) {
      int i;
      const int owner = nth_bit(starts, excl, k0 + lane, &i);
      const uint32_t word = __shfl_sync(~0u, fg[c], owner & 31);
      if (owner >= 0) table_run(a, wbase + c * 32 + owner, i, word);
    }
  }
}

}  // namespace

extern "C" {

// the scratch of ysmr_compact_row_tables, in uint32 words
int64_t ysmr_compact_scratch_words(int t, int h, int w) {
  const int64_t nw = (static_cast<int64_t>(t) * h * w + 31) / 32;
  const int64_t tiles = (nw + kTileWords - 1) / kTileWords;
  return 2 * tiles + 2 + 2 * nw + (nw + kGroup - 1) / kGroup + t + 1;
}

// labels (T, H, W) int32 and mask (T, H, W) bool, contiguous; row_min,
// row_max (T max_det, max_bh) int32, row_valid (T max_det, max_bh) bool,
// min_y (T max_det,) int32, n_comp (T,) int32, all contiguous and 16-byte
// aligned; bits: the mask packed 32 pixels a word (as csrc/cc.cu's
// labeling packs it), read in place of the mask, or null; scratch: 8-byte
// aligned, ysmr_compact_scratch_words(t, h, w) uint32. All on CUDA device
// `device`, launched on `stream`. Returns a cudaError_t (0 = launched).
int ysmr_compact_row_tables(const void* labels, const void* mask,
                            void* row_min, void* row_max, void* row_valid,
                            void* min_y, void* n_comp, const void* bits,
                            void* scratch, int t,
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
  a.s.status = static_cast<unsigned long long*>(scratch);
  uint32_t* sc = reinterpret_cast<uint32_t*>(a.s.status + a.tiles);
  a.s.counter = sc;
  a.bits = static_cast<const uint32_t*>(bits);
  a.s.fg = sc + 2;
  a.s.root = a.s.fg + a.nw;
  a.s.gpre = a.s.root + a.nw;
  a.s.frame = a.s.gpre + (a.nw + kGroup - 1) / kGroup;
  // the tables launch reads the foreground words the labeling packed
  uint32_t* const own_fg = a.s.fg;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0, (2 * a.tiles + 2) * sizeof(uint32_t),
                        st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // at least a block a tile, and enough threads that the fill of the
  // tables takes a few stores each
  const int64_t fill_blocks = (a.entries / 4 + 4 * kThreads - 1) /
                              (4 * kThreads);
  const int64_t blocks =
      std::max<int64_t>(a.tiles, std::min<int64_t>(fill_blocks, 1 << 16));
  roots_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(a);
  a.s.fg = a.bits ? const_cast<uint32_t*>(a.bits) : own_fg;
  tables_kernel<<<static_cast<unsigned>(a.tiles), kThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
