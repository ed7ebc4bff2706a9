// Run-graph connected components around csrc/run_prop.cu: the run wire's
// decode, windows and links, the compaction of the runs the marker
// reconstruction keeps, and the component ids, their scatter back to wire
// order and, for the device rects, each component's per-row x extremes.
//
// Replaces the plain-XLA part of ysmr_tpu/ops/run_cc.py:291
// run_cc_components outside propagate_min (and the same steps of
// keep_marked_runs and label_runs), the row tables of
// ysmr_tpu/ops/labeling.py:520 component_stats_runs (its three scatters
// and the sort that feeds them), and on the host-rect path
// ysmr_tpu/pipeline/detect_pixels.py:101-121 (rc_eff and det_run_idx).
// Same contract and bits as the plain versions in
// ysmr_tpu_torch/ops/run_cc.py:
// 1. prepare, two launches (prepare_runs_plain: decode_runs,
//    run_windows_multi, chain_mask and the initial labels): the planes
//    run_prop.cu reads, for each dilation asked for.
// 2. compact, two launches (compact_kept_runs_plain): between the two
//    propagations of the double threshold, the stable compaction of the
//    kept runs, the 8-connected windows remapped onto the compacted table
//    and its links.
// 3. finish, two launches (finish_components_plain): after the 8-connected
//    propagation, the roots and their ascending rank, the per-run ids and
//    their scatter to wire order, the kept pixels, the larger step count
//    and, when asked, the row tables (ops/labeling.py::run_row_tables of
//    the component-sorted runs, ids reversed to cv2's order) or the
//    host-rect batch's readback plane (ysmr_tpu's det_run_idx of the
//    wire's first runs, the clamped count and the steps, int16).
// The keys launch also takes frame_valid and writes the counts with the
// invalid frames' set to 0 (ysmr_tpu's rc_eff), which every launch after
// it reads.
//
// Facts it uses. A window endpoint is torch.searchsorted over the frame's
// key row. Where the row does not decrease (the wire in raster order)
// each search has one answer, and it lies between the answers to the
// least and the greatest query of a block of runs; otherwise the launch
// runs torch's own probes over [0, R), so the same index on any input. The
// compaction and the ranks are prefix counts over one bit a run. The row
// tables are integer minima and maxima, so the order of the atomics does
// not change a bit and the runs need no sort. A run's table row is its row
// less its component's least row (y0; the plain version's first run in
// (component, start) order, start = row w + x). A run's id is the rank
// of the root at or before its label, so where no label exceeds its slot
// (the propagation's labels only fall from the index) a component's root
// is its least slot, and where the rows of the valid runs do not decrease
// in slot order the root's row is y0.
//
// Design. Prepare: a keys launch (each slot's two keys, and a flag for
// each 256 slots where a key exceeds the next), then a thread a run,
// blocks of 256 covering 255 runs of one frame (the last thread's run is
// its neighbour's for the link); the second dilation's answers a step
// from the first's. Compact and finish: tiles of 1024 slots, a block of
// 256 threads a tile, four slots a thread, their loads first, in two
// launches each: the bits launch writes a tile's 32 words (each word's bit
// mask and the tile's count before it) and the tile's count; the second
// launch reads the frame's tile counts (at most 512: R <= 2^19) into
// shared memory, scans them, and answers any slot's count before it with
// one 8-byte load. Compact's bits are the kept runs; its second launch
// places every wire run, remaps its window and links each kept run to the
// next (shared memory within the tile, else the next word or a search of
// the counts). Finish's bits launch (roots) marks the roots, writes each
// root's row and flags a frame whose valid rows decrease (or follow an
// invalid slot) or whose labels exceed their slots. The ids launch ranks
// each slot's label and scatters it; with the tables its blocks take
// their tiles in order from a counter, and a tile's block fills the
// tables of its roots' ids (a range: the roots' ranks are consecutive)
// and a share of the ids past the frame's components with their empty
// values (+-2^30, false), so those lines are in L2 when the updates come,
// then sets its tile's flag. A run updates its component's entry at its
// row less the root's row (a warp's runs of one entry merged first: one
// atomicMin, one atomicMax and one byte store a stretch of lanes), after
// the flags of its frame's tiles up to its own (its root's tile among
// them), and the root writes min_y. In a flagged frame (outside the
// encoder's or the propagation's contract) the frame's last tile's block
// makes its updates alone, after every tile's flag: the components' least
// rows by atomicMin into min_y, then the updates against them.
//
// What bounds it on an H100: latency, and at the dense batch the tables'
// bytes (113 MB at T = 64, 4096 ids of 48 rows). Each slot is a chain of
// dependent loads (label, word, root row); the tiles put 2048 blocks of 8
// warps on the card at T = 64, R = 32768.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int32_t kBig = 1 << 28;  // ops/run_cc.py's _BIG
constexpr int kPrepThreads = 256;

struct Wire {
  const int32_t* runs;    // (T, R) int32 view of the uint32 wire
  const int32_t* counts;  // (T,) valid runs of a frame (a prefix)
  int r, w;
  uint64_t magic;         // ceil(2^64 / w) for w >= 2; 0 for w = 1
};

struct Run {
  int32_t row, xs, xe, lens;
  bool valid, mark;
};

// decode_runs of one slot: start bits 0..25, marker bit 26, length bits
// 27..31 (arithmetic shifts of the int32 view, masked)
__device__ __forceinline__ Run decode(int32_t word, int i, int count,
                                      const Wire& g) {
  Run q;
  const int32_t start = word & 0x03FFFFFF;
  q.lens = (word >> 27) & 0x1F;
  q.valid = i < count && q.lens > 0;
  q.mark = q.valid && ((word >> 26) & 1);
  // floor(start / w): start < 2^26, so the high word of start * magic is
  // the quotient (the rounding error of magic times start stays below
  // 2^64)
  q.row = g.magic ? static_cast<int32_t>(__umul64hi(
                        static_cast<uint64_t>(start), g.magic))
                  : start;
  q.xs = start - q.row * g.w;
  q.xe = q.xs + q.lens - 1;
  return q;
}

// key_e (end) or key_s (start) of a decoded run
__device__ __forceinline__ int32_t run_key(const Run& b, int m, bool end) {
  return b.valid ? b.row * m + (end ? b.xe : b.xs) : kBig;
}

// the first index in [lo, hi) whose key is at least q (lower) or above q
// (upper), else hi: torch.searchsorted's loop over keys[lo, hi)
__device__ __forceinline__ int bound_in(const int32_t* keys, int lo, int hi,
                                        int32_t q, bool upper) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const int32_t key = __ldg(keys + mid);
    if (upper ? !(key > q) : !(key >= q))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// In keys[lo, hi) that do not decrease: the lower bound of q given i, that
// of a query above q (so q's lies in [lo, i]): down while the key below is
// at least q, at most kSteps steps, then a search of what is left
constexpr int kSteps = 4;

__device__ __forceinline__ int lower_below(const int32_t* keys, int lo, int i,
                                           int32_t q) {
  for (int n = 0; n < kSteps; ++n) {
    if (i <= lo || __ldg(keys + i - 1) < q) return i;
    --i;
  }
  return bound_in(keys, lo, i, q, false);
}

// ... and the upper bound of q given i, that of a query below q (so q's
// lies in [i, hi]): up while the key at i is at most q
__device__ __forceinline__ int upper_above(const int32_t* keys, int i, int hi,
                                           int32_t q) {
  for (int n = 0; n < kSteps; ++n) {
    if (i >= hi || __ldg(keys + i) > q) return i;
    ++i;
  }
  return bound_in(keys, i, hi, q, true);
}

// keys launch: each slot's key_e and key_s (run_windows_multi's sort keys)
// and, a byte a block, whether a slot's keys exceed the next slot's
struct KeyArgs {
  Wire g;
  int32_t* key_e;     // (T, R)
  int32_t* key_s;     // (T, R)
  uint8_t* unsorted;  // (T, blocks a frame)
  const uint8_t* fv;  // (T,) frame_valid, or null: every frame
  int32_t* counts;    // (T,) out with fv: the counts of the valid frames,
                      // 0 elsewhere (the launches after this one read it)
};

__global__ void __launch_bounds__(kPrepThreads) keys_kernel(KeyArgs a) {
  const Wire& g = a.g;
  const int f = blockIdx.y;
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  const int r = g.r, m = g.w + 2;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int32_t* wrow = g.runs + row0;
  const int count = a.fv && !a.fv[f] ? 0 : g.counts[f];
  if (a.fv && blockIdx.x == 0 && threadIdx.x == 0) a.counts[f] = count;
  bool down = false;
  if (i < r) {
    const Run me = decode(__ldg(wrow + i), i, count, g);
    const int32_t ke = run_key(me, m, true), ks = run_key(me, m, false);
    a.key_e[row0 + i] = ke;
    a.key_s[row0 + i] = ks;
    if (i + 1 < r) {
      const Run nx = decode(__ldg(wrow + i + 1), i + 1, count, g);
      down = ke > run_key(nx, m, true) || ks > run_key(nx, m, false);
    }
  }
  down = __syncthreads_or(down);
  if (threadIdx.x == 0)
    a.unsorted[static_cast<int64_t>(f) * gridDim.x + blockIdx.x] = down;
}

struct PrepArgs {
  Wire g;
  const int32_t* key_e;     // (T, R) from the keys launch
  const int32_t* key_s;
  const uint8_t* unsorted;  // (T, key_blocks)
  int key_blocks;
  int d[2];        // the dilations
  bool weak;       // init = marked ? i : i + R (else i)
  int32_t* ends;   // (ND, 4, T, R): lo_up, hi_up, lo_dn, hi_dn
  uint8_t* oks;    // (ND, 2, T, R): ok_up, ok_dn
  uint8_t* link;   // (T, R): the chain of the first dilation's windows
  int32_t* init;   // (T, R)
  uint8_t* valid;  // (T, R)
  int t;
};

// the min and max of v over the block (every thread calls it)
__device__ __forceinline__ void block_min_max(int32_t v_min, int32_t v_max,
                                              int32_t* s_min, int32_t* s_max,
                                              int32_t* out_min,
                                              int32_t* out_max) {
  for (int o = 16; o; o >>= 1) {
    v_min = min(v_min, __shfl_xor_sync(~0u, v_min, o));
    v_max = max(v_max, __shfl_xor_sync(~0u, v_max, o));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    s_min[warp] = v_min;
    s_max[warp] = v_max;
  }
  __syncthreads();
  v_min = s_min[0];
  v_max = s_max[0];
  for (int k = 1; k < static_cast<int>(blockDim.x >> 5); ++k) {
    v_min = min(v_min, s_min[k]);
    v_max = max(v_max, s_max[k]);
  }
  *out_min = v_min;
  *out_max = v_max;
  __syncthreads();
}

template <int ND>
__global__ void __launch_bounds__(kPrepThreads) prepare_kernel(PrepArgs a) {
  constexpr int kWarpsP = kPrepThreads / 32;
  __shared__ int32_t s_row[kPrepThreads], s_xs[kPrepThreads];
  __shared__ int32_t s_lo_up[kPrepThreads], s_lo_dn[kPrepThreads];
  __shared__ uint8_t s_valid[kPrepThreads], s_ok_up[kPrepThreads],
      s_ok_dn[kPrepThreads];
  __shared__ int32_t s_min[kWarpsP], s_max[kWarpsP];
  __shared__ int s_range[4];
  const Wire& g = a.g;
  const int f = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.x * (kPrepThreads - 1) + tid;
  const int r = g.r, m = g.w + 2;
  const bool in = i < r;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int64_t plane = static_cast<int64_t>(a.t) * r;
  const int32_t* wrow = g.runs + row0;
  const int32_t* key_e = a.key_e + row0;
  const int32_t* key_s = a.key_s + row0;
  const int count = g.counts[f];
  const Run me = decode(in ? __ldg(wrow + i) : 0, i, count, g);
  const int32_t base = me.row * m;
  int32_t q[4 * ND], res[4 * ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const int d = a.d[k];
    q[2 * k] = (base - m) + (me.xs - d);
    q[2 * k + 1] = (base + m) + (me.xs - d);
    q[2 * ND + 2 * k] = (base - m) + (me.xe + d);
    q[2 * ND + 2 * k + 1] = (base + m) + (me.xe + d);
  }
  // a frame whose key rows do not decrease has one answer to each search,
  // and it lies between the answers to the block's least and greatest
  // queries (the bounds grow with the query): the block searches the
  // frame for those four, each run within them. Otherwise each run
  // searches [0, R) with torch.searchsorted's probes.
  bool unsorted = false;
  for (int k = tid; k < a.key_blocks; k += kPrepThreads)
    unsorted |= a.unsorted[static_cast<int64_t>(f) * a.key_blocks + k];
  unsorted = __syncthreads_or(unsorted);
  int lo_l = 0, lo_h = r, hi_l = 0, hi_h = r;
  if (!unsorted) {
    int32_t qmin_lo = INT32_MAX, qmax_lo = INT32_MIN;
    int32_t qmin_hi = INT32_MAX, qmax_hi = INT32_MIN;
    if (in) {
#pragma unroll
      for (int k = 0; k < 2 * ND; ++k) {
        qmin_lo = min(qmin_lo, q[k]);
        qmax_lo = max(qmax_lo, q[k]);
        qmin_hi = min(qmin_hi, q[2 * ND + k]);
        qmax_hi = max(qmax_hi, q[2 * ND + k]);
      }
    }
    int32_t lo_min, lo_max, hi_min, hi_max;
    block_min_max(qmin_lo, qmax_lo, s_min, s_max, &lo_min, &lo_max);
    block_min_max(qmin_hi, qmax_hi, s_min, s_max, &hi_min, &hi_max);
    if (tid < 4) {
      const bool upper = tid >= 2;
      const int32_t qq = tid == 0 ? lo_min : tid == 1 ? lo_max
                       : tid == 2 ? hi_min : hi_max;
      s_range[tid] = bound_in(upper ? key_s : key_e, 0, r, qq, upper);
    }
    __syncthreads();
    lo_l = s_range[0];
    lo_h = s_range[1];
    hi_l = s_range[2];
    hi_h = s_range[3];
  }
  if (in) {
    // in order with dilations d and d + 1, the second's queries are one
    // below (lower bounds) and one above (upper bounds) the first's, and
    // so are their answers: a step or two from the first's
    const bool step = !unsorted && ND == 2 && a.d[1] == a.d[0] + 1;
#pragma unroll
    for (int k = 0; k < 2 * ND; ++k) {
      if (step && k >= 2) {
        res[k] = lower_below(key_e, lo_l, res[k - 2], q[k]);
        res[2 * ND + k] = upper_above(key_s, res[2 * ND + k - 2], hi_h,
                                      q[2 * ND + k]);
      } else {
        res[k] = bound_in(key_e, lo_l, lo_h, q[k], false);
        res[2 * ND + k] = bound_in(key_s, hi_l, hi_h, q[2 * ND + k], true);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4 * ND; ++k) res[k] = 0;
  }
  const bool own = in && tid < kPrepThreads - 1;
  int32_t hi_up0 = 0, hi_dn0 = 0;
  bool ok_up0 = false, ok_dn0 = false;
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    const int32_t lo_up = res[2 * k], lo_dn = res[2 * k + 1];
    const int32_t hi_up = res[2 * ND + 2 * k] - 1;
    const int32_t hi_dn = res[2 * ND + 2 * k + 1] - 1;
    const bool ok_up = me.valid && lo_up <= hi_up;
    const bool ok_dn = me.valid && lo_dn <= hi_dn;
    if (k == 0) {
      s_lo_up[tid] = lo_up;
      s_lo_dn[tid] = lo_dn;
      s_ok_up[tid] = ok_up;
      s_ok_dn[tid] = ok_dn;
      hi_up0 = hi_up;
      hi_dn0 = hi_dn;
      ok_up0 = ok_up;
      ok_dn0 = ok_dn;
    }
    if (own) {
      int32_t* e = a.ends + 4 * k * plane + row0 + i;
      e[0] = lo_up;
      e[plane] = hi_up;
      e[2 * plane] = lo_dn;
      e[3 * plane] = hi_dn;
      uint8_t* o = a.oks + 2 * k * plane + row0 + i;
      o[0] = ok_up;
      o[plane] = ok_dn;
    }
  }
  s_row[tid] = me.row;
  s_xs[tid] = me.xs;
  s_valid[tid] = me.valid;
  __syncthreads();
  if (!own) return;
  // chain_mask: the next run of the same row, touching or sharing a
  // window edge (the next run is the next thread's)
  const int nb = tid + 1;
  const bool same_row = me.valid && i + 1 < r && s_valid[nb] &&
                        s_row[nb] == me.row;
  const bool consec = same_row && s_xs[nb] == me.xe + 1;
  const bool cut_up = same_row && ok_up0 && s_ok_up[nb] &&
                      hi_up0 >= s_lo_up[nb];
  const bool cut_dn = same_row && ok_dn0 && s_ok_dn[nb] &&
                      hi_dn0 >= s_lo_dn[nb];
  a.link[row0 + i] = consec || cut_up || cut_dn;
  a.init[row0 + i] = a.weak && !me.mark ? i + r : i;
  a.valid[row0 + i] = me.valid;
}

// ---- compact and finish: tiles of kTile slots, two launches each ----

constexpr int kTile = 1024;                // slots a tile
constexpr int kTileWords = kTile / 32;     // 32-slot words a tile
constexpr int kThreads = 256;              // a tile's block
constexpr int kWarps = kThreads / 32;
constexpr int kPer = kTile / kThreads;     // slots a thread
constexpr int kMaxTiles = 512;             // tiles a frame: R <= 2^19
constexpr int kPerTiles = kMaxTiles / kThreads;
constexpr int32_t kBigI = 1 << 30;         // ops/labeling.py's BIG_I
constexpr uint32_t kFlag = 1u << 31;       // in a tile count: out of order

// a bit a slot: per frame nw words (a word's bits, and the tile's set bits
// before it) and ntiles tile counts (| kFlag where the bits launch flagged
// the frame)
struct Words {
  uint2* wl;       // (T, nw)
  uint32_t* tcnt;  // (T, ntiles)
  int nw, ntiles;
};

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

// slot u of this thread in tile `tile`
__device__ __forceinline__ int tile_slot(int tile, int u) {
  return tile * kTile + u * kThreads + static_cast<int>(threadIdx.x);
}

// The bits launches' end: each thread's kPer flags (its slots) as the
// tile's words and count, kFlag where any thread's `flag` is set. Every
// thread calls it.
__device__ void write_tile(const bool (&b)[kPer], bool flag, const Words& s,
                           int f, int tile) {
  __shared__ uint32_t s_w[kTileWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const uint32_t m = __ballot_sync(~0u, b[u]);
    if (lane == 0) s_w[u * kWarps + warp] = m;
  }
  flag = __syncthreads_or(flag);
  if (warp == 0) {
    const uint32_t m = s_w[lane];
    uint32_t total;
    const uint32_t excl = warp_excl(__popc(m), &total);
    const int wd = tile * kTileWords + lane;
    if (wd < s.nw) s.wl[static_cast<int64_t>(f) * s.nw + wd] = make_uint2(m, excl);
    if (lane == 0)
      s.tcnt[static_cast<int64_t>(f) * s.ntiles + tile] =
          total | (flag ? kFlag : 0u);
  }
}

// The second launches' start: the frame's set bits before each tile into
// tpre (shared), their total and whether the frame was flagged. Every
// thread calls it.
__device__ void frame_prefix(const Words& s, int f, uint32_t* tpre,
                             int* total, bool* flagged) {
  __shared__ uint32_t s_warp[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t* tc = s.tcnt + static_cast<int64_t>(f) * s.ntiles;
  uint32_t v[kPerTiles], sum = 0;
  bool flag = false;
#pragma unroll
  for (int k = 0; k < kPerTiles; ++k) {
    const int i = threadIdx.x * kPerTiles + k;
    v[k] = i < s.ntiles ? tc[i] : 0u;
    flag |= (v[k] & kFlag) != 0;
    v[k] &= ~kFlag;
    sum += v[k];
  }
  uint32_t wtot;
  uint32_t run = warp_excl(sum, &wtot);
  if (lane == 0) s_warp[warp] = wtot;
  *flagged = __syncthreads_or(flag);
  uint32_t all = 0;
  for (int k = 0; k < kWarps; ++k) {
    run += k < warp ? s_warp[k] : 0u;
    all += s_warp[k];
  }
#pragma unroll
  for (int k = 0; k < kPerTiles; ++k) {
    tpre[threadIdx.x * kPerTiles + k] = run;
    run += v[k];
  }
  *total = static_cast<int>(all);
  __syncthreads();
}

// set bits before slot j, and through it (wl: the frame's words)
__device__ __forceinline__ int bits_before(const uint2* wl,
                                           const uint32_t* tpre, int j) {
  const uint2 w = wl[j >> 5];
  return static_cast<int>(tpre[j / kTile] + w.y +
                          __popc(w.x & ((1u << (j & 31)) - 1u)));
}

__device__ __forceinline__ int bits_through(const uint2* wl,
                                            const uint32_t* tpre, int j) {
  const uint2 w = wl[j >> 5];
  return static_cast<int>(tpre[j / kTile] + w.y +
                          __popc(w.x & ((2u << (j & 31)) - 1u)));
}

// the slot of the frame's k-th set bit (0 <= k < its count): the last tile
// and then the last word whose count before it is at most k
__device__ int select_bit(const Words& s, const uint2* wl,
                          const uint32_t* tpre, int k) {
  int lo = 0, hi = s.ntiles - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (static_cast<int>(tpre[mid]) <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  const int rest = k - static_cast<int>(tpre[lo]);
  int a = lo * kTileWords, b = min(s.nw, a + kTileWords) - 1;
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (static_cast<int>(wl[mid].y) <= rest)
      a = mid;
    else
      b = mid - 1;
  }
  const uint2 w = wl[a];
  uint32_t m = w.x;
  for (int n = rest - static_cast<int>(w.y); n > 0; --n) m &= m - 1u;
  return a * 32 + __ffs(m) - 1;
}

__device__ __forceinline__ int clamp_run(int32_t i, int r) {
  return min(max(i, 0), r - 1);
}

struct CompactArgs {
  Wire g;
  const int32_t* lab4;      // (T, R) the 4-connected labels
  const int32_t* ends8[4];  // (T, R) each: the 8-connected windows' lo_up,
                            // hi_up, lo_dn, hi_dn in wire order
  const uint8_t* oks8[2];   // (T, R) each: ok_up, ok_dn
  int32_t* init;         // (T, R) out: iota
  int32_t* ends;         // (4, T, R) out: remapped onto the compaction
  uint8_t* oks;          // (2, T, R) out
  uint8_t* link;         // (T, R) out
  int32_t* c_orig;       // (T, R) out: wire index of each compacted slot
  int32_t* n_kept;       // (T,) out
  Words s;               // the kept runs' bits
  int t;
};

// keep bits: valid wire runs the 4-connected propagation labelled below R
__global__ void __launch_bounds__(kThreads) keep_kernel(CompactArgs a) {
  const Wire& g = a.g;
  const int tile = blockIdx.x, f = blockIdx.y, r = g.r;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int count = g.counts[f];
  int32_t word[kPer], lab[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = tile_slot(tile, u);
    word[u] = j < r ? __ldg(g.runs + row0 + j) : 0;
    lab[u] = j < r ? __ldg(a.lab4 + row0 + j) : r;
  }
  bool keep[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = tile_slot(tile, u);
    keep[u] = j < r && decode(word[u], j, count, g).valid && lab[u] < r;
  }
  write_tile(keep, false, a.s, f, tile);
}

struct Remapped {
  int32_t lo_up, hi_up, lo_dn, hi_dn;
  bool ok_up, ok_dn;
};

// the 8-connected window (e: lo_up, hi_up, lo_dn, hi_dn; ok: ok_up, ok_dn)
// of a wire run on the compacted table: kept runs with wire index in
// [lo, hi] are the compacted [#kept before lo, #kept through hi - 1]
__device__ __forceinline__ Remapped remap(const uint2* wl,
                                          const uint32_t* tpre, int r,
                                          const int32_t (&e)[4],
                                          const bool (&ok)[2], bool c_valid) {
  Remapped o;
  o.lo_up = bits_before(wl, tpre, clamp_run(e[0], r));
  o.hi_up = bits_through(wl, tpre, clamp_run(e[1], r)) - 1;
  o.lo_dn = bits_before(wl, tpre, clamp_run(e[2], r));
  o.hi_dn = bits_through(wl, tpre, clamp_run(e[3], r)) - 1;
  o.ok_up = c_valid && ok[0] && o.lo_up <= o.hi_up;
  o.ok_dn = c_valid && ok[1] && o.lo_dn <= o.hi_dn;
  return o;
}

__device__ __forceinline__ void load_window(const CompactArgs& a, int64_t k,
                                            int32_t (&e)[4], bool (&ok)[2]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) e[c] = __ldg(a.ends8[c] + k);
  ok[0] = __ldg(a.oks8[0] + k) != 0;
  ok[1] = __ldg(a.oks8[1] + k) != 0;
}

__global__ void __launch_bounds__(kThreads, 4)
    compact_kernel(CompactArgs a) {
  __shared__ uint32_t s_tpre[kMaxTiles];
  // the tile's kept runs: remapped window, ok bits, row and first x
  __shared__ int32_t s_e[4][kTile];
  __shared__ int32_t s_row[kTile], s_xs[kTile];
  __shared__ uint8_t s_ok[kTile];
  const Wire& g = a.g;
  const int tile = blockIdx.x, f = blockIdx.y, r = g.r;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int64_t plane = static_cast<int64_t>(a.t) * r;
  const int count = g.counts[f];
  int kept;
  bool unused;
  frame_prefix(a.s, f, s_tpre, &kept, &unused);
  const uint2* wl = a.s.wl + static_cast<int64_t>(f) * a.s.nw;
  const int32_t* wrow = g.runs + row0;
  int32_t word[kPer], e[kPer][4];
  bool ok[kPer][2];
  uint2 w[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = tile_slot(tile, u);
    const bool in = j < r;
    word[u] = in ? __ldg(wrow + j) : 0;
    w[u] = in ? wl[j >> 5] : make_uint2(0, 0);
    if (in) {
      load_window(a, row0 + j, e[u], ok[u]);
    } else {
      e[u][0] = e[u][1] = e[u][2] = e[u][3] = 0;
      ok[u][0] = ok[u][1] = false;
    }
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = tile_slot(tile, u);
    if (j >= r) break;
    const bool keep = (w[u].x >> (j & 31)) & 1u;
    const int before = static_cast<int>(s_tpre[tile] + w[u].y) +
                       __popc(w[u].x & ((1u << (j & 31)) - 1u));
    const int p = keep ? before : kept + (j - before);
    const int64_t at = row0 + p;
    a.c_orig[at] = j;
    a.init[row0 + j] = j;
    const Remapped o = remap(wl, s_tpre, r, e[u], ok[u], keep);
    a.ends[at] = o.lo_up;
    a.ends[plane + at] = o.hi_up;
    a.ends[2 * plane + at] = o.lo_dn;
    a.ends[3 * plane + at] = o.hi_dn;
    a.oks[at] = o.ok_up;
    a.oks[plane + at] = o.ok_dn;
    if (keep) {
      const int loc = j - tile * kTile;
      const Run q = decode(word[u], j, count, g);
      s_e[0][loc] = o.lo_up;
      s_e[1][loc] = o.hi_up;
      s_e[2][loc] = o.lo_dn;
      s_e[3][loc] = o.hi_dn;
      s_ok[loc] = static_cast<uint8_t>(o.ok_up | (o.ok_dn << 1));
      s_row[loc] = q.row;
      s_xs[loc] = q.xs;
    }
  }
  __syncthreads();
  // each compacted slot's link to the next: the next kept wire run
  const int end = min(r, (tile + 1) * kTile);
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = tile_slot(tile, u);
    if (j >= r) break;
    const bool keep = (w[u].x >> (j & 31)) & 1u;
    const int before = static_cast<int>(s_tpre[tile] + w[u].y) +
                       __popc(w[u].x & ((1u << (j & 31)) - 1u));
    const int p = keep ? before : kept + (j - before);
    bool link = false;
    if (keep && p + 1 < kept) {
      const uint32_t rest = w[u].x & ~((2u << (j & 31)) - 1u);
      int j2;
      if (rest) {
        j2 = (j & ~31) + __ffs(rest) - 1;
      } else {
        const int wd = (j >> 5) + 1;
        const uint32_t m = wd < a.s.nw ? wl[wd].x : 0u;
        j2 = m ? wd * 32 + __ffs(m) - 1 : select_bit(a.s, wl, s_tpre, p + 1);
      }
      const int loc = j - tile * kTile;
      const Run q = decode(word[u], j, count, g);
      Remapped o2;
      int32_t row2, xs2;
      if (j2 < end) {
        const int l2 = j2 - tile * kTile;
        o2.lo_up = s_e[0][l2];
        o2.hi_up = s_e[1][l2];
        o2.lo_dn = s_e[2][l2];
        o2.hi_dn = s_e[3][l2];
        o2.ok_up = s_ok[l2] & 1;
        o2.ok_dn = s_ok[l2] >> 1;
        row2 = s_row[l2];
        xs2 = s_xs[l2];
      } else {
        int32_t e2[4];
        bool ok2[2];
        load_window(a, row0 + j2, e2, ok2);
        const Run q2 = decode(__ldg(wrow + j2), j2, count, g);
        o2 = remap(wl, s_tpre, r, e2, ok2, true);
        row2 = q2.row;
        xs2 = q2.xs;
      }
      const bool ok_up = s_ok[loc] & 1, ok_dn = s_ok[loc] >> 1;
      const bool same_row = row2 == q.row;
      link = (same_row && xs2 == q.xe + 1) ||
             (same_row && ok_up && o2.ok_up && s_e[1][loc] >= o2.lo_up) ||
             (same_row && ok_dn && o2.ok_dn && s_e[3][loc] >= o2.lo_dn);
    }
    a.link[row0 + p] = link;
  }
  if (tile == 0 && threadIdx.x == 0) a.n_kept[f] = kept;
}

struct FinishArgs {
  Wire g;
  const int32_t* lab8;    // (T, R) the 8-connected labels
  const int32_t* c_orig;  // (T, R), or null: the identity
  const int32_t* n_kept;  // (T,), or null: the wire's valid runs
  const int32_t* steps4;  // (T,), or null
  const int32_t* steps8;  // (T,)
  int32_t* run_comp;      // (T, R) out, wire order
  int32_t* n_comp;        // (T,) out
  int32_t* n_px;          // (T,) out
  int32_t* cc_steps;      // (T,) out
  int32_t* row_min;       // (T max_det, max_bh) out, or null: no tables
  int32_t* row_max;
  uint8_t* row_valid;
  int32_t* min_y;         // (T max_det,) out
  int16_t* readback;      // (T, rb + 2) out, or null: the host-rect
                          // batch's plane (each wire run's detection
                          // index, then the count and the steps)
  int rb;                 // its runs: the wire's first rb
  int32_t* root_row;      // (T, R) scratch: each root's row
  uint32_t* sync;         // (T ntiles + 1,) scratch: each tile's fill
                          // done, then the ids launch's next block
  Words s;                // the roots' bits
  int t, max_det, max_bh;
};

// the roots launch: a block a tile (a 1-D grid, frame-major); with the
// tables the blocks also clear the ids launch's flags and counter
__global__ void __launch_bounds__(kThreads) roots_kernel(FinishArgs a) {
  const int nt = a.s.ntiles;
  if (a.row_min)
    for (int i = blockIdx.x * kThreads + threadIdx.x; i <= a.t * nt;
         i += gridDim.x * kThreads)
      a.sync[i] = 0;
  const Wire& g = a.g;
  const int f = blockIdx.x / nt, tile = blockIdx.x % nt;
  const int r = g.r, lane = threadIdx.x & 31;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int32_t* wrow = g.runs + row0;
  const int count = g.counts[f];
  const int kept = a.n_kept ? a.n_kept[f] : 0;
  int32_t word[kPer], lab[kPer], prev[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int p = tile_slot(tile, u);
    word[u] = p < r ? __ldg(wrow + p) : 0;
    lab[u] = p < r ? __ldg(a.lab8 + row0 + p) : -1;
    prev[u] = lane == 0 && p > 0 && p <= r ? __ldg(wrow + p - 1) : 0;
  }
  bool root[kPer], flag = false;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int p = tile_slot(tile, u);
    // the slot's wire run (the compacted slot's own with a single threshold)
    const Run q = decode(word[u], p, count, g);
    const int32_t pw = __shfl_up_sync(~0u, word[u], 1);
    const Run qp = decode(lane ? pw : prev[u], p - 1, count, g);
    // the valid wire runs' rows do not decrease, nor follow an invalid
    // slot, and no valid slot's label exceeds its index
    flag |= p < r && p > 0 && q.valid && (!qp.valid || qp.row > q.row);
    const bool valid = a.n_kept ? p < kept : q.valid;
    flag |= p < r && valid && lab[u] > p;
    root[u] = p < r && valid && lab[u] == p;
  }
  if (a.row_min) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (!root[u]) continue;
      const int p = tile_slot(tile, u);
      int32_t row = decode(word[u], p, count, g).row;
      if (a.c_orig) {
        const int o = __ldg(a.c_orig + row0 + p);
        row = decode(__ldg(wrow + o), o, count, g).row;
      }
      a.root_row[row0 + p] = row;
    }
  }
  write_tile(root, flag, a.s, f, tile);
  if (tile == 0 && threadIdx.x == 0) {
    a.n_px[f] = 0;
    const int32_t s8 = a.steps8[f];
    a.cc_steps[f] = a.steps4 ? max(a.steps4[f], s8) : s8;
  }
}

// a compacted slot's run as the ids launch sees it
struct Slot {
  int orig;      // its wire index
  int asc;       // the rank of the root at its clamped label
  int lab;       // that label
  bool valid, root_at_lab;
  Run q;         // its wire run
};

__device__ __forceinline__ Slot finish_slot(const FinishArgs& a, int f,
                                            const uint2* wl,
                                            const uint32_t* tpre, int p,
                                            int kept) {
  const Wire& g = a.g;
  const int64_t row0 = static_cast<int64_t>(f) * g.r;
  Slot s;
  s.lab = clamp_run(__ldg(a.lab8 + row0 + p), g.r);
  s.orig = a.c_orig ? __ldg(a.c_orig + row0 + p) : p;
  const uint2 w = wl[s.lab >> 5];
  s.q = decode(__ldg(g.runs + row0 + s.orig), s.orig, g.counts[f], g);
  s.valid = a.n_kept ? p < kept : s.q.valid;
  s.root_at_lab = (w.x >> (s.lab & 31)) & 1u;
  s.asc = static_cast<int>(tpre[s.lab / kTile] + w.y +
                           __popc(w.x & ((2u << (s.lab & 31)) - 1u))) - 1;
  return s;
}

// a run's entry in its frame's tables: its row less y0 in its id's rows
__device__ __forceinline__ int table_entry(const FinishArgs& a, int id,
                                           const Run& q, int y0) {
  return id * a.max_bh + min(max(q.row - y0, 0), a.max_bh - 1);
}

// x extremes lo, hi into entry e of frame f's tables
__device__ __forceinline__ void table_update(const FinishArgs& a, int f,
                                             int e, int lo, int hi) {
  const int64_t slot = static_cast<int64_t>(f) * a.max_det * a.max_bh + e;
  atomicMin(a.row_min + slot, lo);
  atomicMax(a.row_max + slot, hi);
  a.row_valid[slot] = 1;
}

// the warp's runs' table updates (entry e, or -1 for none): a run's
// extremes merged into those of the lanes after it with its entry (a
// component's runs of a row are mostly neighbours), then one update for
// the last lane of each stretch of lanes with one entry. Every lane calls
// it.
__device__ __forceinline__ void warp_table_update(const FinishArgs& a, int f,
                                                  int e, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int e2 = __shfl_up_sync(~0u, e, o);
    const int lo2 = __shfl_up_sync(~0u, lo, o);
    const int hi2 = __shfl_up_sync(~0u, hi, o);
    if (lane >= o && e2 == e) {
      lo = min(lo, lo2);
      hi = max(hi, hi2);
    }
  }
  const int next = __shfl_down_sync(~0u, e, 1);
  if (e >= 0 && (lane == 31 || next != e)) table_update(a, f, e, lo, hi);
}

// frame f's table entries of ids [d0, d1) filled with their empty values
// (+-2^30, false; with min_y, BIG_I there too) by the block's threads,
// 16-byte stores where an id's rows are a multiple of 16
__device__ void fill_ids(const FinishArgs& a, int f, int d0, int d1,
                         bool with_min_y) {
  const int64_t c0 = static_cast<int64_t>(f) * a.max_det + d0;
  const int64_t e0 = c0 * a.max_bh;
  const int64_t n = static_cast<int64_t>(max(d1 - d0, 0)) * a.max_bh;
  if (a.max_bh % 16 == 0) {
    int4* mn = reinterpret_cast<int4*>(a.row_min + e0);
    int4* mx = reinterpret_cast<int4*>(a.row_max + e0);
    uint4* v = reinterpret_cast<uint4*>(a.row_valid + e0);
    for (int64_t i = threadIdx.x; i < n / 4; i += kThreads) {
      mn[i] = make_int4(kBigI, kBigI, kBigI, kBigI);
      mx[i] = make_int4(-kBigI, -kBigI, -kBigI, -kBigI);
      if (i < n / 16) v[i] = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      a.row_min[e0 + i] = kBigI;
      a.row_max[e0 + i] = -kBigI;
      a.row_valid[e0 + i] = 0;
    }
  }
  if (with_min_y)
    for (int i = threadIdx.x; i < d1 - d0; i += kThreads)
      a.min_y[c0 + i] = kBigI;
}

// the ids launch: a block a tile (a 1-D grid, frame-major). With the
// tables the blocks take their tiles in order from a counter. A tile's
// roots are a range of ids, and the block fills those ids' tables (and
// its share of the ids past the frame's components) before any update,
// so the lines are in L2 when the atomics come; then it sets its tile's
// flag. A run's component has its root at or before the run's tile (in a
// frame not flagged), so a block's updates wait for the flags of its
// frame's tiles up to its own, all taken before it.
__global__ void __launch_bounds__(kThreads) ids_kernel(FinishArgs a) {
  __shared__ uint32_t s_tpre[kMaxTiles];
  __shared__ uint32_t s_px[kWarps];
  __shared__ int s_block;
  const Wire& g = a.g;
  const bool tables = a.row_min != nullptr;
  const int nt = a.s.ntiles;
  int b = blockIdx.x;
  if (tables) {
    if (threadIdx.x == 0) s_block = atomicAdd(a.sync + a.t * nt, 1u);
    __syncthreads();
    b = s_block;
  }
  const int tile = b % nt, f = b / nt, r = g.r;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  int n_comp;
  bool flagged;
  frame_prefix(a.s, f, s_tpre, &n_comp, &flagged);
  const uint2* wl = a.s.wl + static_cast<int64_t>(f) * a.s.nw;
  const int kept = a.n_kept ? a.n_kept[f] : 0;
  Slot sl[kPer];
  int32_t y_root[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int p = min(tile_slot(tile, u), r - 1);
    sl[u] = finish_slot(a, f, wl, s_tpre, p, kept);
    y_root[u] = tables && !flagged ? a.root_row[row0 + sl[u].lab] : 0;
  }
  if (tables) {
    // the ids of the tile's roots (ranks tpre[tile] on), in a flagged
    // frame their min_y too, and a share of the ids past the components
    const int rank_end =
        tile + 1 < nt ? static_cast<int>(s_tpre[tile + 1]) : n_comp;
    fill_ids(a, f, n_comp - rank_end,
             min(n_comp - static_cast<int>(s_tpre[tile]), a.max_det),
             flagged);
    const int rest = max(a.max_det - n_comp, 0);
    fill_ids(a, f, a.max_det - rest + rest * tile / nt,
             a.max_det - rest + rest * (tile + 1) / nt, true);
    __threadfence();
    __syncthreads();
    uint32_t* flags = a.sync + static_cast<int64_t>(f) * nt;
    if (threadIdx.x == 0) atomicExch(flags + tile, 1u);
    // the tiles' fills this block's updates need: those up to its own (in
    // a flagged frame the last tile's block makes them all)
    const int need = flagged ? (tile == nt - 1 ? nt : 0) : tile + 1;
    if (warp == 0)
      for (int j = lane; j < need; j += 32)
        while (!*static_cast<volatile uint32_t*>(flags + j)) {
        }
    __syncthreads();
  }
  uint32_t px = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int p = tile_slot(tile, u);
    const Slot& s = sl[u];
    const bool valid = p < r && s.valid;
    if (p < r) {
      const int comp = valid ? s.asc : -1;
      a.run_comp[row0 + s.orig] = comp;
      if (a.readback && s.orig < a.rb) {
        // cv2's order, -1 for none and past max_det (det_run_idx)
        const int id = n_comp - 1 - comp;
        a.readback[static_cast<int64_t>(f) * (a.rb + 2) + s.orig] =
            static_cast<int16_t>(comp >= 0 && id < a.max_det ? id : -1);
      }
    }
    px += valid ? static_cast<uint32_t>(s.q.lens) : 0u;
    if (!tables || flagged) continue;  // the block's lanes alike
    int e = -1;
    const int id = n_comp - 1 - s.asc;  // cv2's order
    if (valid && s.asc >= 0 && id < a.max_det) {
      // the component's least row: its root's (a label that names no
      // root ranks with the root before it, whose group this run joins)
      const int y0 =
          s.root_at_lab
              ? y_root[u]
              : a.root_row[row0 + select_bit(a.s, wl, s_tpre, s.asc)];
      e = table_entry(a, id, s.q, y0);
      if (s.root_at_lab && s.lab == p)
        a.min_y[static_cast<int64_t>(f) * a.max_det + id] = s.q.row;
    }
    warp_table_update(a, f, e, s.q.xs, s.q.xe);
  }
  for (int o = 16; o; o >>= 1) px += __shfl_xor_sync(~0u, px, o);
  if (lane == 0) s_px[warp] = px;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int k = 0; k < kWarps; ++k) total += s_px[k];
    atomicAdd(a.n_px + f, static_cast<int32_t>(total));
    if (tile == 0) {
      a.n_comp[f] = n_comp;
      if (a.readback) {
        // the count clamped to int16, the steps (the roots launch's)
        int16_t* tail = a.readback + static_cast<int64_t>(f) * (a.rb + 2) +
                        a.rb;
        tail[0] = static_cast<int16_t>(min(n_comp, 32767));
        tail[1] = static_cast<int16_t>(a.cc_steps[f]);
      }
    }
  }
  if (!tables || !flagged || tile != nt - 1) return;
  // a flagged frame: this block alone, the components' least rows first
  int32_t* min_y = a.min_y + static_cast<int64_t>(f) * a.max_det;
  for (int pass = 0; pass < 2; ++pass) {
    for (int p = threadIdx.x; p < r; p += kThreads) {
      const Slot s = finish_slot(a, f, wl, s_tpre, p, kept);
      if (!s.valid || s.asc < 0) continue;
      const int id = n_comp - 1 - s.asc;
      if (id >= a.max_det) continue;
      if (pass == 0)
        atomicMin(min_y + id, s.q.row);
      else
        table_update(a, f, table_entry(a, id, s.q, __ldcg(min_y + id)),
                     s.q.xs, s.q.xe);
    }
    __syncthreads();
  }
}

Wire make_wire(const void* runs, const void* counts, int r, int w) {
  Wire g;
  g.runs = static_cast<const int32_t*>(runs);
  g.counts = static_cast<const int32_t*>(counts);
  g.r = r;
  g.w = w;
  g.magic = w >= 2 ? UINT64_MAX / static_cast<uint64_t>(w) + 1 : 0;
  return g;
}

// the bits scratch of the compact and finish launches
Words make_words(void* scratch, int t, int r) {
  Words s;
  s.nw = (r + 31) / 32;
  s.ntiles = (r + kTile - 1) / kTile;
  s.wl = static_cast<uint2*>(scratch);
  s.tcnt = reinterpret_cast<uint32_t*>(s.wl + static_cast<int64_t>(t) * s.nw);
  return s;
}

}  // namespace

extern "C" {

// the scratch of ysmr_run_prepare (kind 0), of ysmr_run_compact and
// ysmr_run_finish (kind 1: the tiles' words and counts) and of
// ysmr_run_finish with the row tables (kind 2: and the roots' rows), in
// int32 words
int64_t ysmr_run_scratch_words(int t, int r, int kind) {
  const int64_t tr = static_cast<int64_t>(t) * r;
  if (kind == 0) {
    const int64_t flags = static_cast<int64_t>(t) *
                          ((r + kPrepThreads - 1) / kPrepThreads);
    return 2 * tr + (flags + 3) / 4;
  }
  const int64_t words = 2 * static_cast<int64_t>(t) * ((r + 31) / 32) +
                        static_cast<int64_t>(t) * ((r + kTile - 1) / kTile);
  return words + (kind == 2 ? tr + static_cast<int64_t>(t) *
                                         ((r + kTile - 1) / kTile) + 1
                           : 0);
}

// runs: (T, R) int32 wire, counts: (T,) int32; frame_valid: (T,) uint8,
// or null, and then counts_out (T,) int32 out: the counts with the
// invalid frames' set to 0, which the launches use; out: ends (nd, 4, T,
// R) int32, oks (nd, 2, T, R) uint8, link (T, R) uint8 (the first
// dilation's chain), init (T, R) int32, valid (T, R) uint8; scratch:
// ysmr_run_scratch_words(t, r, 0) int32; nd 1 or 2 dilations d0, d1;
// weak: the marker
// reconstruction's init. 1 <= w <= 2^26, T <= 65535. Two launches.
// All on CUDA device `device`, launched on `stream`. Returns a
// cudaError_t (0 = launched).
int ysmr_run_prepare(const void* runs, const void* counts,
                     const void* frame_valid, void* counts_out, void* ends,
                     void* oks, void* link, void* init, void* valid,
                     void* scratch, int t, int r, int w, int nd, int d0,
                     int d1, int weak, int device, void* stream) {
  if (t <= 0 || r <= 0) return 0;
  if (nd < 1 || nd > 2 || w < 1 || w > (1 << 26) || t > 65535 ||
      (frame_valid && !counts_out))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  PrepArgs a{};
  a.g = make_wire(runs, counts, r, w);
  a.d[0] = d0;
  a.d[1] = d1;
  a.weak = weak != 0;
  a.ends = static_cast<int32_t*>(ends);
  a.oks = static_cast<uint8_t*>(oks);
  a.link = static_cast<uint8_t*>(link);
  a.init = static_cast<int32_t*>(init);
  a.valid = static_cast<uint8_t*>(valid);
  a.t = t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  KeyArgs k;
  k.g = a.g;
  k.fv = static_cast<const uint8_t*>(frame_valid);
  k.counts = static_cast<int32_t*>(counts_out);
  if (frame_valid) a.g.counts = k.counts;
  k.key_e = static_cast<int32_t*>(scratch);
  k.key_s = k.key_e + static_cast<int64_t>(t) * r;
  k.unsorted =
      reinterpret_cast<uint8_t*>(k.key_s + static_cast<int64_t>(t) * r);
  a.key_blocks = (r + kPrepThreads - 1) / kPrepThreads;
  a.key_e = k.key_e;
  a.key_s = k.key_s;
  a.unsorted = k.unsorted;
  keys_kernel<<<dim3(a.key_blocks, t), kPrepThreads, 0, s>>>(k);
  const dim3 grid((r + kPrepThreads - 2) / (kPrepThreads - 1), t);
  if (nd == 1)
    prepare_kernel<1><<<grid, kPrepThreads, 0, s>>>(a);
  else
    prepare_kernel<2><<<grid, kPrepThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// runs, counts as above; lab4: (T, R) int32; ends8: four (T, R) int32
// planes and oks8 two (T, R) uint8 planes (host arrays of device
// pointers): the 8-connected windows in wire order; out: init
// (T, R) int32, ends (4, T, R), oks (2, T, R), link (T, R) uint8, c_orig
// (T, R) int32, n_kept (T,) int32; scratch: ysmr_run_scratch_words(t, r,
// 1) int32, 8-byte aligned. R <= 2^19, T <= 65535. Two launches. Returns
// a cudaError_t.
int ysmr_run_compact(const void* runs, const void* counts, const void* lab4,
                     const void* const* ends8, const void* const* oks8,
                     void* init, void* ends, void* oks, void* link,
                     void* c_orig, void* n_kept, void* scratch, int t, int r,
                     int w, int device, void* stream) {
  if (t <= 0 || r <= 0) return 0;
  if (w < 1 || w > (1 << 26) || r > kMaxTiles * kTile || t > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CompactArgs a{};
  a.g = make_wire(runs, counts, r, w);
  a.lab4 = static_cast<const int32_t*>(lab4);
  for (int k = 0; k < 4; ++k)
    a.ends8[k] = static_cast<const int32_t*>(ends8[k]);
  for (int k = 0; k < 2; ++k) a.oks8[k] = static_cast<const uint8_t*>(oks8[k]);
  a.init = static_cast<int32_t*>(init);
  a.ends = static_cast<int32_t*>(ends);
  a.oks = static_cast<uint8_t*>(oks);
  a.link = static_cast<uint8_t*>(link);
  a.c_orig = static_cast<int32_t*>(c_orig);
  a.n_kept = static_cast<int32_t*>(n_kept);
  a.s = make_words(scratch, t, r);
  a.t = t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(a.s.ntiles, t);
  keep_kernel<<<grid, kThreads, 0, s>>>(a);
  compact_kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// runs, counts as above; lab8 (T, R) int32; c_orig (T, R) int32 and
// n_kept (T,) int32, both null for the identity compaction; steps4 (T,)
// (or null) and steps8 (T,) int32; out: run_comp (T, R), n_comp, n_px,
// cc_steps (T,) int32; with the row tables (else null) row_min, row_max
// (T max_det, max_bh) int32, row_valid (T max_det, max_bh) uint8 and
// min_y (T max_det,) int32, each 16-byte aligned; with the readback
// plane (else null) readback (T, rb + 2) int16, 1 <= rb <= R: each of the
// first rb wire runs' detection index (n_comp - 1 - its id, -1 for none
// and from max_det), then min(n_comp, 32767) and the steps; scratch:
// ysmr_run_scratch_words(t, r, 2 with the tables, else 1) int32, 8-byte
// aligned. R <= 2^19, T <= 65535. Two launches. Returns a cudaError_t.
int ysmr_run_finish(const void* runs, const void* counts, const void* lab8,
                    const void* c_orig, const void* n_kept,
                    const void* steps4, const void* steps8, void* run_comp,
                    void* n_comp, void* n_px, void* cc_steps, void* row_min,
                    void* row_max, void* row_valid, void* min_y,
                    void* readback, void* scratch, int t, int r, int w,
                    int max_det, int max_bh, int rb, int device,
                    void* stream) {
  if (t <= 0 || r <= 0) return 0;
  if (w < 1 || w > (1 << 26) || r > kMaxTiles * kTile || t > 65535 ||
      (row_min && (max_det < 1 || max_bh < 1 ||
                   static_cast<int64_t>(max_det) * max_bh > INT32_MAX)) ||
      (readback && (max_det < 1 || rb < 1 || rb > r)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  FinishArgs a{};
  a.g = make_wire(runs, counts, r, w);
  a.lab8 = static_cast<const int32_t*>(lab8);
  a.c_orig = static_cast<const int32_t*>(c_orig);
  a.n_kept = static_cast<const int32_t*>(n_kept);
  a.steps4 = static_cast<const int32_t*>(steps4);
  a.steps8 = static_cast<const int32_t*>(steps8);
  a.run_comp = static_cast<int32_t*>(run_comp);
  a.n_comp = static_cast<int32_t*>(n_comp);
  a.n_px = static_cast<int32_t*>(n_px);
  a.cc_steps = static_cast<int32_t*>(cc_steps);
  a.s = make_words(scratch, t, r);
  if (row_min) {
    a.row_min = static_cast<int32_t*>(row_min);
    a.row_max = static_cast<int32_t*>(row_max);
    a.row_valid = static_cast<uint8_t*>(row_valid);
    a.min_y = static_cast<int32_t*>(min_y);
    a.root_row = reinterpret_cast<int32_t*>(
        a.s.tcnt + static_cast<int64_t>(t) * a.s.ntiles);
    a.sync = reinterpret_cast<uint32_t*>(a.root_row +
                                         static_cast<int64_t>(t) * r);
    a.max_bh = max_bh;
  }
  a.readback = static_cast<int16_t*>(readback);
  a.rb = rb;
  a.max_det = max_det;
  a.t = t;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned tiles = static_cast<unsigned>(t * a.s.ntiles);
  roots_kernel<<<tiles, kThreads, 0, s>>>(a);
  ids_kernel<<<tiles, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
