// Run-graph connected components around csrc/run_prop.cu: the run wire's
// decode, windows and links, the compaction of the runs the marker
// reconstruction keeps, and the component ids, their scatter back to wire
// order and the component-sorted run tables.
//
// Replaces the plain-XLA part of ysmr_tpu/ops/run_cc.py:291
// run_cc_components outside propagate_min (and the same steps of
// keep_marked_runs and label_runs). Same contract and bits as the plain
// versions in ysmr_tpu_torch/ops/run_cc.py:
// 1. prepare, two launches (prepare_runs_plain: decode_runs,
//    run_windows_multi, chain_mask and the initial labels): the planes
//    run_prop.cu reads, for each dilation asked for.
// 2. compact, one launch (compact_kept_runs_plain): between the two
//    propagations of the double threshold, the stable compaction of the
//    kept runs, the 8-connected windows remapped onto the compacted table
//    and its links.
// 3. finish, one launch (finish_components_plain): after the 8-connected
//    propagation, the roots and their ascending rank, the per-run ids and
//    their scatter to wire order, the kept pixels, the larger step count
//    and, when asked, the (component, start) order of the kept runs.
//
// Facts it uses. A window endpoint is torch.searchsorted over the frame's
// key row. Where the row does not decrease (the wire in raster order)
// each search has one answer, and it lies between the answers to the
// least and the greatest query of a block of runs; otherwise the launch
// runs torch's own probes over [0, R), so the same index on any input. The
// compaction and the ranks are prefix counts over one bit a run: per
// 32-run word a bit mask and the count before it, in shared memory. The
// plain version sorts the kept runs stably by (component, start), every
// padding slot after them ordered by its start. Where the valid slots are
// a prefix in raster order, a group's slots are in start order already:
// a group's place is a prefix sum of the groups' sizes and its slots go
// there in slot order; the padding's starts are a few non-decreasing runs
// (stale wire past the count), merged by rank. Anything else takes stable
// 4-bit radix passes by start, then by group.
//
// Design. Prepare: a keys launch (each slot's two keys, and a flag for
// each 256 slots where a key exceeds the next), then a thread a run,
// blocks of 256 covering 255 runs of one frame (the last thread's run is
// its neighbour's for the link); the second dilation's answers a step
// from the first's. Compact and finish: one block of 1024 threads a
// frame, the frame's bit masks and counts in shared memory (R / 4 bytes;
// with the sort, count tables of n_comp + 2 words a segment, one segment
// a warp, and the group totals), which bounds R at 2^19 runs; a thread
// takes four slots at a time, their loads first.
//
// What bounds it on an H100: latency. The frame launches run one block a
// frame (64 of the 132 SMs at T = 64), each slot a chain of dependent
// loads; the prepare launch's searches are dependent L1 loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace {

constexpr int32_t kBig = 1 << 28;  // ops/run_cc.py's _BIG
constexpr int kPrepThreads = 256;
constexpr int kFrameThreads = 1024;
constexpr int kFrameWarps = kFrameThreads / 32;
constexpr int kDigits = 16;  // 4-bit radix digits

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
};

__global__ void __launch_bounds__(kPrepThreads) keys_kernel(KeyArgs a) {
  const Wire& g = a.g;
  const int f = blockIdx.y;
  const int i = blockIdx.x * kPrepThreads + threadIdx.x;
  const int r = g.r, m = g.w + 2;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int32_t* wrow = g.runs + row0;
  const int count = g.counts[f];
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

// exclusive prefix sums of cnt[0..n) in place (shared memory, every
// thread of a kFrameThreads block calls it); returns the total
__device__ uint32_t block_exclusive_scan(uint32_t* cnt, int n) {
  __shared__ uint32_t warp_tot[kFrameWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + kFrameThreads - 1) / kFrameThreads;
  const int lo = min(n, static_cast<int>(threadIdx.x) * per);
  const int hi = min(n, lo + per);
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += cnt[i];
  uint32_t inc = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t v = __shfl_up_sync(~0u, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  uint32_t run = inc - sum, total = 0;
  for (int k = 0; k < kFrameWarps; ++k) {
    const uint32_t v = warp_tot[k];
    run += k < warp ? v : 0u;
    total += v;
  }
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = cnt[i];
    cnt[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

// set bits of words[0..) before bit j, and through bit j
__device__ __forceinline__ int count_before(const uint32_t* bits,
                                            const uint32_t* pre, int j) {
  return static_cast<int>(pre[j >> 5]) +
         __popc(bits[j >> 5] & ((1u << (j & 31)) - 1u));
}

__device__ __forceinline__ int count_through(const uint32_t* bits,
                                             const uint32_t* pre, int j) {
  return count_before(bits, pre, j) +
         static_cast<int>((bits[j >> 5] >> (j & 31)) & 1u);
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
  int t;
};

struct Remapped {
  int32_t lo_up, hi_up, lo_dn, hi_dn;
  bool ok_up, ok_dn;
};

// the 8-connected window of wire run j on the compacted table: kept runs
// with wire index in [lo, hi] are the compacted [#kept before lo,
// #kept through hi - 1]
__device__ __forceinline__ Remapped remap(const CompactArgs& a, int64_t row0,
                                          const uint32_t* bits,
                                          const uint32_t* pre, int j,
                                          bool c_valid) {
  const int r = a.g.r;
  const int64_t k = row0 + j;
  Remapped o;
  o.lo_up = count_before(bits, pre, clamp_run(a.ends8[0][k], r));
  o.hi_up = count_through(bits, pre, clamp_run(a.ends8[1][k], r)) - 1;
  o.lo_dn = count_before(bits, pre, clamp_run(a.ends8[2][k], r));
  o.hi_dn = count_through(bits, pre, clamp_run(a.ends8[3][k], r)) - 1;
  o.ok_up = c_valid && a.oks8[0][k] && o.lo_up <= o.hi_up;
  o.ok_dn = c_valid && a.oks8[1][k] && o.lo_dn <= o.hi_dn;
  return o;
}

__global__ void __launch_bounds__(kFrameThreads)
    compact_kernel(CompactArgs a) {
  extern __shared__ uint32_t sh[];
  const Wire& g = a.g;
  const int f = blockIdx.x, r = g.r, nw = (r + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* bits = sh;
  uint32_t* pre = sh + nw;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int64_t plane = static_cast<int64_t>(a.t) * r;
  const int32_t* wrow = g.runs + row0;
  const int count = g.counts[f];
  for (int wd = warp; wd < nw; wd += kFrameWarps) {
    const int j = wd * 32 + lane;
    bool keep = false;
    if (j < r)
      keep = decode(wrow[j], j, count, g).valid && a.lab4[row0 + j] < r;
    const uint32_t b = __ballot_sync(~0u, keep);
    if (lane == 0) {
      bits[wd] = b;
      pre[wd] = __popc(b);
    }
  }
  __syncthreads();
  const int kept = static_cast<int>(block_exclusive_scan(pre, nw));
  for (int j = threadIdx.x; j < r; j += kFrameThreads) {
    const bool keep = (bits[j >> 5] >> (j & 31)) & 1u;
    const int before = count_before(bits, pre, j);
    const int p = keep ? before : kept + (j - before);
    const int64_t at = row0 + p;
    a.c_orig[at] = j;
    a.init[row0 + j] = j;
    const Remapped o = remap(a, row0, bits, pre, j, p < kept);
    a.ends[at] = o.lo_up;
    a.ends[plane + at] = o.hi_up;
    a.ends[2 * plane + at] = o.lo_dn;
    a.ends[3 * plane + at] = o.hi_dn;
    a.oks[at] = o.ok_up;
    a.oks[plane + at] = o.ok_dn;
    // the link to the next compacted slot: the next kept wire run
    bool link = false;
    if (keep && p + 1 < kept) {
      int wd = j >> 5;
      uint32_t rest = bits[wd] & ~((2u << (j & 31)) - 1u);
      if ((j & 31) == 31) rest = 0;
      while (!rest) rest = bits[++wd];
      const int j2 = wd * 32 + __ffs(rest) - 1;
      const Run q = decode(wrow[j], j, count, g);
      const Run q2 = decode(wrow[j2], j2, count, g);
      const Remapped o2 = remap(a, row0, bits, pre, j2, true);
      const bool same_row = q2.row == q.row;
      link = (same_row && q2.xs == q.xe + 1) ||
             (same_row && o.ok_up && o2.ok_up && o.hi_up >= o2.lo_up) ||
             (same_row && o.ok_dn && o2.ok_dn && o.hi_dn >= o2.lo_dn);
    }
    a.link[at] = link;
  }
  if (threadIdx.x == 0) a.n_kept[f] = kept;
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
  int32_t* s_start;       // (T, R) out, or null: no sorted runs
  int32_t* s_len;
  int32_t* s_comp;
  int32_t* grp;           // (T, R) scratch: sort group of a slot
  int32_t* cst;           // (T, R) scratch: start | kept length << 26
  int32_t* pay_a;         // (T, R) scratch: slot order, two buffers
  int32_t* pay_b;
  uint32_t* gcnt;         // (T, 2 R + 4) scratch: the sort's count tables
  uint32_t* rcnt;         // (T, kDigits kFrameThreads) scratch: digit counts
  bool gcnt_shared;       // r + 2 words of shared memory for the tables
  int t;
};

// padding segments (non-decreasing runs of starts) merged by rank; more
// take the radix passes
constexpr int kMaxSegs = 32;
// slots a thread takes at a time in the finish launch's first loop
constexpr int kUnroll = 4;

// one stable 4-bit pass of the sort of slots `in` by the digit at `shift`
// of keys[slot] (masked to 26 bits with `start`), into `out`: each thread
// counts and places a contiguous chunk in order
__device__ void radix_pass(const int32_t* keys, bool start, int shift,
                           const int32_t* in, int32_t* out, int r,
                           uint32_t* cnt) {
  const int tid = threadIdx.x;
  const int per = (r + kFrameThreads - 1) / kFrameThreads;
  const int lo = min(r, tid * per), hi = min(r, lo + per);
  for (int d = 0; d < kDigits; ++d) cnt[d * kFrameThreads + tid] = 0;
  for (int e = lo; e < hi; ++e) {
    int32_t k = keys[in[e]];
    if (start) k &= 0x03FFFFFF;
    ++cnt[((k >> shift) & (kDigits - 1)) * kFrameThreads + tid];
  }
  __syncthreads();
  block_exclusive_scan(cnt, kDigits * kFrameThreads);
  for (int e = lo; e < hi; ++e) {
    const int32_t s = in[e];
    int32_t k = keys[s];
    if (start) k &= 0x03FFFFFF;
    out[cnt[((k >> shift) & (kDigits - 1)) * kFrameThreads + tid]++] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kFrameThreads)
    finish_kernel(FinishArgs a) {
  extern __shared__ uint32_t sh[];
  const Wire& g = a.g;
  const int f = blockIdx.x, r = g.r, nw = (r + 31) >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* bits = sh;
  uint32_t* pre = sh + nw;
  const int64_t row0 = static_cast<int64_t>(f) * r;
  const int32_t* wrow = g.runs + row0;
  const int count = g.counts[f];
  const int kept = a.n_kept ? a.n_kept[f] : 0;
  const int32_t* lab8 = a.lab8 + row0;
  // roots: valid compacted slots labelled with their own index
  for (int wd = warp; wd < nw; wd += kFrameWarps) {
    const int p = wd * 32 + lane;
    bool root = false;
    if (p < r) {
      const bool valid =
          a.n_kept ? p < kept : decode(wrow[p], p, count, g).valid;
      root = valid && lab8[p] == p;
    }
    const uint32_t b = __ballot_sync(~0u, root);
    if (lane == 0) {
      bits[wd] = b;
      pre[wd] = __popc(b);
    }
  }
  __syncthreads();
  const int n_comp = static_cast<int>(block_exclusive_scan(pre, nw));
  // ids (the rank of the root at the clamped label), scatter, pixels;
  // with the sort each group's size. kUnroll slots a thread at a time,
  // their loads first.
  const bool sorted = a.s_start != nullptr;
  int32_t* grp = a.grp + row0;
  int32_t* cst = a.cst + row0;
  // the sort's valid slots lie below `bound`, in `nseg` segments of
  // seg_len slots (as many as the count tables fit), one a warp: a count
  // table a segment, of stride groups, and one of the groups' totals; in
  // shared memory (r + 2 words) where two tables fit, else in the global
  // scratch (2 r + 4 words a frame)
  const int bound = a.n_kept ? kept : min(count, r);
  const int stride = n_comp + 2;
  const bool in_shared = a.gcnt_shared && 2 * stride <= r + 2;
  uint32_t* gcnt =
      !sorted     ? nullptr
      : in_shared ? pre + nw
                  : a.gcnt + static_cast<int64_t>(f) * (2 * r + 4);
  const int64_t room = in_shared ? r + 2 : 2 * r + 4;
  int nseg = kFrameWarps;
  while (nseg > 1 && static_cast<int64_t>(nseg + 1) * stride > room)
    nseg >>= 1;
  const int seg_len = max(1, (bound + nseg - 1) / nseg);
  if (sorted) {
    for (int k = threadIdx.x; k < (nseg + 1) * stride; k += kFrameThreads)
      gcnt[k] = 0;
    __syncthreads();
  }
  uint32_t px = 0;
  for (int p0 = threadIdx.x; p0 < r; p0 += kUnroll * kFrameThreads) {
    int32_t lab[kUnroll], orig[kUnroll], word[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kFrameThreads;
      lab[u] = p < r ? lab8[p] : 0;
      orig[u] = p < r && a.c_orig ? a.c_orig[row0 + p] : p;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      word[u] = p0 + u * kFrameThreads < r ? wrow[orig[u]] : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int p = p0 + u * kFrameThreads;
      if (p >= r) break;
      const int asc = count_through(bits, pre, clamp_run(lab[u], r)) - 1;
      const bool valid =
          a.n_kept ? p < kept : decode(word[u], p, count, g).valid;
      const int32_t len = valid ? (word[u] >> 27) & 0x1F : 0;
      a.run_comp[row0 + orig[u]] = valid ? asc : -1;
      px += static_cast<uint32_t>(len);
      if (sorted) {
        grp[p] = valid ? asc + 1 : n_comp + 1;
        cst[p] = (word[u] & 0x03FFFFFF) | (len << 26);
        if (valid) atomicAdd(gcnt + (p / seg_len) * stride + asc + 1, 1u);
      }
    }
  }
  __shared__ uint32_t px_warp[kFrameWarps];
  for (int o = 16; o; o >>= 1) px += __shfl_xor_sync(~0u, px, o);
  if (lane == 0) px_warp[warp] = px;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t total = 0;
    for (int k = 0; k < kFrameWarps; ++k) total += px_warp[k];
    a.n_px[f] = static_cast<int32_t>(total);
    a.n_comp[f] = n_comp;
    const int32_t s8 = a.steps8[f];
    a.cc_steps[f] = a.steps4 ? max(a.steps4[f], s8) : s8;
  }
  if (!sorted) return;
  // (component, start) order, the padding (group n_comp + 1) last. The
  // groups' first places (a prefix sum of their totals), and each
  // segment's first place in each group (the counts of the segments
  // before it); then a warp a segment places its valid slots in slot
  // order, a group's slots in order (their starts do not decrease where
  // the wire is in raster order).
  uint32_t* tot = gcnt + nseg * stride;
  for (int gp = threadIdx.x; gp <= n_comp; gp += kFrameThreads) {
    uint32_t t = 0;
    for (int w = 0; w < nseg; ++w) t += gcnt[w * stride + gp];
    tot[gp] = t;
  }
  __syncthreads();
  const int n_valid = static_cast<int>(block_exclusive_scan(tot, n_comp + 1));
  for (int gp = threadIdx.x; gp <= n_comp; gp += kFrameThreads) {
    uint32_t run = tot[gp];
    for (int w = 0; w < nseg; ++w) {
      const uint32_t c = gcnt[w * stride + gp];
      gcnt[w * stride + gp] = run;
      run += c;
    }
  }
  // in order: the valid slots are [0, bound) and their starts do not
  // decrease (else the general passes below)
  bool ordered = n_valid == bound;
  for (int p = threadIdx.x + 1; ordered && p < bound; p += kFrameThreads)
    if ((cst[p] & 0x03FFFFFF) < (cst[p - 1] & 0x03FFFFFF)) ordered = false;
  ordered = __syncthreads_and(ordered);
  if (ordered && warp < nseg) {
    uint32_t* place_of = gcnt + warp * stride;
    const uint32_t lt = (1u << lane) - 1u;
    const int lo = warp * seg_len, hi = min(bound, lo + seg_len);
    // the next chunk's loads in flight while a chunk is placed
    int32_t gp_next = lo + lane < hi ? grp[lo + lane] : 0;
    int32_t c_next = lo + lane < hi ? cst[lo + lane] : 0;
    for (int p0 = lo; p0 < hi; p0 += 32) {
      const bool in = p0 + lane < hi;
      const int32_t gp = gp_next, c = c_next;
      const int pn = p0 + 32 + lane;
      gp_next = pn < hi ? grp[pn] : 0;
      c_next = pn < hi ? cst[pn] : 0;
      const uint32_t peers = __match_any_sync(
          ~0u, in ? static_cast<uint32_t>(gp) : 0x80000000u | lane);
      const int leader = __ffs(peers) - 1;
      uint32_t place = 0;
      if (in && lane == leader) {
        place = place_of[gp];
        place_of[gp] = place + __popc(peers);
      }
      place = __shfl_sync(~0u, place, leader) + __popc(peers & lt);
      if (in) {
        a.s_start[row0 + place] = c & 0x03FFFFFF;
        a.s_len[row0 + place] = c >> 26;
        a.s_comp[row0 + place] = gp - 1;
      }
      __syncwarp();
    }
  }
  __shared__ int s_seg[kMaxSegs + 1];
  uint32_t* cnt = a.rcnt + static_cast<int64_t>(f) * kDigits * kFrameThreads;
  int32_t* pay = a.pay_a + row0;
  int32_t* alt = a.pay_b + row0;
  if (!ordered) {
    // the valid slots are no prefix or their starts decrease somewhere
    // (the wire is not in raster order): a stable sort by start, then by
    // group, of every slot
    for (int p = threadIdx.x; p < r; p += kFrameThreads) pay[p] = p;
    __syncthreads();
    for (int shift = 0; shift < 26; shift += 4) {
      radix_pass(cst, true, shift, pay, alt, r, cnt);
      int32_t* t = pay;
      pay = alt;
      alt = t;
    }
    for (int shift = 0; shift < 32 - __clz(n_comp + 1); shift += 4) {
      radix_pass(grp, false, shift, pay, alt, r, cnt);
      int32_t* t = pay;
      pay = alt;
      alt = t;
    }
    for (int p = threadIdx.x; p < r; p += kFrameThreads) {
      const int sl = pay[p];
      const int32_t c = cst[sl];
      const int32_t gp = grp[sl];
      a.s_start[row0 + p] = c & 0x03FFFFFF;
      a.s_len[row0 + p] = c >> 26;
      a.s_comp[row0 + p] = gp <= n_comp ? gp - 1 : -1;
    }
    return;
  }
  __syncthreads();
  // the padding's starts in slot order: the rest of cst (the valid slots
  // are a prefix; the padding's lengths are 0), cut into non-decreasing
  // segments
  const int n_pad = r - n_valid;
  const int32_t* pad = cst + n_valid;
  const int nwp = (n_pad + 31) >> 5;
  for (int wd = warp; wd < nwp; wd += kFrameWarps) {
    const int k = wd * 32 + lane;
    const uint32_t b = __ballot_sync(
        ~0u, k < n_pad && (k == 0 || pad[k] < pad[k - 1]));
    if (lane == 0) {
      bits[wd] = b;
      pre[wd] = __popc(b);
    }
  }
  __syncthreads();
  const int cuts = static_cast<int>(block_exclusive_scan(pre, nwp));
  if (cuts <= kMaxSegs) {
    for (int k = threadIdx.x; k < n_pad; k += kFrameThreads)
      if ((bits[k >> 5] >> (k & 31)) & 1u)
        s_seg[count_before(bits, pre, k)] = k;
    if (threadIdx.x == 0) s_seg[cuts] = n_pad;
    // the starts in shared memory where the group counts were
    const int32_t* sp = pad;
    if (in_shared) {
      int32_t* copy = reinterpret_cast<int32_t*>(gcnt);
      for (int k = threadIdx.x; k < n_pad; k += kFrameThreads)
        copy[k] = pad[k];
      sp = copy;
    }
    __syncthreads();
    // a start's place: its offset in its segment, the starts of the
    // segments before it that are not above it and those of the segments
    // after it that are below it
    for (int k = threadIdx.x; k < n_pad; k += kFrameThreads) {
      const int32_t v = sp[k];
      int own = 0;
      while (own + 1 < cuts && s_seg[own + 1] <= k) ++own;
      int place = n_valid + k - s_seg[own];
      for (int b = 0; b < cuts; ++b) {
        if (b == own) continue;
        int lo = s_seg[b], hi = s_seg[b + 1];
        const int first = lo;
        while (lo < hi) {
          const int mid = lo + ((hi - lo) >> 1);
          if (b < own ? sp[mid] <= v : sp[mid] < v)
            lo = mid + 1;
          else
            hi = mid;
        }
        place += lo - first;
      }
      a.s_start[row0 + place] = v;
      a.s_len[row0 + place] = 0;
      a.s_comp[row0 + place] = -1;
    }
    return;
  }
  // many segments: the padding's starts sorted in radix passes
  for (int k = threadIdx.x; k < n_pad; k += kFrameThreads) pay[k] = k;
  __syncthreads();
  for (int shift = 0; shift < 26; shift += 4) {
    radix_pass(pad, false, shift, pay, alt, n_pad, cnt);
    int32_t* t = pay;
    pay = alt;
    alt = t;
  }
  for (int k = threadIdx.x; k < n_pad; k += kFrameThreads) {
    a.s_start[row0 + n_valid + k] = pad[pay[k]];
    a.s_len[row0 + n_valid + k] = 0;
    a.s_comp[row0 + n_valid + k] = -1;
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

template <typename K>
cudaError_t frame_launch(K kernel, const void* args, size_t smem, int t,
                         cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  void* params[] = {const_cast<void*>(args)};
  return cudaLaunchKernel(reinterpret_cast<const void*>(kernel), dim3(t),
                          dim3(kFrameThreads), params, smem, s);
}

}  // namespace

extern "C" {

// the scratch of ysmr_run_prepare and, with the sorted runs, of
// ysmr_run_finish, in int32 words
int64_t ysmr_run_scratch_words(int t, int r, int finish) {
  const int64_t tr = static_cast<int64_t>(t) * r;
  if (finish)
    return 6 * tr + 4 * static_cast<int64_t>(t) +
           static_cast<int64_t>(t) * kDigits * kFrameThreads;
  const int64_t flags = static_cast<int64_t>(t) *
                        ((r + kPrepThreads - 1) / kPrepThreads);
  return 2 * tr + (flags + 3) / 4;
}

// runs: (T, R) int32 wire, counts: (T,) int32; out: ends (nd, 4, T, R)
// int32, oks (nd, 2, T, R) uint8, link (T, R) uint8 (the first dilation's
// chain), init (T, R) int32, valid (T, R) uint8; scratch:
// ysmr_run_scratch_words(t, r, 0) int32; nd 1 or 2 dilations d0, d1;
// weak: the marker
// reconstruction's init. 1 <= w <= 2^26, T <= 65535. Two launches.
// All on CUDA device `device`, launched on `stream`. Returns a
// cudaError_t (0 = launched).
int ysmr_run_prepare(const void* runs, const void* counts, void* ends,
                     void* oks, void* link, void* init, void* valid,
                     void* scratch, int t, int r, int w, int nd, int d0,
                     int d1, int weak, int device, void* stream) {
  if (t <= 0 || r <= 0) return 0;
  if (nd < 1 || nd > 2 || w < 1 || w > (1 << 26) || t > 65535)
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
// (T, R) int32, n_kept (T,) int32. R <= 2^19. Returns a cudaError_t.
int ysmr_run_compact(const void* runs, const void* counts, const void* lab4,
                     const void* const* ends8, const void* const* oks8,
                     void* init,
                     void* ends, void* oks, void* link, void* c_orig,
                     void* n_kept, int t, int r, int w, int device,
                     void* stream) {
  if (t <= 0 || r <= 0) return 0;
  if (w < 1 || w > (1 << 26) || r > (1 << 19))
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
  a.t = t;
  const size_t smem = 2 * sizeof(uint32_t) * ((r + 31) / 32);
  err = frame_launch(compact_kernel, &a, smem, t,
                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// runs, counts as above; lab8 (T, R) int32; c_orig (T, R) int32 and
// n_kept (T,) int32, both null for the identity compaction; steps4 (T,)
// (or null) and steps8 (T,) int32; out: run_comp (T, R), n_comp, n_px,
// cc_steps (T,) int32; with sorted runs s_start, s_len, s_comp (T, R)
// int32 (else null) and scratch of ysmr_run_scratch_words(t, r, 1) int32.
// R <= 2^19.
// Returns a cudaError_t.
int ysmr_run_finish(const void* runs, const void* counts, const void* lab8,
                    const void* c_orig, const void* n_kept,
                    const void* steps4, const void* steps8, void* run_comp,
                    void* n_comp, void* n_px, void* cc_steps, void* s_start,
                    void* s_len, void* s_comp, void* scratch, int t, int r,
                    int w, int device, void* stream) {
  if (t <= 0 || r <= 0) return 0;
  if (w < 1 || w > (1 << 26) || r > (1 << 19))
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
  a.s_start = static_cast<int32_t*>(s_start);
  a.s_len = static_cast<int32_t*>(s_len);
  a.s_comp = static_cast<int32_t*>(s_comp);
  const int64_t plane = static_cast<int64_t>(t) * r;
  int32_t* sc = static_cast<int32_t*>(scratch);
  if (sc) {
    a.grp = sc;
    a.cst = sc + plane;
    a.pay_a = sc + 2 * plane;
    a.pay_b = sc + 3 * plane;
    a.gcnt = reinterpret_cast<uint32_t*>(sc + 4 * plane);
    a.rcnt = a.gcnt + static_cast<int64_t>(t) * (2 * r + 4);
  }
  a.t = t;
  size_t smem = 2 * sizeof(uint32_t) * ((r + 31) / 32);
  if (s_start) {
    // the group counts where they fit beside the masks
    a.gcnt_shared = smem + sizeof(uint32_t) * (r + 2) <= 200 * 1024;
    if (a.gcnt_shared) smem += sizeof(uint32_t) * (r + 2);
  }
  err = frame_launch(finish_kernel, &a, smem, t,
                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
