// Connected components of sparse pixel tables, for `use table cc`: the
// function of ops/cc.py::cc_labels_at_pixels computed by the table CC of
// ysmr_tpu/ops/labeling.py::label_components_table (with
// compact_labels_table and the marker's segment maximum of
// ysmr_tpu/pipeline/detect_pixels.py:300-323). That route has no Pallas
// kernel: on a TPU it is plain XLA (a sort, searchsorted lookups, then up
// to max_iters rounds of gathers, minima and a pointer jump under a
// while_loop), and its torch form is the same hundreds of operations with
// a host sync a round.
//
// Per frame a table of F entries (lin = y*w + x, valid, marker) in any
// order; out, in table order, the keep flag (with the double threshold:
// the entry's 4-connected component of the valid entries holds a marker;
// without it: valid) and the label of every kept entry, the minimum lin
// of its 8-connected component among the kept entries (-1 for the
// others). No frame-sized array and no width cap.
//
// The wrapper hands over each frame's sorted keys: the lins sorted
// ascending by torch.sort with 2^30 at the invalid entries, and the sort's
// order (sorted slot -> table index), or the table itself with its valid
// flags where the caller knows the valid entries are a prefix in strictly
// ascending lin (every wire of the pipeline). Either way the valid slots
// are a prefix, and a run (slots whose lins follow one another in one
// image row) is a range of slots.
//
// Design: a union-find over the slots in tiles of 2048. A forest over a
// frame's slots is stored as distances (parent(x) = x - d[x], d = 0 at a
// root), as ysmr_cc_pixels in cc.cu keeps it; a union hooks the larger
// root under the smaller by an atomicMax on the distance, so each root is
// its component's first slot, whose lin is the minimum, and the labels do
// not depend on the schedule. The run is the unit of the searches and the
// unions: a thread a run in the tiles, and in the edges between tiles a
// warp's lanes split into segments (the lanes of one run) whose first lane
// alone searches. Five launches with the double threshold, three without
// (no memset):
//   - tcc_local (4-connected with the double threshold, 8-connected
//     without it): a block a tile, all in shared memory: its keys, its
//     runs (ballotted and compacted; the tile's first slot starts one),
//     each slot's run and a forest over the runs' first slots. A thread a
//     run finds its first upper candidate in the tile (a binary search of
//     the staged keys) and unites its first slot with that of the
//     candidate's run and of each run after it that starts in the range.
//     Every valid slot then points at its tile root in d (coalesced
//     stores), and a flag byte a slot (in the keep output until the last
//     launch) marks the tile roots, those whose tile component holds a
//     marker (double threshold) and the slots with diagonal records. The
//     runs whose row above lies in the tile record their partners: the
//     up-left one of a run's first pixel (the slot just before the first
//     upper candidate) in the forest's second plane, the up-right one of
//     its last pixel (the first slot past the candidate runs) in the
//     labels output, each where the pixel right above is not valid (else
//     the partner is 4-connected through it): only diagonals at a run's
//     ends can join two 4-connected components. Columns (lin mod w) by a
//     multiply and a shift;
//   - tcc_cross: the edges that leave a tile, in global memory: the
//     tile's first slots (those whose row above can reach before the tile)
//     unite with their upper candidates before it, found in a window of
//     keys staged in shared memory (the slots within two rows of the
//     tile's first lin, at most 2w, found by one warp's 32-way search;
//     where the window is longer than kWindow slots, wide dense rows, the
//     same launch reads the keys from global memory), and record their
//     partners; the tile's first slot unites with the slot before it where
//     a run goes on across the tile's start;
//   - tcc_compress_mark: each tile root walks to its 4-connected root,
//     points straight at it and, where its tile component holds a marker,
//     sets the root's mark bit (one atomicOr a tile component, none where
//     the root already has it); a thread reads four slots' flags;
//   - tcc_diagonals (the same threads): each slot with a record, where its
//     run is kept, unites with its partner where that is kept, in the same
//     forest: the
//     8-connected components of the kept slots are unions of kept
//     4-connected components, so the forest grows in place and a kept
//     component's root keeps a mark bit (a dropped component is never
//     touched);
//   - tcc_final: every slot walks to its root (two hops: its tile root,
//     then the root, addresses a warp mostly shares; four slots a thread,
//     the walks interleaved) and writes the root's lin, or -1, and keep, at
//     its table index.
// ysmr_tpu stops after max_iters rounds; this kernel always reaches the
// fixpoint (ROADMAP's "Differences from ysmr_tpu"). It needs H * W < 2^30,
// where the invalid entries' 2^30 would collide with a lin.
// Bound: the tables, the valid flags and both outputs at every slot (int32
// label, keep byte) and the lin (and marker) at the valid slots, ~5.4 MB
// per 64 x 8192 bench batch (~1.6 us) and ~83 MB at F = 131072 (~25 us);
// the sorted route adds the sort and 8 bytes a slot of its order. The
// kernels also move the forest (4 bytes a valid slot, written and read,
// and the walks), the flags and the keys again, and spend most of their
// time issuing the tiles' searches and unions (PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                    // the per-slot launches
constexpr int kLocalThreads = 512;
constexpr int kCrossThreads = 128;
constexpr int kTile = 2048;                      // slots a tile
constexpr int kWindow = 2048;                    // tcc_cross: staged slots
constexpr int kFlagSlots = 4;                    // compress, diagonals
constexpr int kFinalSlots = 4;
constexpr int32_t kSentinel = 1 << 30;           // an invalid entry's key
constexpr int32_t kFar = -(1 << 30);             // a slot before the window
constexpr int32_t kDist = 0x7fffffff;            // d[x] without the mark bit
constexpr int32_t kMark = static_cast<int32_t>(0x80000000u);
constexpr unsigned kFull = 0xffffffffu;
// a slot's flag byte in the keep output until tcc_final: a tile root, its
// tile component holds a marker, an up-left record, an up-right record
constexpr uint8_t kRootFlag = 1, kMarkFlag = 2, kUlFlag = 4, kUrFlag = 8;

// n / w and n % w for 0 <= n < 2^31 by a multiply and a shift: q =
// n * m >> (31 + l) with l = ceil(log2 w), m = ceil(2^(31 + l) / w) <
// 2^32 (the error n * (m - 2^(31 + l) / w) / 2^(31 + l) < 1 / w)
struct Div {
  int32_t w;
  uint32_t m;
  int l;
};

__device__ __forceinline__ int32_t col(const Div& D, int32_t n) {
  const int32_t q = static_cast<int32_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(n)) * D.m) >> (31 + D.l));
  return n - q * D.w;
}

// the root of slot x in a distance forest; *raw is the root's entry (its
// mark bit). Only roots carry a mark bit, and a marked root that is hooked
// loses it, so the walk ends at a current root.
__device__ __forceinline__ int32_t root_of(const volatile int32_t* d,
                                           int32_t x, int32_t* raw) {
  int32_t v = d[x];
  while ((v & kDist) != 0) {
    x -= v & kDist;
    v = d[x];
  }
  *raw = v;
  return x;
}

// the root of slot x; a walk of more than one hop points x straight at the
// root it found (an atomicMax: a parent only ever moves to a smaller
// ancestor, so a concurrent hook is kept)
__device__ __forceinline__ int32_t find(int32_t* d, int32_t x) {
  const volatile int32_t* v = d;
  int32_t s = v[x] & kDist;
  if (s == 0) return x;
  int32_t r = x - s;
  s = v[r] & kDist;
  if (s == 0) return r;
  while (s != 0) {
    r -= s;
    s = v[r] & kDist;
  }
  atomicMax(d + x, x - r);
  return r;
}

// unites the trees of slots a and b of one frame's forest d: link the
// larger root a under b by raising d[a] to a - b (a marked root's entry is
// negative, so the link replaces it); if a stopped being a root meanwhile,
// its new parent still has to join b. Parents are read through a volatile
// pointer (no stale L1 line survives another block's atomic); a stale
// read still names an ancestor, because parents only decrease within one
// tree. The same code unites in a tile's forest in shared memory.
__device__ void unite(int32_t* d, int32_t a, int32_t b) {
  while (true) {
    a = find(d, a);
    b = find(d, b);
    if (a == b) return;
    if (a < b) {
      const int32_t t = a;
      a = b;
      b = t;
    }
    const int32_t old = atomicMax(d + a, a - b);
    if ((old & kDist) == 0) return;
    a -= old;
  }
}

__device__ __forceinline__ bool slot_valid(const int32_t* __restrict__ keys,
                                           const uint8_t* __restrict__ valid,
                                           int32_t i) {
  return valid != nullptr ? valid[i] != 0 : keys[i] < kSentinel;
}

// a frame's keys as tcc_cross reads them: slots [ws, we) from the staged
// window (all valid), the others from global memory (kSentinel at an
// invalid slot); with the halo staged, a slot before the window lies more
// than two rows before the tile and reads as kFar
struct Window {
  const int32_t* k;
  const uint8_t* v;
  const int32_t* s;
  int32_t ws, we;
  bool staged;
  __device__ __forceinline__ int32_t operator()(int32_t j) const {
    if (j >= ws && j < we) return s[j - ws];
    if (j < ws && staged) return kFar;
    return slot_valid(k, v, j) ? k[j] : kSentinel;
  }
};

// the keys of a tile in shared memory (slots t0 - 1 .. t1)
struct TileKeys {
  const int32_t* s;
  int32_t t0;
  __device__ __forceinline__ int32_t operator()(int32_t j) const {
    return s[j - t0 + 1];
  }
};

// first slot in [lo, hi) whose key is >= v, hi if none
template <typename Key>
__device__ __forceinline__ int32_t lower_bound(const Key& key, int32_t lo,
                                               int32_t hi, int32_t v) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (key(mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// the first slot in [lo, hi) whose key is >= v (hi if none; an invalid
// slot counts as past v), by the 32 lanes of a warp, 32 probes a round
__device__ __forceinline__ int32_t warp_lower_bound(
    const int32_t* __restrict__ k, const uint8_t* __restrict__ valid,
    int32_t lo, int32_t hi, int32_t v, int lane) {
  while (lo < hi) {
    const int32_t step = (hi - lo + 31) / 32;
    const int32_t q = lo + step * (lane + 1) - 1;
    const unsigned below = __ballot_sync(
        kFull, q < hi && slot_valid(k, valid, q) && k[q] < v);
    const int32_t c = __popc(below);
    const int32_t nlo = min(lo + step * c, hi);
    hi = min(hi, lo + step * (c + 1) - 1);
    lo = nlo;
  }
  return lo;
}

// the segments of a warp: the lanes of one run (a lane continues its left
// lane when its slot does). s: the first lane of this lane's segment, e:
// the last; members are a prefix of the lanes.
__device__ __forceinline__ void segments(bool member, bool left, int lane,
                                         int* s, int* e) {
  const unsigned members = __ballot_sync(kFull, member);
  const unsigned cont = __ballot_sync(kFull, left && lane > 0);
  const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
  *s = max(31 - __clz(members & ~cont & upto), 0);
  const unsigned after = ~cont & ~upto;
  *e = (after != 0u ? __ffs(after) - 1 : 32) - 1;
}

// One warp segment of a run in tcc_cross (first slot i_s, key lin_s, column
// x_s; last key lin_e): its first upper candidate from slot lo_slot on,
// found by the segment's first lane and shared, and its diagonal records. The
// 4-connected candidates start past the up-left partner. ul: the up-left
// partner of the run's first slot (the slot just before the first upper
// candidate), ur: the up-right one of its last slot (the slot just after
// the last candidate), each kept only where the pixel right above is not
// valid (else it is 4-connected through it), -1 otherwise.
struct Segment {
  int32_t p4, hi, row_up;
};

template <int kConn, typename Key>
__device__ __forceinline__ Segment upper(const Key& key, bool lead,
                                         bool run_start, int32_t i_s,
                                         int32_t lin_s, int32_t x_s,
                                         int32_t lin_e, int32_t lo_slot,
                                         int s, int w, int32_t* ul) {
  const int32_t x_e = x_s + (lin_e - lin_s);
  const bool up_left = x_s > 0 && (kConn == 8 || run_start);
  int32_t p = i_s;
  if (lead && lin_s >= w) {
    p = lower_bound(key, max(i_s - w - 1, lo_slot), i_s,
                    lin_s - w - (up_left ? 1 : 0));
  }
  p = __shfl_sync(kFull, p, s);
  Segment g{p, lin_e - w + ((kConn == 8 && x_e < w - 1) ? 1 : 0),
            lin_s - x_s - w};
  *ul = -1;
  if (kConn == 4 && up_left && lin_s >= w && p < i_s &&
      key(p) == lin_s - w - 1) {
    g.p4 = p + 1;
    if (!(g.p4 < i_s && key(g.p4) == lin_s - w)) *ul = p;
  }
  return g;
}

template <typename Key>
__device__ __forceinline__ int32_t up_right(const Key& key, int32_t p4,
                                            int32_t i_s, int32_t lin_e,
                                            int w) {
  const int32_t want = lin_e - w + 1;
  const int32_t q = lower_bound(key, p4, i_s, want);
  if (q < i_s && key(q) == want && (q == 0 || key(q - 1) != want - 1)) {
    return q;
  }
  return -1;
}

// tcc_local: a block a tile of kTile slots, all in shared memory:
// the tile's keys (and the slots just before and after it), its runs (the
// first slot of each, in order; the tile's first slot starts one), each
// slot's run and a forest over the runs' first slots. Step 1: the slots
// that start a run are ballotted and compacted. Step 2: a thread a run
// writes its slots' run. Step 3: a thread a run finds its first upper
// candidate in the tile (a binary search of the staged keys) and unites
// its first slot with that of each run above that holds a candidate (the
// candidate's run, then the runs that follow while they start in the
// range); the runs whose row above lies in the tile record their diagonal
// partners (rec_ul at the run's first slot, rec_ur at its last; only
// where there is one). Step 4: every valid slot of the tile points at its
// tile root in d, and its flag byte says whether it is a root (with the
// double threshold: whether its tile component holds a marker) and has
// records. The edges to the slots before the tile are tcc_cross's.
template <int kConn>
__global__ void __launch_bounds__(kLocalThreads)
tcc_local(const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
          const int64_t* __restrict__ order,
          const uint8_t* __restrict__ marker, int32_t* __restrict__ d,
          int32_t* __restrict__ rec_ul, int32_t* __restrict__ rec_ur,
          uint8_t* __restrict__ flags, int t, int f, Div D) {
  constexpr bool kRecord = kConn == 4;    // the double threshold's records
  constexpr int kWarpsL = kLocalThreads / 32;
  constexpr int kPasses = kTile / kLocalThreads;
  constexpr int kCounts = kPasses * kWarpsL;
  static_assert(kCounts <= 64, "one warp scans the counts, two a lane");
  __shared__ int32_t s_key[kTile + 2];     // slots t0 - 1 .. t1
  __shared__ int32_t s_par[kTile];         // the forest, at the runs' first
  __shared__ int16_t s_rid[kTile];         // each slot's run
  __shared__ int16_t s_run[kTile + 1];     // each run's first slot - t0
  __shared__ uint8_t s_bits[kTile];
  __shared__ int32_t s_cnt[kCounts];
  __shared__ int32_t s_nrun, s_nvalid;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int w = D.w;
  const int32_t t0 = static_cast<int32_t>(blockIdx.x) * kTile;
  const int32_t t1 = min(t0 + kTile, f);
  const TileKeys key{s_key, t0};
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    const int32_t* k = keys + base;
    const uint8_t* v = valid != nullptr ? valid + base : nullptr;
    if (!slot_valid(k, v, t0)) continue;   // past the valid prefix
    __syncthreads();                       // the last frame's tile is read
    for (int32_t j = threadIdx.x; j < t1 - t0 + 2; j += kLocalThreads) {
      const int32_t g = t0 - 1 + j;
      s_key[j] = g < 0 ? kFar
                       : (g < f && slot_valid(k, v, g) ? k[g] : kSentinel);
      if (j < t1 - t0) {
        s_par[j] = 0;
        s_bits[j] = 0;
      }
    }
    __syncthreads();
    const int32_t kt = key(t0);
    // step 1: the runs' first slots, compacted in slot order
    unsigned starts[kPasses];
    int32_t n_valid = 0;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      const int32_t i =
          t0 + q * kLocalThreads + static_cast<int32_t>(threadIdx.x);
      const int32_t lin = i < t1 ? key(i) : kSentinel;
      const bool member = lin < kSentinel;
      const bool start = member && (i == t0 || col(D, lin) == 0 ||
                                    key(i - 1) != lin - 1);
      starts[q] = __ballot_sync(kFull, start);
      n_valid += __popc(__ballot_sync(kFull, member));
      if (lane == 0) s_cnt[q * kWarpsL + warp] = __popc(starts[q]);
    }
    if (threadIdx.x == 0) s_nvalid = 0;
    __syncthreads();
    if (lane == 0) atomicAdd(&s_nvalid, n_valid);
    if (warp == 0) {
      // exclusive scan of the counts in (pass, warp) order, 2 a lane
      const int32_t a = 2 * lane < kCounts ? s_cnt[2 * lane] : 0;
      const int32_t b = 2 * lane + 1 < kCounts ? s_cnt[2 * lane + 1] : 0;
      int32_t x = a + b;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      if (2 * lane < kCounts) s_cnt[2 * lane] = x - a - b;
      if (2 * lane + 1 < kCounts) s_cnt[2 * lane + 1] = x - b;
      if (lane == 31) s_nrun = x;
    }
    __syncthreads();
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int q = 0; q < kPasses; ++q) {
      if ((starts[q] >> lane) & 1u) {
        s_run[s_cnt[q * kWarpsL + warp] + __popc(starts[q] & below)] =
            static_cast<int16_t>(q * kLocalThreads + threadIdx.x);
      }
    }
    __syncthreads();
    const int n_run = s_nrun;
    const int32_t nv = s_nvalid;           // the tile's valid slots
    if (threadIdx.x == 0) s_run[n_run] = static_cast<int16_t>(nv);
    // step 2: each slot's run
    for (int r = threadIdx.x; r < n_run; r += kLocalThreads) {
      const int a = s_run[r];
      const int b = r + 1 < n_run ? s_run[r + 1] : nv;
      for (int j = a; j < b; ++j) s_rid[j] = static_cast<int16_t>(r);
    }
    __syncthreads();
    // step 3: a thread a run
    for (int r = threadIdx.x; r < n_run; r += kLocalThreads) {
      const int32_t i_s = t0 + s_run[r];
      const int32_t i_e = t0 + (r + 1 < n_run ? s_run[r + 1] : nv) - 1;
      const int32_t lin_s = key(i_s), lin_e = key(i_e);
      if (lin_s < w) continue;             // the frame's first row
      const int32_t x_s = col(D, lin_s);
      const int32_t x_e = x_s + (lin_e - lin_s);
      // the run goes on from the tile before: its first slot is not here
      const bool run_start = !(r == 0 && x_s > 0 && key(i_s - 1) == lin_s - 1);
      const bool up_left = x_s > 0 && (kConn == 8 || run_start);
      const int32_t lo_lin = lin_s - w - (up_left ? 1 : 0);
      int32_t p = lower_bound(key, max(i_s - w - 1, t0), i_s, lo_lin);
      if (kConn == 4 && up_left && p < i_s && key(p) == lin_s - w - 1) {
        // the up-left partner, 4-connected where the pixel above is valid
        if (kRecord && run_start && lin_s - w - 1 >= kt &&
            !(p + 1 < i_s && key(p + 1) == lin_s - w)) {
          rec_ul[base + i_s] = p;
          s_bits[i_s - t0] |= kUlFlag;
        }
        ++p;
      }
      const int32_t hi = lin_e - w + ((kConn == 8 && x_e < w - 1) ? 1 : 0);
      // the runs above that hold a candidate: p's run and those after it
      // that start at most at hi; q: the first slot past the candidates
      int32_t q = p;
      if (p < i_s && key(p) <= hi) {
        int rr = s_rid[p - t0];
        unite(s_par, s_run[rr], s_run[r]);
        int32_t next = t0 + s_run[rr + 1];
        while (next < i_s && key(next) <= hi) {
          ++rr;
          unite(s_par, s_run[rr], s_run[r]);
          next = t0 + s_run[rr + 1];
        }
        // past the last candidate run, unless it goes on past hi (then the
        // pixel above the run's last one is valid: no up-right record)
        q = key(next - 1) > hi ? i_s : next;
      }
      if (kRecord && x_e < w - 1 && lin_e - w - 1 >= kt &&
          key(i_e + 1) != lin_e + 1 && q < i_s && key(q) == lin_e - w + 1 &&
          key(q - 1) != lin_e - w) {
        rec_ur[base + i_e] = q;
        s_bits[i_e - t0] |= kUrFlag;
      }
    }
    __syncthreads();
    // step 4: the tile roots, the marks of the tile components, then the
    // forest and the flags
    for (int32_t j = threadIdx.x; j < nv; j += kLocalThreads) {
      int32_t x = s_run[s_rid[j]], sx = s_par[x];
      while (sx != 0) {
        x -= sx;
        sx = s_par[x];
      }
      s_key[j + 1] = x;                    // the keys are read no more
      if (kRecord && marker[base + (order != nullptr ? order[base + t0 + j]
                                                     : t0 + j)]) {
        s_bits[x] |= kMarkFlag;            // the same value from any thread
      }
    }
    __syncthreads();
    for (int32_t j = threadIdx.x; j < t1 - t0; j += kLocalThreads) {
      uint8_t fl = 0;
      if (j < nv) {
        const int32_t x = s_key[j + 1];
        d[base + t0 + j] = j - x;
        fl = (s_bits[j] & (kUlFlag | kUrFlag)) |
             (x == j ? kRootFlag | (s_bits[j] & kMarkFlag) : 0);
      }
      flags[base + t0 + j] = fl;
    }
  }
}

// tcc_cross: the edges from a tile's first slots to the slots before it,
// in global memory, after tcc_local (every valid slot points into its
// tile's forest). A block a tile: one warp finds the window's first slot
// (the first within two rows of the tile's first lin, among the 2w slots
// before it), another the end of the tile's cross slots (the slots whose
// row above can reach before the tile: lin < the tile's first lin + w +
// 1); the window between them is staged in shared memory where it fits
// (kWindow slots; else every key is read from global memory). The
// segments of the cross slots unite with their upper candidates before
// the tile, and record the diagonal partners of the runs that start or
// end there; the tile's first slot unites with the slot before it where
// a run goes on across the tile's start.
template <int kConn>
__global__ void __launch_bounds__(kCrossThreads)
tcc_cross(const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
          int32_t* d, int32_t* __restrict__ rec_ul,
          int32_t* __restrict__ rec_ur, uint8_t* __restrict__ flags, int t,
          int f, Div D) {
  constexpr bool kRecord = kConn == 4;
  __shared__ int32_t win[kWindow];
  __shared__ int32_t s_ws, s_te;
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int w = D.w;
  const int32_t t0 = static_cast<int32_t>(blockIdx.x) * kTile;
  const int32_t t1 = min(t0 + kTile, f);
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    const int32_t* k = keys + base;
    const uint8_t* v = valid != nullptr ? valid + base : nullptr;
    int32_t* df = d + base;
    if (!slot_valid(k, v, t0)) continue;   // past the valid prefix
    __syncthreads();                       // the last frame's window is read
    const int32_t kt = k[t0];
    if (warp == 0) {
      const int32_t ws = warp_lower_bound(k, v, max(t0 - 2 * w, 0), t0,
                                          kt - 2 * w, lane);
      if (lane == 0) s_ws = ws;
    } else if (warp == 1) {
      const int32_t te = warp_lower_bound(k, v, t0, min(t0 + w + 1, t1),
                                          kt + w + 1, lane);
      if (lane == 0) s_te = te;
    }
    __syncthreads();
    const int32_t te = s_te;
    const bool staged = te - s_ws <= kWindow;
    const int32_t ws = staged ? s_ws : te;
    for (int32_t j = threadIdx.x; j < te - ws; j += kCrossThreads) {
      win[j] = k[ws + j];                  // slots below te are valid
    }
    __syncthreads();
    const Window key{k, v, win, ws, te, staged};
    const int32_t floor_slot = staged ? ws : 0;
    if (threadIdx.x == 0 && t0 > 0 && col(D, kt) > 0 && k[t0 - 1] == kt - 1) {
      unite(df, t0, t0 - 1);               // a run across the tile's start
    }
    for (int32_t i0 = t0; i0 < te; i0 += kCrossThreads) {
      const int32_t wi = i0 + (static_cast<int32_t>(threadIdx.x) & ~31);
      if (wi >= te) break;
      const int32_t i = wi + lane;
      const bool member = i < te;
      const int32_t lin = member ? key(i) : 0;
      const int32_t x = member ? col(D, lin) : 0;
      const bool left = member && x > 0 && i > 0 && key(i - 1) == lin - 1;
      int s, e;
      segments(member, left, lane, &s, &e);
      const int32_t i_s = i - (lane - s);
      const int32_t lin_s = __shfl_sync(kFull, lin, s);
      const int32_t x_s = __shfl_sync(kFull, x, s);
      const int32_t lin_e = __shfl_sync(kFull, lin, e);
      const bool left_s = __shfl_sync(kFull, left, s);
      int32_t ul;
      const Segment g = upper<kConn>(
          key, member && lane == s, !left_s, i_s, lin_s, x_s, lin_e,
          floor_slot, s, w, &ul);
      if (!member) continue;
      if (kRecord && lane == s && !left_s && ul >= 0) {
        rec_ul[base + i_s] = ul;
        flags[base + i_s] |= kUlFlag;
      }
      if (kRecord && lane == e && lin_s >= w &&
          x_s + (lin_e - lin_s) < w - 1 &&
          (i + 1 >= f || key(i + 1) != lin_e + 1)) {
        const int32_t ur = up_right(key, g.p4, i_s, lin_e, w);
        if (ur >= 0) {
          rec_ur[base + i] = ur;
          flags[base + i] |= kUrFlag;
        }
      }
      if (lin_s < w) continue;             // the frame's first row
      const int len = e - s + 1;
      for (int32_t j = g.p4 + (lane - s); j < min(i_s, t0); j += len) {
        const int32_t kj = key(j);
        if (kj > g.hi) break;
        if (j == g.p4 || kj == g.row_up || key(j - 1) != kj - 1) {
          unite(df, i_s, j);
        }
      }
    }
  }
}

// each tile root points straight at its 4-connected root, and sets the
// root's mark bit where its tile component holds a marker (one atomicOr
// a tile component, none where the root already has it; roots change only
// by the atomics, and a walk that reads a slot before or after its
// rewrite meets an ancestor either way). A thread kFlagSlots slots' flags.
__global__ void __launch_bounds__(kThreads)
tcc_compress_mark(const uint8_t* __restrict__ flags, int32_t* d,
                  const int32_t* __restrict__ keys,
                  const uint8_t* __restrict__ valid, int t, int f) {
  const int32_t i0 = (static_cast<int32_t>(blockIdx.x) * kThreads +
                      static_cast<int32_t>(threadIdx.x)) * kFlagSlots;
  if (i0 >= f) return;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    // the flags of a tile past the valid prefix were never written
    if (!slot_valid(keys + base, valid != nullptr ? valid + base : nullptr,
                    i0 - i0 % kTile)) {
      continue;
    }
    int32_t* df = d + base;
    for (int32_t i = i0; i < min(i0 + kFlagSlots, f); ++i) {
      const uint8_t fl = flags[base + i];
      if ((fl & kRootFlag) == 0) continue;
      int32_t raw;
      const int32_t r = root_of(df, i, &raw);
      if (r != i) df[i] = i - r;
      if ((fl & kMarkFlag) != 0 && (raw & kMark) == 0) {
        atomicOr(df + r, kMark);
      }
    }
  }
}

// each kept run end unites with its recorded diagonal partner where that
// is kept (rec_ul in the forest's second plane, rec_ur in the labels
// output), in the same forest; a thread kFlagSlots slots' flags
__global__ void __launch_bounds__(kThreads)
tcc_diagonals(const uint8_t* __restrict__ flags,
              const int32_t* __restrict__ rec_ul,
              const int32_t* __restrict__ rec_ur, int32_t* d,
              const int32_t* __restrict__ keys,
              const uint8_t* __restrict__ valid, int t, int f) {
  const int32_t i0 = (static_cast<int32_t>(blockIdx.x) * kThreads +
                      static_cast<int32_t>(threadIdx.x)) * kFlagSlots;
  if (i0 >= f) return;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    if (!slot_valid(keys + base, valid != nullptr ? valid + base : nullptr,
                    i0 - i0 % kTile)) {
      continue;
    }
    int32_t* df = d + base;
    for (int32_t i = i0; i < min(i0 + kFlagSlots, f); ++i) {
      const uint8_t fl = flags[base + i];
      if ((fl & (kUlFlag | kUrFlag)) == 0) continue;
      int32_t raw;
      root_of(df, i, &raw);
      if ((raw & kMark) == 0) continue;    // the run is dropped
      for (int side = 0; side < 2; ++side) {
        if ((fl & (side == 0 ? kUlFlag : kUrFlag)) == 0) continue;
        const int32_t p = side == 0 ? rec_ul[base + i] : rec_ur[base + i];
        const int32_t r = root_of(df, p, &raw);
        if ((raw & kMark) != 0) unite(df, i, r);
      }
    }
  }
}

// the label (the root's lin) and keep of each slot, at its table index;
// marks: the double threshold (keep = the root's mark). A thread
// kFinalSlots slots kThreads apart, their walks interleaved (a warp's
// walks mostly share their addresses).
__global__ void __launch_bounds__(kThreads)
tcc_final(const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
          const int64_t* __restrict__ order, const int32_t* __restrict__ d,
          int32_t* __restrict__ labels, uint8_t* __restrict__ keep, int t,
          int f, int marks) {
  const int32_t i0 = static_cast<int32_t>(blockIdx.x) * kThreads *
                         kFinalSlots + static_cast<int32_t>(threadIdx.x);
  if (i0 >= f) return;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    const int32_t* k = keys + base;
    const uint8_t* v = valid != nullptr ? valid + base : nullptr;
    const volatile int32_t* df = d + base;
    int32_t x[kFinalSlots], val[kFinalSlots];
    bool ok[kFinalSlots];
#pragma unroll
    for (int q = 0; q < kFinalSlots; ++q) {
      const int32_t i = i0 + q * kThreads;
      ok[q] = i < f && slot_valid(k, v, i);
      x[q] = i;
      val[q] = ok[q] ? df[i] : 0;
    }
    // one hop a round for every slot still walking
    bool walking = true;
    while (walking) {
      walking = false;
#pragma unroll
      for (int q = 0; q < kFinalSlots; ++q) {
        if ((val[q] & kDist) != 0) {
          x[q] -= val[q] & kDist;
          val[q] = df[x[q]];
          walking = true;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kFinalSlots; ++q) {
      const int32_t i = i0 + q * kThreads;
      if (i >= f) continue;
      const bool kept = ok[q] && (!marks || (val[q] & kMark) != 0);
      const int64_t ti = base + (order != nullptr ? order[base + i] : i);
      labels[ti] = kept ? k[x[q]] : -1;
      keep[ti] = kept ? 1 : 0;
    }
  }
}

}  // namespace

extern "C" {

// keys: (T, F) int32, each row's lins sorted ascending with 2^30 at the
// invalid entries (valid and order then given: order (T, F) int64, the
// table index of each sorted slot; valid null), or the table itself
// (valid (T, F) uint8 flags whose set entries are a prefix in strictly
// ascending lin; order null); marker: (T, F) uint8 in table order (read
// with the double threshold only); forest: (2, T, F) int32 scratch with
// the double threshold (the forest and the up-left records), (1, T, F)
// without; labels: (T, F) int32 out (the up-right records until the last
// launch) and keep: (T, F) uint8 out (the slots' flags until the last
// launch), in table order. H * W < 2^30 (the wrapper checks). Returns a
// cudaError_t (0 = launched).
int ysmr_table_cc(const void* keys, const void* valid, const void* order,
                  const void* marker, void* forest, void* labels, void* keep,
                  int t, int f, int w, int double_threshold, int device,
                  void* stream) {
  if (t <= 0 || f <= 0) return 0;
  if (w <= 0 || w >= (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(t) * f;
  const int32_t* k = static_cast<const int32_t*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int64_t* o = static_cast<const int64_t*>(order);
  const uint8_t* mk = static_cast<const uint8_t*>(marker);
  int32_t* d = static_cast<int32_t*>(forest);
  int32_t* lab = static_cast<int32_t*>(labels);
  uint8_t* fl = static_cast<uint8_t*>(keep);
  Div D{w, 0, 0};
  while ((1 << D.l) < w) ++D.l;
  D.m = static_cast<uint32_t>(((uint64_t{1} << (31 + D.l)) + w - 1) / w);
  const unsigned ty = static_cast<unsigned>(t < 65535 ? t : 65535);
  const dim3 tiles(static_cast<unsigned>((f + kTile - 1) / kTile), ty);
  const int per_flags = kThreads * kFlagSlots;
  const int per_final = kThreads * kFinalSlots;
  const dim3 flag_slots(static_cast<unsigned>((f + per_flags - 1) / per_flags),
                        ty);
  const dim3 final_slots(
      static_cast<unsigned>((f + per_final - 1) / per_final), ty);
  if (double_threshold) {
    int32_t* rec_ul = d + total;
    tcc_local<4><<<tiles, kLocalThreads, 0, s>>>(k, v, o, mk, d, rec_ul, lab,
                                                 fl, t, f, D);
    tcc_cross<4><<<tiles, kCrossThreads, 0, s>>>(k, v, d, rec_ul, lab, fl, t,
                                                 f, D);
    tcc_compress_mark<<<flag_slots, kThreads, 0, s>>>(fl, d, k, v, t, f);
    tcc_diagonals<<<flag_slots, kThreads, 0, s>>>(fl, rec_ul, lab, d, k, v, t,
                                                  f);
  } else {
    tcc_local<8><<<tiles, kLocalThreads, 0, s>>>(
        k, v, o, mk, d, nullptr, nullptr, fl, t, f, D);
    tcc_cross<8><<<tiles, kCrossThreads, 0, s>>>(
        k, v, d, nullptr, nullptr, fl, t, f, D);
  }
  tcc_final<<<final_slots, kThreads, 0, s>>>(k, v, o, d, lab, fl, t, f,
                                             double_threshold);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
