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
// others). No frame-sized array and no width cap. Design, a memset and
// four launches with the double threshold (a memset and two without):
//   - the wrapper hands over each frame's sorted keys: the lins sorted
//     ascending by torch.sort with 2^30 at the invalid entries, and the
//     sort's order (sorted slot -> table index), or the table itself with
//     its valid flags where the caller knows the valid entries are a
//     prefix in strictly ascending lin (every wire of the pipeline); in
//     both cases a valid slot's predecessors are all valid;
//   - a forest over a frame's sorted slots is stored as distances
//     (parent(x) = x - d[x], d = 0 at a root; the zeroed array is the
//     forest of singletons), as ysmr_cc_pixels in cc.cu keeps it; a union
//     hooks the larger root under the smaller by an atomicMax on the
//     distance (an atomicMin on the parent), so each root is its
//     component's first slot, whose lin is the minimum, and the labels do
//     not depend on the schedule;
//   - tcc_merge (4-connected with the double threshold, 8-connected
//     without it): a thread a slot; each edge is taken at its later end
//     (left, and the row above). The lanes of a warp split into segments,
//     the lanes of one horizontal run (a slot continues its left lane when
//     its lin is one more); a segment's lanes hook under its first slot,
//     and its first lane, alone, finds the run's upper neighbours: a binary
//     search for the first lin >= lin_s - w (- 1 with 8-connectivity)
//     among the w + 1 slots before it (the lins in between are distinct
//     integers of one row's span). The candidate slots up to lin_e - w
//     (+ 1) are shared out over its lanes; only the first of each run
//     above is united with the lane's slot (that run's own threads unite
//     the rest). A find of more than one hop points its slot straight at
//     the root;
//   - tcc_compress_mark: each valid slot points straight at its
//     4-connected root, in the 4-connected forest and in the 8-connected
//     one, which starts as it; a marker entry sets the root's mark bit
//     (a kept slot: its root's mark, two loads);
//   - tcc_diagonals: a kept run's first pixel unites with its kept
//     up-left pixel, its last with its up-right one (one lower bound
//     each), in the 8-connected forest: the only edges that can join two
//     4-connected components, whose pixels are all kept or all dropped;
//   - tcc_final: the lin of the 8-connected root, or -1, and keep,
//     written at the slot's table index.
// ysmr_tpu stops after max_iters rounds; this kernel always reaches the
// fixpoint (ROADMAP's "Differences from ysmr_tpu"). It needs H * W < 2^30,
// where the invalid entries' 2^30 would collide with a lin.
// Bound: the tables, 6 bytes a slot in (lin int32, valid and marker
// bytes) and 5 out (int32 label, keep byte), ~5.8 MB per 64 x 8192 batch
// (~1.7 us) and ~92 MB at F = 131072 (~28 us); the sorted route adds the
// sort and 8 bytes a slot of its order. The kernels read more: the
// forests (8 bytes a slot), about log2(w + 2) dependent loads of a lower
// bound a run segment and a run end, and the root walks: dependent loads,
// so latency, not bytes, sets the time (0.70 ms dense, PERF.md section 6).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kSentinel = 1 << 30;           // an invalid entry's key
constexpr int32_t kDist = 0x7fffffff;            // d[x] without the mark bit
constexpr int32_t kMark = static_cast<int32_t>(0x80000000u);

// root of slot x in a distance forest (parent(x) = x - (d[x] & kDist))
__device__ __forceinline__ int32_t root_of(const volatile int32_t* d,
                                           int32_t x) {
  int32_t s = d[x] & kDist;
  while (s != 0) {
    x -= s;
    s = d[x] & kDist;
  }
  return x;
}

// the root of slot x in a forest without marks; a walk of more than one
// hop points x straight at the root it found (an atomicMax: a parent only
// ever moves to a smaller ancestor, so a concurrent hook is kept)
__device__ __forceinline__ int32_t find(int32_t* d, int32_t x) {
  const volatile int32_t* v = d;
  const int32_t s0 = v[x];
  if (s0 == 0) return x;
  int32_t r = x - s0;
  int32_t s = v[r];
  if (s == 0) return r;
  while (s != 0) {
    r -= s;
    s = v[r];
  }
  atomicMax(d + x, x - r);
  return r;
}

// unites the trees of slots a and b of one frame's forest d (no marks):
// link the larger root a under b by raising d[a] to a - b; if a stopped
// being a root meanwhile, its new parent still has to join b. Parents are
// read through a volatile pointer (no stale L1 line survives another
// block's atomic); a stale read still names an ancestor, because parents
// only decrease within one tree.
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
    if (old == 0) return;
    a -= old;
  }
}

__device__ __forceinline__ bool slot_valid(const int32_t* __restrict__ keys,
                                           const uint8_t* __restrict__ valid,
                                           int32_t i) {
  return valid != nullptr ? valid[i] != 0 : keys[i] < kSentinel;
}

// a slot is kept when its 4-connected root carries the mark bit; after
// tcc_compress_mark every valid slot points straight at its root
__device__ __forceinline__ bool kept4(const int32_t* __restrict__ d4,
                                      int32_t j) {
  const int32_t r = j - (d4[j] & kDist);
  return (d4[r] & kMark) != 0;
}

// first slot in [lo, hi) whose key is >= v, hi if none
__device__ __forceinline__ int32_t lower_bound(
    const int32_t* __restrict__ keys, int32_t lo, int32_t hi, int32_t v) {
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// frame-major grid: x the slot tiles of a frame, y the frames (strided
// past 65535). Every lane of a warp reaches the ballots and shuffles: the
// lanes past F and the invalid slots take part as non-members.
template <int kConn>
__global__ void __launch_bounds__(kThreads)
tcc_merge(const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
          int32_t* d, int t, int f, int w) {
  constexpr unsigned kFull = 0xffffffffu;
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kThreads +
                    static_cast<int32_t>(threadIdx.x);
  const int lane = static_cast<int>(threadIdx.x) & 31;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    const int32_t* k = keys + base;
    int32_t* df = d + base;
    const bool member = i < f && slot_valid(
        k, valid != nullptr ? valid + base : nullptr, i);
    const int32_t lin = member ? k[i] : 0;
    const int32_t x = lin % w;
    // the left neighbour is the previous slot when its lin is lin - 1
    const bool left = member && x > 0 && i > 0 && k[i - 1] == lin - 1;
    // segments: the lanes of one horizontal run inside the warp
    const unsigned members = __ballot_sync(kFull, member);
    const unsigned cont = __ballot_sync(kFull, left && lane > 0);
    const unsigned upto = lane == 31 ? kFull : (2u << lane) - 1u;
    const int s = 31 - __clz(members & ~cont & upto);
    const unsigned after = ~cont & ~upto;
    const int e = (after != 0u ? __ffs(after) - 1 : 32) - 1;
    const int32_t lin_s = __shfl_sync(kFull, lin, s < 0 ? 0 : s);
    const int32_t lin_e = __shfl_sync(kFull, lin, e);
    // the run above: lins lo..hi of one row (the diagonals only with
    // 8-connectivity, where the segment's ends are off the frame's
    // edges); the segment's first lane finds lo among the w + 1 slots
    // before its own (the lins in between are distinct integers of one
    // row's span)
    const int32_t i_s = i - (lane - s);
    const int32_t lo = lin_s - w - ((kConn == 8 && lin_s % w > 0) ? 1 : 0);
    const int32_t hi = lin_e - w + ((kConn == 8 && lin_e % w < w - 1) ? 1
                                                                      : 0);
    int32_t p0 = 0;
    if (member && lane == s && lin_s >= w) {
      p0 = lower_bound(k, i_s > w + 1 ? i_s - w - 1 : 0, i_s, lo);
    }
    p0 = __shfl_sync(kFull, p0, s < 0 ? 0 : s);
    if (!member) continue;
    if (lane > s) {
      unite(df, i, i_s);
    } else if (left) {
      unite(df, i, i - 1);                 // the run goes on before the warp
    }
    if (lin_s < w) continue;               // the frame's first row
    // the segment's lanes take the candidate slots in turn; the candidates
    // of one run above are united by that run's own threads, so only the
    // first of each joins the segment
    const int len = e - s + 1;
    for (int32_t j = p0 + (lane - s); j < i_s && k[j] <= hi; j += len) {
      if (j == p0 || k[j - 1] != k[j] - 1) unite(df, i, j);
    }
  }
}

// every valid slot points straight at its 4-connected root in d4 and, as
// the start of the 8-connected forest of the kept slots, in d8; a marker
// entry sets the root's mark bit (roots change only by the atomics; a
// walk that reads a slot before or after its rewrite meets an ancestor
// either way)
__global__ void __launch_bounds__(kThreads)
tcc_compress_mark(const int32_t* __restrict__ keys,
                  const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ order,
                  const uint8_t* __restrict__ marker, int32_t* d4,
                  int32_t* __restrict__ d8, int t, int f) {
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kThreads +
                    static_cast<int32_t>(threadIdx.x);
  if (i >= f) return;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    if (!slot_valid(keys + base, valid != nullptr ? valid + base : nullptr,
                    i)) {
      continue;
    }
    int32_t* df = d4 + base;
    const int32_t r = root_of(df, i);
    if (r != i) df[i] = i - r;
    d8[base + i] = i - r;
    const int64_t ti = order != nullptr ? order[base + i] : i;
    if (marker[base + ti]) atomicOr(df + r, kMark);
  }
}

// the 8-connected forest of the kept slots, which starts as their
// 4-connected components: only a diagonal edge can join two of those, and
// only at a run's ends (up-left of its first pixel, up-right of its last;
// the other diagonals of a run touch a pixel above or beside one of its
// pixels); a thread a slot
__global__ void __launch_bounds__(kThreads)
tcc_diagonals(const int32_t* __restrict__ keys,
              const uint8_t* __restrict__ valid, const int32_t* __restrict__ d4,
              int32_t* d8, int t, int f, int w) {
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kThreads +
                    static_cast<int32_t>(threadIdx.x);
  if (i >= f) return;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    const int32_t* k = keys + base;
    const uint8_t* v = valid != nullptr ? valid + base : nullptr;
    if (!slot_valid(k, v, i)) continue;
    const int32_t lin = k[i];
    if (lin < w) continue;                 // the frame's first row
    const int32_t x = lin % w;
    const bool up_left = x > 0 && !(i > 0 && k[i - 1] == lin - 1);
    const bool up_right = x < w - 1 &&
                          !(i + 1 < f && slot_valid(k, v, i + 1) &&
                            k[i + 1] == lin + 1);
    if (!(up_left || up_right) || !kept4(d4 + base, i)) continue;
    const int32_t first = i > w + 1 ? i - w - 1 : 0;
    for (int side = 0; side < 2; ++side) {
      if (!(side == 0 ? up_left : up_right)) continue;
      const int32_t want = lin - w + (side == 0 ? -1 : 1);
      const int32_t j = lower_bound(k, first, i, want);
      if (j < i && k[j] == want && kept4(d4 + base, j)) {
        unite(d8 + base, i, j);
      }
    }
  }
}

// the label (the 8-connected root's lin) and keep of each slot, at its
// table index; d4 is null without the double threshold
__global__ void __launch_bounds__(kThreads)
tcc_final(const int32_t* __restrict__ keys, const uint8_t* __restrict__ valid,
          const int64_t* __restrict__ order, const int32_t* __restrict__ d4,
          const int32_t* __restrict__ d8, int32_t* __restrict__ labels,
          uint8_t* __restrict__ keep, int t, int f) {
  const int32_t i = static_cast<int32_t>(blockIdx.x) * kThreads +
                    static_cast<int32_t>(threadIdx.x);
  if (i >= f) return;
  for (int frame = blockIdx.y; frame < t; frame += gridDim.y) {
    const int64_t base = static_cast<int64_t>(frame) * f;
    const int32_t* k = keys + base;
    const bool ok = slot_valid(k, valid != nullptr ? valid + base : nullptr,
                               i) &&
                    (d4 == nullptr || kept4(d4 + base, i));
    int32_t lab = -1;
    if (ok) lab = k[root_of(d8 + base, i)];
    const int64_t ti = base + (order != nullptr ? order[base + i] : i);
    labels[ti] = lab;
    keep[ti] = ok ? 1 : 0;
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
// the double threshold, (1, T, F) without; labels: (T, F) int32 out and
// keep: (T, F) uint8 out, in table order. H * W < 2^30 (the wrapper
// checks). Returns a cudaError_t (0 = launched).
int ysmr_table_cc(const void* keys, const void* valid, const void* order,
                  const void* marker, void* forest, void* labels, void* keep,
                  int t, int f, int w, int double_threshold, int device,
                  void* stream) {
  if (t <= 0 || f <= 0) return 0;
  if (w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(t) * f;
  const int32_t* k = static_cast<const int32_t*>(keys);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int64_t* o = static_cast<const int64_t*>(order);
  const uint8_t* mk = static_cast<const uint8_t*>(marker);
  int32_t* d4 = static_cast<int32_t*>(forest);
  int32_t* d8 = double_threshold ? d4 + total : d4;
  // the forest merged first starts as singletons; tcc_compress_mark writes
  // d8 at every valid slot
  err = cudaMemsetAsync(d4, 0, static_cast<size_t>(total) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((f + kThreads - 1) / kThreads),
                  static_cast<unsigned>(t < 65535 ? t : 65535));
  if (double_threshold) {
    tcc_merge<4><<<grid, kThreads, 0, s>>>(k, v, d4, t, f, w);
    tcc_compress_mark<<<grid, kThreads, 0, s>>>(k, v, o, mk, d4, d8, t, f);
    tcc_diagonals<<<grid, kThreads, 0, s>>>(k, v, d4, d8, t, f, w);
  } else {
    tcc_merge<8><<<grid, kThreads, 0, s>>>(k, v, d8, t, f, w);
  }
  tcc_final<<<grid, kThreads, 0, s>>>(
      k, v, o, double_threshold ? d4 : nullptr, d8,
      static_cast<int32_t*>(labels), static_cast<uint8_t*>(keep), t, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
