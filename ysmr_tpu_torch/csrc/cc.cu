// Connected components and marker reconstruction, by union-find: over whole
// frames, and over per-frame pixel lists (the last entry, below).
//
// The whole-frame entries replace two Pallas kernels of
// ysmr_tpu/ops/pallas_cc.py:
//   - label_components_whole_frame (kernel _label_frame_kernel, stencil
//     _stencil_converge): labels = the minimum linear index y*w + x of each
//     4- or 8-connected component of the mask, h*w on the background;
//   - binary_reconstruct (kernel _reconstruct_kernel): a mask pixel is kept
//     iff it is 4-connected, within the mask, to a pixel of marker & mask
//     (scipy.ndimage.binary_propagation with markers inside the mask).
// Same contracts as the plain versions
// ysmr_tpu_torch/ops/labeling.py::label_components (labels only) and
// ::propagate_markers.
//
// Design of the labeling (Playne-Hawick union-find, three passes over one
// grid of T*H*W threads):
//   init:     a foreground pixel's parent is its own in-frame index, the
//             background's is h*w;
//   merge:    each foreground pixel unites with its foreground neighbours
//             already visited in raster order (left and up; for 8-conn also
//             up-left and up-right). A union links the larger root under
//             the smaller with atomicMin, so parents only decrease and every
//             tree's root is its smallest index; a lost race retries from
//             the value the atomic returned;
//   compress: each foreground pixel takes its root. The root is the
//             component's minimum index whatever the schedule, so the labels
//             are exact and deterministic.
// Bound: streaming passes (a byte of mask in, four bytes of labels out per
// pixel: ~0.36 GB per 64-frame 1228x922 batch); the merge does work only on
// foreground pixels, a few per cent of a frame.
//
// Design of the reconstruction (four passes over one thread per 32 pixels;
// the passes are below, at rec_pack). It needs no label on the background
// and no flag plane, only whether a component holds a marker:
//   pack:  mask and marker & mask are read once, 32 bytes a thread with two
//          16-byte loads, and kept as bits (2 x 9 MB per 64-frame batch,
//          resident in the L2 for the other passes). The same pass builds
//          the forest of the horizontal runs without an atomic: every set
//          pixel points at the first pixel of its segment (its run within
//          the word and the row);
//   merge: word operations find the pixels with a set pixel above them,
//          and of those only the ones whose left neighbours do not already
//          make the same union: a run meets each run above it once;
//   mark:  every segment's first pixel is pointed at its root, and a
//          segment holding a marker pixel sets the mark bit of the root's
//          entry;
//   keep:  a segment is kept iff its root's entry carries the mark; the
//          output bytes leave with 16-byte stores.
// Bound: mask + marker + out, 3 bytes a pixel (217 MB per 64-frame batch);
// the label array is touched at the mask's pixels only.
//
// Differences from the TPU kernels: the Pallas stencil stops after max_iters
// (64) propagation steps, and the Pallas reconstruction after max_iters
// dilation steps, so there a component whose geodesic diameter exceeds that
// keeps split labels, and a mask pixel more than max_iters 4-steps from
// every marker pixel is dropped. These kernels have no iteration loop and
// always compute the fixpoint, as scipy does (and as the JAX CPU path does
// whenever its labeling converged). The TPU's 32-frame bit packing, lane
// rolls and VMEM residency existed for Mosaic and are not carried over (the
// reconstruction here packs 32 pixels of one row, not 32 frames).
//
// The third entry, ysmr_cc_pixels, replaces cc_labels_at_pixels of the same
// Pallas file (kernel _make_kernel): per frame a list of F foreground pixels
// (x, y, valid, marker) in raster order; out the keep flag (with the double
// threshold: the pixel's 4-connected component of the valid pixels holds a
// marker pixel; without it: valid) and the label of every kept pixel, the
// minimum linear index y*w + x of its 8-connected component among the kept
// pixels (-1 for the others). The TPU kernel rasterizes the list into a
// frame-sized VMEM buffer and runs the stencil there. Here the union-find
// runs over the list itself, so nothing of frame size is touched (a
// lin -> slot map would be 290 MB per 64-frame 1228x922 batch to clear,
// over 30x the lists' own bytes). Design, with the double threshold a
// memset and four launches (without it, a memset and two):
//   - a forest over the slots of a frame is stored as distances: parent(x)
//     = x - d[x], d = 0 at a root, so the zeroed array is the forest of
//     singletons and needs no init pass; unions link the larger root under
//     the smaller slot, so parents only decrease and each root is its
//     component's first slot, whose lin is the minimum (raster order); the
//     labels are schedule-independent;
//   - px_merge: one block per (frame, tile of 2048 slots), of 512 threads
//     when the tiles are few and of 256 otherwise.
//     It stages in shared memory the lins of the tile and of its halo, the
//     w + 1 slots before it, with their active flags: every upper neighbour
//     (lin - w - 1 .. lin - w + 1) of a tile pixel lies there, because the
//     lins in between are distinct integers of one row's span. The left
//     neighbour is the previous slot when its lin is lin - 1. The first
//     staged lin >= lin - w - 1 grows by at most one a slot along a
//     horizontal run: the lanes of a warp take 32 consecutive slots, the
//     lane that starts a run searches the w + 1 staged slots before it,
//     and the run's other lanes search only the k slots after its result
//     (k their offset in the run); no pixel searches global memory.
//     The diagonal unions are skipped when the pixel straight above is
//     present, and up-left when the left neighbour is (cc_merge's rule).
//     Unions inside the tile run on a shared-memory forest of local
//     indices; its trees then enter the frame's forest with one atomicMax a
//     pixel, and only edges into the halo unite through global memory;
//   - px_compress_mark: each valid slot points straight at its 4-connected
//     root, and a marker pixel sets the root's mark bit;
//   - px_merge over the 8-neighbours of the kept pixels (valid, with a
//     marked root, read from the compressed 4-connected forest); it writes
//     keep;
//   - px_final: the lin of the 8-connected root, or -1.
// Contract: the valid pixels of each frame form a prefix of its list, with
// strictly ascending lin (every wire of the pipeline gives that); the tile
// and its halo fit in shared memory (w <= 42,802). The TPU kernel stops
// after max_iters stencil steps; this one always reaches the fixpoint.
// Bound: the lists, 15 bytes a slot (x, y int32, two bools in; int32 label
// and bool out), ~7.9 MB per 64 x 8192 batch (~2.3 us) and ~126 MB at
// F = 131072 (~38 us). The kernels read more: the halo (up to 1.6x the
// tile's lins), the forests (8 bytes a slot, one memset) and the root
// walks; at the bench size the launches cost more than the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t find_root(const volatile int32_t* lab,
                                             int32_t x) {
  int32_t p = lab[x];
  while (p != x) {
    x = p;
    p = lab[x];
  }
  return x;
}

// Unites the trees of in-frame pixels a and b; lab is the frame's base.
// Parents are read through a volatile pointer (no stale L1 line survives
// another block's atomic); a stale read still names an ancestor, because
// parents only decrease within one tree.
__device__ void unite(int32_t* lab, int32_t a, int32_t b) {
  const volatile int32_t* v = lab;
  while (true) {
    a = find_root(v, a);
    b = find_root(v, b);
    if (a == b) return;
    if (a < b) {
      const int32_t t = a;
      a = b;
      b = t;
    }
    // link the larger root a under b; if a stopped being a root meanwhile,
    // the atomic returns its new parent, which still has to join b
    const int32_t old = atomicMin(lab + a, b);
    if (old == a) return;
    a = old;
  }
}

__global__ void __launch_bounds__(kThreads)
cc_init(const uint8_t* __restrict__ mask, int32_t* __restrict__ lab,
        int64_t total, int32_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  lab[idx] = mask[idx] ? static_cast<int32_t>(idx % n) : n;
}

template <int kConn>
__global__ void __launch_bounds__(kThreads)
cc_merge(const uint8_t* __restrict__ mask, int32_t* lab, int64_t total,
         int h, int w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total || !mask[idx]) return;
  const int64_t n = static_cast<int64_t>(h) * w;
  const int64_t base = idx - idx % n;
  const int32_t i = static_cast<int32_t>(idx - base);
  const int y = i / w;
  const int x = i - y * w;
  const uint8_t* m = mask + base;
  int32_t* l = lab + base;
  const bool left = x > 0 && m[i - 1];
  if (left) unite(l, i, i - 1);
  if (y == 0) return;
  if (m[i - w]) {
    // up is foreground: up-left and up-right are its own horizontal
    // neighbours, united by their threads
    unite(l, i, i - w);
    return;
  }
  if (kConn == 8) {
    // with left in the foreground, up-left is left's upper neighbour
    if (!left && x > 0 && m[i - w - 1]) unite(l, i, i - w - 1);
    if (x + 1 < w && m[i - w + 1]) unite(l, i, i - w + 1);
  }
}

__global__ void __launch_bounds__(kThreads)
cc_compress(const uint8_t* __restrict__ mask, int32_t* lab, int64_t total,
            int32_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total || !mask[idx]) return;
  const int64_t base = idx - idx % n;
  // other threads store roots meanwhile: a read returns the old parent or
  // the root, both ancestors
  lab[idx] = find_root(lab + base, static_cast<int32_t>(idx - base));
}

unsigned blocks_for(int64_t total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

// ---- pixel lists (ysmr_cc_pixels) ----

constexpr int kTile = 2048;                      // slots per px_merge block
// threads of a px_merge block: 512 where the tiles are few (a short list
// per frame) and each block's latency is the call's, else 256
constexpr int kTileThreadsFew = 512;
constexpr int kTileThreadsMany = 256;
constexpr int kMaxSmem = 232448;                 // a block's limit on Hopper
constexpr int32_t kDist = 0x7fffffff;            // d[x] without the mark bit
constexpr int32_t kMark = static_cast<int32_t>(0x80000000u);

size_t merge_smem(int w) {
  return static_cast<size_t>(kTile) * 4 +
         static_cast<size_t>(w + 1 + kTile) * 5;
}

// root of slot x in a distance forest (parent(x) = x - (d[x] & kDist))
__device__ __forceinline__ int32_t px_root(const volatile int32_t* d,
                                           int32_t x) {
  int32_t s = d[x] & kDist;
  while (s != 0) {
    x -= s;
    s = d[x] & kDist;
  }
  return x;
}

// unite on a distance forest without marks: link the larger root a under b
// by raising d[a] to a - b; if a stopped being a root meanwhile, its new
// parent still has to join b (as unite above)
__device__ void px_unite(int32_t* d, int32_t a, int32_t b) {
  const volatile int32_t* v = d;
  while (true) {
    a = px_root(v, a);
    b = px_root(v, b);
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

__device__ __forceinline__ int32_t px_lin(const int32_t* __restrict__ xs,
                                          const int32_t* __restrict__ ys,
                                          int64_t g, int h, int w) {
  // coordinates clamped into the frame, as the TPU kernel addresses them
  const int x = min(max(xs[g], 0), w - 1);
  const int y = min(max(ys[g], 0), h - 1);
  return y * w + x;
}

// first index in [lo, hi) whose staged lin is >= target, or hi
__device__ __forceinline__ int32_t lower_bound(const int32_t* s_lin,
                                               int32_t lo, int32_t hi,
                                               int32_t target) {
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (s_lin[mid] < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Slot li = q * kBlock + tid of a tile, so the lanes of a warp hold
// 32 consecutive slots. A lane starts a run when its slot is not the
// right neighbour (in the same image row) of the previous slot of the
// warp; `src` is the lane that starts the caller's run.
struct RunLane {
  bool in;         // li < n
  int32_t v;       // staged lin (INT32_MAX past the tile)
  bool start;
  int src;
};

__device__ __forceinline__ RunLane run_lane(const int32_t* s_lin, int li,
                                            int n, int hl, int w) {
  const int lane = threadIdx.x & 31;
  RunLane r;
  r.in = li < n;
  const int si = hl + li;
  r.v = r.in ? s_lin[si] : INT32_MAX;
  r.start = !r.in || lane == 0 || r.v % w == 0 || s_lin[si - 1] != r.v - 1;
  const unsigned starts = __ballot_sync(0xffffffffu, r.start);
  r.src = 31 - __clz(starts & (0xffffffffu >> (31 - lane)));
  return r;
}

// The unions of the tile's active slots with their earlier neighbours:
// into the tile on the shared forest (kHalo false), or into the halo on
// the frame's forest `df` (kHalo true); the slots of a run within a warp
// are linked to its first slot beforehand. The upper neighbours of a slot
// start at the first staged lin >= lin - w - 1, which grows by at most
// one per slot along a horizontal run: the lane that starts a run (within
// the warp) searches the w + 1 staged slots before it, and the other
// lanes of the run search only the k slots after that lane's result (k
// their offset in the run), taken with a shuffle. An edge that the left
// neighbour's own edges already imply is skipped: the pixels of a run
// meet an upper run once, not once a pixel.
template <int kConn, bool kHalo, int kBlock>
__device__ void px_edges(const int32_t* s_lin, const uint8_t* s_act,
                         int32_t* s_par, int32_t* df, int n, int hl, int t0,
                         int s0, int w) {
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int32_t first_lin = s_lin[hl];
  for (int q = 0; q < kTile / kBlock; ++q) {
    const int li = q * kBlock + threadIdx.x;
    const int si = hl + li;
    const RunLane run = run_lane(s_lin, li, n, hl, w);
    const bool in = run.in;
    const int32_t v = run.v;
    if (kHalo) {
      // only the tile's first slot and the slots whose upper neighbours
      // may lie before the tile (a prefix of the tile) reach the halo
      const bool need = in && (li == 0 || v - w - 1 < first_lin);
      if (__ballot_sync(kAll, need) == 0) return;
    }
    const bool run_start = run.start;
    const int src = run.src;
    const int32_t target = v - w - 1;
    int32_t p = 0;
    if (run_start && in) {
      p = lower_bound(s_lin, max(0, si - w - 1), si, target);
    }
    const int32_t p_run = __shfl_sync(kAll, p, src);
    if (!run_start) {
      // the k upper slots after p_run are usually all below the target (a
      // full run above): one load decides it
      const int32_t hi = min(si, p_run + lane - src);
      p = s_lin[hi - 1] < target ? hi : lower_bound(s_lin, p_run, hi, target);
    }
    if (!in || !s_act[si]) continue;
    const int y = v / w;
    const int x = v - y * w;
    const bool left = x > 0 && si > 0 && s_lin[si - 1] == v - 1 &&
                      s_act[si - 1];
    // the neighbours to unite with, at most two: a run's later slots in the
    // warp are linked to its first already
    int nb0 = -1, nb1 = -1;
    auto add = [&](int j) {
      if (nb0 < 0) {
        nb0 = j;
      } else {
        nb1 = j;
      }
    };
    if (left && run_start) add(si - 1);
    if (y > 0) {
      // lins v - w - 1, v - w, v - w + 1 are at p, p + 1, p + 2 at most
      // (-1: absent or inactive)
      int j = p, up = -1, up_left = -1, up_right = -1;
      if (j < si && s_lin[j] == target) {
        up_left = s_act[j] ? j : -1;
        ++j;
      }
      if (j < si && s_lin[j] == target + 1) {
        up = s_act[j] ? j : -1;
        ++j;
      }
      if (j < si && s_lin[j] == target + 2 && s_act[j]) up_right = j;
      if (up >= 0) {
        // up-left and up-right are up's horizontal neighbours, united
        // there; with left active, left reaches up through its own up (4-
        // and 8-connected) or its up-right (8-connected)
        if (!left || (kConn == 4 && up_left < 0)) add(up);
      } else if (kConn == 8) {
        // with left active, up-left is left's upper neighbour
        if (up_left >= 0 && x > 0 && !left) add(up_left);
        if (up_right >= 0 && x + 1 < w) add(up_right);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int sj = e == 0 ? nb0 : nb1;
      if (sj < 0) break;
      if (kHalo) {
        if (sj < hl) px_unite(df, t0 + li, s0 + sj);
      } else if (sj >= hl) {
        unite(s_par, li, sj - hl);
      }
    }
  }
}

// the slot is valid and its 4-connected root (one hop after
// px_compress_mark) carries the mark bit
__device__ __forceinline__ bool px_marked(const int32_t* __restrict__ dm,
                                          int32_t j) {
  return dm[j - (dm[j] & kDist)] < 0;
}

// unions of one (tile, frame) = (blockIdx.x, blockIdx.y) over the kConn
// neighbours among the active slots: valid ones, or with `marks` (the
// compressed 4-connected forest) valid ones with a marked root. Writes
// keep (when given) and zeroes d_next (when given) on the tile's slots.
template <int kConn, int kBlock>
__global__ void __launch_bounds__(kBlock)
px_merge(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
         const uint8_t* __restrict__ valid, const int32_t* __restrict__ marks,
         int32_t* d, int32_t* __restrict__ d_next, uint8_t* __restrict__ keep,
         int f, int h, int w) {
  extern __shared__ int32_t smem[];
  const int halo = w + 1;
  int32_t* s_par = smem;                         // kTile local parents
  int32_t* s_lin = smem + kTile;                 // halo + kTile lins
  uint8_t* s_act = reinterpret_cast<uint8_t*>(s_lin + halo + kTile);
  const int t0 = blockIdx.x * kTile;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * f;
  const int n = min(kTile, f - t0);
  const int hl = min(t0, halo);
  const int s0 = t0 - hl;
  if (!valid[base + t0]) {
    // the valid slots are a prefix: nothing of this tile is active
    if (keep != nullptr) {
      for (int k = threadIdx.x; k < n; k += kBlock) {
        keep[base + t0 + k] = 0;
      }
    }
    return;
  }
  const int32_t* dm = marks == nullptr ? nullptr : marks + base;
#pragma unroll 4
  for (int k = threadIdx.x; k < hl + n; k += kBlock) {
    const int64_t g = base + s0 + k;
    const bool ok = valid[g];
    // past the valid prefix INT32_MAX keeps s_lin sorted
    s_lin[k] = ok ? px_lin(xs, ys, g, h, w) : INT32_MAX;
    s_act[k] = ok && (dm == nullptr || px_marked(dm, s0 + k));
  }
  __syncthreads();
  for (int q = 0; q < kTile / kBlock; ++q) {
    // each slot's parent is the first slot of its run within the warp
    const int li = q * kBlock + threadIdx.x;
    const RunLane run = run_lane(s_lin, li, n, hl, w);
    if (!run.in) continue;
    s_par[li] = s_act[hl + li] ? li - ((threadIdx.x & 31) - run.src) : li;
    if (d_next != nullptr) d_next[base + t0 + li] = 0;
    if (keep != nullptr) keep[base + t0 + li] = s_act[hl + li];
  }
  __syncthreads();
  px_edges<kConn, false, kBlock>(s_lin, s_act, s_par, nullptr, n, hl, t0,
                                 s0, w);
  __syncthreads();
  // the tile's trees into the frame's forest; a slot that another block
  // linked meanwhile (a halo slot of a later tile) keeps the lower parent,
  // and the other one joins it
  int32_t* df = d + base;
  for (int k = threadIdx.x; k < n; k += kBlock) {
    if (!s_act[hl + k]) continue;
    const int32_t r = find_root(s_par, k);
    if (r == k) continue;
    const int32_t a = t0 + k, b = t0 + r;
    const int32_t old = atomicMax(df + a, a - b);
    if (old != 0 && old != a - b) px_unite(df, a - old, b);
  }
  if (hl > 0) {
    px_edges<kConn, true, kBlock>(s_lin, s_act, s_par, df, n, hl, t0, s0, w);
  }
}

constexpr int kSlotsPerThread = 4;

unsigned slot_blocks(int f, int t) {
  return static_cast<unsigned>(
      (static_cast<int64_t>(f) * t + kThreads * kSlotsPerThread - 1) /
      (kThreads * kSlotsPerThread));
}

// px_compress_mark and px_final: thread x of block b takes the four slots
// b * 1024 + x + 256 j (which may lie in two frames) and walks their four
// roots in lock step, so the loads of the walks are in flight together

// every valid slot points straight at its 4-connected root; a marker pixel
// sets the root's mark bit (roots are written by the atomics only; a walk
// that reads a slot before or after its rewrite meets an ancestor either
// way)
__global__ void __launch_bounds__(kThreads)
px_compress_mark(const uint8_t* __restrict__ valid,
                 const uint8_t* __restrict__ marker, int32_t* d,
                 int64_t total, int f) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads *
                        kSlotsPerThread + threadIdx.x;
  int64_t base[4];
  int32_t i[4], x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t idx = first + j * kThreads;
    const bool ok = idx < total && valid[idx];
    base[j] = idx - idx % f;
    i[j] = static_cast<int32_t>(idx - base[j]);
    x[j] = ok ? i[j] : -1;
  }
  int32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = x[j] < 0 ? 0 : d[base[j] + x[j]] & kDist;
  while (s[0] | s[1] | s[2] | s[3]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (s[j] != 0) {
        x[j] -= s[j];
        s[j] = d[base[j] + x[j]] & kDist;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (x[j] < 0) continue;
    int32_t* df = d + base[j];
    if (x[j] != i[j]) df[i[j]] = i[j] - x[j];
    if (marker[base[j] + i[j]]) atomicOr(df + x[j], kMark);
  }
}

__global__ void __launch_bounds__(kThreads)
px_final(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
         const uint8_t* __restrict__ keep, const int32_t* __restrict__ d,
         int32_t* __restrict__ labels, int64_t total, int f, int h, int w) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads *
                        kSlotsPerThread + threadIdx.x;
  int64_t base[4];
  int32_t x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t idx = first + j * kThreads;
    const bool ok = idx < total && keep[idx];
    base[j] = idx - idx % f;
    x[j] = ok ? static_cast<int32_t>(idx - base[j]) : -1;
    if (idx < total && !ok) labels[idx] = -1;
  }
  int32_t s[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = x[j] < 0 ? 0 : d[base[j] + x[j]];
  while (s[0] | s[1] | s[2] | s[3]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (s[j] != 0) {
        x[j] -= s[j];
        s[j] = d[base[j] + x[j]];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (x[j] >= 0) {
      labels[first + j * kThreads] = px_lin(xs, ys, base[j] + x[j], h, w);
    }
  }
}

// ---- marker reconstruction on bit-packed masks (ysmr_cc_reconstruct) ----
//
// The frames of a call are one flat array of t * h rows of w pixels, pixel
// g in bit g % 32 of word g / 32, so rows and frames start at any bit. A
// segment is a maximal run of set bits within one word and one row; its
// first pixel carries its label.

// 32 bytes from p (non-zero = set) as one bit each; kVec: p is 16-byte
// aligned and all 32 bytes exist, else the first `count` bytes are read
__device__ __forceinline__ uint32_t nibble(uint32_t v) {
  // bytes 0/1 at bits 0, 8, 16, 24 to bits 24..27 of the product
  return ((__vcmpne4(v, 0) & 0x01010101u) * 0x01020408u) >> 24;
}

template <bool kVec>
__device__ __forceinline__ uint32_t pack32(const uint8_t* __restrict__ p,
                                           int count) {
  uint32_t bits = 0;
  if (kVec && count >= 32) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const uint4 b = *reinterpret_cast<const uint4*>(p + 16);
    bits = nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 |
           nibble(a.w) << 12 | nibble(b.x) << 16 | nibble(b.y) << 20 |
           nibble(b.z) << 24 | nibble(b.w) << 28;
  } else {
    for (int b = 0; b < min(count, 32); ++b) {
      bits |= static_cast<uint32_t>(p[b] != 0) << b;
    }
  }
  return bits;
}

// of the 32 pixels from g0: `start` the bits at x = 0, `top` the bits in
// the first row of a frame
struct RowMasks {
  uint32_t start, top;
};

__device__ __forceinline__ RowMasks row_masks(int32_t g0, int h, int w) {
  int row = g0 / w;
  int x = g0 - row * w;
  RowMasks m = {0u, 0u};
  for (int b = 0; b < 32; ++row) {
    const int len = min(32 - b, w - x);
    if (x == 0) m.start |= 1u << b;
    if (row % h == 0) m.top |= (0xffffffffu >> (32 - len)) << b;
    b += len;
    x = 0;
  }
  return m;
}

// the first bits of the segments of a word
__device__ __forceinline__ uint32_t segment_starts(uint32_t m,
                                                   uint32_t row_start) {
  return m & ~((m << 1) & ~row_start);
}

// the 32 bits from bit offset `off` of the packed array (0 outside it)
__device__ __forceinline__ uint32_t bits_at(const uint32_t* __restrict__ m,
                                            int32_t n_words, int32_t off) {
  if (off <= -32) return 0;
  if (off < 0) return m[0] << -off;
  const int32_t j = off >> 5, o = off & 31;
  const uint32_t lo = j < n_words ? m[j] : 0u;
  if (o == 0) return lo;
  const uint32_t hi = j + 1 < n_words ? m[j + 1] : 0u;
  return lo >> o | hi << (32 - o);
}

// pass 1: the mask and marker & mask as bits, and the forest of the
// horizontal runs: every set pixel points at its segment's first pixel,
// which points at itself or, where the run goes on from the previous word,
// at the first pixel of that word's last segment
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rec_pack(const uint8_t* __restrict__ mask, const uint8_t* __restrict__ marker,
         uint32_t* __restrict__ mbits, uint32_t* __restrict__ kbits,
         int32_t* __restrict__ lab, int32_t total, int32_t n_words, int h,
         int w) {
  const int32_t k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_words) return;
  const int32_t g0 = k * 32;
  const uint32_t m = pack32<kVec>(mask + g0, total - g0);
  mbits[k] = m;
  kbits[k] = m == 0 ? 0u : pack32<kVec>(marker + g0, total - g0) & m;
  if (m == 0) return;
  const uint32_t rs = row_masks(g0, h, w).start;
  const uint32_t starts = segment_starts(m, rs);
  int32_t first = g0;
  if ((m & 1u) && !(rs & 1u) && mask[g0 - 1]) {
    const uint32_t pm = pack32<kVec>(mask + g0 - 32, 32);
    first = g0 - 1 - __clz(segment_starts(pm, row_masks(g0 - 32, h, w).start));
  }
  for (uint32_t rest = m; rest != 0; rest &= rest - 1) {
    const int b = __ffs(rest) - 1;
    const int sb = 31 - __clz(starts & (0xffffffffu >> (31 - b)));
    lab[g0 + b] = b == 0 ? first : g0 + sb;
  }
}

// pass 2: a set pixel unites with the set pixel above it, unless both
// have their left neighbours set (those two make the same union)
__global__ void __launch_bounds__(kThreads)
rec_merge(const uint32_t* __restrict__ mbits, int32_t* lab, int32_t n_words,
          int h, int w) {
  const int32_t k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_words) return;
  const uint32_t m = mbits[k];
  if (m == 0) return;
  const int32_t g0 = k * 32;
  const RowMasks rm = row_masks(g0, h, w);
  const uint32_t carry = k > 0 ? mbits[k - 1] >> 31 : 0u;
  const uint32_t left = (m << 1 | carry) & ~rm.start;
  const uint32_t up = bits_at(mbits, n_words, g0 - w) & ~rm.top;
  const uint32_t up_left = bits_at(mbits, n_words, g0 - w - 1) & ~rm.start;
  for (uint32_t need = m & up & ~(left & up_left); need != 0;
       need &= need - 1) {
    const int32_t p = g0 + __ffs(need) - 1;
    unite(lab, p, p - w);
  }
}

// root of x where roots may carry the mark bit
__device__ __forceinline__ int32_t find_root_marked(
    const volatile int32_t* lab, int32_t x) {
  int32_t p = lab[x] & kDist;
  while (p != x) {
    x = p;
    p = lab[x] & kDist;
  }
  return x;
}

// bits [sb, end) of the segment that starts at bit sb of word m
__device__ __forceinline__ uint32_t segment_bits(uint32_t m, uint32_t starts,
                                                 int sb) {
  // the segment ends before the next start or the next clear bit
  const uint32_t stop = (~m | starts) & ~(0xffffffffu >> (31 - sb));
  return (stop == 0 ? 0xffffffffu : (1u << (__ffs(stop) - 1)) - 1u) &
         ~((1u << sb) - 1u);
}

// pass 3: every segment's first pixel points straight at its root, and a
// segment with a marker pixel sets the root's mark bit (other walks read
// the old parent or the root meanwhile, both ancestors)
__global__ void __launch_bounds__(kThreads)
rec_mark(const uint32_t* __restrict__ mbits,
         const uint32_t* __restrict__ kbits, int32_t* lab, int32_t n_words,
         int h, int w) {
  const int32_t k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_words) return;
  const uint32_t m = mbits[k];
  if (m == 0) return;
  const int32_t g0 = k * 32;
  const uint32_t marked = kbits[k];
  const uint32_t starts = segment_starts(m, row_masks(g0, h, w).start);
  for (uint32_t rest = starts; rest != 0; rest &= rest - 1) {
    const int sb = __ffs(rest) - 1;
    const int32_t s = g0 + sb;
    const int32_t root = find_root_marked(lab, s);
    if (root != s) lab[s] = root;
    if (marked & segment_bits(m, starts, sb)) atomicOr(lab + root, kMark);
  }
}

// pass 4: a segment is kept iff its root carries the mark
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
rec_keep(const uint32_t* __restrict__ mbits, const int32_t* __restrict__ lab,
         uint8_t* __restrict__ out, int32_t total, int32_t n_words, int h,
         int w) {
  const int32_t k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n_words) return;
  const uint32_t m = mbits[k];
  const int32_t g0 = k * 32;
  uint32_t keep = 0;
  if (m != 0) {
    const uint32_t starts = segment_starts(m, row_masks(g0, h, w).start);
    for (uint32_t rest = starts; rest != 0; rest &= rest - 1) {
      const int sb = __ffs(rest) - 1;
      int32_t v = lab[g0 + sb];
      if ((v & kDist) != g0 + sb) v = lab[v];
      if (v < 0) keep |= segment_bits(m, starts, sb);
    }
  }
  if (kVec && total - g0 >= 32) {
    // a nibble's bits to the low bits of four bytes
    auto bytes = [keep](int q) {
      return ((keep >> (4 * q) & 0xfu) * 0x00204081u) & 0x01010101u;
    };
    uint4* o = reinterpret_cast<uint4*>(out + g0);
    o[0] = make_uint4(bytes(0), bytes(1), bytes(2), bytes(3));
    o[1] = make_uint4(bytes(4), bytes(5), bytes(6), bytes(7));
  } else {
    for (int b = 0; b < min(total - g0, 32); ++b) out[g0 + b] = keep >> b & 1u;
  }
}

// init + merge + compress on `lab`
cudaError_t label(const uint8_t* mask, int32_t* lab, int t, int h, int w,
                  int connectivity, cudaStream_t s) {
  const int32_t n = h * w;
  const int64_t total = static_cast<int64_t>(t) * n;
  const unsigned blocks = blocks_for(total);
  cc_init<<<blocks, kThreads, 0, s>>>(mask, lab, total, n);
  if (connectivity == 8) {
    cc_merge<8><<<blocks, kThreads, 0, s>>>(mask, lab, total, h, w);
  } else {
    cc_merge<4><<<blocks, kThreads, 0, s>>>(mask, lab, total, h, w);
  }
  cc_compress<<<blocks, kThreads, 0, s>>>(mask, lab, total, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mask: (T, H, W) uint8 (0/1); labels: (T, H, W) int32 out; connectivity 4
// or 8; H * W < 2^31; all on CUDA device `device`, launched on `stream`.
// Returns a cudaError_t (0 = launched).
int ysmr_cc_label(const void* mask, void* labels, int t, int h, int w,
                  int connectivity, int device, void* stream) {
  if (t <= 0 || h <= 0 || w <= 0) return 0;
  if (connectivity != 4 && connectivity != 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(label(static_cast<const uint8_t*>(mask),
                                static_cast<int32_t*>(labels), t, h, w,
                                connectivity,
                                static_cast<cudaStream_t>(stream)));
}

// mask, marker: (T, H, W) uint8 (non-zero = set); labels: (T, H, W) int32
// scratch (touched at the mask's pixels only); bits: 2 * ceil(T * H * W /
// 32) uint32 scratch; out: (T, H, W) uint8 (0/1). T * H * W <= 2^31 - 64
// (cudaErrorInvalidValue otherwise). Returns a cudaError_t (0 = launched).
int ysmr_cc_reconstruct(const void* mask, const void* marker, void* labels,
                        void* bits, void* out, int t, int h, int w,
                        int device, void* stream) {
  if (t <= 0 || h <= 0 || w <= 0) return 0;
  const int64_t total64 = static_cast<int64_t>(t) * h * w;
  if (total64 > (int64_t{1} << 31) - 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t total = static_cast<int32_t>(total64);
  const int32_t n_words = (total + 31) / 32;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const uint8_t* k = static_cast<const uint8_t*>(marker);
  uint8_t* o = static_cast<uint8_t*>(out);
  int32_t* lab = static_cast<int32_t*>(labels);
  uint32_t* mbits = static_cast<uint32_t*>(bits);
  uint32_t* kbits = mbits + n_words;
  const unsigned blocks = blocks_for(n_words);
  // The pipeline passes fresh allocations, which are aligned. The byte-wise
  // variants are there only so that any contiguous tensor is taken: a view
  // that starts inside a batch need not be aligned.
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (aligned(m) && aligned(k)) {
    rec_pack<true><<<blocks, kThreads, 0, s>>>(m, k, mbits, kbits, lab, total,
                                               n_words, h, w);
  } else {
    rec_pack<false><<<blocks, kThreads, 0, s>>>(m, k, mbits, kbits, lab,
                                                total, n_words, h, w);
  }
  rec_merge<<<blocks, kThreads, 0, s>>>(mbits, lab, n_words, h, w);
  rec_mark<<<blocks, kThreads, 0, s>>>(mbits, kbits, lab, n_words, h, w);
  if (aligned(o)) {
    rec_keep<true><<<blocks, kThreads, 0, s>>>(mbits, lab, o, total, n_words,
                                               h, w);
  } else {
    rec_keep<false><<<blocks, kThreads, 0, s>>>(mbits, lab, o, total, n_words,
                                                h, w);
  }
  return static_cast<int>(cudaGetLastError());
}

// px_x, px_y: (T, F) int32; valid, marker: (T, F) uint8 (0/1); forest:
// (2, T, F) int32 scratch with the double threshold, (1, T, F) without;
// labels: (T, F) int32 out; keep: (T, F) uint8 out. H * W < 2^31 and
// W <= 42,802 (the tile and its halo in shared memory). Returns a
// cudaError_t (cudaErrorInvalidValue for a wider frame).
int ysmr_cc_pixels(const void* px_x, const void* px_y, const void* valid,
                   const void* marker, void* forest, void* labels, void* keep,
                   int t, int f, int h, int w, int double_threshold,
                   int device, void* stream) {
  if (t <= 0 || f <= 0 || h <= 0 || w <= 0) return 0;
  const size_t smem = merge_smem(w);
  if (smem > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 tiles(static_cast<unsigned>((f + kTile - 1) / kTile),
                   static_cast<unsigned>(t));
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool few = static_cast<int64_t>(tiles.x) * tiles.y < 4 * sms;
  if (smem > 48 * 1024) {
    const void* merges[] = {
        reinterpret_cast<const void*>(&px_merge<4, kTileThreadsFew>),
        reinterpret_cast<const void*>(&px_merge<8, kTileThreadsFew>),
        reinterpret_cast<const void*>(&px_merge<4, kTileThreadsMany>),
        reinterpret_cast<const void*>(&px_merge<8, kTileThreadsMany>)};
    for (const void* fn : merges) {
      err = cudaFuncSetAttribute(fn,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(t) * f;
  const int32_t* xs = static_cast<const int32_t*>(px_x);
  const int32_t* ys = static_cast<const int32_t*>(px_y);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* d4 = static_cast<int32_t*>(forest);
  int32_t* d8 = double_threshold ? d4 + total : d4;
  uint8_t* k = static_cast<uint8_t*>(keep);
  // the forest merged first starts as singletons; px_merge<4> zeroes d8
  err = cudaMemsetAsync(d4, 0, static_cast<size_t>(total) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* mk = static_cast<const uint8_t*>(marker);
  auto merge = [&](int conn, const int32_t* marks, int32_t* d,
                   int32_t* d_next, uint8_t* keep_out) {
    if (few && conn == 4) {
      px_merge<4, kTileThreadsFew><<<tiles, kTileThreadsFew, smem, s>>>(
          xs, ys, v, marks, d, d_next, keep_out, f, h, w);
    } else if (few) {
      px_merge<8, kTileThreadsFew><<<tiles, kTileThreadsFew, smem, s>>>(
          xs, ys, v, marks, d, d_next, keep_out, f, h, w);
    } else if (conn == 4) {
      px_merge<4, kTileThreadsMany><<<tiles, kTileThreadsMany, smem, s>>>(
          xs, ys, v, marks, d, d_next, keep_out, f, h, w);
    } else {
      px_merge<8, kTileThreadsMany><<<tiles, kTileThreadsMany, smem, s>>>(
          xs, ys, v, marks, d, d_next, keep_out, f, h, w);
    }
  };
  if (double_threshold) {
    merge(4, nullptr, d4, d8, nullptr);
    px_compress_mark<<<slot_blocks(f, t), kThreads, 0, s>>>(v, mk, d4, total,
                                                            f);
    merge(8, d4, d8, nullptr, k);
  } else {
    merge(8, nullptr, d8, nullptr, k);
  }
  px_final<<<slot_blocks(f, t), kThreads, 0, s>>>(
      xs, ys, k, d8, static_cast<int32_t*>(labels), total, f, h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
