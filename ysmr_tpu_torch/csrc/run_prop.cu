// Run-graph connected components: every run takes the minimum initial label
// of its component, by a union-find with the minimum carried at the roots.
//
// Replaces ysmr_tpu/ops/pallas_run_prop.py::propagate_min_fused (Pallas,
// kernel _prop_kernel). Same contract as the plain version
// ysmr_tpu_torch/ops/run_cc.py::propagate_min at its fixpoint: every run
// ends at the minimum initial label over its component of the run graph,
// where the graph is
//   - the same-row chain: link[i] joins run i and run i + 1;
//   - four window endpoints per run (first and last overlapping run in the
//     row above and below), valid where ok_up / ok_dn say so, clamped into
//     [0, R);
//   - the path-halving edge of the plain version, i ~ (init[i] mod R): a
//     label names a run of its own component (labels >= R encode the "weak"
//     class of the marker reconstruction), so on the pipeline's inputs this
//     edge joins nothing new.
// The plain version sweeps these edges until nothing changes and reads the
// endpoints in one direction only; the run tables make that symmetric (a
// run that sees another in its window is in the other's window, and the
// runs of a window are chained by links), and then its fixpoint is the
// component-wise minimum computed here. The TPU kernel and the plain
// version stop after max_iters sweeps; this kernel has no sweeps and always
// reaches the fixpoint (steps = 0 for every frame).
//
// Design. One array A of R entries per frame holds the forest and the
// minima together: a non-root's entry is its parent's index (< 2^31), a
// root's entry is kRoot | (the minimum initial label of its tree). A union
// links the larger root under the smaller with one compare-and-swap on the
// root's entry (which fails, and retries, if the root was linked or its
// minimum lowered meanwhile), then lowers the minimum of the tree it joined
// with atomicMin, walking up while it meets entries without the tag. The
// partition and the minima do not depend on the schedule. Three phases:
// A[i] = kRoot | init[i]; the unions of every run's edges; out[i] = the
// minimum at the root of i. The window planes, the two ok planes and the
// links are read as the pipeline holds them (int32, bool), once each.
//
// One thread per run over a grid of T * R threads, A in a global scratch
// buffer that stays in the L2, one launch per phase. (One block per frame
// with A in shared memory would be one launch, but a thread then walks
// R / 1024 runs in turn: four times slower at R = 32768 on an H100.)
//
// What bounds it on an H100: the latency of the dependent loads of the root
// walks through the L2, and three launches; the tables of a batch are 30
// bytes a run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGridThreads = 256;
constexpr uint32_t kRoot = 0x80000000u;

struct Graph {
  const int32_t* init;
  const int32_t* lo_up;
  const int32_t* hi_up;
  const int32_t* lo_dn;
  const int32_t* hi_dn;
  const uint8_t* ok_up;
  const uint8_t* ok_dn;
  const uint8_t* link;
  // elements from one frame's row to the next in the four endpoint planes
  // (they may be slices along R of a wider table); the others are (T, R)
  int64_t lo_up_stride, hi_up_stride, lo_dn_stride, hi_dn_stride;
};

// Unites the trees of a and b in the tagged forest `fa` (see above);
// returns the root it left them under (a good place to start the next walk
// from a).
__device__ uint32_t unite(uint32_t* fa, uint32_t a, uint32_t b) {
  const volatile uint32_t* v = fa;
  while (true) {
    uint32_t va = v[a];
    while (!(va & kRoot)) {
      a = va;
      va = v[a];
    }
    uint32_t vb = v[b];
    while (!(vb & kRoot)) {
      b = vb;
      vb = v[b];
    }
    if (a == b) return a;
    if (a < b) {
      uint32_t t = a;
      a = b;
      b = t;
      t = va;
      va = vb;
      vb = t;
    }
    // link the larger root a under b, if a is still the root it was read as
    if (atomicCAS(fa + a, va, b) != va) continue;
    // a's minimum goes to the root above b, unless b's was as low when it
    // was read (minima only fall, and a root that is linked passes its own
    // on). An entry without the tag is left as it is by the atomicMin (an
    // index is below every tagged value) and names the next node up.
    for (uint32_t x = b; va < vb;) {
      const uint32_t old = atomicMin(fa + x, va);
      if (old & kRoot) break;
      x = old;
    }
    return b;
  }
}

__device__ __forceinline__ int32_t clamp_run(int32_t i, int r) {
  return min(max(i, 0), r - 1);
}

// run j of frame f has run i as an endpoint of its upper window: j's own
// thread unites the two
__device__ __forceinline__ bool up_edge_of(const Graph& g, int64_t f, int j,
                                           int i, int r) {
  // three independent loads, no short circuit between them
  const bool ok = g.ok_up[f * r + j];
  const int32_t lo = clamp_run(g.lo_up[f * g.lo_up_stride + j], r);
  const int32_t hi = clamp_run(g.hi_up[f * g.hi_up_stride + j], r);
  return ok & ((lo == i) | (hi == i));
}

// The unions of the edges of run i of frame f; `fa` is the frame's forest.
// Everything is loaded before the first union (the walks are chains of
// dependent loads, the tables need not be). An edge to a lower endpoint
// that has run i as its own upper endpoint is left to that run.
__device__ __forceinline__ void unite_edges(const Graph& g, int64_t f,
                                            uint32_t* fa, int i, int r) {
  const int64_t k = f * r + i;
  const bool chain = i + 1 < r && g.link[k];
  const bool ok_up = g.ok_up[k], ok_dn = g.ok_dn[k];
  const int32_t up_lo = clamp_run(g.lo_up[f * g.lo_up_stride + i], r);
  const int32_t up_hi = clamp_run(g.hi_up[f * g.hi_up_stride + i], r);
  const int32_t dn_lo = clamp_run(g.lo_dn[f * g.lo_dn_stride + i], r);
  const int32_t dn_hi = clamp_run(g.hi_dn[f * g.hi_dn_stride + i], r);
  const int32_t l = g.init[k];
  const int32_t tgt = clamp_run(l >= r ? l - r : l, r);
  const bool lo_theirs = up_edge_of(g, f, dn_lo, i, r);
  const bool hi_theirs = up_edge_of(g, f, dn_hi, i, r);
  const bool to_dn_lo = ok_dn && dn_lo != i && !lo_theirs;
  const bool to_dn_hi = ok_dn && dn_hi != i && dn_hi != dn_lo && !hi_theirs;
  uint32_t me = i;
  if (chain) me = unite(fa, me, i + 1);
  if (ok_up && up_lo != i) me = unite(fa, me, up_lo);
  if (ok_up && up_hi != i && up_hi != up_lo) me = unite(fa, me, up_hi);
  if (to_dn_lo) me = unite(fa, me, dn_lo);
  if (to_dn_hi) me = unite(fa, me, dn_hi);
  if (tgt != i) unite(fa, me, tgt);
}

__device__ __forceinline__ int32_t root_min(const uint32_t* fa, uint32_t x) {
  uint32_t v = fa[x];
  while (!(v & kRoot)) v = fa[v];
  return static_cast<int32_t>(v & ~kRoot);
}

// the three phases over one thread per run, the forest in `fa` (T, R)
__global__ void __launch_bounds__(kGridThreads)
run_prop_init(const int32_t* __restrict__ init, uint32_t* __restrict__ fa,
              int64_t total) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kGridThreads +
                      threadIdx.x;
  if (idx < total) fa[idx] = kRoot | static_cast<uint32_t>(init[idx]);
}

__global__ void __launch_bounds__(kGridThreads)
run_prop_unite(Graph g, uint32_t* fa, int64_t total, int r) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kGridThreads +
                      threadIdx.x;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % r);
  unite_edges(g, idx / r, fa + (idx - i), i, r);
}

__global__ void __launch_bounds__(kGridThreads)
run_prop_out(const uint32_t* __restrict__ fa, int32_t* __restrict__ out,
             int32_t* __restrict__ steps, int64_t total, int r) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kGridThreads +
                      threadIdx.x;
  if (idx >= total) return;
  const int i = static_cast<int>(idx % r);
  out[idx] = root_min(fa + (idx - i), i);
  if (i == 0) steps[idx / r] = 0;
}

}  // namespace

extern "C" {

// init, out: (T, R) int32, 0 <= init < 2R; lo_up, hi_up, lo_dn, hi_dn:
// (T, R) int32 window endpoints, frame f's row at strides[j] * f elements
// (strides: four int64 on the host); ok_up, ok_dn, link: (T, R) uint8 (0/1);
// scratch: (T, R) int32, the forest; steps: (T,) int32 out, all 0;
// max_iters 0 copies init. Three launches (two for max_iters 0). All on CUDA
// device `device`, launched on `stream`. Returns a cudaError_t (0 =
// launched).
int ysmr_run_prop(const void* init, const void* lo_up, const void* hi_up,
                  const void* lo_dn, const void* hi_dn, const void* ok_up,
                  const void* ok_dn, const void* link,
                  const int64_t* strides, void* scratch, void* out,
                  void* steps, int t, int r, int max_iters, int device,
                  void* stream) {
  if (t <= 0 || r <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Graph g = {static_cast<const int32_t*>(init),
                   static_cast<const int32_t*>(lo_up),
                   static_cast<const int32_t*>(hi_up),
                   static_cast<const int32_t*>(lo_dn),
                   static_cast<const int32_t*>(hi_dn),
                   static_cast<const uint8_t*>(ok_up),
                   static_cast<const uint8_t*>(ok_dn),
                   static_cast<const uint8_t*>(link),
                   strides[0], strides[1], strides[2], strides[3]};
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* st = static_cast<int32_t*>(steps);
  uint32_t* fa = static_cast<uint32_t*>(scratch);
  const int64_t total = static_cast<int64_t>(t) * r;
  const unsigned blocks =
      static_cast<unsigned>((total + kGridThreads - 1) / kGridThreads);
  run_prop_init<<<blocks, kGridThreads, 0, s>>>(g.init, fa, total);
  if (max_iters > 0) {
    run_prop_unite<<<blocks, kGridThreads, 0, s>>>(g, fa, total, r);
  }
  run_prop_out<<<blocks, kGridThreads, 0, s>>>(fa, o, st, total, r);
  return static_cast<int>(cudaGetLastError());
}

const char* ysmr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
