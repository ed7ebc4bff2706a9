// Run-graph connected components: the min-label fixpoint, one block per frame.
//
// Replaces ysmr_tpu/ops/pallas_run_prop.py::propagate_min_fused (Pallas,
// kernel _prop_kernel). Same contract as the plain version
// ysmr_tpu_torch/ops/run_cc.py::propagate_min: every run ends at the minimum
// initial label over its component of the run graph, where the graph is
//   - the same-row chain: link[i] joins run i and run i + 1;
//   - four window endpoints per run (first and last overlapping run in the
//     row above and below), given as indices with invalid ones pointing at
//     the run itself;
//   - path halving through label mod R (a label names a run of its own
//     component; labels >= R encode the "weak" class of the marker
//     reconstruction).
// The minimum fixpoint is unique, so any schedule that reaches it gives the
// same labels. The TPU kernel's near-diagonal gather split only existed
// because Mosaic gathers stay inside one 128-lane row; here a gather is a
// plain load.
//
// Design: one block per frame, threads strided over the runs, labels in
// shared memory when 4*R bytes fit (global memory otherwise). Each sweep
// relaxes every run in place (Gauss-Seidel): a thread writes only its own
// runs, labels only decrease and stay inside the component, so a load that
// races with another thread's store returns an older or newer valid label
// and cannot break correctness. A sweep in which no label changed proves the
// fixpoint (__syncthreads_or); the sweeps are capped at max_iters and the
// number of sweeps that changed a label is written per frame, so
// converged <=> steps < max_iters.
//
// What bounds it on an H100: latency, not bandwidth. Each sweep is a chain
// of dependent loads (window endpoints, then the path-halving target) and a
// block barrier; the tables of a batch (labels, four endpoint planes, links:
// 25 bytes per run) fit in the 50 MB L2 at every R the pipeline uses.
// A batch is T blocks (64 on the main path), which leaves most of the 132
// SMs idle: splitting frames across blocks or packing several frames per
// block is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
// labels go to shared memory up to this size (the card allows 227 KB)
constexpr int kMaxSharedBytes = 200 * 1024;

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
run_prop_kernel(const int32_t* __restrict__ init,
                const int32_t* __restrict__ idx4,
                const uint8_t* __restrict__ link,
                int32_t* out, int32_t* __restrict__ steps, int r,
                int max_iters) {
  extern __shared__ int32_t smem[];
  const int f = blockIdx.x;
  const size_t base = static_cast<size_t>(f) * r;
  volatile int32_t* lab = kShared ? smem : out + base;
  const int32_t* ini = init + base;
  const int32_t* lo_up = idx4 + 4 * base;
  const int32_t* hi_up = lo_up + r;
  const int32_t* lo_dn = hi_up + r;
  const int32_t* hi_dn = lo_dn + r;
  const uint8_t* lk = link + base;

  for (int i = threadIdx.x; i < r; i += blockDim.x) lab[i] = ini[i];
  __syncthreads();

  int changed_sweeps = 0;
  for (int it = 0; it < max_iters; ++it) {
    int changed = 0;
    for (int i = threadIdx.x; i < r; i += blockDim.x) {
      const int32_t old = lab[i];
      int32_t l = old;
      if (i + 1 < r && lk[i]) l = min(l, lab[i + 1]);
      if (i > 0 && lk[i - 1]) l = min(l, lab[i - 1]);
      l = min(l, lab[lo_up[i]]);
      l = min(l, lab[hi_up[i]]);
      l = min(l, lab[lo_dn[i]]);
      l = min(l, lab[hi_dn[i]]);
      int32_t tgt = l >= r ? l - r : l;
      tgt = min(max(tgt, 0), r - 1);
      l = min(l, lab[tgt]);
      if (l < old) {
        lab[i] = l;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
    ++changed_sweeps;
  }
  if (kShared) {
    for (int i = threadIdx.x; i < r; i += blockDim.x) out[base + i] = lab[i];
  }
  if (threadIdx.x == 0) steps[f] = changed_sweeps;
}

}  // namespace

extern "C" {

// init, out: (T, R) int32; idx4: (T, 4, R) int32 window endpoints in
// [0, R) (lo_up, hi_up, lo_dn, hi_dn; invalid = the run itself); link:
// (T, R) uint8; steps: (T,) int32; all on CUDA device `device`, launched
// on `stream`. Returns a cudaError_t (0 = launched).
int ysmr_run_prop(const void* init, const void* idx4, const void* link,
                  void* out, void* steps, int t, int r, int max_iters,
                  int device, void* stream) {
  if (t <= 0 || r <= 0) return 0;
  cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return static_cast<int>(dev_err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(r) * sizeof(int32_t);
  const int32_t* in = static_cast<const int32_t*>(init);
  const int32_t* ix = static_cast<const int32_t*>(idx4);
  const uint8_t* lk = static_cast<const uint8_t*>(link);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* st = static_cast<int32_t*>(steps);
  if (bytes <= static_cast<size_t>(kMaxSharedBytes)) {
    cudaError_t err = cudaFuncSetAttribute(
        run_prop_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    run_prop_kernel<true><<<t, kThreads, bytes, s>>>(in, ix, lk, o, st, r,
                                                     max_iters);
  } else {
    run_prop_kernel<false><<<t, kThreads, 0, s>>>(in, ix, lk, o, st, r,
                                                  max_iters);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ysmr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
