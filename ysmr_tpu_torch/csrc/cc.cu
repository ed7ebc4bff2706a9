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
// Design (Playne-Hawick union-find, three or four passes over one grid of
// T*H*W threads):
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
//             are exact and deterministic. The reconstruction also sets
//             flag[root] = 1 here for every pixel of marker & mask (all
//             writers store 1);
//   keep:     (reconstruction only) out = mask & flag[label].
//
// Differences from the TPU kernels: the Pallas stencil stops after max_iters
// (64) propagation steps, and the Pallas reconstruction after max_iters
// dilation steps, so there a component whose geodesic diameter exceeds that
// keeps split labels, and a mask pixel more than max_iters 4-steps from
// every marker pixel is dropped. These kernels have no iteration loop and
// always compute the fixpoint, as scipy does (and as the JAX CPU path does
// whenever its labeling converged). The TPU's 32-frame bit packing, lane
// rolls and VMEM residency existed for Mosaic and are not carried over.
//
// What bounds it on an H100: init, compress and keep are streaming passes
// (a byte of mask in, four bytes of labels out per pixel: ~0.36 GB per
// 64-frame 1228x922 batch, ~0.1 ms each at 3.35 TB/s). The merge does work
// only on foreground pixels (a few per cent of a frame); its cost is the
// latency of the root walks and the atomics, which stay in L2 for
// bacteria-sized components.
//
// The third entry, ysmr_cc_pixels, replaces cc_labels_at_pixels of the same
// Pallas file (kernel _make_kernel): per frame a list of F foreground pixels
// (x, y, valid, marker) in raster order; out the keep flag (with the double
// threshold: the pixel's 4-connected component of the valid pixels holds a
// marker pixel; without it: valid) and the label of every kept pixel, the
// minimum linear index y*w + x of its 8-connected component among the kept
// pixels (-1 for the others). The TPU kernel rasterizes the list into a
// frame-sized VMEM buffer and runs the stencil there. Here the union-find
// runs over the list itself, one thread per (frame, slot), so nothing of
// frame size is touched:
//   - a pixel's left neighbour is slot i - 1 when its lin is lin - 1; its
//     upper neighbours (lin - w - 1 .. lin - w + 1) are found by a binary
//     search over slots [i - w - 1, i): the lins in between are distinct
//     integers of one row's span. No lin -> slot map is built, so there is
//     none to clear: a frame-sized map would be 64 x 1,132,216 x 4 B =
//     290 MB per 64-frame 1228x922 batch to memset (~87 us at 3.35 TB/s,
//     over 30x the ~2.3 us the pixel lists themselves need), and resetting
//     it at the listed positions would keep frame-sized state alive
//     between calls;
//   - unions link the larger root under the smaller slot with atomicMin, as
//     above, so each root is its component's first slot, whose lin is the
//     minimum (raster order); the labels are schedule-independent;
//   - passes: init (lin, parent = slot, flag = 0, keep = valid), then with
//     the double threshold merge over 4-neighbours of the valid pixels,
//     compress with flag[root] = 1 for marker pixels, and keep = valid &
//     flag[root] with the parents reset; then merge over the 8-neighbours
//     of the kept pixels and a final pass that writes lin[root] or -1.
// Contract: the valid pixels of each frame form a prefix of its list, with
// strictly ascending lin (every wire of the pipeline gives that). The TPU
// kernel stops after max_iters stencil steps; this one always reaches the
// fixpoint. Bound: the lists, 15 bytes a slot (x, y int32, two bools in;
// int32 label and bool out), ~7.9 MB per 64 x 8192 batch (~2.3 us) and
// ~126 MB at F = 131072 (~38 us); at the bench size the six launches cost
// more than the bytes.

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
cc_compress(const uint8_t* __restrict__ mask,
            const uint8_t* __restrict__ marker, int32_t* lab,
            uint8_t* __restrict__ flag, int64_t total, int32_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total || !mask[idx]) return;
  const int64_t base = idx - idx % n;
  // other threads store roots meanwhile: a read returns the old parent or
  // the root, both ancestors
  const int32_t root = find_root(lab + base,
                                 static_cast<int32_t>(idx - base));
  lab[idx] = root;
  if (marker != nullptr && marker[idx]) flag[base + root] = 1;
}

__global__ void __launch_bounds__(kThreads)
rec_keep(const uint8_t* __restrict__ mask, const int32_t* __restrict__ lab,
         const uint8_t* __restrict__ flag, uint8_t* __restrict__ out,
         int64_t total, int32_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  out[idx] = mask[idx] && flag[idx - idx % n + lab[idx]];
}

unsigned blocks_for(int64_t total) {
  return static_cast<unsigned>((total + kThreads - 1) / kThreads);
}

// ---- pixel lists (ysmr_cc_pixels) ----

__global__ void __launch_bounds__(kThreads)
px_init(const int32_t* __restrict__ xs, const int32_t* __restrict__ ys,
        const uint8_t* __restrict__ valid, int32_t* __restrict__ lin,
        int32_t* __restrict__ parent, uint8_t* __restrict__ flag,
        uint8_t* __restrict__ keep, int64_t total, int f, int h, int w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  // coordinates clamped into the frame, as the TPU kernel addresses them
  const int x = min(max(xs[idx], 0), w - 1);
  const int y = min(max(ys[idx], 0), h - 1);
  lin[idx] = y * w + x;
  parent[idx] = static_cast<int32_t>(idx % f);
  flag[idx] = 0;
  keep[idx] = valid[idx];
}

// unites slot i with its active neighbours among the earlier slots
template <int kConn>
__global__ void __launch_bounds__(kThreads)
px_merge(const uint8_t* __restrict__ active, const int32_t* __restrict__ lin,
         int32_t* parent, int64_t total, int f, int w) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total || !active[idx]) return;
  const int64_t base = idx - idx % f;
  const int32_t i = static_cast<int32_t>(idx - base);
  const int32_t* l = lin + base;
  const uint8_t* a = active + base;
  int32_t* p = parent + base;
  const int32_t v = l[i];
  const int y = v / w;
  const int x = v - y * w;
  if (x > 0 && i > 0 && l[i - 1] == v - 1 && a[i - 1]) unite(p, i, i - 1);
  if (y == 0) return;
  const int32_t t_lo = v - w - (kConn == 8 && x > 0 ? 1 : 0);
  const int32_t t_hi = v - w + (kConn == 8 && x + 1 < w ? 1 : 0);
  // first slot with lin >= t_lo: at most w + 1 distinct lins lie in
  // [t_lo, v), so it is no earlier than i - w - 1
  int32_t lo = max(0, i - w - 1);
  int32_t hi = i;
  while (lo < hi) {
    const int32_t mid = (lo + hi) >> 1;
    if (l[mid] < t_lo) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  for (int32_t j = lo; j < i && l[j] <= t_hi; ++j) {
    if (a[j]) unite(p, i, j);
  }
}

// 4-connected roots; flag[root] = 1 for every marker pixel
__global__ void __launch_bounds__(kThreads)
px_compress_mark(const uint8_t* __restrict__ valid,
                 const uint8_t* __restrict__ marker, int32_t* parent,
                 uint8_t* __restrict__ flag, int64_t total, int f) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total || !valid[idx]) return;
  const int64_t base = idx - idx % f;
  const int32_t root = find_root(parent + base,
                                 static_cast<int32_t>(idx - base));
  parent[idx] = root;
  if (marker[idx]) flag[base + root] = 1;
}

// keep = valid & flag[root]; the parents restart for the 8-connected pass
// (each thread reads and writes only its own slot here)
__global__ void __launch_bounds__(kThreads)
px_keep(const uint8_t* __restrict__ valid, const uint8_t* __restrict__ flag,
        int32_t* __restrict__ parent, uint8_t* __restrict__ keep,
        int64_t total, int f) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  const int64_t base = idx - idx % f;
  keep[idx] = valid[idx] && flag[base + parent[idx]];
  parent[idx] = static_cast<int32_t>(idx - base);
}

__global__ void __launch_bounds__(kThreads)
px_final(const uint8_t* __restrict__ keep, const int32_t* __restrict__ lin,
         const int32_t* parent, int32_t* __restrict__ labels, int64_t total,
         int f) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (idx >= total) return;
  if (!keep[idx]) {
    labels[idx] = -1;
    return;
  }
  const int64_t base = idx - idx % f;
  labels[idx] = lin[base + find_root(parent + base,
                                     static_cast<int32_t>(idx - base))];
}

// init + merge + compress on `lab`; marker/flag as in cc_compress
cudaError_t label(const uint8_t* mask, const uint8_t* marker, int32_t* lab,
                  uint8_t* flag, int t, int h, int w, int connectivity,
                  cudaStream_t s) {
  const int32_t n = h * w;
  const int64_t total = static_cast<int64_t>(t) * n;
  const unsigned blocks = blocks_for(total);
  cc_init<<<blocks, kThreads, 0, s>>>(mask, lab, total, n);
  if (connectivity == 8) {
    cc_merge<8><<<blocks, kThreads, 0, s>>>(mask, lab, total, h, w);
  } else {
    cc_merge<4><<<blocks, kThreads, 0, s>>>(mask, lab, total, h, w);
  }
  cc_compress<<<blocks, kThreads, 0, s>>>(mask, marker, lab, flag, total, n);
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
  return static_cast<int>(label(static_cast<const uint8_t*>(mask), nullptr,
                                static_cast<int32_t*>(labels), nullptr, t, h,
                                w, connectivity,
                                static_cast<cudaStream_t>(stream)));
}

// mask, marker: (T, H, W) uint8 (0/1); labels: (T, H, W) int32 scratch;
// flag: (T, H, W) uint8 scratch, zero on entry; out: (T, H, W) uint8.
// Returns a cudaError_t (0 = launched).
int ysmr_cc_reconstruct(const void* mask, const void* marker, void* labels,
                        void* flag, void* out, int t, int h, int w,
                        int device, void* stream) {
  if (t <= 0 || h <= 0 || w <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* lab = static_cast<int32_t*>(labels);
  uint8_t* f = static_cast<uint8_t*>(flag);
  err = label(m, static_cast<const uint8_t*>(marker), lab, f, t, h, w, 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(t) * h * w;
  rec_keep<<<blocks_for(total), kThreads, 0, s>>>(
      m, lab, f, static_cast<uint8_t*>(out), total, h * w);
  return static_cast<int>(cudaGetLastError());
}

// px_x, px_y: (T, F) int32; valid, marker: (T, F) uint8 (0/1); lin, parent:
// (T, F) int32 scratch; flag: (T, F) uint8 scratch; labels: (T, F) int32
// out; keep: (T, F) uint8 out. H * W < 2^31. Returns a cudaError_t.
int ysmr_cc_pixels(const void* px_x, const void* px_y, const void* valid,
                   const void* marker, void* lin, void* parent, void* flag,
                   void* labels, void* keep, int t, int f, int h, int w,
                   int double_threshold, int device, void* stream) {
  if (t <= 0 || f <= 0 || h <= 0 || w <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t total = static_cast<int64_t>(t) * f;
  const unsigned blocks = blocks_for(total);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int32_t* l = static_cast<int32_t*>(lin);
  int32_t* p = static_cast<int32_t*>(parent);
  uint8_t* fl = static_cast<uint8_t*>(flag);
  uint8_t* k = static_cast<uint8_t*>(keep);
  px_init<<<blocks, kThreads, 0, s>>>(static_cast<const int32_t*>(px_x),
                                      static_cast<const int32_t*>(px_y), v,
                                      l, p, fl, k, total, f, h, w);
  if (double_threshold) {
    px_merge<4><<<blocks, kThreads, 0, s>>>(v, l, p, total, f, w);
    px_compress_mark<<<blocks, kThreads, 0, s>>>(
        v, static_cast<const uint8_t*>(marker), p, fl, total, f);
    px_keep<<<blocks, kThreads, 0, s>>>(v, fl, p, k, total, f);
  }
  px_merge<8><<<blocks, kThreads, 0, s>>>(k, l, p, total, f, w);
  px_final<<<blocks, kThreads, 0, s>>>(k, l, p, static_cast<int32_t*>(labels),
                                       total, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
