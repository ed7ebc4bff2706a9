// The tracker's GSFF block: the register fill of new tracks and one
// correct/predict step of the Gaussian-sum FIR filter bank, for every slot
// of the flat (V * S) slot table, in one launch.
//
// Replaces the plain-XLA ysmr_tpu/ops/gsff.py::_step together with the
// register fill inlined at ysmr_tpu/pipeline/tracker.py:240-249 (no Pallas
// kernel: XLA fuses both inside the jitted scan). Same contract and the
// same bits as ysmr_tpu_torch/ops/gsff.py::register_and_step_plain, the
// torch sequence register_slots + _step, which runs each double-single
// operation of ops/ds.py as its own elementwise pass.
//
// Bits: every float32 sum, difference and product is an _rn intrinsic
// (nvcc contracts a plain a * b + c into an fma by default), in ds.py's
// order: two_sum, quick_two_sum, two_prod with the Veltkamp split by the
// float32 product 4097 * a. The estimates are ds.dot_tree over the full
// 2 * n_max window, zero-padded gains of the shorter filters included (the
// pairing depends on the width, and a product with a zero gain can be
// -0): the first half adds the second at every level, an odd level first
// folds its last element into element 0. The squared innovation is
// dh * dh + (2 * dh) * dl, the filter sums run left to right, exp and log
// run in float64 (the math library's, as torch's CUDA kernels call them)
// and round to float32, and lw - lw_max is formed in float32 first.
//
// Design: a block holds sb slots and 4 * n_f threads per slot; thread d of
// a slot computes one of its 4 * n_f double-single estimates (before or
// after the append, filter d / 2 mod n_f, coordinate d mod 2). It forms
// the window's entries from the ring on the fly (the slot's threads read
// the same ring, through L1), writes the first level of the tree to its
// own column of a dynamic shared-memory scratch ([entry][thread]: a warp's
// accesses fall in distinct banks), reduces it in place and leaves the
// estimate in shared memory. After a barrier one thread per slot runs the
// mode growth, the weights, the corrected output and the prediction; then
// the block writes its slots' rings (shifted for active slots, filled for
// registered ones), consecutive threads on consecutive floats. Inactive
// slots skip the estimates: the plain version drops them. No allocation,
// no host synchronisation.
//
// Cap: one slot's block needs 4 * (4 n_f (2 n_max + 2) + 2 n_f) bytes of
// shared memory, at most 232,448, and 4 n_f threads, at most 1024:
// n_max <= 906 at n_f = 8, 2420 at n_f = 3 (ops/gsff.py::kernel_takes).
//
// What bounds it on an H100: operations. Per active slot two windows of
// 2 n_max double-single differences and 4 n_f dots of a double-single
// product (24 float operations) and a tree add (11) per entry, against
// about 1.1 KB of state in and out: at N = 4096, n_f = 3, n_max = 30 about
// 109 MFLOP (1.6 us at 67 TFLOP/s) and 4.4 MB (1.3 us at 3.35 TB/s). The
// TPU had no kernel here; XLA fused the step into the scan's body.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTargetThreads = 128;
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxShared = 232448;
// float32(-1e30) and float32(log(1e-20)): ops/gsff.py's NEG_INF and
// _LOG_LIK_MIN
constexpr float kNegInf = -0x1.93e594p+99f;
constexpr float kLogLikMin = -0x1.7069e2p+5f;

struct Ds {
  float h, l;
};

__device__ __forceinline__ Ds two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

__device__ __forceinline__ Ds quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ Ds two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  const float ca = __fmul_rn(4097.0f, a);
  const float ah = __fsub_rn(ca, __fsub_rn(ca, a));
  const float al = __fsub_rn(a, ah);
  const float cb = __fmul_rn(4097.0f, b);
  const float bh = __fsub_rn(cb, __fsub_rn(cb, b));
  const float bl = __fsub_rn(b, bh);
  const float e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)),
                __fmul_rn(al, bh)),
      __fmul_rn(al, bl));
  return {p, e};
}

__device__ __forceinline__ Ds ds_add(Ds x, Ds y) {
  const Ds s = two_sum(x.h, y.h);
  return quick_two_sum(s.h, __fadd_rn(s.l, __fadd_rn(x.l, y.l)));
}

__device__ __forceinline__ Ds ds_sub(Ds x, Ds y) {
  return ds_add(x, {-y.h, -y.l});
}

__device__ __forceinline__ Ds ds_mul(Ds x, Ds y) {
  const Ds p = two_prod(x.h, y.h);
  const float cross = __fadd_rn(__fmul_rn(x.h, y.l), __fmul_rn(x.l, y.h));
  return quick_two_sum(p.h, __fadd_rn(p.l, cross));
}

__device__ __forceinline__ float exp_f(float x) {
  return __double2float_rn(exp(static_cast<double>(x)));
}

__device__ __forceinline__ float log_f(float x) {
  return __double2float_rn(log(static_cast<double>(x)));
}

// torch.amax's NaN-propagating maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct Args {
  const float* buf;      // (N, n_max + 1, 2)
  const float* buf_lo;   // (N, n_max + 1, 2)
  const int* len;        // (N,)
  const int* mode;       // (N,)
  const float* log_w;    // (N, n_f)
  const float* pred_lo;  // (N, 2)
  const float* gains;    // (2, n_f, 2, 2 n_max): hi, lo
  const int* n_i;        // (n_f,)
  const float* m;        // (N, 2)
  const uint8_t* active;
  const uint8_t* reg;
  const uint8_t* coast;
  float* out_buf;
  float* out_buf_lo;
  int* out_len;
  int* out_mode;
  float* out_log_w;
  float* out_pred_lo;
  float* corrected;
  float* predicted;
  int n, n_max, n_f, n_i0, sb;
};

// One slot's inputs after the register fill.
struct Slot {
  const float* buf;
  const float* lo;
  bool reg;
  Ds m[2];  // the measurement and its lo half (a coasting slot's pred_lo)

  __device__ __forceinline__ Ds ring(int j, int c) const {
    return reg ? Ds{m[c].h, 0.0f} : Ds{buf[2 * j + c], lo[2 * j + c]};
  }
};

// center + gains[f][r] . (window - center) in double-single, the window
// the last n_max ring entries before the append or after it; the tree's
// entries live at sh[i * stride], sl[i * stride].
__device__ Ds estimate(const Args& a, const Slot& s, bool post, int f, int r,
                       float* sh, float* sl, int stride) {
  const int n_max = a.n_max, w2 = 2 * n_max;
  const float* gh = a.gains + (static_cast<int64_t>(f) * 2 + r) * w2;
  const float* gl = gh + static_cast<int64_t>(a.n_f) * 2 * w2;
  Ds center[2];
  for (int c = 0; c < 2; ++c) center[c] = post ? s.m[c] : s.ring(n_max, c);
  auto product = [&](int k) {
    const int j = k / 2 + 1, c = k % 2;
    const Ds v = !post       ? s.ring(j, c)
                 : j < n_max ? s.ring(j + 1, c)
                             : s.m[c];
    return ds_mul({__ldg(gh + k), __ldg(gl + k)}, ds_sub(v, center[c]));
  };
  // the tree's first level: the width 2 n_max is even, so nothing folds
  for (int i = 0; i < n_max; ++i) {
    const Ds v = ds_add(product(i), product(i + n_max));
    sh[i * stride] = v.h;
    sl[i * stride] = v.l;
  }
  for (int n = n_max; n > 1;) {
    const int half = n / 2;
    if (n % 2) {
      const int k = (n - 1) * stride;
      const Ds v = ds_add({sh[0], sl[0]}, {sh[k], sl[k]});
      sh[0] = v.h;
      sl[0] = v.l;
    }
    for (int i = 0; i < half; ++i) {
      const int k = i * stride, q = (i + half) * stride;
      const Ds v = ds_add({sh[k], sl[k]}, {sh[q], sl[q]});
      sh[k] = v.h;
      sl[k] = v.l;
    }
    n = half;
  }
  return ds_add(center[r], {sh[0], sl[0]});
}

// The slot's weights, outputs and scalar state; eh/el hold its 4 n_f
// estimates (before the append at 2 f + r, after it at 2 n_f + 2 f + r),
// lw and wt are n_f floats of shared scratch.
__device__ void finish_slot(const Args& a, const Slot& s, bool act,
                            int64_t slot, const float* eh, const float* el,
                            float* lw, float* wt) {
  const int n_f = a.n_f;
  const int length = s.reg ? a.n_i0 : a.len[slot];
  const int mode = s.reg ? 0 : a.mode[slot];
  const float* log_w = a.log_w + slot * n_f;
  float* out_lw = a.out_log_w + slot * n_f;
  if (!act) {
    a.out_len[slot] = length;
    a.out_mode[slot] = mode;
    for (int f = 0; f < n_f; ++f) out_lw[f] = s.reg ? kNegInf : log_w[f];
    for (int c = 0; c < 2; ++c) {
      a.out_pred_lo[2 * slot + c] = s.reg ? 0.0f : a.pred_lo[2 * slot + c];
      a.corrected[2 * slot + c] = 0.0f;
      a.predicted[2 * slot + c] = 0.0f;
    }
    return;
  }
  // (a) mode growth: n_f rounds of a clamped lookup into n_i
  int grown = mode;
  for (int i = 0; i < n_f; ++i) {
    const int at = min(max(grown, 0), n_f - 1);
    grown += (grown < n_f && length >= __ldg(a.n_i + at)) ? 1 : 0;
  }
  const bool grew = grown > mode;
  // (b) uniform weights on a transition
  const float uniform = -log_f(static_cast<float>(max(grown, 1)));
  // (d) log likelihoods floored at the likelihood minimum, (e) the update
  float lw_max = 0.0f;
  for (int f = 0; f < n_f; ++f) {
    float v = kNegInf;
    if (f < grown) {
      const float lw_in = grew ? uniform : (s.reg ? kNegInf : log_w[f]);
      float sq[2];
      for (int r = 0; r < 2; ++r) {
        const Ds diff = ds_sub(s.m[r], {eh[2 * f + r], el[2 * f + r]});
        sq[r] = __fadd_rn(__fmul_rn(diff.h, diff.h),
                          __fmul_rn(__fmul_rn(2.0f, diff.h), diff.l));
      }
      float log_lik = __fmul_rn(-0.5f, __fadd_rn(sq[0], sq[1]));
      if (log_lik < kLogLikMin) log_lik = kLogLikMin;  // NaN stays
      v = __fadd_rn(lw_in, log_lik);
    }
    lw[f] = v;
    lw_max = f == 0 ? v : max_nan(lw_max, v);
  }
  float sum = 0.0f;
  for (int f = 0; f < n_f; ++f) {
    const float e = exp_f(__fsub_rn(lw[f], lw_max));
    sum = f == 0 ? e : __fadd_rn(sum, e);
  }
  const float lse = __fadd_rn(lw_max, log_f(sum));
  for (int f = 0; f < n_f; ++f) {
    const float v = f < grown ? __fsub_rn(lw[f], lse) : kNegInf;
    out_lw[f] = v;
    wt[f] = f < grown ? exp_f(v) : 0.0f;
  }
  // (f) the weighted pre-append estimates, (g) the post-append ones
  const int post = 2 * n_f;
  for (int r = 0; r < 2; ++r) {
    Ds corr = ds_mul({eh[r], el[r]}, {wt[0], 0.0f});
    Ds pred = ds_mul({eh[post + r], el[post + r]}, {wt[0], 0.0f});
    for (int f = 1; f < n_f; ++f) {
      const int k = 2 * f + r;
      corr = ds_add(corr, ds_mul({eh[k], el[k]}, {wt[f], 0.0f}));
      pred = ds_add(pred, ds_mul({eh[post + k], el[post + k]}, {wt[f], 0.0f}));
    }
    a.corrected[2 * slot + r] = __fadd_rn(corr.h, corr.l);
    a.predicted[2 * slot + r] = pred.h;
    a.out_pred_lo[2 * slot + r] = pred.l;
  }
  a.out_len[slot] = min(length + 1, a.n_max + 1);
  a.out_mode[slot] = grown;
}

__global__ void gsff_kernel(Args a) {
  extern __shared__ float smem[];
  const int lanes = 4 * a.n_f, nt = blockDim.x;
  float* scr_h = smem;                  // (n_max, nt)
  float* scr_l = scr_h + a.n_max * nt;  // (n_max, nt)
  float* est_h = scr_l + a.n_max * nt;  // (nt,)
  float* est_l = est_h + nt;            // (nt,)
  float* lw = est_l + nt;               // (sb, n_f)
  float* wt = lw + a.sb * a.n_f;        // (sb, n_f)
  const int t = threadIdx.x, local = t / lanes, d = t % lanes;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * a.sb;
  const int64_t slot = first + local;
  const bool live = slot < a.n;
  const int per = 2 * (a.n_max + 1);
  Slot s{};
  bool act = false;
  if (live) {
    act = a.active[slot] != 0;
    s.reg = a.reg[slot] != 0;
    s.buf = a.buf + slot * per;
    s.lo = a.buf_lo + slot * per;
    const bool coast = a.coast[slot] != 0;
    for (int c = 0; c < 2; ++c)
      s.m[c] = {a.m[2 * slot + c], coast ? a.pred_lo[2 * slot + c] : 0.0f};
  }
  if (act) {
    const Ds x = estimate(a, s, d >= 2 * a.n_f, (d / 2) % a.n_f, d % 2,
                          scr_h + t, scr_l + t, nt);
    est_h[t] = x.h;
    est_l[t] = x.l;
  }
  __syncthreads();
  if (live && d == 0)
    finish_slot(a, s, act, slot, est_h + t, est_l + t, lw + local * a.n_f,
                wt + local * a.n_f);
  // the rings: entry j + 1 moves to j and the measurement is appended on
  // an active slot; the filled or the old ring stays on an inactive one
  const int64_t slots = a.n - first < a.sb ? a.n - first : a.sb;
  const int64_t total = slots * per;
  for (int64_t e = t; e < total; e += nt) {
    const int64_t at = first * per + e;
    const int64_t sl = first + e / per;
    const int q = static_cast<int>(e % per), c = q % 2;
    const bool on = a.active[sl] != 0, filled = a.reg[sl] != 0;
    float h, l;
    if (on && q / 2 == a.n_max) {
      h = a.m[2 * sl + c];
      l = a.coast[sl] ? a.pred_lo[2 * sl + c] : 0.0f;
    } else {
      const int64_t src = on ? at + 2 : at;
      h = filled ? a.m[2 * sl + c] : a.buf[src];
      l = filled ? 0.0f : a.buf_lo[src];
    }
    a.out_buf[at] = h;
    a.out_buf_lo[at] = l;
  }
}

size_t shared_bytes(int sb, int n_f, int n_max) {
  const size_t threads = static_cast<size_t>(sb) * 4 * n_f;
  return 4 * (threads * (2 * static_cast<size_t>(n_max) + 2) +
              2 * static_cast<size_t>(sb) * n_f);
}

}  // namespace

extern "C" {

// buf, buf_lo: (N, n_max + 1, 2) float32; len, mode: (N,) int32; log_w:
// (N, n_f) float32; pred_lo, m: (N, 2) float32; gains: (2, n_f, 2,
// 2 n_max) float32; n_i: (n_f,) int32; active, reg, coast: (N,) bool; the
// outputs shaped as their inputs, corrected and predicted (N, 2) float32;
// all contiguous on CUDA device `device`, launched on `stream`. Returns a
// cudaError_t (0 = launched; cudaErrorInvalidValue past the cap).
int ysmr_gsff_step(const void* buf, const void* buf_lo, const void* len,
                   const void* mode, const void* log_w, const void* pred_lo,
                   const void* gains, const void* n_i, const void* m,
                   const void* active, const void* reg, const void* coast,
                   void* out_buf, void* out_buf_lo, void* out_len,
                   void* out_mode, void* out_log_w, void* out_pred_lo,
                   void* corrected, void* predicted, int n, int n_max,
                   int n_f, int n_i0, int device, void* stream) {
  if (n <= 0) return 0;
  if (n_max < 1 || n_f < 1 || 4 * n_f > kMaxThreads ||
      shared_bytes(1, n_f, n_max) > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sb = kTargetThreads / (4 * n_f);
  if (sb < 1) sb = 1;
  if (sb > n) sb = n;
  while (sb > 1 && shared_bytes(sb, n_f, n_max) > kMaxShared) --sb;
  const size_t bytes = shared_bytes(sb, n_f, n_max);
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(gsff_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a{static_cast<const float*>(buf), static_cast<const float*>(buf_lo),
         static_cast<const int*>(len), static_cast<const int*>(mode),
         static_cast<const float*>(log_w), static_cast<const float*>(pred_lo),
         static_cast<const float*>(gains), static_cast<const int*>(n_i),
         static_cast<const float*>(m), static_cast<const uint8_t*>(active),
         static_cast<const uint8_t*>(reg), static_cast<const uint8_t*>(coast),
         static_cast<float*>(out_buf), static_cast<float*>(out_buf_lo),
         static_cast<int*>(out_len), static_cast<int*>(out_mode),
         static_cast<float*>(out_log_w), static_cast<float*>(out_pred_lo),
         static_cast<float*>(corrected), static_cast<float*>(predicted),
         n, n_max, n_f, n_i0, sb};
  const unsigned blocks = static_cast<unsigned>((n + sb - 1) / sb);
  gsff_kernel<<<blocks, sb * 4 * n_f, bytes,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
