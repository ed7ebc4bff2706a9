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
// Design (a warp per slot, lanes over the window, then over the tree):
// lane i forms the tree's first level, product(i) + product(i + n_max),
// for a chunk of up to kChunk of the slot's 4 n_f estimates (before or
// after the append, filter e / 2 mod n_f, coordinate e mod 2; the four
// window differences a lane needs are formed once) into row i of a
// per-warp shared-memory tree whose columns are the chunk's estimates.
// Each further level of ds.dot_tree is one pass of the warp over the flat
// rows, every estimate at once: the odd level's fold of row n - 1 into
// row 0, then row i adds row i + half (the same pairs in the same order
// as the plain tree, so the same bits), the lanes on consecutive entries.
// (A shuffle per level, lane i holding entry i, measured slower: a level
// of width 15 keeps 15 of 32 lanes busy, one estimate an instruction.)
// Lane g adds estimate g's center. The finish is spread over the
// filters' lanes (lane f, f + 32, ...): the log likelihood, the float64
// exp and log, the weights and the weighted double-single products; lane
// 0 runs lw_max (NaN-propagating, left to right) and the sum of the exps,
// lanes 0-3 the four corr / pred accumulations, each in the plain
// version's order. The warp writes its slot's rings a ring entry (8
// bytes, hi or lo) a lane: shifted on an active slot, filled on a
// registered one (the 31 entries of the default ring put every other
// slot off 16-byte alignment, so 8-byte stores are the widest the layout
// allows). Inactive slots skip the estimates: the plain version drops
// them. The measurement is read at stride m_stride (the tracker's (V S,
// K) positions). No allocation, no host synchronisation, no block
// barrier: warps are independent.
//
// The tracker's scan also hands over two destinations (ysmr_tpu/pipeline/
// tracker.py:253's emit_pos / stored_pos): on an active slot the kernel
// writes `predicted` over the first two coordinates of the measurement's
// own row (the new state's position, stride m_stride) and `corrected`
// over those of the frame's emitted position (video stride em_vstride,
// slot stride m_stride); the other slots keep what the frame step wrote.
// A slot's lanes read the measurement at the start, and the two lanes
// that overwrite it do so after the warp's last __syncwarp, so no lane
// reads a prediction in place of the measurement.
//
// Cap: a warp needs 4 (17 n_f + 2 n_max stride) bytes of shared memory
// (stride: the chunk, odd), the launch shrinks the chunk to fit 232,448
// and takes any bank whose chunk of one fits: 4 (17 n_f + 2 n_max) bytes,
// n_max <= 28988 at n_f = 8, 29030 at n_f = 3, n_f <= 3418
// (ops/gsff.py::kernel_takes).
//
// What bounds it on an H100: instruction issue. Per active slot two
// windows of 2 n_max double-single differences and 4 n_f dots of a
// double-single product (24 float operations) and a tree add (11) per
// entry, against about 1.1 KB of state in and out: at N = 4096, n_f = 3,
// n_max = 30 about 109 MFLOP (1.6 us at 67 TFLOP/s) and 4.4 MB (1.3 us
// at 3.35 TB/s). The instructions around the arithmetic (the products'
// Veltkamp splits, the tree's shared loads and stores, the float64 exp
// and log) make about 2,000 warp instructions a slot; with every slot's
// warp resident at once (64 registers, 4 blocks of 8 warps an SM) the
// kernel takes 15.7 us there (29.7 us for the former thread-per-estimate
// design, NVIDIA H100 80GB HBM3, 700 W). Above n_max 32 the launch keeps
// 8 warps a block by shrinking the chunk, and 3 blocks an SM (85
// registers). The TPU had no kernel here; XLA fused the step into the
// scan's body.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTargetWarps = 8;  // slots of a block (a warp each)
constexpr int kChunk = 16;       // estimates a warp's tree holds at most
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
  const float* m;        // (N, m_stride): the first two columns
  float* st_pos;         // null, or m's rows: predicted written there
  float* em_pos;         // null, or (V, S, m_stride) at em_vstride
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
  int n, n_max, n_f, n_i0, m_stride;
  int s;                // slots of a video (em_pos's S)
  int64_t em_vstride;   // em_pos's video stride, in floats
  int warps;   // slots (warps) of a block
  int chunk;   // estimates the tree holds at once
  int stride;  // its row: chunk, or chunk + 1 if that is even
};

// floats of a warp's shared memory: its 4 n_f estimates (hi, lo), the n_f
// log weights, 8 n_f of scratch (the exps, then the weighted products),
// and the tree: n_max rows of `stride` double-single entries
__host__ __device__ __forceinline__ size_t warp_floats(int n_f, int n_max,
                                                       int stride) {
  return 17 * static_cast<size_t>(n_f) +
         2 * static_cast<size_t>(n_max) * stride;
}

// One slot's inputs after the register fill.
struct Slot {
  const float* buf;
  const float* lo;
  bool reg;
  Ds m[2];  // the measurement and its lo half (a coasting slot's pred_lo)

  // coordinate c's measurement, picked by a select (a runtime index would
  // put m on the stack)
  __device__ __forceinline__ Ds meas(int c) const { return c ? m[1] : m[0]; }

  // ring float q (entry q / 2, coordinate q % 2)
  __device__ __forceinline__ Ds ring(int q) const {
    return reg ? Ds{meas(q & 1).h, 0.0f} : Ds{buf[q], lo[q]};
  }
};

// window entry k (of 2 n_max) minus its coordinate's center: before the
// append ring float k + 2, after it ring float k + 4 or the measurement
__device__ __forceinline__ Ds window_diff(const Slot& s, Ds c0, Ds c1,
                                          bool post, int k, int n_max) {
  const Ds v = !post ? s.ring(k + 2)
               : k < 2 * n_max - 2 ? s.ring(k + 4)
                                   : s.meas(k & 1);
  return ds_sub(v, (k & 1) ? c1 : c0);
}

// gains[f][r] . (window - center) at entries i and i + n_max, fr = 2 f +
// r: the tree's first level (the width 2 n_max is even, so nothing folds)
__device__ __forceinline__ Ds first_level(const Args& a, int fr, Ds d0,
                                          Ds d1, int i) {
  const int n_max = a.n_max, w2 = 2 * n_max;
  const float* gh = a.gains + static_cast<int64_t>(fr) * w2;
  const float* gl = gh + static_cast<int64_t>(a.n_f) * 2 * w2;
  return ds_add(ds_mul({__ldg(gh + i), __ldg(gl + i)}, d0),
                ds_mul({__ldg(gh + i + n_max), __ldg(gl + i + n_max)}, d1));
}

// The slot's 4 n_f estimates into est_h, est_l (before the append at
// 2 f + r, after it at 2 n_f + 2 f + r), a chunk of estimates at a time:
// lane i forms the first level of entry i (and i + 32, ...) for each
// estimate g of the chunk into row i, column g of the tree (th, tl: n_max
// rows of `stride` entries, an odd stride so that the lanes' columns fall
// in distinct banks); then each level of ds.dot_tree is one pass over the
// flat rows: the odd level's fold of row n - 1 into row 0, then row i
// (< half) adds row i + half, every column (estimate) at once, the lanes
// over consecutive entries. Lane g adds estimate g's center to row 0.
// Registers are picked by selects, never by a runtime index (which would
// put them on the stack).
__device__ __forceinline__ void estimates(const Args& a, const Slot& s,
                                          float* est_h, float* est_l,
                                          float* th, float* tl) {
  const int lane = threadIdx.x & 31, n_max = a.n_max, ne = 4 * a.n_f;
  const int posts = 2 * a.n_f, stride = a.stride;
  // the centers: before the append the ring's last entry, after it the
  // measurement
  const Ds pre_c0 = s.ring(2 * n_max), pre_c1 = s.ring(2 * n_max + 1);
  for (int e0 = 0; e0 < ne; e0 += a.chunk) {
    const int ec = min(a.chunk, ne - e0);
    for (int i = lane; i < n_max; i += 32) {
      // the window's differences at entries i and i + n_max
      const Ds pre0 = window_diff(s, pre_c0, pre_c1, false, i, n_max);
      const Ds pre1 = window_diff(s, pre_c0, pre_c1, false, i + n_max, n_max);
      const Ds post0 = window_diff(s, s.m[0], s.m[1], true, i, n_max);
      const Ds post1 = window_diff(s, s.m[0], s.m[1], true, i + n_max,
                                   n_max);
      // the chunk's estimates before the append, then after it: each
      // loop's differences are invariant (their splits are formed once)
      const int mid = min(max(posts - e0, 0), ec);
      for (int g = 0; g < mid; ++g) {
        const Ds v = first_level(a, e0 + g, pre0, pre1, i);
        th[i * stride + g] = v.h;
        tl[i * stride + g] = v.l;
      }
      for (int g = mid; g < ec; ++g) {
        const Ds v = first_level(a, e0 + g - posts, post0, post1, i);
        th[i * stride + g] = v.h;
        tl[i * stride + g] = v.l;
      }
    }
    __syncwarp();
    for (int n = n_max; n > 1;) {
      const int half = n / 2;
      if (n & 1) {
        const int off = (n - 1) * stride;
        for (int t = lane; t < stride; t += 32) {
          const Ds v = ds_add({th[t], tl[t]}, {th[t + off], tl[t + off]});
          th[t] = v.h;
          tl[t] = v.l;
        }
        __syncwarp();
      }
      const int off = half * stride;
      for (int t = lane; t < off; t += 32) {
        const Ds v = ds_add({th[t], tl[t]}, {th[t + off], tl[t + off]});
        th[t] = v.h;
        tl[t] = v.l;
      }
      __syncwarp();
      n = half;
    }
    for (int g = lane; g < ec; g += 32) {
      const int e = e0 + g;
      const Ds c = e < posts ? ((e & 1) ? pre_c1 : pre_c0) : s.meas(e & 1);
      const Ds v = ds_add(c, {th[g], tl[g]});
      est_h[e] = v.h;
      est_l[e] = v.l;
    }
    __syncwarp();  // the tree is free for the next chunk
  }
}

static_assert(32 * kTargetWarps <= kMaxThreads, "a block's threads");

// MinBlocks: blocks an SM should hold (the registers a thread may use);
// the launch picks 4 for the register-light trees up to n_max 32, 3 above
template <int MinBlocks>
__global__ void __launch_bounds__(32 * kTargetWarps, MinBlocks)
    gsff_kernel(Args a) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t slot = static_cast<int64_t>(blockIdx.x) * a.warps + warp;
  if (slot >= a.n) return;  // a whole warp: no block barrier follows
  const int n_f = a.n_f, n_max = a.n_max;
  float* est_h = smem + warp * warp_floats(n_f, n_max, a.stride);
  float* est_l = est_h + 4 * n_f;
  float* lw = est_l + 4 * n_f;
  float* tmp = lw + n_f;
  float* tree_h = tmp + 8 * n_f;
  float* tree_l = tree_h + n_max * a.stride;
  const int per = 2 * (n_max + 1);
  const bool act = a.active[slot] != 0;
  const bool coast = a.coast[slot] != 0;
  Slot s;
  s.reg = a.reg[slot] != 0;
  s.buf = a.buf + slot * per;
  s.lo = a.buf_lo + slot * per;
  for (int c = 0; c < 2; ++c)
    s.m[c] = {a.m[slot * a.m_stride + c],
              coast ? a.pred_lo[2 * slot + c] : 0.0f};
  // the rings: entry j + 1 moves to j and the measurement is appended on
  // an active slot; the filled or the old ring stays on an inactive one
  {
    const float2* src = reinterpret_cast<const float2*>(s.buf);
    const float2* src_lo = reinterpret_cast<const float2*>(s.lo);
    float2* dst = reinterpret_cast<float2*>(a.out_buf + slot * per);
    float2* dst_lo = reinterpret_cast<float2*>(a.out_buf_lo + slot * per);
    for (int j = lane; j <= n_max; j += 32) {
      float2 h, l;
      if (act && j == n_max) {
        h = make_float2(s.m[0].h, s.m[1].h);
        l = make_float2(s.m[0].l, s.m[1].l);
      } else if (s.reg) {
        h = make_float2(s.m[0].h, s.m[1].h);
        l = make_float2(0.0f, 0.0f);
      } else {
        const int q = act ? j + 1 : j;
        h = src[q];
        l = src_lo[q];
      }
      dst[j] = h;
      dst_lo[j] = l;
    }
  }
  const int length = s.reg ? a.n_i0 : a.len[slot];
  const int mode = s.reg ? 0 : a.mode[slot];
  const float* log_w = a.log_w + slot * n_f;
  float* out_lw = a.out_log_w + slot * n_f;
  if (!act) {
    for (int f = lane; f < n_f; f += 32)
      out_lw[f] = s.reg ? kNegInf : log_w[f];
    if (lane < 2) {
      const int c = lane;
      a.out_pred_lo[2 * slot + c] = s.reg ? 0.0f : a.pred_lo[2 * slot + c];
      a.corrected[2 * slot + c] = 0.0f;
      a.predicted[2 * slot + c] = 0.0f;
    }
    if (lane == 0) {
      a.out_len[slot] = length;
      a.out_mode[slot] = mode;
    }
    return;
  }
  // (a) mode growth: n_f rounds of a clamped lookup into n_i; (b)
  // uniform weights on a transition (both before the estimates, whose
  // work hides their latency)
  int grown = mode;
  for (int i = 0; i < n_f; ++i) {
    const int at = min(max(grown, 0), n_f - 1);
    grown += (grown < n_f && length >= __ldg(a.n_i + at)) ? 1 : 0;
  }
  const bool grew = grown > mode;
  // read only on a transition (the float64 log is skipped on the rest)
  const float uniform =
      grew ? -log_f(static_cast<float>(max(grown, 1))) : 0.0f;
  estimates(a, s, est_h, est_l, tree_h, tree_l);
  __syncwarp();
  // (d) log likelihoods floored at the likelihood minimum, (e) the update
  for (int f = lane; f < n_f; f += 32) {
    float v = kNegInf;
    if (f < grown) {
      const float lw_in = grew ? uniform : (s.reg ? kNegInf : log_w[f]);
      float sq[2];
      for (int r = 0; r < 2; ++r) {
        const Ds diff = ds_sub(s.m[r], {est_h[2 * f + r], est_l[2 * f + r]});
        sq[r] = __fadd_rn(__fmul_rn(diff.h, diff.h),
                          __fmul_rn(__fmul_rn(2.0f, diff.h), diff.l));
      }
      float log_lik = __fmul_rn(-0.5f, __fadd_rn(sq[0], sq[1]));
      if (log_lik < kLogLikMin) log_lik = kLogLikMin;  // NaN stays
      v = __fadd_rn(lw_in, log_lik);
    }
    lw[f] = v;
  }
  __syncwarp();
  float lw_max = lw[0];
  if (lane == 0)
    for (int f = 1; f < n_f; ++f) lw_max = max_nan(lw_max, lw[f]);
  lw_max = __shfl_sync(0xffffffffu, lw_max, 0);
  for (int f = lane; f < n_f; f += 32) tmp[f] = exp_f(__fsub_rn(lw[f], lw_max));
  __syncwarp();
  float lse = 0.0f;
  if (lane == 0) {
    float sum = tmp[0];
    for (int f = 1; f < n_f; ++f) sum = __fadd_rn(sum, tmp[f]);
    lse = __fadd_rn(lw_max, log_f(sum));
  }
  lse = __shfl_sync(0xffffffffu, lse, 0);
  __syncwarp();  // lane 0 has read the exps before tmp is rewritten
  // (f) the weighted pre-append estimates, (g) the post-append ones:
  // tmp[8 f + 2 q], tmp[8 f + 2 q + 1] for q = 2 kind + r
  const int post = 2 * n_f;
  for (int f = lane; f < n_f; f += 32) {
    const float v = f < grown ? __fsub_rn(lw[f], lse) : kNegInf;
    out_lw[f] = v;
    const Ds w = {f < grown ? exp_f(v) : 0.0f, 0.0f};
    for (int r = 0; r < 2; ++r) {
      const int k = 2 * f + r;
      const Ds c = ds_mul({est_h[k], est_l[k]}, w);
      const Ds p = ds_mul({est_h[post + k], est_l[post + k]}, w);
      tmp[8 * f + 2 * r] = c.h;
      tmp[8 * f + 2 * r + 1] = c.l;
      tmp[8 * f + 4 + 2 * r] = p.h;
      tmp[8 * f + 4 + 2 * r + 1] = p.l;
    }
  }
  __syncwarp();
  if (lane < 4) {  // lanes 0, 1: corrected r; lanes 2, 3: predicted r
    const int q = 2 * lane, r = lane & 1;
    Ds acc = {tmp[q], tmp[q + 1]};
    for (int f = 1; f < n_f; ++f)
      acc = ds_add(acc, {tmp[8 * f + q], tmp[8 * f + q + 1]});
    if (lane < 2) {
      const float corr = __fadd_rn(acc.h, acc.l);
      a.corrected[2 * slot + r] = corr;
      if (a.em_pos)
        a.em_pos[slot / a.s * a.em_vstride +
                 slot % a.s * static_cast<int64_t>(a.m_stride) + r] = corr;
    } else {
      a.predicted[2 * slot + r] = acc.h;
      a.out_pred_lo[2 * slot + r] = acc.l;
      if (a.st_pos) a.st_pos[slot * a.m_stride + r] = acc.h;
    }
  }
  if (lane == 0) {
    a.out_len[slot] = min(length + 1, n_max + 1);
    a.out_mode[slot] = grown;
  }
}

}  // namespace

extern "C" {

// buf, buf_lo: (N, n_max + 1, 2) float32; len, mode: (N,) int32; log_w:
// (N, n_f) float32; pred_lo: (N, 2) float32; gains: (2, n_f, 2, 2 n_max)
// float32; n_i: (n_f,) int32; m: (N, m_stride) float32, its first two
// columns the measurement; active, reg, coast: (N,) bool; the outputs
// shaped as their inputs, corrected and predicted (N, 2) float32; all
// contiguous on CUDA device `device` (buffers 8-byte aligned), launched
// on `stream`. With em_pos (else null) the N = V s slots' corrected
// positions also go over the first two coordinates of em_pos (V, s,
// m_stride) float32 at video stride em_vstride (floats), slot stride
// m_stride, and their predicted ones over those of m's rows, on the
// active slots. Returns a cudaError_t (0 = launched;
// cudaErrorInvalidValue past the cap).
int ysmr_gsff_step(const void* buf, const void* buf_lo, const void* len,
                   const void* mode, const void* log_w, const void* pred_lo,
                   const void* gains, const void* n_i, const void* m,
                   const void* active, const void* reg, const void* coast,
                   void* out_buf, void* out_buf_lo, void* out_len,
                   void* out_mode, void* out_log_w, void* out_pred_lo,
                   void* corrected, void* predicted, void* em_pos, int n,
                   int n_max, int n_f, int n_i0, int m_stride, int s,
                   long long em_vstride, int device, void* stream) {
  if (n <= 0) return 0;
  if (n_max < 1 || n_f < 1 || m_stride < 2 || (em_pos && s < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  // the largest chunk of estimates (at most kChunk) whose tree lets a
  // block hold kTargetWarps warps (slots), or failing that one; then as
  // many warps as fit
  int chunk = min(4 * n_f, kChunk);
  auto warp_bytes = [&](int ch) {
    return 4 * warp_floats(n_f, n_max, ch | 1);
  };
  while (chunk > 1 && kTargetWarps * warp_bytes(chunk) > kMaxShared) --chunk;
  if (warp_bytes(chunk) > kMaxShared)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int warps = kTargetWarps;
  while (warps > 1 && warps * warp_bytes(chunk) > kMaxShared) --warps;
  if (warps > n) warps = n;
  const size_t bytes = warps * warp_bytes(chunk);
  // measured on an H100: 4 blocks an SM (64 registers) is faster for the
  // default bank, 3 (85) for n_max 256 with 8 filters
  void (*kernel)(Args) = n_max <= 32 ? &gsff_kernel<4> : &gsff_kernel<3>;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // with the destinations, the measurement's rows take the prediction
  float* st_pos = em_pos ? static_cast<float*>(const_cast<void*>(m)) : nullptr;
  Args a{static_cast<const float*>(buf), static_cast<const float*>(buf_lo),
         static_cast<const int*>(len), static_cast<const int*>(mode),
         static_cast<const float*>(log_w), static_cast<const float*>(pred_lo),
         static_cast<const float*>(gains), static_cast<const int*>(n_i),
         static_cast<const float*>(m), st_pos, static_cast<float*>(em_pos),
         static_cast<const uint8_t*>(active),
         static_cast<const uint8_t*>(reg), static_cast<const uint8_t*>(coast),
         static_cast<float*>(out_buf), static_cast<float*>(out_buf_lo),
         static_cast<int*>(out_len), static_cast<int*>(out_mode),
         static_cast<float*>(out_log_w), static_cast<float*>(out_pred_lo),
         static_cast<float*>(corrected), static_cast<float*>(predicted),
         n, n_max, n_f, n_i0, m_stride, em_pos ? s : 1,
         static_cast<int64_t>(em_vstride), warps, chunk, chunk | 1};
  const unsigned blocks = static_cast<unsigned>((n + warps - 1) / warps);
  kernel<<<blocks, 32 * warps, bytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
