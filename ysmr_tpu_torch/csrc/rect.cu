// The exact rect's tail after the hull and sweep kernels: the hull-edge
// finish and the rect select, one launch each.
//
// Replaces plain XLA of ysmr_tpu/ops/labeling.py (no Pallas kernel):
//   - edge finish: _edge_vector_finish (:736), called twice by the
//     hull-edge data and concatenated. Same contract and bits as
//     ysmr_tpu_torch/ops/labeling.py::edge_finish_plain;
//   - rect select: _min_area_rect_exact (:877) after the sweep: the
//     double-single areas, their minimum, the tie band, the angle argmax,
//     the picks and the centre. Same contract and bits as
//     ysmr_tpu_torch/ops/labeling.py::rect_select_plain.
//
// Bits: every float32 operation is an _rn intrinsic (nvcc contracts a
// plain a * b + c into an fma by default), in the plain version's order.
// The angle is fdlibm's float32 atan2f (glibc e_atan2f.c / s_atanf.c, which
// XLA:CPU's float32 atan2 gives), one rounding per operation in the C
// order, the branches decided on the float's bits. The double-single
// arithmetic follows ops/ds.py: two_sum, quick_two_sum, two_prod with the
// Veltkamp split by the float32 product 4097 * a. The side length is the
// float64 square root rounded to float32 (which is the correctly rounded
// float32 root), and the angle in degrees one float32 fma (ds.fma_f32,
// XLA's contraction).
//
// Design.
//   - Edge finish: one thread per (component, chain slot) of the
//     (D, 2 (R - 1)) output; slot j < R - 1 reads the left chain's row j,
//     the others the right chain's row j - (R - 1). Elementwise: the fold,
//     the keep rule, the angle.
//   - Rect select: a group of kLanes lanes per component over its K =
//     2 (R - 1) + 1 candidates (the last is the appended horizontal
//     (1, 0), angle 0, always valid, which the kernel forms: only its
//     extents are read), several components a warp. Few
//     candidates are valid (about 7 of 94 a component at the dense
//     batch), so the group first scans the validity flags: lane l loads
//     those of candidates 16 l ... 16 l + 15 at once (two a 16-bit load
//     where the row is 2-byte aligned, as the pipeline's always is),
//     counts them, and a prefix sum over the group numbers the valid
//     ones in index order. Lane l then reads entries l, l + kLanes, ...
//     of the group's first kKept: extents, direction and angle in one
//     pass, kept in registers. Pass 1 forms their double-single areas
//     and the least under the strict order (h, l) < (h', l') (the order
//     is total on these finite pairs, so any reduction order finds the
//     halving tree's value); a butterfly of shuffles within the group
//     gives it to every lane. Pass 2 forms each candidate's tie test
//     against it from the kept areas and keeps the largest angle, the
//     lower index on equal angles (argmax's first maximum; an invalid
//     candidate counts as -1, so only the first one can win). The lane
//     that took the winner computes the outputs from its registers, in
//     parallel with the other groups. Valid candidates past the kKept
//     (more than a group keeps) are read again in each pass.
//
// What bounds it on an H100: the edge finish, bytes (the edge flag and
// 13 bytes out per slot, the 2 x 4 bytes of the vector and about 40
// operations of the polynomial at a kept slot). The rect select reads
// the validity byte per candidate, 7 x 4 bytes and about 100 float
// operations per valid candidate (and the appended one), 20 bytes out
// per component, but its valid candidates are scattered over their rows
// (a 32-byte sector for each few), and a component's work is two
// dependent round trips to memory (the flags, then the kept candidates)
// and a chain of double-single arithmetic: latency, hidden by the
// components in flight (four a warp, 32 warps an SM).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rect select: the lanes of a component's group (kGroups components a
// block), the valid candidates a group keeps in registers from pass 1
// (its first kKept, kSlots a lane), and the blocks an SM keeps resident
// (at most 64 registers a thread)
constexpr int kLanes = 8;
constexpr int kGroups = kThreads / kLanes;
constexpr int kKept = 16;
constexpr int kSlots = kKept / kLanes;
constexpr int kSelectBlocks = 4;
static_assert(kLanes <= 16 && 32 % kLanes == 0 && kKept % kLanes == 0,
              "a group is a power of two lanes of one warp");
constexpr unsigned kFull = 0xffffffffu;
// float32(3e38): ops/labeling.py's BIG_F
constexpr float kBigF = 0x1.c363ccp+127f;
// float32(1e-9), the tie band's constant
constexpr float kTie = 0x1.12e0bep-30f;
// float32(180 / pi), the constant of jnp.degrees
constexpr float kRadToDeg = 0x1.ca5dc2p+5f;

// fdlibm s_atanf.c: atan of the breakpoints split hi + lo, the polynomial
__constant__ float kAtanHi[4] = {0x1.dac670p-2f, 0x1.921fb4p-1f,
                                 0x1.f730bcp-1f, 0x1.921fb4p+0f};
__constant__ float kAtanLo[4] = {0x1.586ed2p-28f, 0x1.4442d0p-25f,
                                 0x1.281f68p-25f, 0x1.4442d0p-24f};
__constant__ float kAtanT[11] = {
    0x1.555556p-2f, -0x1.99999ap-3f, 0x1.24924ap-3f, -0x1.c71c70p-4f,
    0x1.745cdcp-4f, -0x1.3b0f2ap-4f, 0x1.10d66ap-4f, -0x1.dde2d6p-5f,
    0x1.97b4b2p-5f, -0x1.2b4442p-5f, 0x1.0ad3aep-6f};
constexpr float kPiO2 = 0x1.921fb6p+0f;
constexpr float kPiLo = -0x1.777a5cp-24f;

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float fdiv(float a, float b) {
  return __fdiv_rn(a, b);
}

// fdlibm atanf for finite x >= 0
__device__ float atanf_fdlibm(float x) {
  const int ix = __float_as_int(x);
  if (ix >= 0x4c000000) return fadd(kAtanHi[3], kAtanLo[3]);  // |x| >= 2^25
  if (ix < 0x31000000) return x;                               // |x| < 2^-29
  int id = -1;
  float xr = x;
  if (ix >= 0x401c0000) {
    id = 3;
    xr = fdiv(-1.0f, x);
  } else if (ix >= 0x3f980000) {
    id = 2;
    xr = fdiv(fsub(x, 1.5f), fadd(1.0f, fmul(1.5f, x)));
  } else if (ix >= 0x3f300000) {
    id = 1;
    xr = fdiv(fsub(x, 1.0f), fadd(x, 1.0f));
  } else if (ix >= 0x3ee00000) {
    id = 0;
    xr = fdiv(fsub(fmul(x, 2.0f), 1.0f), fadd(2.0f, x));
  }
  const float z = fmul(xr, xr);
  const float w = fmul(z, z);
  const float* t = kAtanT;
  const float s1 = fmul(z, fadd(t[0], fmul(w, fadd(t[2], fmul(w, fadd(t[4],
      fmul(w, fadd(t[6], fmul(w, fadd(t[8], fmul(w, t[10])))))))))));
  const float s2 = fmul(w, fadd(t[1], fmul(w, fadd(t[3], fmul(w, fadd(t[5],
      fmul(w, fadd(t[7], fmul(w, t[9])))))))));
  const float s = fadd(s1, s2);
  if (id < 0) return fsub(xr, fmul(xr, s));
  return fsub(kAtanHi[id], fsub(fsub(fmul(xr, s), kAtanLo[id]), xr));
}

// fdlibm atan2f for finite y >= 0, x > 0 (the folded edge vectors)
__device__ float atan2f_fdlibm(float y, float x) {
  if (y == 0.0f) return y;
  if (x == 1.0f) return atanf_fdlibm(y);
  const int k = (__float_as_int(y) - __float_as_int(x)) >> 23;
  if (k > 60) return fadd(kPiO2, fmul(0.5f, kPiLo));
  return atanf_fdlibm(fabsf(fdiv(y, x)));
}

__global__ void __launch_bounds__(kThreads)
edge_finish_kernel(const float* __restrict__ dxl, const float* __restrict__ dyl,
                   const uint8_t* __restrict__ el,
                   const float* __restrict__ dxr,
                   const float* __restrict__ dyr,
                   const uint8_t* __restrict__ er, float* __restrict__ out_dx,
                   float* __restrict__ out_dy, float* __restrict__ out_ang,
                   uint8_t* __restrict__ out_valid, int64_t total, int r) {
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (o >= total) return;
  const int m = r - 1;
  const int64_t c = o / (2 * m);
  const int j = static_cast<int>(o - c * 2 * m);
  const bool right = j >= m;
  const int i = right ? j - m : j;
  const int64_t q = c * r + i;
  const bool keep = right ? er[q] : el[q];
  out_valid[o] = keep || i == 0;
  if (!keep) {  // the vector is not read
    out_dx[o] = 1.0f;
    out_dy[o] = 0.0f;
    out_ang[o] = 0.0f;
    return;
  }
  float dx = right ? dxr[q] : dxl[q];
  float dy = right ? dyr[q] : dyl[q];
  // the fold to dx > 0, dy >= 0 (ops/labeling.py::_fold_edge_vector)
  const bool neg = (dy < 0.0f) || (dy == 0.0f && dx < 0.0f);
  if (neg) {
    dx = -dx;
    dy = -dy;
  }
  if (dx <= 0.0f && dy > 0.0f) {
    const float t = dx;
    dx = dy;
    dy = -t;
  }
  if (dx == 0.0f && dy == 0.0f) dx = 1.0f;
  out_dx[o] = dx;
  out_dy[o] = dy;
  out_ang[o] = atan2f_fdlibm(dy, dx);
}

struct Ds {
  float h, l;
};

__device__ __forceinline__ Ds two_sum(float a, float b) {
  const float s = fadd(a, b);
  const float bb = fsub(s, a);
  return {s, fadd(fsub(a, fsub(s, bb)), fsub(b, bb))};
}

__device__ __forceinline__ Ds quick_two_sum(float a, float b) {
  const float s = fadd(a, b);
  return {s, fsub(b, fsub(s, a))};
}

__device__ __forceinline__ Ds two_prod(float a, float b) {
  const float p = fmul(a, b);
  const float ca = fmul(4097.0f, a);
  const float ah = fsub(ca, fsub(ca, a));
  const float al = fsub(a, ah);
  const float cb = fmul(4097.0f, b);
  const float bh = fsub(cb, fsub(cb, b));
  const float bl = fsub(b, bh);
  const float e = fadd(fadd(fadd(fsub(fmul(ah, bh), p), fmul(ah, bl)),
                            fmul(al, bh)),
                       fmul(al, bl));
  return {p, e};
}

__device__ __forceinline__ Ds ds_add(Ds x, Ds y) {
  const Ds s = two_sum(x.h, y.h);
  return quick_two_sum(s.h, fadd(s.l, fadd(x.l, y.l)));
}

__device__ __forceinline__ Ds ds_sub(Ds x, Ds y) {
  return ds_add(x, {-y.h, -y.l});
}

__device__ __forceinline__ Ds div_by_f32(Ds x, float d) {
  const float q0 = fdiv(x.h, d);
  const Ds r0 = two_prod(q0, d);
  const Ds r = ds_sub(x, r0);
  return quick_two_sum(q0, fdiv(fadd(r.h, r.l), d));
}

// (bh, bl) < (ah, al) in ops/labeling.py::_ds_less's order
__device__ __forceinline__ bool ds_less(Ds b, Ds a) {
  return b.h < a.h || (b.h == a.h && b.l < a.l);
}

// a candidate's inputs: extents, direction, angle (0 for the appended one)
struct Cand {
  float mnu, mxu, mnv, mxv, dx, dy, ang;
};

// a candidate's double-single area (du dv / l2, the extents clamped at 0)
__device__ __forceinline__ Ds area(const Cand& c) {
  const float du = fmaxf(fsub(c.mxu, c.mnu), 0.0f);
  const float dv = fmaxf(fsub(c.mxv, c.mnv), 0.0f);
  const float l2 = fadd(fmul(c.dx, c.dx), fmul(c.dy, c.dy));
  return div_by_f32(two_prod(du, dv), l2);
}

__global__ void __launch_bounds__(kThreads, kSelectBlocks)
rect_select_kernel(const float* __restrict__ min_u,
                   const float* __restrict__ max_u,
                   const float* __restrict__ min_v,
                   const float* __restrict__ max_v,
                   const float* __restrict__ edx, const float* __restrict__ edy,
                   const float* __restrict__ eang,
                   const uint8_t* __restrict__ evalid, float* __restrict__ cx,
                   float* __restrict__ cy, float* __restrict__ w_out,
                   float* __restrict__ h_out, float* __restrict__ ang_out,
                   int64_t d, int kk) {
  __shared__ int lists[kGroups][kKept];
  const int lane = threadIdx.x & 31;
  const int gl = lane & (kLanes - 1);
  const int shift = lane - gl;
  const unsigned gmask = ((1u << kLanes) - 1u) << shift;
  const int grp = threadIdx.x / kLanes;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kGroups + grp;
  if (c >= d) return;  // whole groups leave together
  const int64_t base = c * kk;
  const int64_t vbase = c * (kk - 1);
  int* list = lists[grp];
  // the appended candidate (1, 0), angle 0, is valid and formed here; the
  // hull candidates' flags
  auto valid = [&](int k) { return k == kk - 1 || evalid[vbase + k] != 0; };
  auto load = [&](int k) {
    const int64_t o = base + k;
    if (k == kk - 1) {
      return Cand{min_u[o], max_u[o], min_v[o], max_v[o], 1.0f, 0.0f, 0.0f};
    }
    const int64_t q = vbase + k;
    return Cand{min_u[o], max_u[o], min_v[o], max_v[o], edx[q], edy[q],
                eang[q]};
  };

  // the scan, kLanes * 16 candidates at a time: lane gl loads the flags
  // of candidates k0 + 16 gl ... + 15 (all loads first, one round trip),
  // counts them, and a prefix sum over the group numbers the valid ones
  // in index order; the first kKept go to the group's list
  int n = 0, first_inv = kk;
  for (int k0 = 0; k0 < kk; k0 += 16 * kLanes) {
    const int kl = k0 + 16 * gl;
    unsigned bits = 0;
    const unsigned in_range =
        kl >= kk ? 0u : kk - kl >= 16 ? 0xffffu : (1u << (kk - kl)) - 1u;
    if (kl <= kk - 1 && kk - 1 < kl + 16) bits |= 1u << (kk - 1 - kl);
    const uint8_t* fl = evalid + vbase + kl;
    if ((reinterpret_cast<uintptr_t>(evalid + vbase) & 1) == 0) {
      // two flags a 16-bit load (kl is even)
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        if (kl + i + 1 < kk - 1) {
          const unsigned w = *reinterpret_cast<const uint16_t*>(fl + i);
          bits |= ((w & 0xffu) != 0u ? 1u : 0u) << i;
          bits |= ((w >> 8) != 0u ? 1u : 0u) << (i + 1);
        } else if (kl + i < kk - 1) {
          bits |= (fl[i] != 0 ? 1u : 0u) << i;
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (kl + i < kk - 1) bits |= (fl[i] != 0 ? 1u : 0u) << i;
      }
    }
    const int cnt = __popc(bits);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const int t = __shfl_up_sync(gmask, incl, off, kLanes);
      if (gl >= off) incl += t;
    }
    int p = n + incl - cnt;
    for (unsigned m = bits; m; m &= m - 1, ++p) {
      if (p < kKept) list[p] = kl + __ffs(m) - 1;
    }
    const unsigned inv = in_range & ~bits;
    const int fi = __reduce_min_sync(gmask, inv ? kl + __ffs(inv) - 1 : kk);
    first_inv = min(first_inv, fi);
    n += __shfl_sync(gmask, incl, kLanes - 1, kLanes);
  }
  __syncwarp(gmask);
  // lane gl keeps list entries gl, gl + kLanes, ...; the valid
  // candidates after the last kept one (none unless n > kKept) are read
  // again in each pass
  const int nk = min(n, kKept);
  const int over0 = n > kKept ? list[kKept - 1] + 1 : kk;
  int ki[kSlots];
  Cand kc[kSlots] = {};
  Ds ka[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    const int p = s * kLanes + gl;
    ki[s] = p < nk ? list[p] : -1;
  }
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (ki[s] >= 0) kc[s] = load(ki[s]);
  }

  // pass 1: the least double-single area; an invalid candidate's area
  // is (BIG_F, 0) in the plain version, so it starts the minimum where
  // the component has one
  Ds m = {n < kk ? kBigF : INFINITY, 0.0f};
  bool have = n < kk;
  auto take_min = [&](const Ds& a) {
    if (!have || ds_less(a, m)) m = a;
    have = true;
  };
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    ka[s] = Ds{0.0f, 0.0f};
    if (ki[s] >= 0) {
      ka[s] = area(kc[s]);
      take_min(ka[s]);
    }
  }
  for (int k = over0 + gl; k < kk; k += kLanes) {
    if (valid(k)) take_min(area(load(k)));
  }
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const Ds o = {__shfl_xor_sync(gmask, m.h, off),
                  __shfl_xor_sync(gmask, m.l, off)};
    const bool oh = __shfl_xor_sync(gmask, static_cast<int>(have), off);
    if (oh && (!have || ds_less(o, m))) m = o;
    have = have || oh;
  }

  // pass 2: argmax of (angle where tied, else -1), the first index on
  // equal values; every invalid candidate has -1, so only the first one
  // can win
  const float band = fadd(fmul(m.h, kTie), kTie);
  float best = -INFINITY;
  int bk = kk;
  auto take = [&](float val, int k) {
    if (val > best || (val == best && k < bk)) {
      best = val;
      bk = k;
    }
  };
  auto tie_val = [&](const Ds& a, float ang) {
    return ds_sub(a, m).h <= band ? ang : -1.0f;
  };
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (ki[s] >= 0) take(tie_val(ka[s], kc[s].ang), ki[s]);
  }
  for (int k = over0 + gl; k < kk; k += kLanes) {
    if (valid(k)) {
      const Cand f = load(k);
      take(tie_val(area(f), f.ang), k);
    }
  }
  if (gl == 0 && first_inv < kk) take(-1.0f, first_inv);
  const int mine = bk;
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(gmask, best, off);
    const int ok = __shfl_xor_sync(gmask, bk, off);
    if (ov > best || (ov == best && ok < bk)) {
      best = ov;
      bk = ok;
    }
  }
  // the lane that took the winner writes the outputs, from its registers
  // where it kept it (an overflow or invalid winner is read again)
  if (mine != bk) return;
  Cand w;
  bool kept = false;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (ki[s] == bk) {
      w = kc[s];
      kept = true;
    }
  }
  if (!kept) w = load(bk);
  const float du = fmaxf(fsub(w.mxu, w.mnu), 0.0f);
  const float dv = fmaxf(fsub(w.mxv, w.mnv), 0.0f);
  const float l2 = fadd(fmul(w.dx, w.dx), fmul(w.dy, w.dy));
  // f32(sqrt(f64(l2))): rounding the float64 root to float32 is the
  // correctly rounded float32 root (53 >= 2 * 24 + 2; checked for every
  // finite float32 on the card: ysmr_rect_sqrt_mismatches)
  const float bl = __fsqrt_rn(l2);
  w_out[c] = fdiv(dv, bl);
  h_out[c] = fdiv(du, bl);
  const float cu2 = fadd(w.mnu, w.mxu);
  const float cv2 = fadd(w.mnv, w.mxv);
  const Ds nx = ds_sub(two_prod(cu2, w.dx), two_prod(cv2, w.dy));
  const Ds ny = ds_add(two_prod(cu2, w.dy), two_prod(cv2, w.dx));
  const float inv = fdiv(1.0f, fmul(2.0f, l2));
  cx[c] = fadd(fmul(nx.h, inv), fmul(nx.l, inv));
  cy[c] = fadd(fmul(ny.h, inv), fmul(ny.l, inv));
  ang_out[c] = __fmaf_rn(w.ang, kRadToDeg, -90.0f);
}

// counts[0] += the finite float32 x >= 0 (+0 to the largest, and -0)
// whose __fsqrt_rn(x) differs in its bits from f32(sqrt(f64(x)));
// counts[1] += the values compared
__global__ void sqrt_check_kernel(unsigned long long* __restrict__ counts) {
  unsigned long long bad = 0, seen = 0;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i <= 0x7f800000u;
       i += stride) {
    const float x = __uint_as_float(i < 0x7f800000u ? i : 0x80000000u);
    const float a = __fsqrt_rn(x);
    const float b = __double2float_rn(__dsqrt_rn(static_cast<double>(x)));
    bad += __float_as_uint(a) != __float_as_uint(b);
    ++seen;
  }
  for (int off = 16; off > 0; off >>= 1) {
    bad += __shfl_xor_sync(kFull, bad, off);
    seen += __shfl_xor_sync(kFull, seen, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(counts, bad);
    atomicAdd(counts + 1, seen);
  }
}

}  // namespace

extern "C" {

// dxl, dyl, dxr, dyr: (D, R) float32; el, er: (D, R) uint8; the outputs
// (D, 2 (R - 1)): dx, dy, angles float32, valid uint8; all contiguous on
// CUDA device `device`, launched on `stream`. Returns a cudaError_t.
int ysmr_edge_finish(const void* dxl, const void* dyl, const void* el,
                     const void* dxr, const void* dyr, const void* er,
                     void* out_dx, void* out_dy, void* out_ang,
                     void* out_valid, long long d, int r, int device,
                     void* stream) {
  const int64_t total = static_cast<int64_t>(d) * 2 * (r - 1);
  if (total <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  edge_finish_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dxl), static_cast<const float*>(dyl),
      static_cast<const uint8_t*>(el), static_cast<const float*>(dxr),
      static_cast<const float*>(dyr), static_cast<const uint8_t*>(er),
      static_cast<float*>(out_dx), static_cast<float*>(out_dy),
      static_cast<float*>(out_ang), static_cast<uint8_t*>(out_valid), total,
      r);
  return static_cast<int>(cudaGetLastError());
}

// min_u, max_u, min_v, max_v: (D, K) float32 (the sweep's extents, the
// appended (1, 0) last); edx, edy, eang: (D, K - 1) float32 (the hull
// candidates); evalid: (D, K - 1) uint8; the outputs (D,) float32: cx, cy, w,
// h, angle in degrees; all contiguous on CUDA device `device`, launched on
// `stream`. Returns a cudaError_t.
int ysmr_rect_select(const void* min_u, const void* max_u, const void* min_v,
                     const void* max_v, const void* edx, const void* edy,
                     const void* eang, const void* evalid, void* cx, void* cy,
                     void* w, void* h, void* ang, long long d, int k,
                     int device, void* stream) {
  if (d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (d + kGroups - 1) / kGroups;
  rect_select_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(min_u), static_cast<const float*>(max_u),
      static_cast<const float*>(min_v), static_cast<const float*>(max_v),
      static_cast<const float*>(edx), static_cast<const float*>(edy),
      static_cast<const float*>(eang), static_cast<const uint8_t*>(evalid),
      static_cast<float*>(cx), static_cast<float*>(cy),
      static_cast<float*>(w), static_cast<float*>(h),
      static_cast<float*>(ang), d, k);
  return static_cast<int>(cudaGetLastError());
}

// counts: two uint64 on CUDA device `device`, set to 0 by the caller;
// adds the number of finite float32 x >= 0 (and -0) whose __fsqrt_rn
// differs from the float64 root rounded to float32 (the rect select's
// side length), and the number compared (2^31 - 2^23 + 1). Launched on
// `stream`. Returns a cudaError_t.
int ysmr_rect_sqrt_mismatches(void* counts, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  sqrt_check_kernel<<<4096, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
