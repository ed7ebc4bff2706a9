// cv2.minAreaRect's float32 centre of every component, bit for bit, from its
// row-extreme tables, in one launch.
//
// Replaces the plain XLA of ysmr_tpu/ops/cv2_centers.py::
// cv2_centers_from_tables (:157; no Pallas kernel). Same contract and bits as
// ysmr_tpu_torch/ops/cv2_centers.py::cv2_centers_from_tables_plain, whose
// module docstring (and the JAX module's) sets out the closed form: the
// strict corners of the row-extreme envelopes in cycle order are cv2's
// hull, the caliper visit order is a sort by (in-quadrant tangent, caliper
// index), and only the float32 area comparison and the float32 centre of at
// most 8 near-minimal edges are replayed literally.
//
// Bits: the float32 products, sums and quotients are _rn intrinsics (nvcc
// contracts a plain a * b + c into an fma by default; _dot2 is two rounded
// products and a rounded sum), the divisions cdy / cdx and 1 / det are
// correctly rounded, integer to float conversions round to nearest, and a
// value the plain version picks by a masked sum gets its "+ 0.0" (-0.0
// becomes +0.0). The band constants are float32 and multiply and add with
// two roundings. Where ``ok`` comes out False the centre is not read; the
// kernel writes 0 there.
//
// Design: one warp per component, lane j = packed hull slot j (32 slots,
// the plain version's _K_HULL, the warp's width), kWarps components a
// block, two round trips to memory a component.
//   1. The lanes read the validity flags (a ballot per 32 rows: the count
//      and last index), then only the valid rows, a prefix: rows 0..31 in
//      registers, lane = row (taller components read the rest where they
//      need it), and reduce the x minimum and maximum; a component with
//      no valid row, rows that are no prefix, too wide a bbox or more than
//      32 strict corners leaves with ok False (an empty slot after the
//      flags).
//   2. The cycle (right corners by ascending row, left corners by
//      descending row) is compacted in order by __ballot_sync and __popc
//      into the warp's packed slots in shared memory; slots past the
//      corner count hold 0.
//   3. Lane j takes edge j (slot j to the next): caliper arcs from the four
//      first-occurrence extremes, the in-quadrant tangent key, and the
//      surrogate area from the u/v extremes over the <= 32 vertices (the
//      lanes past the corner count share the loop: 32 / np2 lanes an
//      edge, np2 the count rounded up to a power of two). The edges in the
//      surrogate band are the candidates; more than 8 leave with ok
//      False.
//   4. Only the in-band lanes rank themselves, by (surrogate area, slot)
//      against the other in-band lanes (the lanes of smaller areas: no
//      lane outside the band precedes one inside it), and each takes its
//      own edge as a candidate: the support counts (a ballot an in-band
//      lane over the warp's edges, by arc), the float32 caliper
//      arithmetic with the inverse square root computed in float64 (the
//      table's entry, bit for bit; only the table's length is read) and
//      its area.
//   5. The winner (least area, the last visited on ties: the largest count
//      of earlier candidates, the lower rank of those) computes the centre
//      from its registers.
//
// What bounds it on an H100: latency and the integer work of the warp
// (the projection loop, n x n products per component of n strict
// corners, the ballots and reductions); bytes are the flag of every row
// and 10 more a valid row in, 9 per component out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// blocks an SM keeps resident: all 64 warps, at most 32 registers a
// thread (a few bytes spill; faster on the H100 than 40 registers and
// 48 warps)
constexpr int kBlocks = 16;
constexpr int kSlots = 32;
constexpr int kCand = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;
// float32(1 + 2^-14) and float32(1e-30): the surrogate band
constexpr float kBandMul = 0x1.0004p+0f;
constexpr float kBandAdd = 0x1.4484cp-100f;

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}
// f32(x1 * y1) + f32(x2 * y2), each rounded (the plain version's _dot2)
__device__ __forceinline__ float dot2(float x1, float y1, float x2,
                                      float y2) {
  return fadd(fmul(x1, y1), fmul(x2, y2));
}
__device__ __forceinline__ float i2f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ int first_lane(unsigned mask) {
  return mask ? __ffs(mask) - 1 : 0;
}

// entry v of ops/cv2_centers.py::inv_sqrt_table, f32(1 / sqrt(f64(v)))
// with entry 0 = 1: two correctly rounded float64 operations and one
// rounding, as numpy computes it (checked over a whole table on the card:
// ysmr_cv2_inv_sqrt)
__device__ __forceinline__ float inv_sqrt_entry(int v) {
  if (v == 0) return 1.0f;
  return __double2float_rn(__drcp_rn(__dsqrt_rn(static_cast<double>(v))));
}

struct Shared {
  int vx[kSlots + 1], vy[kSlots + 1];   // packed slots; [32] = 0
  float2 fv[kSlots + 1];                // the same as float32
};

__global__ void __launch_bounds__(kThreads, kBlocks)
cv2_centers_kernel(const int* __restrict__ row_min_x,
                   const int* __restrict__ row_max_x,
                   const uint8_t* __restrict__ row_valid,
                   const int* __restrict__ min_y,
                   const uint8_t* __restrict__ corner_l,
                   const uint8_t* __restrict__ corner_r,
                   float* __restrict__ cx_out, float* __restrict__ cy_out,
                   uint8_t* __restrict__ ok_out, int64_t d, int r, int tab_n,
                   int w_lim) {
  __shared__ Shared smem[kWarps];
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const unsigned gt_mask = ~lt_mask << 1;
  Shared& s = smem[threadIdx.x >> 5];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (c >= d) return;  // whole warps leave together
  const int64_t row0 = c * r;
  const int* mn = row_min_x + row0;
  const int* mx = row_max_x + row0;
  const uint8_t* valid = row_valid + row0;
  const uint8_t* cl = corner_l + row0;
  const uint8_t* cr = corner_r + row0;
  const int ytop = min_y[c];
  auto fail = [&]() {
    if (lane == 0) {
      cx_out[c] = 0.0f;
      cy_out[c] = 0.0f;
      ok_out[c] = 0;
    }
  };

  // 1. the valid rows: count and last index from the flags (ballots),
  // then the rows themselves, a prefix [0, h): rows 0..31 in registers
  // (lane = row), later ones read where needed
  int h = 0, last_valid = -1;
  for (int i0 = 0; i0 < r; i0 += 64) {
    const bool v0 = i0 + lane < r && valid[i0 + lane];
    const bool v1 = i0 + 32 + lane < r && valid[i0 + 32 + lane];
    const unsigned m0 = __ballot_sync(kFull, v0);
    const unsigned m1 = __ballot_sync(kFull, v1);
    h += __popc(m0) + __popc(m1);
    if (m1) last_valid = i0 + 63 - __clz(m1);
    else if (m0) last_valid = i0 + 31 - __clz(m0);
  }
  // valid rows a prefix
  if (h == 0 || last_valid != h - 1) {
    fail();
    return;
  }
  const bool in0 = lane < h;
  const int mn0 = in0 ? mn[lane] : kBig;
  const int mx0 = in0 ? mx[lane] : -kBig;
  const bool cl0 = in0 && cl[lane];
  const bool cr0 = in0 && cr[lane];
  int x0 = mn0, xmax = mx0;
  for (int i = 32 + lane; i < h; i += 32) {
    x0 = min(x0, mn[i]);
    xmax = max(xmax, mx[i]);
  }
  x0 = __reduce_min_sync(kFull, x0);
  xmax = __reduce_max_sync(kFull, xmax);
  // the f32 slope/tan keys collision-free
  if (xmax - x0 >= w_lim) {
    fail();
    return;
  }

  // 2. the corner cycle, compacted in order: the right corners by
  // ascending row, then the left ones by descending row (a chunk of 32
  // rows a ballot)
  const int last = h - 1;
  const bool top_single = __shfl_sync(kFull, mn0 == mx0, 0);
  const bool bot_single =
      last < 32 ? __shfl_sync(kFull, mn0 == mx0, last)
                : mn[last] == mx[last];
  int n = 0;
  for (int i0 = 0; i0 < h; i0 += 32) {
    const int y = i0 + lane;
    const bool f = i0 == 0 ? cr0 && (y != 0 || !top_single)
                           : y < h && cr[y];
    const unsigned mask = __ballot_sync(kFull, f);
    const int pos = n + __popc(mask & lt_mask);
    if (f && pos < kSlots) {
      s.vx[pos] = (i0 == 0 ? mx0 : mx[y]) - x0;
      s.vy[pos] = y;
    }
    n += __popc(mask);
  }
  for (int i0 = last & ~31; i0 >= 0; i0 -= 32) {
    const int y = i0 + lane;
    const bool f = (i0 == 0 ? cl0 : y < h && cl[y]) &&
                   (y != last || !bot_single);
    const unsigned mask = __ballot_sync(kFull, f);
    const int pos = n + __popc(mask & gt_mask);
    if (f && pos < kSlots) {
      s.vx[pos] = (i0 == 0 ? mn0 : mn[y]) - x0;
      s.vy[pos] = y;
    }
    n += __popc(mask);
  }
  if (n > kSlots) {
    fail();
    return;
  }
  if (lane >= n) {
    s.vx[lane] = 0;
    s.vy[lane] = 0;
  }
  if (lane == 0) {
    s.vx[kSlots] = 0;
    s.vy[kSlots] = 0;
    s.fv[kSlots] = make_float2(0.0f, 0.0f);
  }
  __syncwarp();
  const float x0f = i2f(x0);
  const float y0f = i2f(ytop);
  if (n <= 2) {
    // a single point or a line: the f32 midpoint
    if (lane == 0) {
      const float p0x = i2f(s.vx[0] + x0), p0y = i2f(s.vy[0] + ytop);
      const float p1x = i2f(s.vx[1] + x0), p1y = i2f(s.vy[1] + ytop);
      cx_out[c] = n == 1 ? p0x : fmul(fadd(p0x, p1x), 0.5f);
      cy_out[c] = n == 1 ? p0y : fmul(fadd(p0y, p1y), 0.5f);
      ok_out[c] = 1;
    }
    return;
  }

  // 3. edge `lane`: slot lane to the next (the first after the last).
  // Lanes from np2 (the corner count rounded up to a power of two) take
  // edge lane % np2 too, for the projection loop below.
  const int np2 = n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
  const int j = lane & (np2 - 1);
  const bool vvalid = lane < n;  // also the edge's validity: n > 2
  const int vx = s.vx[j], vy = s.vy[j];
  if (lane < np2) s.fv[j] = make_float2(i2f(vx), i2f(vy));
  const int nxt = j == n - 1 ? 0 : j + 1;
  const int dx = s.vx[nxt] - vx, dy = s.vy[nxt] - vy;
  const int ymax = __reduce_max_sync(kFull, vvalid ? vy : -kBig);
  const int xvmax = __reduce_max_sync(kFull, vvalid ? vx : -kBig);
  const int xvmin = __reduce_min_sync(kFull, vvalid ? vx : kBig);
  int seq0[4];
  seq0[0] = first_lane(__ballot_sync(kFull, vvalid && vy == 0));
  seq0[1] = first_lane(__ballot_sync(kFull, vvalid && vx == xvmax));
  seq0[2] = first_lane(__ballot_sync(kFull, vvalid && vy == ymax));
  seq0[3] = first_lane(__ballot_sync(kFull, vvalid && vx == xvmin));
  // torch.remainder(a, n) for a in (-n, 2n): every use below (an
  // invalid edge's arc is never read)
  auto wrap = [n](int a) { return a < 0 ? a + n : a >= n ? a - n : a; };
  const int bot0 = seq0[0];
  const int rel_s = wrap(j - bot0);
  const int r1 = wrap(seq0[1] - bot0);
  const int q2 = wrap(seq0[2] - bot0);
  const int q3 = wrap(seq0[3] - bot0);
  const int r2 = q2 + (q2 < r1 ? n : 0);
  const int r3 = q3 + n * (q3 >= r2 ? 0 : (q3 + n >= r2 ? 1 : 2));
  const int arc = (0 <= rel_s) + (r1 <= rel_s) + (r2 <= rel_s) +
                  (r3 <= rel_s) - 1;
  const int cdx = arc == 0 ? dx : arc == 1 ? dy : arc == 2 ? -dx : -dy;
  const int cdy = arc == 0 ? dy : arc == 1 ? -dx : arc == 2 ? -dy : dx;
  const float tan_key = vvalid ? __fdiv_rn(i2f(cdy), i2f(cdx)) : INFINITY;
  __syncwarp();
  // surrogate area: the u/v extremes over the vertices, the 32 / np2
  // lanes of an edge each over every (32 / np2)-th vertex, then a
  // butterfly over them (the extremes of exact products: any order)
  const float dxf = i2f(dx), dyf = i2f(dy);
  float umin = INFINITY, umax = -INFINITY, vmin = INFINITY, vmax = -INFINITY;
  for (int p = lane / np2; p < n; p += 32 / np2) {
    const float2 q = s.fv[p];
    const float u = dot2(dxf, q.x, dyf, q.y);
    const float v = fsub(fmul(dxf, q.y), fmul(dyf, q.x));
    umin = fminf(umin, u);
    umax = fmaxf(umax, u);
    vmin = fminf(vmin, v);
    vmax = fmaxf(vmax, v);
  }
  for (int off = np2; off < 32; off <<= 1) {
    umin = fminf(umin, __shfl_xor_sync(kFull, umin, off));
    umax = fmaxf(umax, __shfl_xor_sync(kFull, umax, off));
    vmin = fminf(vmin, __shfl_xor_sync(kFull, vmin, off));
    vmax = fmaxf(vmax, __shfl_xor_sync(kFull, vmax, off));
  }
  const float l2f = fmaxf(i2f(dx * dx + dy * dy), 1.0f);
  float area_sur = __fdiv_rn(fmul(fsub(umax, umin), fsub(vmax, vmin)), l2f);
  if (!vvalid) area_sur = INFINITY;
  float min_sur = area_sur;
  for (int off = 16; off > 0; off >>= 1)
    min_sur = fminf(min_sur, __shfl_xor_sync(kFull, min_sur, off));
  const float band = fadd(fmul(min_sur, kBandMul), kBandAdd);
  // the lane of the least area is in the band: 1 <= popc <= 32
  const bool in_band = vvalid && area_sur <= band;
  const unsigned band_mask = __ballot_sync(kFull, in_band);
  if (__popc(band_mask) > kCand) {
    fail();
    return;
  }

  // 4. for each in-band lane i, two ballots: the in-band lanes before it
  // in (area, slot) order (its candidate number) and the edges visited
  // before it, by (tangent key, arc); lane i keeps them
  unsigned arc_mask[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    arc_mask[q] = __ballot_sync(kFull, vvalid && arc == q);
  unsigned ahead = 0, before = 0;
  for (unsigned mm = band_mask; mm; mm &= mm - 1) {
    const int i = __ffs(mm) - 1;
    const float o = __shfl_sync(kFull, area_sur, i);
    const float ot = __shfl_sync(kFull, tan_key, i);
    const int oa = __shfl_sync(kFull, arc, i);
    const unsigned ah = __ballot_sync(
        kFull, in_band && (area_sur < o || (area_sur == o && lane < i)));
    const unsigned bf = __ballot_sync(
        kFull, vvalid && (tan_key < ot || (tan_key == ot && arc < oa)));
    if (lane == i) {
      ahead = ah;
      before = bf;
    }
  }
  const int rank = __popc(ahead);
  // 5.'s count of the candidates visited before this one
  const int later = __popc(before & band_mask);
  float a = 0.0f, b = 0.0f, rwidth = 0.0f, rheight = 0.0f;
  float area = INFINITY;
  float sx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  bool vlen_ok = true;
  if (in_band) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int tgt = arc == q ? nxt
                         : wrap(seq0[q] + __popc(before & arc_mask[q]));
      tgt = min(tgt, kSlots);
      const float2 v = s.fv[tgt];
      sx[q] = v.x;
      sy[q] = v.y;
    }
    const int vlen2 = dx * dx + dy * dy;
    vlen_ok = vlen2 < tab_n;
    const float iv = inv_sqrt_entry(min(max(vlen2, 0), tab_n - 1));
    const float lx = fmul(i2f(dx), iv), ly = fmul(i2f(dy), iv);
    a = arc == 0 ? lx : arc == 1 ? ly : arc == 2 ? -lx : -ly;
    b = arc == 0 ? ly : arc == 1 ? -lx : arc == 2 ? -ly : lx;
    rwidth = dot2(fsub(sx[1], sx[3]), a, fsub(sy[1], sy[3]), b);
    rheight = dot2(fsub(sy[2], sy[0]), a, -fsub(sx[2], sx[0]), b);
    area = fmul(rwidth, rheight);
  }
  if (!__all_sync(kFull, vlen_ok)) {
    fail();
    return;
  }

  // 5. the winner: least area, ties to the last visited, then the lower
  // candidate number (the first maximum of the plain version's argmax)
  float min_area = area;
  for (int off = 16; off > 0; off >>= 1)
    min_area = fminf(min_area, __shfl_xor_sync(kFull, min_area, off));
  const int key = in_band && area == min_area ? later * 64 + (63 - rank)
                                              : -1;
  if (key != __reduce_max_sync(kFull, key)) return;
  // the winner's picks, "+ 0.0" as the plain version's masked sums
  const float wa = fadd(a, 0.0f), wb = fadd(b, 0.0f);
  const float wwidth = fadd(rwidth, 0.0f), wheight = fadd(rheight, 0.0f);
  // absolute support coordinates (cv2 computes on absolute hull points)
  const float lxx = fadd(fadd(sx[3], 0.0f), x0f);
  const float lyy = fadd(fadd(sy[3], 0.0f), y0f);
  const float bxx = fadd(fadd(sx[0], 0.0f), x0f);
  const float byy = fadd(fadd(sy[0], 0.0f), y0f);
  const float nb = -wb;
  const float cc1 = dot2(lxx, wa, lyy, wb);
  const float cc2 = dot2(bxx, nb, byy, wa);
  const float det = dot2(wa, wa, -nb, wb);
  const float idet = __fdiv_rn(1.0f, det);
  const float px = fmul(dot2(cc1, wa, -cc2, wb), idet);
  const float py = fmul(dot2(cc2, wa, -cc1, nb), idet);
  const float osx = dot2(wa, wwidth, nb, wheight);
  const float osy = dot2(wb, wwidth, wa, wheight);
  cx_out[c] = fadd(fmul(osx, 0.5f), px);
  cy_out[c] = fadd(fmul(osy, 0.5f), py);
  ok_out[c] = 1;
}

__global__ void inv_sqrt_kernel(float* __restrict__ out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = inv_sqrt_entry(i);
}

}  // namespace

extern "C" {

// row_min_x, row_max_x: (D, R) int32; row_valid, corner_l, corner_r:
// (D, R) uint8; min_y: (D,) int32; cx, cy: (D,) float32; ok: (D,) uint8;
// all contiguous on CUDA device `device`, launched on `stream`. tab_n: the
// length of the inverse-sqrt table (ops/cv2_centers.py::inv_sqrt_table),
// whose entries the kernel computes; w_lim: the bbox width bound of the
// tangent keys. Returns a cudaError_t.
int ysmr_cv2_centers(const void* row_min_x, const void* row_max_x,
                     const void* row_valid, const void* min_y,
                     const void* corner_l, const void* corner_r, void* cx,
                     void* cy, void* ok, long long d, int r, int tab_n,
                     int w_lim, int device, void* stream) {
  if (d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (d + kWarps - 1) / kWarps;
  cv2_centers_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_min_x), static_cast<const int*>(row_max_x),
      static_cast<const uint8_t*>(row_valid), static_cast<const int*>(min_y),
      static_cast<const uint8_t*>(corner_l),
      static_cast<const uint8_t*>(corner_r), static_cast<float*>(cx),
      static_cast<float*>(cy), static_cast<uint8_t*>(ok), d, r, tab_n, w_lim);
  return static_cast<int>(cudaGetLastError());
}

// out: (n,) float32 on CUDA device `device`: the kernel's inverse-sqrt
// table entries 0..n-1, launched on `stream`. Returns a cudaError_t.
int ysmr_cv2_inv_sqrt(void* out, int n, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n / 256 + 1 < 4096 ? n / 256 + 1 : 4096;
  inv_sqrt_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
