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
// the plain version's _K_HULL, the warp's width).
//   1. The lanes read the component's rows (row j and j + 32, ...) and
//      reduce the valid rows' count, last index, x minimum and maximum;
//      a component with no valid row, rows that are no prefix, too wide a
//      bbox or more than 32 strict corners leaves with ok False.
//   2. The 2R-entry cycle (right corners rows 0..R-1, left corners rows
//      R-1..0) is compacted in cycle order 32 entries at a time by
//      __ballot_sync and __popc into the warp's packed slots in shared
//      memory; slots past the corner count hold 0.
//   3. Lane j takes edge j (slot j to the next): caliper arcs from the four
//      first-occurrence extremes, the in-quadrant tangent key, and the
//      surrogate area from the u/v extremes over the <= 32 vertices.
//   4. The 8 smallest surrogate areas by a rank count over the warp (the
//      lower slot first on equal areas: the stable sort's order); lane
//      c < 8 then takes candidate c: its support counts (loops over the
//      warp's edges), the float32 caliper arithmetic with the inverse
//      square root read from the table in global memory, and its area.
//   5. The winner (least area, the last visited on ties: the largest count
//      of earlier candidates, the first such) and lane 0's centre.
//
// What bounds it on an H100: latency and the integer work of the warp
// (a 32 x 32 projection loop per component, shuffles); bytes are 11 per
// row in and 9 per component out.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
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
// torch.remainder for a positive divisor
__device__ __forceinline__ int pmod(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}
__device__ __forceinline__ int first_lane(unsigned mask) {
  return mask ? __ffs(mask) - 1 : 0;
}

struct Shared {
  int vx[kSlots + 1], vy[kSlots + 1];   // packed slots; [32] = 0
  int dx[kSlots], dy[kSlots], arc[kSlots], arc_key[kSlots];
  float tan_key[kSlots];
  int cand[kCand];
};

__global__ void __launch_bounds__(kThreads)
cv2_centers_kernel(const int* __restrict__ row_min_x,
                   const int* __restrict__ row_max_x,
                   const uint8_t* __restrict__ row_valid,
                   const int* __restrict__ min_y,
                   const uint8_t* __restrict__ corner_l,
                   const uint8_t* __restrict__ corner_r,
                   const float* __restrict__ isq, float* __restrict__ cx_out,
                   float* __restrict__ cy_out, uint8_t* __restrict__ ok_out,
                   int64_t d, int r, int tab_n, int w_lim) {
  __shared__ Shared smem[kWarps];
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  Shared& s = smem[threadIdx.x >> 5];
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kWarps +
                    (threadIdx.x >> 5);
  if (c >= d) return;  // whole warps leave together
  const int64_t row0 = c * r;

  // 1. valid rows: count, last index, x extremes
  int h = 0, last_valid = -1, x0 = kBig, xmax = -kBig;
  for (int i = lane; i < r; i += 32) {
    if (row_valid[row0 + i]) {
      ++h;
      last_valid = i;
      x0 = min(x0, row_min_x[row0 + i]);
      xmax = max(xmax, row_max_x[row0 + i]);
    }
  }
  h = __reduce_add_sync(kFull, h);
  last_valid = __reduce_max_sync(kFull, last_valid);
  x0 = __reduce_min_sync(kFull, x0);
  xmax = __reduce_max_sync(kFull, xmax);
  // valid rows a prefix; the f32 slope/tan keys collision-free
  bool ok = h > 0 && last_valid == h - 1 && xmax - x0 < w_lim;

  // 2. the corner cycle, compacted in order
  int n = 0;
  if (ok) {
    const bool top_single = row_min_x[row0] == row_max_x[row0];
    const int last = h - 1;
    const bool bot_single =
        row_min_x[row0 + last] == row_max_x[row0 + last];
    for (int e0 = 0; e0 < 2 * r; e0 += 32) {
      const int e = e0 + lane;
      bool flag = false;
      int x = 0, y = 0;
      if (e < r) {
        y = e;
        flag = row_valid[row0 + y] && corner_r[row0 + y] &&
               (y != 0 || !top_single);
        if (flag) x = row_max_x[row0 + y] - x0;
      } else if (e < 2 * r) {
        y = 2 * r - 1 - e;
        flag = row_valid[row0 + y] && corner_l[row0 + y] &&
               (y != last || !bot_single);
        if (flag) x = row_min_x[row0 + y] - x0;
      }
      const unsigned mask = __ballot_sync(kFull, flag);
      const int pos = n + __popc(mask & lt_mask);
      if (flag && pos < kSlots) {
        s.vx[pos] = x;
        s.vy[pos] = y;
      }
      n += __popc(mask);
    }
    ok = n <= kSlots;
  }
  if (!ok) {
    if (lane == 0) {
      cx_out[c] = 0.0f;
      cy_out[c] = 0.0f;
      ok_out[c] = 0;
    }
    return;
  }
  if (lane >= n) {
    s.vx[lane] = 0;
    s.vy[lane] = 0;
  }
  if (lane == 0) {
    s.vx[kSlots] = 0;
    s.vy[kSlots] = 0;
  }
  __syncwarp();
  const float x0f = i2f(x0);
  const float y0f = i2f(min_y[c]);
  if (n <= 2) {
    // a single point or a line: the f32 midpoint
    if (lane == 0) {
      const float p0x = i2f(s.vx[0] + x0), p0y = i2f(s.vy[0] + min_y[c]);
      const float p1x = i2f(s.vx[1] + x0), p1y = i2f(s.vy[1] + min_y[c]);
      cx_out[c] = n == 1 ? p0x : fmul(fadd(p0x, p1x), 0.5f);
      cy_out[c] = n == 1 ? p0y : fmul(fadd(p0y, p1y), 0.5f);
      ok_out[c] = 1;
    }
    return;
  }

  // 3. edge `lane`: slot lane to the next (the first after the last)
  const int j = lane;
  const bool vvalid = j < n;   // also the edge's validity: n > 2
  const int vx = s.vx[j], vy = s.vy[j];
  const int nxt = j == n - 1 ? 0 : (j + 1) & 31;
  const int dx = s.vx[nxt] - vx, dy = s.vy[nxt] - vy;
  const int ymax = __reduce_max_sync(kFull, vvalid ? vy : -kBig);
  const int xvmax = __reduce_max_sync(kFull, vvalid ? vx : -kBig);
  const int xvmin = __reduce_min_sync(kFull, vvalid ? vx : kBig);
  int seq0[4];
  seq0[0] = first_lane(__ballot_sync(kFull, vvalid && vy == 0));
  seq0[1] = first_lane(__ballot_sync(kFull, vvalid && vx == xvmax));
  seq0[2] = first_lane(__ballot_sync(kFull, vvalid && vy == ymax));
  seq0[3] = first_lane(__ballot_sync(kFull, vvalid && vx == xvmin));
  const int bot0 = seq0[0];
  const int rel_s = pmod(j - bot0, n);
  const int r1 = pmod(seq0[1] - bot0, n);
  const int q2 = pmod(seq0[2] - bot0, n);
  const int q3 = pmod(seq0[3] - bot0, n);
  const int r2 = q2 + (q2 < r1 ? n : 0);
  const int r3 = q3 + n * (q3 >= r2 ? 0 : (q3 + n >= r2 ? 1 : 2));
  const int arc = (0 <= rel_s) + (r1 <= rel_s) + (r2 <= rel_s) +
                  (r3 <= rel_s) - 1;
  const int cdx = arc == 0 ? dx : arc == 1 ? dy : arc == 2 ? -dx : -dy;
  const int cdy = arc == 0 ? dy : arc == 1 ? -dx : arc == 2 ? -dy : dx;
  const float tan_key = vvalid ? __fdiv_rn(i2f(cdy), i2f(cdx)) : INFINITY;
  const int arc_key = vvalid ? arc : 4;
  s.dx[j] = dx;
  s.dy[j] = dy;
  s.arc[j] = arc;
  s.arc_key[j] = arc_key;
  s.tan_key[j] = tan_key;
  // surrogate area: the u/v extremes over the vertices
  const float dxf = i2f(dx), dyf = i2f(dy);
  float umin = INFINITY, umax = -INFINITY, vmin = INFINITY, vmax = -INFINITY;
  for (int p = 0; p < n; ++p) {
    const float px = i2f(s.vx[p]), py = i2f(s.vy[p]);
    const float u = dot2(dxf, px, dyf, py);
    const float v = fsub(fmul(dxf, py), fmul(dyf, px));
    umin = fminf(umin, u);
    umax = fmaxf(umax, u);
    vmin = fminf(vmin, v);
    vmax = fmaxf(vmax, v);
  }
  const float l2f = fmaxf(i2f(dx * dx + dy * dy), 1.0f);
  float area_sur = __fdiv_rn(fmul(fsub(umax, umin), fsub(vmax, vmin)), l2f);
  if (!vvalid) area_sur = INFINITY;
  float min_sur = area_sur;
  for (int off = 16; off > 0; off >>= 1)
    min_sur = fminf(min_sur, __shfl_xor_sync(kFull, min_sur, off));
  const float band = fadd(fmul(min_sur, kBandMul), kBandAdd);
  const bool in_band = vvalid && area_sur <= band;
  const unsigned band_mask = __ballot_sync(kFull, in_band);
  bool good = __popc(band_mask) <= kCand;

  // 4. the 8 smallest surrogate areas, the lower slot first on ties
  int rank = 0;
  for (int i = 0; i < 32; ++i) {
    const float o = __shfl_sync(kFull, area_sur, i);
    rank += o < area_sur || (o == area_sur && i < j);
  }
  if (rank < kCand) s.cand[rank] = j;
  __syncwarp();
  float a = 0.0f, b = 0.0f, rwidth = 0.0f, rheight = 0.0f;
  float area = INFINITY, ctan = 0.0f;
  float sx[4] = {0.0f, 0.0f, 0.0f, 0.0f}, sy[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int carc = 4;
  bool cvalid = false, vlen_ok = true;
  if (lane < kCand) {
    const int cs = s.cand[lane];
    cvalid = (band_mask >> cs) & 1u;
    ctan = fadd(s.tan_key[cs], 0.0f);
    carc = s.arc_key[cs];
    int cnt[4] = {0, 0, 0, 0};
    for (int e = 0; e < n; ++e) {
      const float te = s.tan_key[e];
      if (te < ctan || (te == ctan && s.arc_key[e] < carc)) ++cnt[s.arc[e]];
    }
    for (int q = 0; q < 4; ++q) {
      int tgt = carc == q ? pmod(cs + 1, n) : pmod(seq0[q] + cnt[q], n);
      tgt = min(tgt, kSlots);
      sx[q] = i2f(s.vx[tgt]);
      sy[q] = i2f(s.vy[tgt]);
    }
    const int ex = s.dx[cs], ey = s.dy[cs];
    const int vlen2 = ex * ex + ey * ey;
    vlen_ok = vlen2 < tab_n || !cvalid;
    const float iv = isq[min(max(vlen2, 0), tab_n - 1)];
    const float lx = fmul(i2f(ex), iv), ly = fmul(i2f(ey), iv);
    a = carc == 0 ? lx : carc == 1 ? ly : carc == 2 ? -lx : -ly;
    b = carc == 0 ? ly : carc == 1 ? -lx : carc == 2 ? -ly : lx;
    rwidth = dot2(fsub(sx[1], sx[3]), a, fsub(sy[1], sy[3]), b);
    rheight = dot2(fsub(sy[2], sy[0]), a, -fsub(sx[2], sx[0]), b);
    area = cvalid ? fmul(rwidth, rheight) : INFINITY;
  }
  good = good && __all_sync(kFull, vlen_ok);

  // 5. the winner: least area, ties to the last visited
  float min_area = area;
  for (int off = 16; off > 0; off >>= 1)
    min_area = fminf(min_area, __shfl_xor_sync(kFull, min_area, off));
  int later = 0;
  for (int i = 0; i < kCand; ++i) {
    const float ot = __shfl_sync(kFull, ctan, i);
    const int oa = __shfl_sync(kFull, carc, i);
    const bool ov = __shfl_sync(kFull, static_cast<int>(cvalid), i);
    later += ov && (ctan > ot || (ctan == ot && carc > oa));
  }
  const int tie_rank = lane < kCand ? (area == min_area ? later : -1)
                                    : -2;
  int win = 0, best = -3;
  for (int i = 0; i < kCand; ++i) {
    const int t = __shfl_sync(kFull, tie_rank, i);
    if (t > best) {
      best = t;
      win = i;
    }
  }
  const float wa = fadd(__shfl_sync(kFull, a, win), 0.0f);
  const float wb = fadd(__shfl_sync(kFull, b, win), 0.0f);
  const float wwidth = fadd(__shfl_sync(kFull, rwidth, win), 0.0f);
  const float wheight = fadd(__shfl_sync(kFull, rheight, win), 0.0f);
  float wsx[4], wsy[4];
  for (int q = 0; q < 4; ++q) {
    wsx[q] = fadd(__shfl_sync(kFull, sx[q], win), 0.0f);
    wsy[q] = fadd(__shfl_sync(kFull, sy[q], win), 0.0f);
  }
  if (lane != 0) return;
  // absolute support coordinates (cv2 computes on absolute hull points)
  const float lxx = fadd(wsx[3], x0f), lyy = fadd(wsy[3], y0f);
  const float bxx = fadd(wsx[0], x0f), byy = fadd(wsy[0], y0f);
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
  ok_out[c] = good;
}

}  // namespace

extern "C" {

// row_min_x, row_max_x: (D, R) int32; row_valid, corner_l, corner_r:
// (D, R) uint8; min_y: (D,) int32; isq: (tab_n,) float32; cx, cy: (D,)
// float32; ok: (D,) uint8; all contiguous on CUDA device `device`,
// launched on `stream`. w_lim: the bbox width bound of the tangent keys.
// Returns a cudaError_t.
int ysmr_cv2_centers(const void* row_min_x, const void* row_max_x,
                     const void* row_valid, const void* min_y,
                     const void* corner_l, const void* corner_r,
                     const void* isq, void* cx, void* cy, void* ok,
                     long long d, int r, int tab_n, int w_lim, int device,
                     void* stream) {
  if (d <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (d + kWarps - 1) / kWarps;
  cv2_centers_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_min_x), static_cast<const int*>(row_max_x),
      static_cast<const uint8_t*>(row_valid), static_cast<const int*>(min_y),
      static_cast<const uint8_t*>(corner_l),
      static_cast<const uint8_t*>(corner_r), static_cast<const float*>(isq),
      static_cast<float*>(cx), static_cast<float*>(cy),
      static_cast<uint8_t*>(ok), d, r, tab_n, w_lim);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
