// The exact rotated-rect mean of the gray frames (the ILLUMINATION column):
// for each (frame, detection) slot the mean gray value over the filled
// rotated rectangle, / 100, as cv2.boxPoints + cv2.fillPoly + cv2.mean
// give it.
//
// Replaces no Pallas kernel: ysmr_tpu/ops/luminosity.py:113
// rect_mean_luminosity is plain XLA under vmap, which XLA fuses; eager
// PyTorch does not (the torch sequence took about 440 operations over
// (n, win, win) windows a chunk of 2^24 window pixels, and a torch.nonzero
// host synchronisation a call). Same contract as the plain version
// ysmr_tpu_torch/ops/luminosity.py::rect_mean_luminosity_plain, bit for
// bit:
//   - a slot whose valid flag is false gives 0;
//   - the integer corners are OpenCV 4's RotatedRect::points truncated
//     toward zero: the angle in radians in float64 ((angle * pi) / 180, two
//     rounded products), cos and sin in float64 rounded to float32 and
//     halved, the float32 corner sums unfused, corners 2 and 3 mirrored
//     through the center (2 * c - corner, two rounded operations);
//   - the window origin is clamp(min corner, 0, max(img - win, 0)) on each
//     axis, the window win x win pixels;
//   - a window pixel is a member when it lies in the frame and in the
//     quad's bounding box with the four edge cross products of the quad's
//     orientation sign (inclusive point-in-quad), or on one of the four
//     edges drawn as LINE_8 lines (the closed form of OpenCV's
//     LineIterator: the floor divisions of the plain version's
//     _edge_line_membership);
//   - the int32 sum of gray and the int32 count over the members, then
//     count > 0 ? (float(sum) / float(count)) * float32(0.01) : 0.
// Every integer step wraps as the plain version's int32 and int64 tensors
// do (torch.sum of int32 gives int64, where(..., 1, -1) int64), so the
// results agree for any corners, not only those of real rects.
//
// Design. The build flags allow fma contraction, so the corner arithmetic
// is written with __dmul_rn, __ddiv_rn, __fmul_rn, __fadd_rn and __fsub_rn,
// each operation rounded on its own as the plain version's separate torch
// operations round them. A warp takes 32 consecutive slots: lane k
// computes slot k's corners, window and walk box (the float64 cos and sin
// once a slot, not once a lane), then the warp walks the slots one at a
// time, the slot's corners and box broadcast by shuffles. Only the quad's
// bounding box clipped to the window and the frame is visited: every
// member lies in it (the edges run between the corners), so a bacterium
// costs its box, about 150-400 pixels, not the win x win = 2,304 of the
// window. The box's pixels are numbered in raster order and dealt to the
// lanes, 32 consecutive pixels a pass (consecutive bytes of a row, a row
// and the next where the box is narrow), the lane's (x, y) advanced by the
// pass's 32 / bw rows and 32 % bw columns. A pixel that passes the cross
// products skips the edge tests; the edge tests replace each floor
// division q = floor(n / d) == m by 0 <= n - m * d < d in int64 (exact for
// the int32 operands of the x-major edges; for the int64 ones of the
// y-major edges wherever n stays below 2^62, else the division itself).
// The sum and count are reduced with one __reduce_add_sync each, kept by
// the slot's lane, which writes the slot's mean at the end. An invalid slot
// has an empty box; a warp with no valid slot returns at once. No host
// synchronisation: one launch over all T x D slots.
//
// What bounds it on an H100: the bytes the data needs, the member pixels'
// gray (a byte each on the pixels-mode upload, four on frames mode's int32
// gray) and the slots' 21 bytes of rect and flag in and 4 bytes out; about
// 0.005 ms for the dense batch's 64 x 4096 slots (~180,000 valid, ~150
// member pixels each). The walk's integer tests and the reductions make it
// issue-bound well above that.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // warps a block
constexpr unsigned kAll = 0xffffffffu;
constexpr double kPi = 3.141592653589793;    // math.pi

// int32 arithmetic that wraps as torch's int32 tensors do
__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}
__device__ __forceinline__ int32_t wabs(int32_t a) {
  return a < 0 ? wsub(0, a) : a;
}
__device__ __forceinline__ int64_t wadd64(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) +
                              static_cast<uint64_t>(b));
}
__device__ __forceinline__ int64_t wmul64(int64_t a, int64_t b) {
  return static_cast<int64_t>(static_cast<uint64_t>(a) *
                              static_cast<uint64_t>(b));
}

__device__ __forceinline__ int64_t min3(int64_t a, int64_t b, int64_t c) {
  const int64_t m = a < b ? a : b;
  return m < c ? m : c;
}

// floor(a / b) for b > 0, as torch.div(..., rounding_mode='floor')
__device__ __forceinline__ int64_t floor_div64(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// One LINE_8 edge of a quad in the plain version's terms: the endpoints
// ordered lexicographically, |dx|, |dy|, the y step sign and the major
// axis.
struct Edge {
  int32_t ax0, ay0, adx, ady;
  int64_t sy;
  bool x_major, point;
};

__device__ __forceinline__ Edge make_edge(int32_t x0, int32_t y0, int32_t x1,
                                          int32_t y1) {
  const bool swap = (x1 < x0) || ((x1 == x0) && (y1 < y0));
  Edge e;
  e.ax0 = swap ? x1 : x0;
  e.ay0 = swap ? y1 : y0;
  const int32_t dx = wsub(swap ? x0 : x1, e.ax0);
  const int32_t dy = wsub(swap ? y0 : y1, e.ay0);
  e.sy = dy >= 0 ? 1 : -1;
  e.adx = wabs(dx);
  e.ady = wabs(dy);
  e.x_major = e.adx >= e.ady;
  e.point = e.adx == 0 && e.ady == 0;
  return e;
}

// pixel (px, py) on the edge's LINE_8 segment
__device__ __forceinline__ bool on_edge(const Edge& e, int32_t px,
                                        int32_t py) {
  if (e.point) return px == e.ax0 && py == e.ay0;
  if (e.x_major) {
    // k = px - ax0; y offset q = floor((2k*ady + adx - 1) / (2*adx)), int32
    const int32_t kx = wsub(px, e.ax0);
    if (kx < 0 || kx > e.adx) return false;
    const int64_t m = static_cast<int64_t>(wsub(py, e.ay0)) * e.sy;
    if (e.adx <= 0) return m == 0;
    const int32_t n = wsub(wadd(wmul(wmul(2, kx), e.ady), e.adx), 1);
    const int64_t d = max(wmul(2, e.adx), int32_t(1));
    const int64_t r = static_cast<int64_t>(n) - m * d;  // |m * d| < 2^62
    return r >= 0 && r < d;
  }
  // k = (py - ay0) * sy, int64; x offset q = floor((2k*adx + ady - 1) /
  // (2*ady)), int64
  const int64_t ky = static_cast<int64_t>(wsub(py, e.ay0)) * e.sy;
  if (ky < 0 || ky > e.ady) return false;
  const int64_t c = wsub(px, e.ax0);
  if (e.ady <= 0) return c == 0;
  const int64_t n = wadd64(wmul64(wmul64(2, ky), e.adx),
                           static_cast<int64_t>(e.ady) - 1);
  const int64_t d = max(wmul(2, e.ady), int32_t(1));
  if (ky < (int64_t(1) << 30) && e.adx >= 0 && e.adx < (1 << 30)) {
    const int64_t r = n - c * d;          // |n| < 2^62, |c * d| < 2^62
    return r >= 0 && r < d;
  }
  return floor_div64(n, d) == c;
}

// The corners of slot (cx, cy, w, h, angle): OpenCV 4's RotatedRect::points
// rounded as the plain version rounds it, truncated toward zero
__device__ __forceinline__ void box_points(float cx, float cy, float w,
                                           float h, float angle,
                                           int32_t qx[4], int32_t qy[4]) {
  const double a = __ddiv_rn(__dmul_rn(static_cast<double>(angle), kPi),
                             180.0);
  const float b = __fmul_rn(__double2float_rn(cos(a)), 0.5f);
  const float s = __fmul_rn(__double2float_rn(sin(a)), 0.5f);
  const float sh = __fmul_rn(s, h), bw = __fmul_rn(b, w);
  const float bh = __fmul_rn(b, h), sw = __fmul_rn(s, w);
  const float x0 = __fsub_rn(__fsub_rn(cx, sh), bw);
  const float y0 = __fsub_rn(__fadd_rn(cy, bh), sw);
  const float x1 = __fsub_rn(__fadd_rn(cx, sh), bw);
  const float y1 = __fsub_rn(__fsub_rn(cy, bh), sw);
  const float cx2 = __fmul_rn(2.0f, cx), cy2 = __fmul_rn(2.0f, cy);
  qx[0] = __float2int_rz(x0);
  qy[0] = __float2int_rz(y0);
  qx[1] = __float2int_rz(x1);
  qy[1] = __float2int_rz(y1);
  qx[2] = __float2int_rz(__fsub_rn(cx2, x0));
  qy[2] = __float2int_rz(__fsub_rn(cy2, y0));
  qx[3] = __float2int_rz(__fsub_rn(cx2, x1));
  qy[3] = __float2int_rz(__fsub_rn(cy2, y1));
}

template <typename Gray>
__global__ void __launch_bounds__(kWarps * 32)
rect_mean_kernel(const Gray* __restrict__ gray, const float* __restrict__ p_cx,
                 const float* __restrict__ p_cy, const float* __restrict__ p_w,
                 const float* __restrict__ p_h,
                 const float* __restrict__ p_angle,
                 const uint8_t* __restrict__ valid, float* __restrict__ out,
                 int64_t total, int d, int img_h, int img_w, int win) {
  const int lane = threadIdx.x & 31;
  const int64_t base =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * 32;
  if (base >= total) return;
  const int64_t slot = base + lane;
  const bool mine = slot < total && valid[slot];
  // lane k: its slot's corners and walk box (empty where invalid)
  int32_t qx[4] = {0, 0, 0, 0}, qy[4] = {0, 0, 0, 0};
  int32_t xlo = 0, xhi = -1, ylo = 0, yhi = -1;
  if (mine) {
    box_points(p_cx[slot], p_cy[slot], p_w[slot], p_h[slot], p_angle[slot],
               qx, qy);
    const int32_t mnx = min(min(qx[0], qx[1]), min(qx[2], qx[3]));
    const int32_t mxx = max(max(qx[0], qx[1]), max(qx[2], qx[3]));
    const int32_t mny = min(min(qy[0], qy[1]), min(qy[2], qy[3]));
    const int32_t mxy = max(max(qy[0], qy[1]), max(qy[2], qy[3]));
    const int32_t x_org = min(max(mnx, 0), max(img_w - win, 0));
    const int32_t y_org = min(max(mny, 0), max(img_h - win, 0));
    // the window holds x_org .. x_org + win - 1 (int64: no wrap for any win)
    xlo = max(mnx, x_org);
    ylo = max(mny, y_org);
    xhi = static_cast<int32_t>(min3(mxx, int64_t(x_org) + win - 1,
                                    int64_t(img_w) - 1));
    yhi = static_cast<int32_t>(min3(mxy, int64_t(y_org) + win - 1,
                                    int64_t(img_h) - 1));
  }
  const unsigned busy = __ballot_sync(kAll, mine && xlo <= xhi && ylo <= yhi);
  uint32_t my_sum = 0;
  int32_t my_count = 0;
  for (unsigned left = busy; left != 0; left &= left - 1) {
    const int j = __ffs(left) - 1;
    int32_t x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = __shfl_sync(kAll, qx[i], j);
      y[i] = __shfl_sync(kAll, qy[i], j);
    }
    const int32_t bx0 = __shfl_sync(kAll, xlo, j);
    const int32_t bx1 = __shfl_sync(kAll, xhi, j);
    const int32_t by0 = __shfl_sync(kAll, ylo, j);
    const int32_t by1 = __shfl_sync(kAll, yhi, j);
    // orientation: the int64 sum of the int32 (wrapping) edge terms
    int64_t area2 = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = (i + 1) & 3;
      area2 += wsub(wmul(x[i], y[k]), wmul(x[k], y[i]));
    }
    const bool positive = area2 >= 0;
    int32_t ex[4], ey[4];
    Edge edge[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = (i + 1) & 3;
      ex[i] = wsub(x[k], x[i]);
      ey[i] = wsub(y[k], y[i]);
      edge[i] = make_edge(x[i], y[i], x[k], y[k]);
    }
    const int32_t bw = bx1 - bx0 + 1;
    const int32_t n = bw * (by1 - by0 + 1);
    const int32_t step_y = 32 / bw, step_x = 32 % bw;
    int32_t px = bx0 + lane % bw, py = by0 + lane / bw;
    const int64_t frame = (base + j) / d;
    const Gray* g = gray + frame * img_h * static_cast<int64_t>(img_w);
    uint32_t sum = 0;
    uint32_t count = 0;
    for (int32_t idx = lane; idx < n; idx += 32) {
      bool member = true;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int32_t cross = wsub(wmul(ex[i], wsub(py, y[i])),
                                   wmul(ey[i], wsub(px, x[i])));
        member = member && (positive ? cross >= 0 : cross <= 0);
      }
      if (!member) {
        member = on_edge(edge[0], px, py) || on_edge(edge[1], px, py) ||
                 on_edge(edge[2], px, py) || on_edge(edge[3], px, py);
      }
      if (member) {
        sum += static_cast<uint32_t>(
            static_cast<int32_t>(g[static_cast<int64_t>(py) * img_w + px]));
        ++count;
      }
      px += step_x;
      py += step_y;
      if (px > bx1) {
        px -= bw;
        ++py;
      }
    }
    sum = __reduce_add_sync(kAll, sum);
    count = __reduce_add_sync(kAll, count);
    if (lane == j) {
      my_sum = sum;
      my_count = static_cast<int32_t>(count);
    }
  }
  if (slot < total) {
    out[slot] = my_count > 0
                    ? __fmul_rn(__fdiv_rn(__int2float_rn(
                                              static_cast<int32_t>(my_sum)),
                                          __int2float_rn(my_count)),
                                0.01f)
                    : 0.0f;
  }
}

}  // namespace

extern "C" {

// gray: (T, H, W) uint8 (gray_bytes 1) or int32 (gray_bytes 4); cx, cy, w,
// h, angle: (T, D) float32; valid: (T, D) uint8 (0/1); out: (T, D) float32.
// Returns a cudaError_t (cudaErrorInvalidValue for another gray type or a
// window below 1).
int ysmr_rect_mean_lum(const void* gray, int gray_bytes, const void* cx,
                       const void* cy, const void* w, const void* h,
                       const void* angle, const void* valid, void* out, int t,
                       int d, int img_h, int img_w, int win, int device,
                       void* stream) {
  if (win < 1 || (gray_bytes != 1 && gray_bytes != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(t) * d;
  if (total <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per_block = static_cast<int64_t>(kWarps) * 32;
  const unsigned blocks =
      static_cast<unsigned>((total + per_block - 1) / per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fcx = static_cast<const float*>(cx);
  const float* fcy = static_cast<const float*>(cy);
  const float* fw = static_cast<const float*>(w);
  const float* fh = static_cast<const float*>(h);
  const float* fa = static_cast<const float*>(angle);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (gray_bytes == 1) {
    rect_mean_kernel<uint8_t><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const uint8_t*>(gray), fcx, fcy, fw, fh, fa, v, o, total,
        d, img_h, img_w, win);
  } else {
    rect_mean_kernel<int32_t><<<blocks, kWarps * 32, 0, s>>>(
        static_cast<const int32_t*>(gray), fcx, fcy, fw, fh, fa, v, o, total,
        d, img_h, img_w, win);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
