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
// operations round them. One launch over tiles of S consecutive slots (S
// <= 256; 64 on the dense batch, 32 on the bench batches: 16 blocks an SM
// or more), a block of 256 threads a tile:
//   - corners: thread j takes slot j of the tile: its corners (the float64
//     cos and sin once a slot), window and walk box, the quad's bounding
//     box clipped to the window and the frame (every member lies in it:
//     the edges run between the corners), and the box's pixel count (0 for
//     an invalid slot or an empty box). One block scan of (pixels, boxes)
//     packed in 64 bits gives each non-empty box its place in the tile's
//     compact list and its first pixel in the tile's flat list of box
//     pixels; the box's parameters go to shared memory at that place.
//   - walk: the flat list is dealt to the 8 warps in contiguous ranges of
//     32-pixel passes, pixel p to lane p % 32, across box boundaries (no
//     lane idles at a box's end, and a tile of empty slots walks nothing).
//     A lane finds its box once (a binary search of the starts) and then
//     steps forward: the next box where its pixel passes the box's end,
//     else (x, y) advanced by 32 / bw rows and 32 % bw columns. Its int32
//     sum and count go to the box's shared totals by two atomics when it
//     leaves the box (integer sums: the order does not change the bits);
//     a member's gray is added a pass after its load, which stays in
//     flight meanwhile. The box's terms (the cross products'
//     coefficients, 1 / bw, its frame) are computed once by the corners'
//     thread and read from shared memory.
//   - membership: the four edge cross products as ex * y + (-ey) * x + k,
//     two wrapping products each: modulo 2^32 this is the plain version's
//     int32 (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1), bit for bit,
//     for any corners. A pixel that fails the orientation's signs takes
//     the LINE_8 edge tests. Where every corner lies within +-2^13 nothing
//     of the plain version's int32 arithmetic wraps, and each floor
//     division's test is a closed form in the cross product c already
//     computed: for an x-major edge (endpoints ordered as the plain
//     version orders them, ax0 <= x <= ax0 + |dx|) the pixel is on it iff
//     2 t lies in [1 - |dx|, |dx|] with t = -sy * c (c of the ordered
//     endpoints), for a y-major edge likewise with |dy| and t = sy * c,
//     over the edge's range of the major coordinate; a point edge adds
//     nothing (its pixel is an endpoint of a neighbouring edge, or every
//     corner is that pixel and the sign tests hold). Other corners take
//     the plain version's floor divisions as remainder tests in int64
//     (exact for the int32 operands of the x-major edges; for the int64
//     ones of the y-major edges wherever n stays below 2^62, else the
//     division itself).
//   - means: thread j writes slot j's mean from its box's totals, 0 for
//     an invalid slot or an empty box.
// No host synchronisation, no scratch, nothing the host reads.
//
// What bounds it on an H100: the bytes the data needs, the member pixels'
// gray (a byte each on the pixels-mode upload, four on frames mode's int32
// gray) and the slots' 21 bytes of rect and flag in and 4 bytes out; about
// 0.005 ms for the dense batch's 64 x 4096 slots (148,362 valid, ~60
// member pixels each). The walk's instructions and their latency keep it
// well above that: a pixel outside the quad takes the edge tests, and a
// lane entering a new box reloads its terms from shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 256;                // slots a block, at most
constexpr unsigned kAll = 0xffffffffu;
constexpr double kPi = 3.141592653589793;    // math.pi
constexpr int32_t kSane = 1 << 13;           // corner bound of the closed form
constexpr int kPositive = 1;                 // flags: orientation sign >= 0
constexpr int kSaneFlag = 2;                 // every corner within +-kSane
// flags bit 2 + i: edge i is x-major; bit 6 + i: edge i's t is -c

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

// A non-empty box's terms, in 16-byte groups (one shared load each)
struct __align__(16) Box {
  uint4 ex, ney, k;   // edge i's cross product: ex y + ney x + k, mod 2^32
  int4 lo, len;       // the closed form's ranges
  int4 geo;           // xlo, ylo, bw, (32 / bw) << 8 | 32 % bw
  int32_t flags, frame;
  float inv_bw;       // 1 / bw, rounded
  int32_t pad;        // to 16 bytes
};

// A tile's non-empty boxes in shared memory, at their places in the tile's
// compact list
struct Boxes {
  Box box[kMaxTile];
  int32_t start[kMaxTile + 1];   // first pixel in the tile's flat list
  int32_t qx[4][kMaxTile], qy[4][kMaxTile];
  uint32_t sum[kMaxTile], count[kMaxTile];
  unsigned long long warp_scan[kWarps];
  int32_t n, pixels;
};

template <typename Gray>
__global__ void __launch_bounds__(kThreads, 4)
rect_mean_tiles(const Gray* __restrict__ gray, const float* __restrict__ p_cx,
                const float* __restrict__ p_cy, const float* __restrict__ p_w,
                const float* __restrict__ p_h,
                const float* __restrict__ p_angle,
                const uint8_t* __restrict__ valid, float* __restrict__ out,
                int64_t total, int tile, int d, int img_h, int img_w,
                int win) {
  __shared__ Boxes s;
  const int j = threadIdx.x, lane = j & 31, warp = j >> 5;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t slot = tile0 + j;
  const bool in = j < tile && slot < total;
  // corners: thread j, slot j of the tile
  int32_t qx[4] = {0, 0, 0, 0}, qy[4] = {0, 0, 0, 0};
  int32_t xlo = 0, ylo = 0, bw = 0, n = 0;
  if (in && valid[slot]) {
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
    const int32_t xhi = static_cast<int32_t>(
        min3(mxx, int64_t(x_org) + win - 1, int64_t(img_w) - 1));
    const int32_t yhi = static_cast<int32_t>(
        min3(mxy, int64_t(y_org) + win - 1, int64_t(img_h) - 1));
    if (xlo <= xhi && ylo <= yhi) {
      bw = xhi - xlo + 1;
      n = bw * (yhi - ylo + 1);  // below 2^30: the entry bounds the window
    }
  }
  // each box's place in the compact list and first pixel: one block scan
  // of (pixels << 9 | box)
  const unsigned long long mine =
      (static_cast<unsigned long long>(n) << 9) | (n > 0 ? 1u : 0u);
  unsigned long long inc = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long u = __shfl_up_sync(kAll, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) s.warp_scan[warp] = inc;
  __syncthreads();
  unsigned long long before = 0;
  for (int k = 0; k < warp; ++k) before += s.warp_scan[k];
  const unsigned long long excl = before + inc - mine;
  const int q = static_cast<int>(excl & 511u);
  if (j == kThreads - 1) {
    const unsigned long long all = before + inc;
    s.n = static_cast<int32_t>(all & 511u);
    s.pixels = static_cast<int32_t>(all >> 9);
    s.start[s.n] = s.pixels;
  }
  if (n > 0) {
    s.start[q] = static_cast<int32_t>(excl >> 9);
    Box& bx = s.box[q];
    bx.geo = make_int4(xlo, ylo, bw, ((32 / bw) << 8) | (32 % bw));
    bx.frame = static_cast<int32_t>(slot / d);
    bx.inv_bw = __frcp_rn(static_cast<float>(bw));
    // orientation: the int64 sum of the int32 (wrapping) edge terms
    int64_t area2 = 0;
    bool sane = true;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = (i + 1) & 3;
      area2 += wsub(wmul(qx[i], qy[k]), wmul(qx[k], qy[i]));
      sane = sane && qx[i] >= -kSane && qx[i] <= kSane && qy[i] >= -kSane &&
             qy[i] <= kSane;
    }
    int flags = (area2 >= 0 ? kPositive : 0) | (sane ? kSaneFlag : 0);
    uint32_t ex[4], ney[4], kk[4];
    int32_t lo[4], len[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = (i + 1) & 3;
      s.qx[i][q] = qx[i];
      s.qy[i][q] = qy[i];
      // the cross product's terms: c = ex * y + (-ey) * x + (ey * x_i -
      // ex * y_i), modulo 2^32
      const uint32_t ey = static_cast<uint32_t>(qy[k]) - qy[i];
      ex[i] = static_cast<uint32_t>(qx[k]) - qx[i];
      ney[i] = 0u - ey;
      kk[i] = ey * static_cast<uint32_t>(qx[i]) -
              ex[i] * static_cast<uint32_t>(qy[i]);
      // the closed form's range and sign (read only where sane)
      const Edge e = make_edge(qx[i], qy[i], qx[k], qy[k]);
      const bool swap =
          (qx[k] < qx[i]) || ((qx[k] == qx[i]) && (qy[k] < qy[i]));
      lo[i] = INT32_MIN;               // a point edge: no pixel
      len[i] = 0;
      bool neg = false;
      if (!e.point) {
        if (e.x_major) {
          lo[i] = e.ax0;
          len[i] = e.adx;
          neg = e.sy > 0;              // t = -sy * c
          flags |= 4 << i;
        } else {
          lo[i] = e.sy > 0 ? e.ay0 : wsub(e.ay0, e.ady);
          len[i] = e.ady;
          neg = e.sy < 0;              // t = sy * c
        }
        if (swap) neg = !neg;          // c of the ordered endpoints is -c
      }
      if (neg) flags |= 64 << i;
    }
    bx.ex = make_uint4(ex[0], ex[1], ex[2], ex[3]);
    bx.ney = make_uint4(ney[0], ney[1], ney[2], ney[3]);
    bx.k = make_uint4(kk[0], kk[1], kk[2], kk[3]);
    bx.lo = make_int4(lo[0], lo[1], lo[2], lo[3]);
    bx.len = make_int4(len[0], len[1], len[2], len[3]);
    bx.flags = flags;
    s.sum[q] = 0;
    s.count[q] = 0;
  }
  __syncthreads();
  const int32_t pixels = s.pixels;
  if (pixels > 0) {
    // walk: the warp's contiguous range of 32-pixel passes
    const int passes = (pixels + 31) >> 5;
    const int pass0 = static_cast<int>(static_cast<int64_t>(warp) * passes /
                                       kWarps);
    const int pass1 = static_cast<int>(
        static_cast<int64_t>(warp + 1) * passes / kWarps);
    const int64_t frame_px = static_cast<int64_t>(img_h) * img_w;
    const Gray* g = gray;
    int b = -1;                        // the lane's box
    int32_t end = 0, px = 0, py = 0, x_end = 0, wb = 1, sx = 0, sy = 0;
    int flags = 0;
    uint32_t ex[4], ney[4], kk[4];
    uint32_t sum = 0, count = 0;
    uint32_t held = 0;  // the last pass's gray, added a pass late: its load
                        // stays in flight through this pass
    for (int pass = pass0; pass < pass1; ++pass) {
      const int32_t p = pass * 32 + lane;
      if (p >= pixels) break;
      sum += held;
      held = 0;
      if (p >= end) {
        // the next box: its totals out, its parameters in
        if (b >= 0) {
          atomicAdd(&s.sum[b], sum);
          atomicAdd(&s.count[b], count);
        }
        if (b < 0) {
          int lo = 0, hi = s.n - 1;    // the last box starting at or before p
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s.start[mid] <= p) {
              lo = mid;
            } else {
              hi = mid - 1;
            }
          }
          b = lo;
        } else {
          do {
            ++b;
          } while (s.start[b + 1] <= p);
        }
        end = s.start[b + 1];
        const Box& bx = s.box[b];
        const int4 geo = bx.geo;
        wb = geo.z;
        const int32_t r = p - s.start[b];
        // r / wb: below 2^21 the rounded 1 / wb times r + 1/2 lies within
        // 2^-22 relative of the quotient, which sits at least 1 / (2 wb)
        // from an integer
        const int32_t row =
            r < (1 << 21)
                ? __float2int_rz(__fmul_rn(__int2float_rn(r) + 0.5f,
                                           bx.inv_bw))
                : r / wb;
        px = geo.x + (r - row * wb);
        py = geo.y + row;
        x_end = geo.x + wb;
        sy = geo.w >> 8;
        sx = geo.w & 255;
        flags = bx.flags;
        const uint4 e4 = bx.ex, n4 = bx.ney, k4 = bx.k;
        ex[0] = e4.x;
        ex[1] = e4.y;
        ex[2] = e4.z;
        ex[3] = e4.w;
        ney[0] = n4.x;
        ney[1] = n4.y;
        ney[2] = n4.z;
        ney[3] = n4.w;
        kk[0] = k4.x;
        kk[1] = k4.y;
        kk[2] = k4.z;
        kk[3] = k4.w;
        g = gray + bx.frame * frame_px;
        sum = 0;
        count = 0;
      } else {
        px += sx;
        py += sy;
        if (px >= x_end) {
          px -= wb;
          ++py;
        }
      }
      // the cross products, modulo 2^32 the plain version's int32 ones
      int32_t c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[i] = static_cast<int32_t>(ex[i] * static_cast<uint32_t>(py) +
                                    ney[i] * static_cast<uint32_t>(px) +
                                    kk[i]);
      }
      bool member = (flags & kPositive)
                        ? min(min(c[0], c[1]), min(c[2], c[3])) >= 0
                        : max(max(c[0], c[1]), max(c[2], c[3])) <= 0;
      if (!member) {
        if (flags & kSaneFlag) {
          const int4 lo4 = s.box[b].lo, len4 = s.box[b].len;
          const int32_t los[4] = {lo4.x, lo4.y, lo4.z, lo4.w};
          const int32_t lens[4] = {len4.x, len4.y, len4.z, len4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const uint32_t u =
                static_cast<uint32_t>(((flags >> (2 + i)) & 1) ? px : py) -
                static_cast<uint32_t>(los[i]);
            const uint32_t len = static_cast<uint32_t>(lens[i]);
            const int32_t t = ((flags >> (6 + i)) & 1) ? -c[i] : c[i];
            member = member ||
                     (u <= len && static_cast<uint32_t>(2 * t) + len - 1u <=
                                      2u * len - 1u);
          }
        } else {
          int32_t x[4], y[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x[i] = s.qx[i][b];
            y[i] = s.qy[i][b];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int k = (i + 1) & 3;
            member = member || on_edge(make_edge(x[i], y[i], x[k], y[k]),
                                       px, py);
          }
        }
      }
      if (member) {
        held = static_cast<uint32_t>(
            static_cast<int32_t>(g[static_cast<int64_t>(py) * img_w + px]));
        ++count;
      }
    }
    sum += held;
    if (b >= 0) {
      atomicAdd(&s.sum[b], sum);
      atomicAdd(&s.count[b], count);
    }
  }
  __syncthreads();
  if (in) {
    float m = 0.0f;
    if (n > 0) {
      const int32_t c = static_cast<int32_t>(s.count[q]);
      if (c > 0) {
        const float sum = __int2float_rn(static_cast<int32_t>(s.sum[q]));
        m = __fmul_rn(__fdiv_rn(sum, __int2float_rn(c)), 0.01f);
      }
    }
    out[slot] = m;
  }
}

}  // namespace

extern "C" {

// gray: (T, H, W) uint8 (gray_bytes 1) or int32 (gray_bytes 4); cx, cy, w,
// h, angle: (T, D) float32; valid: (T, D) uint8 (0/1); out: (T, D) float32.
// Returns a cudaError_t (cudaErrorInvalidValue for another gray type, a
// window below 1, or a window of 2^30 pixels or more inside the frame).
int ysmr_rect_mean_lum(const void* gray, int gray_bytes, const void* cx,
                       const void* cy, const void* w, const void* h,
                       const void* angle, const void* valid, void* out, int t,
                       int d, int img_h, int img_w, int win, int device,
                       void* stream) {
  const int64_t box = static_cast<int64_t>(min(win, max(img_w, 0))) *
                      min(win, max(img_h, 0));
  if (win < 1 || (gray_bytes != 1 && gray_bytes != 4) ||
      box >= (int64_t(1) << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t total = static_cast<int64_t>(t) * d;
  if (total <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a tile's flat list stays below 2^30 pixels; smaller tiles, down to 32
  // slots, until the batch gives 16 blocks an SM (short walks a warp, and
  // the blocks' uneven work spread finely over the SMs)
  int tile = kMaxTile;
  while (tile > 1 && tile * box >= (int64_t(1) << 30)) tile >>= 1;
  while (tile > 32 && (total + tile - 1) / tile < 16LL * sms) tile >>= 1;
  const int64_t blocks = (total + tile - 1) / tile;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fcx = static_cast<const float*>(cx);
  const float* fcy = static_cast<const float*>(cy);
  const float* fw = static_cast<const float*>(w);
  const float* fh = static_cast<const float*>(h);
  const float* fa = static_cast<const float*>(angle);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (gray_bytes == 1) {
    rect_mean_tiles<uint8_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(static_cast<const uint8_t*>(gray), fcx,
                                    fcy, fw, fh, fa, v, o, total, tile, d,
                                    img_h, img_w, win);
  } else {
    rect_mean_tiles<int32_t><<<static_cast<unsigned>(blocks), kThreads, 0,
                               s>>>(static_cast<const int32_t*>(gray), fcx,
                                    fcy, fw, fh, fa, v, o, total, tile, d,
                                    img_h, img_w, win);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
