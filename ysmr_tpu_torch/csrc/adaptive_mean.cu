// The 11x11 Gaussian-weighted local mean of cv2.adaptiveThreshold, and
// frames mode's whole preprocess around it in one pass; and mean-threshold
// mode's preprocess and masks.
//
// Replaces the plain-XLA ysmr_tpu/ops/preprocess.py::adaptive_gaussian_mean
// (no Pallas kernel: XLA fuses it on the TPU) and, in the second entry, the
// chain XLA fuses around it in ysmr_tpu/pipeline/detect.py (bgr_to_gray,
// blur3, the mean, the two threshold rules, & frame_valid); in the third
// and fourth, ysmr_tpu/pipeline/detect.py::prepare_batch(needs_sums=True)
// (bgr_to_gray, blur3, frame_mean_std_sums) and the mean branch of
// detect_masks (global_threshold) with & frame_valid, plain XLA too; the
// host sets each frame's threshold between the two. Four entries, the first
// two on one tile core:
//
// - ysmr_adaptive_mean: int32 (T, H, W) in and out, any int32 value; the
//   bits of ysmr_tpu_torch/ops/preprocess.py::adaptive_gaussian_mean_plain.
// - ysmr_adaptive_masks: BGR uint8 (N, H, W, 3) in; the mask and, with the
//   double threshold, the markers (N, H, W) bool out, and on request the
//   gray frames as int32; the bits of adaptive_masks_from_bgr_plain. An
//   invalid frame writes zero masks and reads no BGR unless the gray is
//   asked for (it is bgr_to_gray of every frame).
// - ysmr_mean_prepare: BGR uint8 (N, H, W, 3) in; the blurred frames as
//   uint8, the (N, 3) int32 sums [total, hi, lo] of frame_mean_std_sums
//   and on request the int32 gray out, for every frame; the bits of
//   mean_prepare_from_bgr_plain. A warp a tile of 30 rows and 128 columns
//   with a one-pixel halo, no shared memory; each row's sum of squares is
//   made whole in a per-row table by atomics before the frame's last tile
//   splits it into hi and lo.
// - ysmr_mean_masks: the uint8 blurred frames, (N,) int32 thresholds and
//   frame_valid in, the bool mask out; a block row a frame, 4 x 16 bytes a
//   thread; the bits of mean_masks_plain.
//
// Arithmetic, the same bits as the plain versions: gray is OpenCV's
// fixed-point (b * 3735 + g * 19235 + r * 9798 + 2^14) >> 15; the 3x3 blur's
// (acc + 2^15) >> 16 with acc = 4096 * S, S the [1 2 1] x [1 2 1] sum, is
// (S + 8) >> 4, reflect-101 at the frame's edges; the mean's border
// replicates the blurred frame, so a halo position of the mean is the blur
// at the clamped pixel, not a blur of replicated gray. The mean takes the
// float32 taps of getGaussianKernel(11, 0), horizontal pass first, each
// 11-tap sum in XLA:CPU's contracted order
//   acc = fma(p0, k0, p1 * k1), then acc = fma(p_i, k_i, acc), i = 2..10,
// then the same chain vertically over the rounded row sums, and
// floor(acc + 0.5). Every product, fma and sum is an _rn intrinsic: nvcc
// contracts a plain a * b + c by default (-fmad=true), which would change
// which products are rounded. The rules compare blur - mean with integer
// bounds the host computes (-ceil(C) for white on dark, -floor(C) for
// dark): white keeps diff > bound, dark diff <= bound, i.e. (diff > bound)
// xor dark; both sides are small integers, exact in float32.
//
// Design: one block of 128 threads per (frame, 64-row x 128-column output
// tile), frames on the grid's z axis (in launches of at most 65,535).
//   1. (masks) The gray window of the tile, 76 x 144 bytes in shared memory
//      (origin 6 rows up and 8 columns left, so a thread's 4 pixels are 12
//      aligned bytes of a BGR row: three 4-byte loads; 16-byte vectors do
//      not fit a 3W-byte row). A warp takes every fourth window row, a lane
//      one 4-pixel group of it, ten rows' loads in flight; groups 32-35 of
//      each row follow. The gray of a group is eight 16 x 8-bit dot
//      products (__dp2a_lo/hi) and three byte permutes. Rows and columns
//      outside the frame map by reflect-101; a group that crosses the
//      frame's edge, and every group when W % 4 != 0, is read pixel by
//      pixel.
//      (mean) The int32 input at the clamped window positions, as float32,
//      a warp a row, four rows' loads in flight.
//   2. (masks) The blurred window, 74 x 140 float32: each thread slides a
//      4-column group down a third of the rows, its [1 2 1] sums in 16-bit
//      lanes of a word (columns 0 and 2, 1 and 3), the blur turned to
//      float32 under the exponent of 2^23. Window rows and columns outside
//      the frame are then copied from the frame's edge row and column (the
//      clamp), in the edge tiles only.
//   3. The mean: each thread owns 4 output columns of a 16-row strip and
//      slides down the strip's 26 window rows: per row three 16-byte and
//      one 8-byte shared load give the 14 values of its 4 horizontal
//      chains, whose sums go into an 11-row ring in registers (the loop is
//      unrolled 11 times so the ring's slots are fixed registers); from the
//      11th row on, the vertical chain of each column reads the ring. The
//      epilogue writes the int32 mean (16 bytes a row) or compares with the
//      blurred centre and stores 4 mask bytes (and 4 marker bytes) as one
//      32-bit word when W % 4 == 0. The masks kernel is instantiated for
//      white or dark and for one or two rules.
// The mean-threshold entries (below the masks kernel) have designs of their
// own, at their kernels. No allocation and no host synchronisation, so a
// launch can be captured in a CUDA graph (ysmr_mean_prepare's memset of its
// sums and row table included).
//
// What bounds it on an H100. The data's bound is bytes: ysmr_adaptive_masks
// moves 3 bytes in and 2 out a pixel (+ 4 with the gray), at 64 x 922 x
// 1228 362.4 MB, 0.108 ms at 3.35 TB/s (652 MB, 0.195 ms with the gray);
// ysmr_adaptive_mean 4 + 4 bytes a pixel, 579.7 MB, 0.173 ms. Neither
// kernel reaches it: the mean's 22 fmas a pixel and each phase's integer
// work run in phases that a block's barriers serialise, with 4 blocks of
// 4 warps an SM (shared memory and about 90 registers a thread allow no
// more). Timing each phase inside the kernel showed the gray phase
// lasting as long with its loads and arithmetic taken out: the phases
// compete for issue, and the kernel is bound by issue and latency, not by
// bytes.
// ysmr_mean_prepare moves 3 bytes in and 1 out a pixel (+ 4 with the
// gray), 289.9 MB at the bench batch, 0.087 ms at 3.35 TB/s (0.173 ms with
// the gray); ysmr_mean_masks 1 in and 1 out, 144.9 MB, 0.043 ms. Both are
// bound by bytes, and both designs keep bytes in flight with nothing that
// serialises: the prepare kernel's warps are independent (no block
// barrier, no shared memory, 64 registers or fewer for 8 blocks of 4 warps
// an SM), each with 4 rows' loads ahead of its arithmetic, reading 32 BGR
// rows for 30 output rows (the halo, mostly from L2) and one more word a
// row at the warp's edges. Its integer work, about 75 instructions a lane
// and row counted from the source, stays below the SMs' instruction rate.
// The masks kernel has no division and no frame search: the frame is the
// grid's y, and 4 x 16 bytes a thread are in flight. On an H100 at 700 W
// the prepare kernel runs at 73-74% of its bound (65% with the gray) and
// the masks kernel at 82%, at the bench batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRadius = 5;
constexpr int kTaps = 2 * kRadius + 1;
constexpr int kTileH = 64;                      // output rows of a tile
constexpr int kTileW = 128;                     // output columns of a tile
constexpr int kStrip = 16;                      // output rows of a mean strip
constexpr int kGroups = kTileW / 4;             // 4-column groups of a row
constexpr int kThreads = kGroups * (kTileH / kStrip);
constexpr int kBH = kTileH + 2 * kRadius;       // rows of the mean's window
constexpr int kBW = kTileW + 12;                // its 138 columns, padded to 4
constexpr int kGH = kBH + 2;                    // gray rows (the blur's halo)
constexpr int kGW = kBW + 4;                    // gray columns, origin x0 - 8
constexpr int kBStrips = 3;                     // row strips of the blur
constexpr int kBRows = (kBH + kBStrips - 1) / kBStrips;
constexpr int kMeanSmem = kBH * kBW * 4;
constexpr int kMasksSmem = kMeanSmem + kGH * kGW;
constexpr int kMaxFrames = 65535;

static_assert(kThreads == 128, "phase 3 gives every thread one strip");
static_assert((kBW / 4) * kBStrips <= kThreads, "phase 2 is one pass");

struct Taps {
  float k[kTaps];
};

__device__ __forceinline__ float chain11(const float* v, const Taps& t) {
  float acc = __fmaf_rn(v[0], t.k[0], __fmul_rn(v[1], t.k[1]));
#pragma unroll
  for (int i = 2; i < kTaps; ++i) acc = __fmaf_rn(v[i], t.k[i], acc);
  return acc;
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// reflect-101 (-1 -> 1, n -> n - 2), then clamped: the positions it maps
// beyond the blur's one-pixel halo feed no output, and on an axis of one
// pixel every position maps to 0 (jnp.pad's reflect there).
__device__ __forceinline__ int reflect101(int v, int n) {
  v = v < 0 ? -v : (v >= n ? 2 * n - 2 - v : v);
  return clampi(v, n - 1);
}

// Twice the gray's fixed-point sum, 2 (b * 3735 + g * 19235 + r * 9798 +
// 2^14) < 2^24: the gray is its byte 2.
__device__ __forceinline__ uint32_t gray2_of(uint32_t b, uint32_t g,
                                             uint32_t r) {
  return b * 7470u + g * 38470u + r * 19596u + 32768u;
}

// Phase 3: this thread's 4 columns (window column c) down the strip whose
// first window row is row0, rows_out output rows; emit(i, acc) per row.
template <class Emit>
__device__ __forceinline__ void mean_strip(const float* win, int row0,
                                           int rows_out, int c,
                                           const Taps& t, Emit emit) {
  float ring[kTaps][4];
  const int n = rows_out + 2 * kRadius;
  for (int w0 = 0; w0 < n; w0 += kTaps) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int wr = w0 + j;
      if (wr < n) {
        const float* src = win + (row0 + wr) * kBW + c;
        const float4 a = *reinterpret_cast<const float4*>(src);
        const float4 b = *reinterpret_cast<const float4*>(src + 4);
        const float4 d = *reinterpret_cast<const float4*>(src + 8);
        const float2 e = *reinterpret_cast<const float2*>(src + 12);
        const float v[14] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z,
                             b.w, d.x, d.y, d.z, d.w, e.x, e.y};
#pragma unroll
        for (int q = 0; q < 4; ++q) ring[j][q] = chain11(v + q, t);
        if (wr >= 2 * kRadius) {
          // the ring holds window rows wr - 10 .. wr: row wr - 10 + i in
          // slot (j + 1 + i) % 11
          float acc[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q] = __fmaf_rn(ring[(j + 1) % kTaps][q], t.k[0],
                               __fmul_rn(ring[(j + 2) % kTaps][q], t.k[1]));
#pragma unroll
            for (int i = 2; i < kTaps; ++i)
              acc[q] = __fmaf_rn(ring[(j + 1 + i) % kTaps][q], t.k[i],
                                 acc[q]);
          }
          emit(wr - 2 * kRadius, acc);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
mean_kernel(const int* __restrict__ img, int* __restrict__ out, Taps taps,
            int h, int w, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* win = reinterpret_cast<float*>(smem);
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * h * w;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  // a warp stages rows warp, warp + 4, ...; a lane columns lane + 32 k,
  // their clamped sources computed once; four rows' loads in flight
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int kWarps = kThreads / 32, kChunks = (kBW + 31) / 32;
  int col[kChunks];
#pragma unroll
  for (int k = 0; k < kChunks; ++k)
    col[k] = clampi(x0 - kRadius + lane + 32 * k, w - 1);
  const int chunks = lane + 32 * (kChunks - 1) < kBW ? kChunks : kChunks - 1;
  for (int r0 = warp; r0 < kBH; r0 += 4 * kWarps) {
    int v[4][kChunks];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = min(r0 + u * kWarps, kBH - 1);
      const int* row = img + frame +
                       static_cast<int64_t>(clampi(y0 - kRadius + r, h - 1)) *
                           w;
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
        if (k < chunks) v[u][k] = __ldg(row + col[k]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * kWarps;
#pragma unroll
      for (int k = 0; k < kChunks; ++k)
        if (r < kBH && k < chunks)
          win[r * kBW + lane + 32 * k] = __int2float_rn(v[u][k]);
    }
  }
  __syncthreads();
  const int s = threadIdx.x / kGroups, c = 4 * (threadIdx.x % kGroups);
  const int ys = y0 + s * kStrip, x = x0 + c;
  const int rows_out = min(kStrip, h - ys);
  if (rows_out <= 0 || x >= w) return;
  mean_strip(win, s * kStrip, rows_out, c, taps,
             [&](int i, const float* acc) {
               int* dst = out + frame + static_cast<int64_t>(ys + i) * w + x;
               int m[4];
#pragma unroll
               for (int q = 0; q < 4; ++q)
                 m[q] = __float2int_rd(__fadd_rn(acc[q], 0.5f));
               if (vec) {
                 *reinterpret_cast<int4*>(dst) = make_int4(m[0], m[1], m[2],
                                                           m[3]);
               } else {
#pragma unroll
                 for (int q = 0; q < 4; ++q)
                   if (x + q < w) dst[q] = m[q];
               }
             });
}

struct MaskArgs {
  const uint8_t* bgr;
  const bool* valid;
  uint8_t* mask;
  uint8_t* markers;  // null: single threshold
  int* gray;         // null: not asked for
  float bound_mask, bound_marker;
  int h, w;
  int words;  // 4-byte BGR loads and 32-bit mask stores (W % 4 == 0)
};

// gray2_of of 4 pixels from their 12 BGR bytes (little-endian words
// B0 G0 R0 B1 | G1 R1 B2 G2 | R2 B3 G3 R3), two 16 x 8-bit dot products a
// pixel: __dp2a_lo takes bytes 0-1 of its second operand, __dp2a_hi
// bytes 2-3, against the two 16-bit coefficients of the first.
__device__ __forceinline__ void gray2_words(const uint32_t* wd,
                                            uint32_t* g2) {
  constexpr uint32_t kBG = 7470u | 38470u << 16, kR = 19596u;
  constexpr uint32_t kB = 7470u << 16, kGR = 38470u | 19596u << 16;
  const uint32_t p = wd[0], q = wd[1], r = wd[2];
  g2[0] = __dp2a_hi(kR, p, __dp2a_lo(kBG, p, 32768u));
  g2[1] = __dp2a_lo(kGR, q, __dp2a_hi(kB, p, 32768u));
  g2[2] = __dp2a_lo(kR, r, __dp2a_hi(kBG, q, 32768u));
  g2[3] = __dp2a_hi(kGR, r, __dp2a_lo(kB, r, 32768u));
}

// gray2_of of the 4 pixels from column x of a BGR row, each column mapped
// by reflect-101: the groups at the frame's edges and every group when
// W % 4 != 0. Out of line, as are the other rare paths below: the unrolled
// loops hold the common path only.
__device__ __noinline__ uint4 gray2_pixels(const uint8_t* row, int x, int w) {
  uint32_t g2[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint8_t* px = row + 3 * reflect101(x + j, w);
    g2[j] = gray2_of(px[0], px[1], px[2]);
  }
  return make_uint4(g2[0], g2[1], g2[2], g2[3]);
}

__device__ __noinline__ void store_gray(int* dst, const uint32_t* g2, int x,
                                        int w, int words) {
  const int gv[4] = {static_cast<int>(g2[0] >> 16),
                     static_cast<int>(g2[1] >> 16),
                     static_cast<int>(g2[2] >> 16),
                     static_cast<int>(g2[3] >> 16)};
  if (words) {
    *reinterpret_cast<int4*>(dst) = make_int4(gv[0], gv[1], gv[2], gv[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (x + j < w) dst[j] = gv[j];
  }
}

// One 4-pixel group of the gray window (window row gr, group k, first
// pixel column x): `fast` groups from the words loaded into wd, the others
// pixel by pixel through reflect-101; stored as 4 bytes, and as int32 gray
// where it is a tile pixel and the gray is asked for.
__device__ __forceinline__ void gray_group(const MaskArgs& a,
                                           const uint8_t* bgr, uint8_t* g8,
                                           int64_t frame, int y0, int gr,
                                           int k, int x, bool fast,
                                           const uint32_t* wd) {
  const int h = a.h, w = a.w;
  uint32_t g2[4];
  if (fast) {
    gray2_words(wd, g2);
  } else {
    const uint4 v = gray2_pixels(
        bgr + static_cast<int64_t>(reflect101(y0 - 6 + gr, h)) * w * 3, x, w);
    g2[0] = v.x;
    g2[1] = v.y;
    g2[2] = v.z;
    g2[3] = v.w;
  }
  reinterpret_cast<uint32_t*>(g8)[gr * (kGW / 4) + k] =
      __byte_perm(__byte_perm(g2[0], g2[1], 0x0062),
                  __byte_perm(g2[2], g2[3], 0x0062), 0x5410);
  const int y = y0 - 6 + gr;
  if (a.gray && gr >= 6 && gr < 6 + kTileH && k >= 2 && k < 2 + kGroups &&
      y < h && x < w)
    store_gray(a.gray + frame + static_cast<int64_t>(y) * w + x, g2, x, w,
               a.words);
}

__device__ __forceinline__ const uint32_t* bgr_words(const uint8_t* bgr,
                                                     int h, int w, int y,
                                                     int x) {
  return reinterpret_cast<const uint32_t*>(
      bgr + (static_cast<int64_t>(reflect101(y, h)) * w + x) * 3);
}

// The bytes of mask (and markers) words at columns x .. x + 3 below w.
__device__ __noinline__ void store_mask_bytes(uint8_t* mask, uint8_t* markers,
                                              uint32_t mk, uint32_t mr, int x,
                                              int w) {
  for (int q = 0; q < 4; ++q) {
    if (x + q < w) {
      mask[q] = (mk >> (8 * q)) & 1u;
      if (markers) markers[q] = (mr >> (8 * q)) & 1u;
    }
  }
}

// Bytes 0 and 2 (`sel` 0x4240) or 1 and 3 (0x4341) of v as 16-bit lanes.
__device__ __forceinline__ uint32_t lanes16(uint32_t v, uint32_t sel) {
  return __byte_perm(v, 0u, sel);
}

// The 16-bit lane `sel` of v (a value below 256) as float32: its byte
// under the exponent of 2^23, minus 2^23.
__device__ __forceinline__ float lane_float(uint32_t v, uint32_t sel) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, sel)),
                   8388608.0f);
}

// Phase 1 of the masks kernel: the gray window of the tile at (y0, x0),
// rows y0 - 6 .., columns x0 - 8 .., 36 groups of 4 pixels a row, into g8
// (and the int32 gray of the tile's pixels where a.gray is set). A warp
// takes rows warp, warp + 4, ..., a lane group lane of each, ten rows'
// loads in flight; then groups 32-35.
__device__ __forceinline__ void gray_window(const MaskArgs& a,
                                            const uint8_t* bgr, uint8_t* g8,
                                            int64_t frame, int y0, int x0) {
  const int h = a.h, w = a.w;
  constexpr int kWarps = kThreads / 32;
  constexpr int kRows = (kGH + kWarps - 1) / kWarps, kBatch = 10;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int x = x0 - 8 + 4 * lane;
  const bool fast = a.words && x >= 0 && x + 4 <= w;
  for (int n0 = 0; n0 < kRows; n0 += kBatch) {
    uint32_t wd[kBatch][3];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int gr = min(warp + kWarps * (n0 + u), kGH - 1);
      if (fast) {
        const uint32_t* p = bgr_words(bgr, h, w, y0 - 6 + gr, x);
        wd[u][0] = __ldg(p);
        wd[u][1] = __ldg(p + 1);
        wd[u][2] = __ldg(p + 2);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int gr = warp + kWarps * (n0 + u);
      if (n0 + u < kRows && gr < kGH)
        gray_group(a, bgr, g8, frame, y0, gr, lane, x, fast, wd[u]);
    }
  }
  constexpr int kTail = kGW / 4 - 32, kTailItems = kGH * kTail;
  constexpr int kTailRounds = (kTailItems + kThreads - 1) / kThreads;
  uint32_t wd[kTailRounds][3];
#pragma unroll
  for (int u = 0; u < kTailRounds; ++u) {
    const int item = threadIdx.x + u * kThreads;
    const int xt = x0 - 8 + 4 * (32 + item % kTail);
    if (item < kTailItems && a.words && xt >= 0 && xt + 4 <= w) {
      const uint32_t* p = bgr_words(bgr, h, w, y0 - 6 + item / kTail, xt);
      wd[u][0] = __ldg(p);
      wd[u][1] = __ldg(p + 1);
      wd[u][2] = __ldg(p + 2);
    }
  }
#pragma unroll
  for (int u = 0; u < kTailRounds; ++u) {
    const int item = threadIdx.x + u * kThreads;
    const int xt = x0 - 8 + 4 * (32 + item % kTail);
    if (item < kTailItems)
      gray_group(a, bgr, g8, frame, y0, item / kTail, 32 + item % kTail, xt,
                 a.words && xt >= 0 && xt + 4 <= w, wd[u]);
  }
}

// Phase 2 of the masks kernel: the blurred window from the gray window.
// Window row r, column c is the blur at (y0 - 5 + r, x0 - 5 + c), from
// gray rows r .. r + 2, columns c + 2 .. c + 4. A thread takes a 4-column
// group down a third of the rows; its [1 2 1] sums run in 16-bit lanes
// (columns 0 and 2, 1 and 3), at most 4080, and each row's blur goes to
// emit(r, c, even, odd): the blur of columns c and c + 2 in the 16-bit
// lanes of even, of c + 1 and c + 3 in those of odd, each below 256.
template <class Emit>
__device__ __forceinline__ void blur_window(const uint8_t* g8, Emit emit) {
  if (threadIdx.x < (kBW / 4) * kBStrips) {
    const int c = 4 * (threadIdx.x % (kBW / 4));
    const int r0 = (threadIdx.x / (kBW / 4)) * kBRows;
    const int r1 = min(r0 + kBRows, kBH);
    auto hsum = [&](int gr, uint32_t& even, uint32_t& odd) {
      const uint32_t lo =
          *reinterpret_cast<const uint32_t*>(g8 + gr * kGW + c);
      const uint32_t hi =
          *reinterpret_cast<const uint32_t*>(g8 + gr * kGW + c + 4);
      const uint32_t p = __funnelshift_r(lo, hi, 16);  // gray c+2 .. c+5
      const uint32_t q = __funnelshift_r(lo, hi, 24);  // gray c+3 .. c+6
      even = lanes16(p, 0x4240) + 2 * lanes16(q, 0x4240) +
             lanes16(hi, 0x4240);
      odd = lanes16(p, 0x4341) + 2 * lanes16(q, 0x4341) + lanes16(hi, 0x4341);
    };
    uint32_t e0, o0, e1, o1;
    hsum(r0, e0, o0);
    hsum(r0 + 1, e1, o1);
#pragma unroll 5
    for (int r = r0; r < r1; ++r) {
      uint32_t e2, o2;
      hsum(r + 2, e2, o2);
      const uint32_t be = ((e0 + 2 * e1 + e2 + 0x00080008u) >> 4) &
                          0x0FFF0FFFu;
      const uint32_t bo = ((o0 + 2 * o1 + o2 + 0x00080008u) >> 4) &
                          0x0FFF0FFFu;
      emit(r, c, be, bo);
      e0 = e1;
      o0 = o1;
      e1 = e2;
      o1 = o2;
    }
  }
}

template <bool kDark, bool kDouble>
__global__ void __launch_bounds__(kThreads, 4)
masks_kernel(MaskArgs a, Taps taps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* win = reinterpret_cast<float*>(smem);
  uint8_t* g8 = smem + kMeanSmem;
  const int h = a.h, w = a.w;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * plane;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const bool valid = a.valid[blockIdx.z];
  if (!valid && a.gray == nullptr) {
    // a padding frame: zero masks, no BGR read
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int y = y0 + i / kTileW, x = x0 + i % kTileW;
      if (y < h && x < w) {
        a.mask[frame + static_cast<int64_t>(y) * w + x] = 0;
        if (kDouble) a.markers[frame + static_cast<int64_t>(y) * w + x] = 0;
      }
    }
    return;
  }

  // 1. gray window
  gray_window(a, a.bgr + frame * 3, g8, frame, y0, x0);
  __syncthreads();

  // 2. blurred window, as float32 through the exponent of 2^23
  blur_window(g8, [&](int r, int c, uint32_t be, uint32_t bo) {
    *reinterpret_cast<float4*>(win + r * kBW + c) = make_float4(
        lane_float(be, 0x7650), lane_float(bo, 0x7650),
        lane_float(be, 0x7652), lane_float(bo, 0x7652));
  });
  __syncthreads();
  // the clamp: window rows, then columns, outside the frame take the
  // frame's edge row or column (edge tiles only; block-uniform branches)
  const int top = kRadius - y0, bottom = h - 1 - y0 + kRadius;
  if (top > 0 || bottom < kBH - 1) {
    for (int i = threadIdx.x; i < kBH * kBW; i += kThreads) {
      const int r = i / kBW;
      if (r < top) win[i] = win[top * kBW + i % kBW];
      if (r > bottom) win[i] = win[bottom * kBW + i % kBW];
    }
    __syncthreads();
  }
  const int left = kRadius - x0, right = w - 1 - x0 + kRadius;
  if (left > 0 || right < kBW - 1) {
    for (int i = threadIdx.x; i < kBH * kBW; i += kThreads) {
      const int r = i / kBW, c = i % kBW;
      if (c < left) win[i] = win[r * kBW + left];
      if (c > right) win[i] = win[r * kBW + right];
    }
    __syncthreads();
  }

  // 3. the mean, the rules and & frame_valid. White keeps diff > bound,
  // i.e. floor(acc + 0.5) < blur - bound, i.e. acc + 0.5 < blur - bound
  // (blur - bound is an integer; acc + 0.5 rounded first, as the plain
  // version rounds it); dark keeps the rest. Each comparison's all-ones or
  // zero word gives one byte of the 4-pixel word.
  const int s = threadIdx.x / kGroups, c = 4 * (threadIdx.x % kGroups);
  const int ys = y0 + s * kStrip, x = x0 + c;
  const int rows_out = min(kStrip, h - ys);
  if (rows_out <= 0 || x >= w) return;
  const float bound_mask = a.bound_mask, bound_marker = a.bound_marker;
  const uint32_t keep = valid ? 0x01010101u : 0u;
  const uint32_t flip = valid && kDark ? 0x01010101u : 0u;
  const int64_t first = frame + static_cast<int64_t>(ys) * w + x;
  mean_strip(win, s * kStrip, rows_out, c, taps,
             [&](int i, const float* acc) {
               const float* ctr = win + (s * kStrip + i + kRadius) * kBW + c;
               const float4 m = *reinterpret_cast<const float4*>(ctr + 4);
               const float blur[4] = {m.y, m.z, m.w, ctr[8]};
               uint32_t lt[4], lr[4];
#pragma unroll
               for (int q = 0; q < 4; ++q) {
                 const float half = __fadd_rn(acc[q], 0.5f);
                 lt[q] = half < __fsub_rn(blur[q], bound_mask) ? ~0u : 0u;
                 if (kDouble)
                   lr[q] = half < __fsub_rn(blur[q], bound_marker) ? ~0u : 0u;
               }
               // byte q of the word from lt[q]; then keep or flip its bit
               const uint32_t mk =
                   (__byte_perm(__byte_perm(lt[0], lt[1], 0x3250),
                                __byte_perm(lt[2], lt[3], 0x3250), 0x5410) &
                    keep) ^
                   flip;
               const uint32_t mr =
                   kDouble ? (__byte_perm(__byte_perm(lr[0], lr[1], 0x3250),
                                          __byte_perm(lr[2], lr[3], 0x3250),
                                          0x5410) &
                              keep) ^
                                 flip
                           : 0u;
               const int64_t at = first + static_cast<int64_t>(i) * w;
               if (a.words) {
                 *reinterpret_cast<uint32_t*>(a.mask + at) = mk;
                 if (kDouble)
                   *reinterpret_cast<uint32_t*>(a.markers + at) = mr;
               } else {
                 store_mask_bytes(a.mask + at,
                                  kDouble ? a.markers + at : nullptr, mk, mr,
                                  x, w);
               }
             });
}

struct PrepareArgs {
  const uint8_t* bgr;
  uint8_t* blurred;
  unsigned* sums;     // (N, 3): total, hi, lo; zeroed before the launch
  unsigned* tickets;  // (N,): warp tiles of the frame done; zeroed
  unsigned* rows;     // (N, H): each row's sum of squares; zeroed
  int* gray;          // null: not asked for
  int h, w;
  unsigned tiles;  // warp tiles a frame: column strips x bands
};

constexpr int kPrepWarps = 4;                   // bands a block, stacked
constexpr int kPrepThreads = 32 * kPrepWarps;
constexpr int kBand = 30;                       // output rows of a band
constexpr int kBatch = 4;                       // window rows loaded ahead
static_assert((kBand + 2) % kBatch == 0, "a full band is whole batches");
static_assert(kTileW == 4 * 32, "a warp's lanes cover a strip");
static_assert(kBand <= 32, "a lane keeps one row's sum of squares");

// The bytes of a blurred word at columns x .. x + 3 below w.
__device__ __noinline__ void store_blur_bytes(uint8_t* dst, uint32_t v, int x,
                                              int w) {
  for (int q = 0; q < 4; ++q)
    if (x + q < w) dst[q] = (v >> (8 * q)) & 0xFFu;
}

// The 4-pixel gray word of columns x .. x + 3 and the gray of columns
// x - 1 and x + 4 (reflect-101 at the frame's edges) of a BGR row read
// byte by byte: the path of W % 4 != 0 and of misaligned frames. Returns
// gray2_of of the 4 pixels in g2, the left gray in byte 3 of *lw and the
// right one in byte 0 of *rw.
__device__ __noinline__ void gray_row_pixels(const uint8_t* row, int x, int w,
                                             uint32_t* g2, uint32_t* lw,
                                             uint32_t* rw) {
  uint32_t v[6];
  for (int j = 0; j < 6; ++j) {
    const uint8_t* px = row + 3 * reflect101(x - 1 + j, w);
    v[j] = gray2_of(px[0], px[1], px[2]);
  }
  for (int j = 0; j < 4; ++j) g2[j] = v[j + 1];
  *lw = (v[0] >> 16) << 24;
  *rw = v[5] >> 16;
}

// Mean-threshold mode's preprocess. A warp takes a band of kBand rows of a
// 128-column strip of one frame: lane l the columns x = x0 + 4 l .. + 3,
// rows y0 - 1 .. y0 + kBand (reflect-101) slid down in batches of kBatch
// rows whose words are loaded ahead. Of each row the lane forms the gray of
// its 4 pixels (three 4-byte words, __dp2a), takes the gray of columns
// x - 1 and x + 4 from its neighbour lanes (__shfl) or, at the warp's
// edges, from one more word (lanes 0 and 31), reflects at the frame's
// edges, and sums [1 2 1] in 16-bit lanes (columns x and x + 2, x + 1 and
// x + 3); the vertical [1 2 1] of three rows' sums gives 4 blurred bytes,
// one 32-bit store. The rows' gray adds to the lane's total (__dp4a), each
// row's squares to the row's warp sum (__dp4a, __reduce_add_sync), kept by
// lane (row - y0). All in uint32, which wraps as JAX's int32 sums do.
// After the band each lane adds its row's sum to the frame's row table and
// lane 0 the total to the frame's sums, by atomics (integers: any order
// gives the same bits); the frame's last warp tile, found by a ticket
// after __threadfence, splits each whole row sum into hi (>> 16, signed)
// and lo (& 0xFFFF) and writes their sums. No shared memory and no block
// barrier: the four warps of a block are independent bands.
template <bool kWords>
__global__ void __launch_bounds__(kPrepThreads, 8)
mean_prepare_kernel(PrepareArgs a) {
  constexpr uint32_t kBG = 7470u | 38470u << 16, kR = 19596u;
  constexpr uint32_t kB = 7470u << 16, kGR = 38470u | 19596u << 16;
  const int h = a.h, w = a.w;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y0 = (blockIdx.y * kPrepWarps + warp) * kBand;
  if (y0 >= h) return;  // a band below the frame: no tile, no ticket
  const int x = blockIdx.x * kTileW + 4 * lane;
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * h * w;
  const uint8_t* bgr = a.bgr + frame * 3;
  uint8_t* blurred = a.blurred + frame;
  int* gray = a.gray ? a.gray + frame : nullptr;
  const int rows_out = min(kBand, h - y0);
  const int rows_in = rows_out + 2;
  // this lane's bytes inside the frame
  const uint32_t cols = x >= w ? 0u
                        : w - x >= 4 ? ~0u
                                     : (1u << (8 * (w - x))) - 1u;
  // the warp's edge lanes: lane 0 reads the word ending with pixel x - 1,
  // lane 31 the word starting with pixel x + 4, where those are in the
  // frame; their gray by the coefficients of that word's byte layout
  const bool edge = kWords && ((lane == 0 && x > 0 && x < w) ||
                               (lane == 31 && x + 4 < w));
  const int eoff = lane == 0 ? 3 * x - 4 : 3 * x + 12;
  const uint32_t klo = lane == 0 ? kB : kBG, khi = lane == 0 ? kGR : kR;
  uint32_t total = 0, mine = 0;
  uint32_t e0 = 0, o0 = 0, e1 = 0, o1 = 0;
  for (int r0 = 0; r0 < rows_in; r0 += kBatch) {
    uint32_t wd[kBatch][4];
    if constexpr (kWords) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const uint8_t* row =
            bgr + static_cast<uint32_t>(reflect101(y0 - 1 + r0 + u, h)) *
                      static_cast<uint32_t>(3 * w);
        const uint32_t* p = reinterpret_cast<const uint32_t*>(row + 3 * x);
        wd[u][0] = x < w ? __ldg(p) : 0u;
        wd[u][1] = x < w ? __ldg(p + 1) : 0u;
        wd[u][2] = x < w ? __ldg(p + 2) : 0u;
        wd[u][3] = edge ? __ldg(reinterpret_cast<const uint32_t*>(row +
                                                                  eoff))
                        : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int r = r0 + u;  // window row: frame row y0 - 1 + r
      if (r >= rows_in) break;
      uint32_t g2[4], lw, rw;
      if constexpr (kWords) {
        gray2_words(wd[u], g2);
      } else {
        gray_row_pixels(
            bgr + static_cast<uint32_t>(reflect101(y0 - 1 + r, h)) *
                      static_cast<uint32_t>(3 * w),
            x, w, g2, &lw, &rw);
      }
      const uint32_t g = __byte_perm(__byte_perm(g2[0], g2[1], 0x0062),
                                     __byte_perm(g2[2], g2[3], 0x0062),
                                     0x5410);
      if constexpr (kWords) {
        const uint32_t eg = __dp2a_hi(khi, wd[u][3],
                                      __dp2a_lo(klo, wd[u][3], 32768u));
        lw = __shfl_up_sync(~0u, g, 1);    // byte 3: column x - 1
        rw = __shfl_down_sync(~0u, g, 1);  // byte 0: column x + 4
        if (lane == 0) lw = eg << 8;
        if (lane == 31) rw = eg >> 16;
        if (x == 0) lw = g << 16;       // reflect-101: column 1
        if (x + 4 >= w) rw = g >> 16;   // column w - 2
      }
      // [1 2 1] of columns x - 1 .. x + 4 in 16-bit lanes
      const uint32_t left = __funnelshift_r(lw, g, 24);   // x - 1 .. x + 2
      const uint32_t right = __funnelshift_r(g, rw, 8);   // x + 1 .. x + 4
      const uint32_t e2 = lanes16(left, 0x4240) + 2 * lanes16(g, 0x4240) +
                          lanes16(right, 0x4240);
      const uint32_t o2 = lanes16(left, 0x4341) + 2 * lanes16(g, 0x4341) +
                          lanes16(right, 0x4341);
      if (r >= 1 && r <= rows_out) {
        // frame row y0 + r - 1: its sums and, on request, its gray
        const uint32_t gm = g & cols;
        total = __dp4a(gm, 0x01010101u, total);
        const uint32_t sq = __reduce_add_sync(~0u, __dp4a(gm, gm, 0u));
        if (lane == r - 1) mine = sq;
        if (gray && cols) {
          int* dst = gray + static_cast<uint32_t>(y0 + r - 1) *
                                static_cast<uint32_t>(w) + x;
          const int gv[4] = {static_cast<int>(g2[0] >> 16),
                             static_cast<int>(g2[1] >> 16),
                             static_cast<int>(g2[2] >> 16),
                             static_cast<int>(g2[3] >> 16)};
          if constexpr (kWords) {
            *reinterpret_cast<int4*>(dst) =
                make_int4(gv[0], gv[1], gv[2], gv[3]);
          } else {
            for (int j = 0; j < 4 && x + j < w; ++j) dst[j] = gv[j];
          }
        }
      }
      if (r >= 2 && cols) {
        // frame row y0 + r - 2 from window rows r - 2 .. r
        const uint32_t be = ((e0 + 2 * e1 + e2 + 0x00080008u) >> 4) &
                            0x0FFF0FFFu;
        const uint32_t bo = ((o0 + 2 * o1 + o2 + 0x00080008u) >> 4) &
                            0x0FFF0FFFu;
        const uint32_t v = __byte_perm(be, bo, 0x6240);
        uint8_t* dst = blurred + static_cast<uint32_t>(y0 + r - 2) *
                                     static_cast<uint32_t>(w) + x;
        if constexpr (kWords)
          *reinterpret_cast<uint32_t*>(dst) = v;
        else
          store_blur_bytes(dst, v, x, w);
      }
      e0 = e1;
      o0 = o1;
      e1 = e2;
      o1 = o2;
    }
  }
  unsigned* rows = a.rows + static_cast<int64_t>(blockIdx.z) * h;
  unsigned* sums = a.sums + 3 * static_cast<int64_t>(blockIdx.z);
  if (lane < rows_out) atomicAdd(rows + y0 + lane, mine);
  total = __reduce_add_sync(~0u, total);
  if (lane == 0) atomicAdd(sums, total);
  __threadfence();
  __syncwarp();
  unsigned ticket = 0;
  if (lane == 0) ticket = atomicAdd(a.tickets + blockIdx.z, 1u);
  if (__shfl_sync(~0u, ticket, 0) != a.tiles - 1) return;
  // the frame's last warp tile: every row sum is whole
  __threadfence();
  uint32_t hi = 0, lo = 0;
  for (int i = lane; i < h; i += 32) {
    const int row = static_cast<int>(__ldcg(rows + i));
    hi += static_cast<uint32_t>(row >> 16);
    lo += static_cast<uint32_t>(row & 0xFFFF);
  }
  hi = __reduce_add_sync(~0u, hi);
  lo = __reduce_add_sync(~0u, lo);
  if (lane == 0) {
    sums[1] = hi;
    sums[2] = lo;
  }
}

constexpr int kMaskThreads = 256;
constexpr int kMaskVecs = 4;  // 16-byte vectors a thread, all in flight

// 4 mask bytes of the blurred bytes in v: byte i is 1 where byte i of v
// exceeds the threshold t, with k = 255 - clamp(t, -1, 255) in both 16-bit
// lanes (v's byte + k carries into bit 8 exactly where it exceeds t),
// flipped by `flip` and kept by `keep`.
__device__ __forceinline__ uint32_t mask_word(uint32_t v, uint32_t k,
                                              uint32_t flip, uint32_t keep) {
  const uint32_t even = v & 0x00FF00FFu, odd = (v >> 8) & 0x00FF00FFu;
  const uint32_t gt = (((even + k) >> 8) & 0x00010001u) |
                      ((odd + k) & 0x01000100u);
  return (gt ^ flip) & keep;
}

// Mean-threshold mode's masks: blurred > t (white on dark) or blurred <= t
// (dark), & frame_valid, t the frame's threshold. The grid is column
// chunks x frames: a block reads its frame's threshold and valid flag once
// (an invalid frame writes zeros and reads nothing). With kVec (blurred
// and mask at the same offset mod 16) a thread takes kMaskVecs 16-byte
// vectors of the frame's aligned body, all loads in flight before the
// stores; the frame's head (up to its first 16-byte boundary) and tail
// bytes are scalar lanes of block 0. Without kVec a thread takes 16 bytes,
// one at a time.
template <bool kVec>
__global__ void __launch_bounds__(kMaskThreads)
global_threshold_kernel(const uint8_t* __restrict__ blurred,
                        const int* __restrict__ thr,
                        const bool* __restrict__ valid,
                        uint8_t* __restrict__ mask, uint32_t plane,
                        int dark) {
  const int64_t frame = static_cast<int64_t>(blockIdx.y) * plane;
  const uint8_t* src = blurred + frame;
  uint8_t* dst = mask + frame;
  const bool on = valid[blockIdx.y];
  const int t = min(max(thr[blockIdx.y], -1), 255);
  const uint32_t k = static_cast<uint32_t>(255 - t) * 0x00010001u;
  const uint32_t keep = on ? 0x01010101u : 0u;
  const uint32_t flip = dark ? 0x01010101u : 0u;
  if constexpr (kVec) {
    const uint32_t head =
        min((16u - static_cast<uint32_t>(
                       reinterpret_cast<uintptr_t>(src) % 16)) % 16,
            plane);
    const uint32_t nv = (plane - head) / 16;
    const uint4* vs = reinterpret_cast<const uint4*>(src + head);
    uint4* vd = reinterpret_cast<uint4*>(dst + head);
    const uint32_t j0 = blockIdx.x * (kMaskThreads * kMaskVecs) + threadIdx.x;
    uint4 v[kMaskVecs];
#pragma unroll
    for (int u = 0; u < kMaskVecs; ++u) {
      const uint32_t j = j0 + u * kMaskThreads;
      v[u] = on && j < nv ? __ldcs(vs + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kMaskVecs; ++u) {
      const uint32_t j = j0 + u * kMaskThreads;
      if (j < nv)
        vd[j] = make_uint4(mask_word(v[u].x, k, flip, keep),
                           mask_word(v[u].y, k, flip, keep),
                           mask_word(v[u].z, k, flip, keep),
                           mask_word(v[u].w, k, flip, keep));
    }
    if (blockIdx.x == 0 && threadIdx.x < 32) {
      const uint32_t i = threadIdx.x < 16
                             ? threadIdx.x
                             : head + 16 * nv + (threadIdx.x - 16);
      if (threadIdx.x < 16 ? i < head : i < plane)
        dst[i] = mask_word(on ? src[i] : 0u, k, flip, keep) & 1u;
    }
  } else {
    const uint32_t i0 = blockIdx.x * (kMaskThreads * 16) + threadIdx.x;
    uint32_t v[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const uint32_t i = i0 + u * kMaskThreads;
      v[u] = on && i < plane ? src[i] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const uint32_t i = i0 + u * kMaskThreads;
      if (i < plane) dst[i] = mask_word(v[u], k, flip, keep) & 1u;
    }
  }
}

Taps taps_of(const float* taps) {
  Taps k;
  for (int i = 0; i < kTaps; ++i) k.k[i] = taps[i];
  return k;
}

}  // namespace

extern "C" {

// img, out: (T, H, W) int32, contiguous on CUDA device `device`; taps: 11
// float32 values in host memory (the Gaussian taps, passed by value to the
// kernel); launched on `stream`. Returns a cudaError_t (0 = launched).
int ysmr_adaptive_mean(const void* img, void* out, const float* taps, int t,
                       int h, int w, int device, void* stream) {
  if (t <= 0 || h <= 0 || w <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps k = taps_of(taps);
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int z = 0; z < t; z += kMaxFrames) {
    const int frames = t - z < kMaxFrames ? t - z : kMaxFrames;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    frames);
    mean_kernel<<<grid, kThreads, kMeanSmem,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(img) + z * plane,
        static_cast<int*>(out) + z * plane, k, h, w, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// bgr: (N, H, W, 3) uint8; valid: (N,) bool; mask: (N, H, W) bool;
// markers: (N, H, W) bool or null (single threshold); gray: (N, H, W) int32
// or null; all contiguous on CUDA device `device`.
// taps: as above; bound_mask, bound_marker: the rules' integer bounds;
// dark: 1 keeps diff <= bound, 0 diff > bound. Launched on `stream`.
// Returns a cudaError_t (0 = launched).
int ysmr_adaptive_masks(const void* bgr, const void* valid, void* mask,
                        void* markers, void* gray, const float* taps,
                        int bound_mask, int bound_marker, int dark, int n,
                        int h, int w, int device, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void (*kernel)(MaskArgs, Taps) =
      dark ? (markers ? masks_kernel<true, true> : masks_kernel<true, false>)
           : (markers ? masks_kernel<false, true> : masks_kernel<false, false>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMasksSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Taps k = taps_of(taps);
  const int64_t plane = static_cast<int64_t>(h) * w;
  MaskArgs a{};
  a.bound_mask = static_cast<float>(bound_mask);
  a.bound_marker = static_cast<float>(bound_marker);
  a.h = h;
  a.w = w;
  a.words = w % 4 == 0 && reinterpret_cast<uintptr_t>(bgr) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(markers) % 4 == 0 &&
            reinterpret_cast<uintptr_t>(gray) % 16 == 0;
  for (int z = 0; z < n; z += kMaxFrames) {
    const int frames = n - z < kMaxFrames ? n - z : kMaxFrames;
    a.bgr = static_cast<const uint8_t*>(bgr) + z * plane * 3;
    a.valid = static_cast<const bool*>(valid) + z;
    a.mask = static_cast<uint8_t*>(mask) + z * plane;
    a.markers = markers ? static_cast<uint8_t*>(markers) + z * plane
                        : nullptr;
    a.gray = gray ? static_cast<int*>(gray) + z * plane : nullptr;
    const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                    frames);
    kernel<<<grid, kThreads, kMasksSmem, static_cast<cudaStream_t>(stream)>>>(
        a, k);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// bgr: (N, H, W, 3) uint8; blurred: (N, H, W) uint8; gray: (N, H, W)
// int32 or null; scratch: (N * (4 + H),) int32, the (N, 3) sums (total,
// hi, lo) first, then the frames' tickets and row sums; all contiguous on
// CUDA device `device`, H * W * 3 below 2^32. A memset of the scratch and
// one launch on `stream`. Returns a cudaError_t (0 = launched).
int ysmr_mean_prepare(const void* bgr, void* blurred, void* scratch,
                      void* gray, int n, int h, int w, int device,
                      void* stream) {
  if (n <= 0) return 0;
  const int64_t plane = static_cast<int64_t>(h) * w;
  if (plane * 3 >= (int64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(scratch, 0,
                        static_cast<size_t>(n) * (4 + (h > 0 ? h : 0)) *
                            sizeof(int),
                        st);
  if (err != cudaSuccess || h <= 0 || w <= 0) return static_cast<int>(err);
  const int words = w % 4 == 0 && reinterpret_cast<uintptr_t>(bgr) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(blurred) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(gray) % 16 == 0;
  void (*kernel)(PrepareArgs) =
      words ? mean_prepare_kernel<true> : mean_prepare_kernel<false>;
  const int strips = (w + kTileW - 1) / kTileW;
  const int bands = (h + kBand - 1) / kBand;
  unsigned* base = static_cast<unsigned*>(scratch);
  PrepareArgs a{};
  a.h = h;
  a.w = w;
  a.tiles = static_cast<unsigned>(strips) * bands;
  for (int z = 0; z < n; z += kMaxFrames) {
    const int frames = n - z < kMaxFrames ? n - z : kMaxFrames;
    a.bgr = static_cast<const uint8_t*>(bgr) + z * plane * 3;
    a.blurred = static_cast<uint8_t*>(blurred) + z * plane;
    a.sums = base + 3 * static_cast<int64_t>(z);
    a.tickets = base + 3 * static_cast<int64_t>(n) + z;
    a.rows = base + 4 * static_cast<int64_t>(n) + static_cast<int64_t>(z) * h;
    a.gray = gray ? static_cast<int*>(gray) + z * plane : nullptr;
    const dim3 grid(strips, (bands + kPrepWarps - 1) / kPrepWarps, frames);
    kernel<<<grid, kPrepThreads, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// blurred: (N, H, W) uint8; thresholds: (N,) int32; valid: (N,) bool;
// mask: (N, H, W) bool; all contiguous on CUDA device `device`, H * W
// below 2^32. dark: 1 keeps blurred <= t, 0 blurred > t. One launch on
// `stream`. Returns a cudaError_t (0 = launched).
int ysmr_mean_masks(const void* blurred, const void* thresholds,
                    const void* valid, void* mask, int dark, int n, int h,
                    int w, int device, void* stream) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  if (n <= 0 || plane <= 0) return 0;
  if (plane >= (int64_t{1} << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = (reinterpret_cast<uintptr_t>(blurred) -
                    reinterpret_cast<uintptr_t>(mask)) % 16 == 0;
  void (*kernel)(const uint8_t*, const int*, const bool*, uint8_t*,
                 uint32_t, int) = vec ? global_threshold_kernel<true>
                                      : global_threshold_kernel<false>;
  const int64_t per_block = vec ? 16 * kMaskThreads * kMaskVecs
                                : 16 * kMaskThreads;
  const unsigned blocks =
      static_cast<unsigned>((plane + per_block - 1) / per_block);
  for (int z = 0; z < n; z += kMaxFrames) {
    const int frames = n - z < kMaxFrames ? n - z : kMaxFrames;
    const dim3 grid(blocks, frames);
    const uint8_t* src = static_cast<const uint8_t*>(blurred) + z * plane;
    const int* thr = static_cast<const int*>(thresholds) + z;
    const bool* ok = static_cast<const bool*>(valid) + z;
    uint8_t* dst = static_cast<uint8_t*>(mask) + z * plane;
    kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        src, thr, ok, dst, static_cast<uint32_t>(plane), dark);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
