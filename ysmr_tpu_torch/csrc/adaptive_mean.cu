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
// xor dark. The masks kernel takes floor(acc + 0.5) as the low byte of
// (acc + 0.5) + 2^23 rounded down and compares in 16-bit integer lanes.
//
// Design of ysmr_adaptive_mean: one block of 128 threads per (frame,
// 64-row x 128-column output tile), frames on the grid's z axis (in
// launches of at most 65,535).
//   1. The int32 input at the clamped window positions, as float32, into
//      a 74 x 140 window in shared memory, a warp a row, four rows' loads
//      in flight.
//   2. The mean: each thread owns 4 output columns of a 16-row strip and
//      slides down the strip's 26 window rows: per row three 16-byte and
//      one 8-byte shared load give the 14 values of its 4 horizontal
//      chains, whose sums go into an 11-row ring in registers (the loop is
//      unrolled 11 times so the ring's slots are fixed registers); from the
//      11th row on, the vertical chain of each column reads the ring and
//      the int32 mean is written, 16 bytes a row.
// ysmr_adaptive_masks (at masks_kernel) is one warp a band of a 112-column
// strip that forms gray, blur and the mean in registers as it slides down
// the band, no shared memory and no barrier; the mean-threshold entries
// (below it) have designs of their own, at their kernels. No allocation
// and no host synchronisation, so a launch can be captured in a CUDA graph
// (ysmr_mean_prepare's memset of its sums and row table included).
//
// What bounds it on an H100. The data's bound is bytes: ysmr_adaptive_masks
// moves 3 bytes in and 2 out a pixel (+ 4 with the gray), at 64 x 922 x
// 1228 362.4 MB, 0.108 ms at 3.35 TB/s (652 MB, 0.195 ms with the gray);
// ysmr_adaptive_mean 4 + 4 bytes a pixel, 579.7 MB, 0.173 ms. Neither
// kernel reaches it: both issue more instructions than the SMs retire in
// the bytes' time. ysmr_adaptive_masks' 22 fmas a pixel (11 of them 1.16
// times for the band's halo rows) and its integer gray, blur and rules,
// all 1.14 times for the halo lanes, come to about 275 executed
// instructions a lane and window row, counted from its SASS: 209 M warp
// instructions at the bench batch, 0.20 ms at the SMs' issue rate at 1.98
// GHz. It is bound by issue: 0.257 ms on an H100 at 700 W (88 registers,
// 23 warps an SM; 24 warps at 80 registers were 1% faster without the
// gray and 4% slower with it). The former design, blocks of 128 threads
// over 64 x 128 tiles in three phases between barriers, 4 blocks an SM,
// issued about as many and left the SMs idle at its barriers (0.465 ms).
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
constexpr int kMeanSmem = kBH * kBW * 4;
constexpr int kMaxFrames = 65535;

static_assert(kThreads == 128, "the mean gives every thread one strip");

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

// The int32 mean's second phase: this thread's 4 columns (window column c)
// down the strip whose first window row is row0, rows_out output rows;
// emit(i, acc) per row.
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
  // each rule's 0x8100 - T in both 16-bit lanes, T = 257 + bound clamped
  // to 0 .. 512: blur + this - mean has bit 15 set where blur - mean > bound
  uint32_t rule_mask, rule_marker;
  int h, w;
  int dark;          // 1 keeps diff <= bound, 0 diff > bound
  int band;          // output rows of a band (the last may hold fewer)
  int strips;        // 112-column strips of a frame
};

constexpr int kStripW = 112;                    // output columns of a warp
constexpr int kStripHalo = 8;                   // columns left of them
constexpr int kBandMax = 64;                    // output rows of a band
static_assert(kStripW + 2 * kStripHalo == 4 * 32,
              "a warp's lanes cover a strip and its halo");

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

// gray2_of of the 4 pixels at the byte offsets col3 of a BGR row: the path
// of W % 4 != 0 and of misaligned frames, each column already mapped by
// reflect-101 (and clamped) where it lies outside the frame.
__device__ __noinline__ uint4 gray2_at(const uint8_t* row, const int* col3) {
  uint32_t g2[4];
  for (int j = 0; j < 4; ++j) {
    const uint8_t* px = row + col3[j];
    g2[j] = gray2_of(px[0], px[1], px[2]);
  }
  return make_uint4(g2[0], g2[1], g2[2], g2[3]);
}

__device__ __noinline__ void store_gray_bytes(int* dst, uint32_t g, int x,
                                              int w) {
  for (int j = 0; j < 4 && x + j < w; ++j)
    dst[j] = static_cast<int>((g >> (8 * j)) & 0xFFu);
}

// Frames mode's fused preprocess. A block is one warp; it takes a band of
// up to kBandMax output rows of a 112-column strip of one frame (the
// frame's rows in equal bands; a block's index names the band and strip,
// so every branch on them is uniform, with no convergence barrier around
// the shuffles in it). Lane l holds the 4
// columns x = x0 - 8 + 4 l .. + 3, so lanes 2-29 own the strip's output
// columns and lanes 0, 1, 30, 31 form the mean's 5-column halo (lane 0's
// last and lane 31's first column). The warp slides down the window rows
// y0 - 5 .. y0 + rows + 4, each the blurred row clamp(y) (the mean's
// replicated border), and for each new one:
//   - takes the gray row below it, loaded a step ahead: the gray of the
//     lane's 4 pixels from three 4-byte BGR words (__dp2a), the columns
//     x - 1 and x + 4 from the neighbour lanes (__shfl), reflect-101 at the
//     frame's edges, their [1 2 1] sums in 16-bit lanes;
//   - forms the blurred row from three such sums (columns x and x + 2,
//     x + 1 and x + 3 in the lanes of two words), keeps its 4 bytes in an
//     11-word ring and turns them to float32 under the exponent of 2^23;
//   - in the strips at the frame's left or right edge, gives columns
//     outside the frame the blur of the edge column (one __shfl);
//   - takes columns x - 5 .. x - 1 and x + 4 .. x + 8 from lanes l - 2 ..
//     l + 2 (ten __shfl) and runs the 4 horizontal chains into an 11-row
//     ring in registers (the loop is unrolled 11 times so the ring's slots
//     are fixed registers).
// From the 11th window row on, each lane runs the vertical chain of its 4
// columns over the ring, compares the mean with the centre row's blur (its
// bytes from the word ring) in 16-bit lanes and stores 4 mask bytes (and
// 4 marker bytes) as one 32-bit word. Window rows past the frame's top or
// bottom repeat the previous row's sums and bytes. No shared memory and no
// barrier. kWords: W % 4 == 0 and aligned pointers; otherwise every lane
// reads its pixels byte by byte at reflect-101 columns and stores bytes.
// kGray: the int32 gray of the band's rows is stored as they are read.
template <bool kWords, bool kDouble, bool kGray>
__global__ void __launch_bounds__(32, 20)
masks_kernel(MaskArgs a, Taps t) {
  const int h = a.h, w = a.w;
  const int lane = threadIdx.x;
  const int band = blockIdx.x / a.strips;
  const int y0 = band * a.band;
  const int rows_out = min(a.band, h - y0);
  const int x0 = (blockIdx.x - band * a.strips) * kStripW - kStripHalo;
  const int x = x0 + 4 * lane;
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int64_t frame = static_cast<int64_t>(blockIdx.z) * plane;
  uint8_t* mask = a.mask + frame;
  uint8_t* markers = kDouble ? a.markers + frame : nullptr;
  const bool out = lane >= 2 && lane < 30 && x < w;
  const bool valid = a.valid[blockIdx.z];
  if (!valid && !kGray) {
    // a padding frame: zero masks, no BGR read
    if (out) {
      for (int r = 0; r < rows_out; ++r) {
        const int64_t at = static_cast<int64_t>(y0 + r) * w + x;
        if constexpr (kWords) {
          *reinterpret_cast<uint32_t*>(mask + at) = 0u;
          if (kDouble) *reinterpret_cast<uint32_t*>(markers + at) = 0u;
        } else {
          store_mask_bytes(mask + at, markers ? markers + at : nullptr, 0u,
                           0u, x, w);
        }
      }
    }
    return;
  }
  const uint8_t* bgr = a.bgr + frame * 3;
  // the next int32 gray row's (rows y0 .. y0 + rows_out - 1 in order)
  int* gray = kGray ? a.gray + frame + static_cast<int64_t>(y0) * w + x
                    : nullptr;
  const int64_t pitch = static_cast<int64_t>(w) * 3;
  const bool in = x >= 0 && x < w;  // the word path's loads
  int col3[4];                      // the byte path's pixel offsets
#pragma unroll
  for (int j = 0; j < 4; ++j) col3[j] = 3 * reflect101(x + j, w);

  // the words of a BGR row, loaded ahead of their use on the word path
  uint32_t wd[3] = {0u, 0u, 0u};
  auto load_row = [&](const uint8_t* row) {
    if constexpr (kWords) {
      if (in) {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(row + 3 * x);
        wd[0] = __ldg(p);
        wd[1] = __ldg(p + 1);
        wd[2] = __ldg(p + 2);
      }
    }
  };
  // gray row i (at `row`: reflect-101) from the loaded words: its [1 2 1]
  // sums (columns x and x + 2 in e, x + 1 and x + 3 in o), and the int32
  // gray where row i is one of the band's
  auto gray_row = [&](const uint8_t* row, int i, uint32_t& e, uint32_t& o) {
    uint32_t g2[4];
    if constexpr (kWords) {
      gray2_words(wd, g2);
    } else {
      const uint4 v = gray2_at(row, col3);
      g2[0] = v.x;
      g2[1] = v.y;
      g2[2] = v.z;
      g2[3] = v.w;
    }
    const uint32_t g = __byte_perm(__byte_perm(g2[0], g2[1], 0x0062),
                                   __byte_perm(g2[2], g2[3], 0x0062), 0x5410);
    uint32_t lw = __shfl_up_sync(~0u, g, 1);    // byte 3: column x - 1
    uint32_t rw = __shfl_down_sync(~0u, g, 1);  // byte 0: column x + 4
    if constexpr (kWords) {
      if (x == 0) lw = g << 16;      // reflect-101: column 1
      if (x + 4 == w) rw = g >> 16;  // column w - 2
    }
    const uint32_t left = __funnelshift_r(lw, g, 24);  // x - 1 .. x + 2
    const uint32_t right = __funnelshift_r(g, rw, 8);  // x + 1 .. x + 4
    e = lanes16(left, 0x4240) + 2 * lanes16(g, 0x4240) +
        lanes16(right, 0x4240);
    o = lanes16(left, 0x4341) + 2 * lanes16(g, 0x4341) +
        lanes16(right, 0x4341);
    if (kGray && i >= y0 && i < y0 + rows_out) {
      if (out) {
        if constexpr (kWords)
          *reinterpret_cast<int4*>(gray) = make_int4(
              g & 0xFF, (g >> 8) & 0xFF, (g >> 16) & 0xFF, g >> 24);
        else
          store_gray_bytes(gray, g, x, w);
      }
      gray += w;
    }
  };

  // the edge strips: columns left of 0 take column 0 (lane 2's first),
  // columns from w on take column w - 1 (lane er's column ec)
  const bool left_edge = x0 < 0;
  const bool right_edge = x0 + 4 * 32 > w;
  const int er = (w - 1 - x0) >> 2, ec = (w - 1 - x0) & 3;

  const int b_first = max(y0 - kRadius, 0);
  const int b_last = min(y0 + rows_out - 1 + kRadius, h - 1);
  uint32_t e0, o0, e1, o1;
  const uint8_t* row = bgr + reflect101(b_first - 1, h) * pitch;
  load_row(row);
  gray_row(row, b_first - 1, e0, o0);
  row = bgr + b_first * pitch;
  load_row(row);
  gray_row(row, b_first, e1, o1);
  // the row below the next new blurred row
  row = bgr + reflect101(b_first + 1, h) * pitch;
  load_row(row);

  const uint32_t rule_mask = a.rule_mask, rule_marker = a.rule_marker;
  const uint32_t keep = valid ? 0x01010101u : 0u;
  const uint32_t flip = valid && a.dark ? 0x01010101u : 0u;
  float ring[kTaps][4];
  uint32_t bw[kTaps];  // the window rows' blurred bytes
  const int n = rows_out + 2 * kRadius;
  int b = b_first;  // the blurred row of the next new window row
  int64_t at = static_cast<int64_t>(y0) * w + x;  // the next output row's
  for (int w0 = 0; w0 < n; w0 += kTaps) {
#pragma unroll
    for (int j = 0; j < kTaps; ++j) {
      const int s = w0 + j;  // window row y0 - 5 + s
      if (s < n) {
        const int y = y0 - kRadius + s;
        if (s == 0 || (y >= 1 && y < h)) {
          // a new blurred row b, from gray rows b - 1 .. b + 1
          uint32_t e2, o2;
          gray_row(row, b + 1, e2, o2);
          if (b + 1 <= b_last) {
            // row b + 2: below the frame only at b + 2 = h, which
            // reflect-101 maps to h - 2
            row += b + 2 < h ? pitch : -pitch;
            load_row(row);
          }
          const uint32_t be = ((e0 + 2 * e1 + e2 + 0x00080008u) >> 4) &
                              0x0FFF0FFFu;
          const uint32_t bo = ((o0 + 2 * o1 + o2 + 0x00080008u) >> 4) &
                              0x0FFF0FFFu;
          e0 = e1;
          o0 = o1;
          e1 = e2;
          o1 = o2;
          ++b;
          bw[j] = __byte_perm(be, bo, 0x6240);
          float v[4] = {lane_float(be, 0x7650), lane_float(bo, 0x7650),
                        lane_float(be, 0x7652), lane_float(bo, 0x7652)};
          if (left_edge) {
            const float c0 = __shfl_sync(~0u, v[0], 2);
            if (lane < 2) v[0] = v[1] = v[2] = v[3] = c0;
          }
          if (right_edge) {
            const float sel = ec == 0 ? v[0] : ec == 1 ? v[1]
                            : ec == 2 ? v[2] : v[3];
            const float cw = __shfl_sync(~0u, sel, er);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (x + q >= w) v[q] = cw;
          }
          // columns x - 5 .. x + 8
          float u[14];
          u[0] = __shfl_up_sync(~0u, v[3], 2);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            u[1 + q] = __shfl_up_sync(~0u, v[q], 1);
            u[5 + q] = v[q];
            u[9 + q] = __shfl_down_sync(~0u, v[q], 1);
          }
          u[13] = __shfl_down_sync(~0u, v[0], 2);
#pragma unroll
          for (int q = 0; q < 4; ++q) ring[j][q] = chain11(u + q, t);
        } else {
          // past the frame's top or bottom: the clamped row again
#pragma unroll
          for (int q = 0; q < 4; ++q) ring[j][q] = ring[(j + 10) % kTaps][q];
          bw[j] = bw[(j + 10) % kTaps];
        }
        if (s >= 2 * kRadius) {
          // output row y0 + s - 10: the ring holds window rows s - 10 .. s,
          // row s - 10 + i in slot (j + 1 + i) % 11; its centre, row s - 5,
          // in slot (j + 6) % 11. The mean floor(acc + 0.5) (acc + 0.5
          // rounded first, as the plain version rounds it) is the low byte
          // of (acc + 0.5) + 2^23 rounded down. In 16-bit lanes (columns x
          // and x + 2, x + 1 and x + 3), blur + rule - mean lies in 0x7E01
          // .. 0x81FF and has bit 15 set where blur - mean > bound: white
          // keeps those pixels, dark the rest.
          uint32_t f[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float acc = __fmaf_rn(ring[(j + 1) % kTaps][q], t.k[0],
                                  __fmul_rn(ring[(j + 2) % kTaps][q], t.k[1]));
#pragma unroll
            for (int i = 2; i < kTaps; ++i)
              acc = __fmaf_rn(ring[(j + 1 + i) % kTaps][q], t.k[i], acc);
            f[q] = __float_as_uint(
                __fadd_rd(__fadd_rn(acc, 0.5f), 8388608.0f));
          }
          const uint32_t cb = bw[(j + 6) % kTaps];
          const uint32_t me = __byte_perm(f[0], f[2], 0x5410);
          const uint32_t mo = __byte_perm(f[1], f[3], 0x5410);
          const uint32_t ce = lanes16(cb, 0x4240), co = lanes16(cb, 0x4341);
          // bit 7 of byte q: column x + q; then keep or flip it
          auto rule = [&](uint32_t k) {
            return ((__byte_perm(ce + k - me, co + k - mo, 0x7351) >> 7) &
                    keep) ^
                   flip;
          };
          const uint32_t mk = rule(rule_mask);
          const uint32_t mr = kDouble ? rule(rule_marker) : 0u;
          if (out) {
            if constexpr (kWords) {
              *reinterpret_cast<uint32_t*>(mask + at) = mk;
              if (kDouble) *reinterpret_cast<uint32_t*>(markers + at) = mr;
            } else {
              store_mask_bytes(mask + at, markers ? markers + at : nullptr,
                               mk, mr, x, w);
            }
          }
          at += w;
        }
      }
    }
  }
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

// The rule's constant of MaskArgs for an integer bound.
uint32_t rule_lanes(int bound) {
  const int t = bound < -257 ? 0 : bound > 255 ? 512 : 257 + bound;
  return static_cast<uint32_t>(0x8100 - t) * 0x00010001u;
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
// taps: as above; bound_mask, bound_marker: the rules' integer bounds
// (|bound| <= 2^20); dark: 1 keeps diff <= bound, 0 diff > bound. One
// launch on `stream` (one per 65,535 frames). Returns a cudaError_t (0 =
// launched).
int ysmr_adaptive_masks(const void* bgr, const void* valid, void* mask,
                        void* markers, void* gray, const float* taps,
                        int bound_mask, int bound_marker, int dark, int n,
                        int h, int w, int device, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool words = w % 4 == 0 && reinterpret_cast<uintptr_t>(bgr) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(markers) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(gray) % 16 == 0;
  void (*const kernels[2][2][2])(MaskArgs, Taps) = {
      {{masks_kernel<false, false, false>, masks_kernel<false, false, true>},
       {masks_kernel<false, true, false>, masks_kernel<false, true, true>}},
      {{masks_kernel<true, false, false>, masks_kernel<true, false, true>},
       {masks_kernel<true, true, false>, masks_kernel<true, true, true>}}};
  void (*kernel)(MaskArgs, Taps) =
      kernels[words][markers != nullptr][gray != nullptr];
  const Taps k = taps_of(taps);
  const int64_t plane = static_cast<int64_t>(h) * w;
  MaskArgs a{};
  a.rule_mask = rule_lanes(bound_mask);
  a.rule_marker = rule_lanes(bound_marker);
  a.h = h;
  a.w = w;
  a.dark = dark;
  const int bands = (h + kBandMax - 1) / kBandMax;
  a.band = (h + bands - 1) / bands;
  a.strips = (w + kStripW - 1) / kStripW;
  const unsigned blocks = static_cast<unsigned>(bands) * a.strips;
  for (int z = 0; z < n; z += kMaxFrames) {
    const int frames = n - z < kMaxFrames ? n - z : kMaxFrames;
    a.bgr = static_cast<const uint8_t*>(bgr) + z * plane * 3;
    a.valid = static_cast<const bool*>(valid) + z;
    a.mask = static_cast<uint8_t*>(mask) + z * plane;
    a.markers = markers ? static_cast<uint8_t*>(markers) + z * plane
                        : nullptr;
    a.gray = gray ? static_cast<int*>(gray) + z * plane : nullptr;
    kernel<<<dim3(blocks, 1, frames), 32, 0,
             static_cast<cudaStream_t>(stream)>>>(a, k);
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
