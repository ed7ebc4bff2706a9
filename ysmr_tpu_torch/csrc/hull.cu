// Hull-edge candidates of the per-row extreme points, both chains, and
// each component's row-span count.
//
// Replaces ysmr_tpu/ops/pallas_hull.py::hull_edge_vectors (Pallas, kernel
// _make_kernel) and the abs_y and count of the stats tail
// (ysmr_tpu/ops/labeling.py::_stats_tail_from_tables, :459, plain XLA).
// Same contract as the plain version
// ysmr_tpu_torch/ops/labeling.py::hull_tables_plain: abs_y = min_y + row
// formed, then hull_edge_vectors_plain, the slope-matrix closed form of
// ysmr_tpu/ops/labeling.py::_hull_edge_data (:794-833) before the angle
// finishing, and count = the sum over the valid rows of
// row_max_x - row_min_x + 1 (int32). For component c and bbox row i (a
// valid row):
//   - left chain (row x minima): the minimum outgoing slope
//     (x_k - x_i) / (y_k - y_i) over valid rows k below i, with the edge
//     vector of the LARGEST k attaining it (the farthest collinear endpoint),
//     and the maximum incoming slope over valid rows k above i;
//   - right chain (row x maxima): the same on the negated slopes;
//   - edge flag = valid & out_min >= in_max & out_min < big, strict corner
//     flag = valid & out_min > in_max; the edge vector is 0 where the edge
//     flag is False.
// Slopes are correctly rounded float32 quotients (__fdiv_rn, a zero
// numerator formed apart) of exact integer differences, so the kernel
// equals the plain version bit for bit.
// Rows "below" and "above" row i are the valid rows after and before it in
// the table, which is ascending y (abs_y = min_y + row, formed in
// registers).
// The TPU kernel's (R, D) lane layout and its fori_loop over rows existed
// for Mosaic and are not carried over.
//
// Design: one warp per component. The lanes read the component's R rows
// once, 32 at a time, coalesced; a ballot on row_valid compacts the valid
// rows, in ascending order, into the warp's slice of shared memory as
// float4 (y, x_min, x_max, row), and the invalid rows get their zeros there
// and then (an empty component touches row_valid only); the valid rows'
// spans are summed in the same pass and one warp reduction gives count.
// With n valid rows, s = 32 / n lanes share a row (one lane a row, 32 rows
// a pass, above 32):
// lane k of a row loops over the rows q = k, k + s, ... in ascending order
// with `<=`, one broadcast 16-byte shared load each, so the last minimal q
// of its share wins; shuffles then combine the s lanes, the smaller
// minimum and on a tie the larger q (the farthest collinear endpoint), the
// larger maximum. The loop has no branch: the row itself divides by 1 and
// counts for neither chain. A row's outputs go to its own position, so a
// component's valid rows leave as contiguous runs. Above 14,528 rows (at
// 16 bytes a row, more than a block's shared memory) the warp's slice lies
// in a (D, R) scratch in global memory instead.
//
// What bounds it on an H100: the bytes the data needs, row_valid and the
// 20 bytes out (four float32, four flags) of every (component, row), the
// 8 bytes of the x tables at the valid rows only, and min_y and count
// (4 bytes each) of every component: about 0.08 ms for the dense batch's
// 262,144 x 48 at 3.35 TB/s; then the divisions, two per ordered pair of
// valid rows and chain, which grow with the square of a component's valid
// rows and are kept on the division's fast path (quotient, below).
// Measured with trace_kernels.py on an NVIDIA H100 80GB HBM3 at 700 W,
// when it still read a (D, R) abs_y table and wrote no count: 0.178-0.183
// ms on the card at the dense batch, 45-47% of its bound then (0.083 ms);
// 0.023-0.024 ms at the frames-mode bench batch (32,768 x 64; bound
// 0.0135 ms, 56-58%).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kMaxWarps = 8;                 // components per block
constexpr int kMaxSmem = 232448;             // a block's limit on Hopper
constexpr float kBig = 3.0e38f;

// a / b correctly rounded (__fdiv_rn). The division's fast path refuses a
// zero numerator (FCHK: the sign of the zero), which the vertical edges of
// a component give in plenty, and its slow path stalls the whole warp; the
// zero, signed as IEEE signs it, is formed here instead.
__device__ __forceinline__ float quotient(float a, float b) {
  const float q = __fdiv_rn(a == 0.f ? 1.f : a, b);
  return a == 0.f
             ? __int_as_float((__float_as_int(a) ^ __float_as_int(b)) &
                              static_cast<int>(0x80000000u))
             : q;
}

// kShared: the compacted rows in the block's shared memory, else in
// `scratch` (D, R) float4 in global memory (R above the shared cap)
template <bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32)
hull_kernel(const int32_t* __restrict__ row_min_x,
            const int32_t* __restrict__ row_max_x,
            const uint8_t* __restrict__ row_valid,
            const int32_t* __restrict__ min_y, float* __restrict__ dx_l,
            float* __restrict__ dy_l, uint8_t* __restrict__ edge_l,
            float* __restrict__ dx_r, float* __restrict__ dy_r,
            uint8_t* __restrict__ edge_r, uint8_t* __restrict__ corner_l,
            uint8_t* __restrict__ corner_r, int32_t* __restrict__ count,
            float4* scratch, int d, int r) {
  extern __shared__ float4 s_rows[];
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                    warp;
  if (c >= d) return;
  const int64_t base = c * r;
  float4* rows = kShared ? s_rows + warp * r : scratch + base;
  int n = 0, span = 0;
  for (int j0 = 0; j0 < r; j0 += 32) {
    const int j = j0 + lane;
    const int64_t g = base + j;
    const bool in = j < r;
    const bool v = in && row_valid[g];
    const unsigned valid = __ballot_sync(kAll, v);
    if (v) {
      const int x0 = row_min_x[g], x1 = row_max_x[g];
      span += x1 - x0 + 1;
      rows[n + __popc(valid & ((1u << lane) - 1u))] = make_float4(
          static_cast<float>(min_y[c] + j), static_cast<float>(x0),
          static_cast<float>(x1), __int_as_float(j));
    } else if (in) {
      dx_l[g] = dy_l[g] = dx_r[g] = dy_r[g] = 0.f;
      edge_l[g] = edge_r[g] = corner_l[g] = corner_r[g] = 0;
    }
    n += __popc(valid);
  }
  // int32 sums wrap as the plain version's sum(dtype=int32) does
  span = static_cast<int>(__reduce_add_sync(kAll,
                                            static_cast<unsigned>(span)));
  if (lane == 0) count[c] = span;
  __syncwarp();
  if (n == 0) return;
  // s lanes a row (consecutive lanes), each over every s-th row q of the
  // component: one pass takes 32 / s rows
  const int s = n <= 32 ? 32 / n : 1;
  const int per_pass = 32 / s;
  const int part = lane % s;
  for (int p0 = 0; p0 < n; p0 += per_pass) {
    const int p = p0 + lane / s;
    const bool act = lane < s * per_pass && p < n;
    const float4 me = rows[act ? p : 0];
    // the minimum outgoing slope and its row (the last of the lane's rows
    // that attain it), the maximum incoming slope, of each chain
    float omin_l = kBig, imax_l = -kBig, omin_r = kBig, imax_r = -kBig;
    int qmin_l = -1, qmin_r = -1;
    if (act) {
      for (int q = part; q < n; q += s) {
        const float4 o = rows[q];
        // the lane's own row divides by 1 and is used by neither chain
        const float dy = q == p ? 1.f : __fsub_rn(o.x, me.x);
        const float col_l = quotient(__fsub_rn(o.y, me.y), dy);
        const float col_r = quotient(-__fsub_rn(o.z, me.z), dy);
        // ascending q with <=: the last (farthest) minimal row wins
        if (q > p && col_l <= omin_l) {
          omin_l = col_l;
          qmin_l = q;
        }
        if (q > p && col_r <= omin_r) {
          omin_r = col_r;
          qmin_r = q;
        }
        if (q < p) {
          imax_l = fmaxf(imax_l, col_l);
          imax_r = fmaxf(imax_r, col_r);
        }
      }
    }
    // the s lanes of a row combined into its first: the smaller minimum,
    // on a tie the farther row; the larger maximum
    for (int off = 1; off < s; off <<= 1) {
      const float o_l = __shfl_down_sync(kAll, omin_l, off);
      const int oq_l = __shfl_down_sync(kAll, qmin_l, off);
      const float i_l = __shfl_down_sync(kAll, imax_l, off);
      const float o_r = __shfl_down_sync(kAll, omin_r, off);
      const int oq_r = __shfl_down_sync(kAll, qmin_r, off);
      const float i_r = __shfl_down_sync(kAll, imax_r, off);
      if (part + off < s) {
        if (o_l < omin_l || (o_l == omin_l && oq_l > qmin_l)) {
          omin_l = o_l;
          qmin_l = oq_l;
        }
        if (o_r < omin_r || (o_r == omin_r && oq_r > qmin_r)) {
          omin_r = o_r;
          qmin_r = oq_r;
        }
        imax_l = fmaxf(imax_l, i_l);
        imax_r = fmaxf(imax_r, i_r);
      }
    }
    if (!act || part != 0) continue;
    const int64_t g = base + __float_as_int(me.w);
    const bool el = omin_l >= imax_l && omin_l < kBig;
    const bool er = omin_r >= imax_r && omin_r < kBig;
    // the edge vectors to the rows found, as the loop formed them
    const float4 ol = rows[el ? qmin_l : p];
    const float4 orr = rows[er ? qmin_r : p];
    dx_l[g] = el ? __fsub_rn(ol.y, me.y) : 0.f;
    dy_l[g] = el ? __fsub_rn(ol.x, me.x) : 0.f;
    edge_l[g] = el;
    dx_r[g] = er ? __fsub_rn(orr.z, me.z) : 0.f;
    dy_r[g] = er ? __fsub_rn(orr.x, me.x) : 0.f;
    edge_r[g] = er;
    corner_l[g] = omin_l > imax_l;
    corner_r[g] = omin_r > imax_r;
  }
}

}  // namespace

extern "C" {

// row_min_x, row_max_x: (D, R) int32; row_valid: (D, R) uint8; min_y: (D,)
// int32; outputs (D, R): float32 dx/dy, uint8 flags, and count (D,) int32;
// all contiguous on CUDA device
// `device`, launched on `stream`. scratch: (D, R) float4, used (and needed)
// only for R > 14,528, where a warp's R rows of 16 bytes exceed a block's
// shared memory (cudaErrorInvalidValue if it is null then). Returns a
// cudaError_t (0 = launched).
int ysmr_hull_edges(const void* row_min_x, const void* row_max_x,
                    const void* row_valid, const void* min_y, void* dx_l,
                    void* dy_l, void* edge_l, void* dx_r, void* dy_r,
                    void* edge_r, void* corner_l, void* corner_r,
                    void* count, void* scratch, int d, int r, int device,
                    void* stream) {
  if (d <= 0 || r <= 0) return 0;
  const int64_t row_bytes = static_cast<int64_t>(r) * sizeof(float4);
  const bool shared = row_bytes <= kMaxSmem;
  if (!shared && scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // as many warps as fit 48 KB of shared memory, or one warp up to the
  // block's limit; the most warps with the rows in global memory
  const int warps = shared ? static_cast<int>(std::max<int64_t>(
                                 1, std::min<int64_t>(kMaxWarps,
                                                      49152 / row_bytes)))
                           : kMaxWarps;
  const int smem = shared ? static_cast<int>(warps * row_bytes) : 0;
  if (smem > 49152) {
    err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&hull_kernel<true>),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned blocks = static_cast<unsigned>((d + warps - 1) / warps);
  auto kernel = shared ? hull_kernel<true> : hull_kernel<false>;
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(row_min_x),
      static_cast<const int32_t*>(row_max_x),
      static_cast<const uint8_t*>(row_valid),
      static_cast<const int32_t*>(min_y), static_cast<float*>(dx_l),
      static_cast<float*>(dy_l), static_cast<uint8_t*>(edge_l),
      static_cast<float*>(dx_r), static_cast<float*>(dy_r),
      static_cast<uint8_t*>(edge_r), static_cast<uint8_t*>(corner_l),
      static_cast<uint8_t*>(corner_r), static_cast<int32_t*>(count),
      static_cast<float4*>(scratch), d, r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
