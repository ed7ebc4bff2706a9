// The tracker frame step's match-and-register block: the greedy
// first-come match of the slots' nearest detections, ageing and
// deregistration, registration of the unmatched detections in ascending
// column order, and the frame's emissions, for V videos' slot tables in
// two launches; and the merge of the GSFF step's outputs in a third.
//
// Replaces the plain-XLA body of ysmr_tpu/pipeline/tracker.py:129
// _tracker_frame_update outside the distances and the GSFF step, with
// ysmr_tpu/ops/assignment.py:67 greedy_assign_from_candidates (no Pallas
// kernel: XLA fuses them inside the jitted scan). Same contract and the
// same bits as ysmr_tpu_torch/ops/frame_step.py::match_and_register_plain
// and ::gsff_merge_plain. The block is integer and selection logic; its
// one float operation is the comparison of the aged count, rounded to
// float32 (__int2float_rn), with max_disappeared as a float32, which is
// how torch compares a float32 tensor with a Python scalar.
//
// The greedy order: the plain version sorts the active slots by id (ties
// by slot), then the rows stably by row minimum; a row claims its nearest
// detection and the first claimant of a column wins it. A slot's position
// in that order is the number of active slots of its video whose key
// (row_min, id, slot) is smaller, the float32 row minima compared as the
// sort compares them (NaN after every number, -0 equal to +0). Free slots
// sort after every active one and never claim, so counting among the
// active slots gives the same winners.
//
// Launch A (rank), grid (ceil(S / 32), V), 256 threads: lane l of each
// warp owns slot 32 blockIdx.x + l; the block stages 1024 slots' keys of
// its video at a time in shared memory, and warp w compares its lanes'
// keys with the staged keys w * 128 .. w * 128 + 127 (one shared word
// broadcast to the warp a step). The eight warps' counts meet in shared
// memory; the slot's rank goes to scratch. S^2 key comparisons a video:
// 16.7 M at S = 4096 over 128 blocks.
//
// Launch B (update), one block of 1024 threads per video: the counts of
// active slots and valid detections; the column winners, each column's
// smallest claiming rank by atomicMin on a word of scratch that the block
// set to INT_MAX first; the unmatched columns' exclusive prefix sum (block
// scans over chunks of 1024 columns) gives each registration's column;
// then a pass over chunks of 1024 slots computes match, ageing,
// deregistration, the free slots' prefix sum, registration, and writes
// the new state, the emission row and the GSFF block's masks. A free slot
// whose rank is n_new or more stays free; the difference to n_new is
// counted in dropped_registrations. Signed int32 sums wrap as torch's do
// (unsigned arithmetic).
//
// The merge (one thread per slot): on a live slot the GSFF step's
// predicted position over the first two coordinates of the new state's
// position, its corrected position over the emitted one's.
//
// What bounds it on an H100: neither bytes nor operations. A dense frame
// step (S = C = 4096) moves about 0.4 MB (0.1 us at 3.35 TB/s) and
// compares about 9 M pairs of live keys; launch B is one block per video,
// a chain of dependent block scans and passes (latency), launch A's
// 128 blocks fill the card once. No allocation, no host synchronisation:
// the launches depend on the shapes only.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRankThreads = 256;
constexpr int kRankSlots = 32;  // slots of a rank block: a warp's lanes
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kStage = 1024;  // keys staged at once
constexpr int kUpdateThreads = 1024;
constexpr int kMergeThreads = 256;
constexpr int kMaxVideos = 65535;  // the rank grid's y dimension

// a < b as torch's stable float sort orders them: NaN after every number
__device__ __forceinline__ bool f_lt(float a, float b) {
  return isnan(b) ? !isnan(a) : a < b;
}

// (ra, ia, sa) < (rb, ib, sb): row minimum, then id, then slot
__device__ __forceinline__ bool key_lt(float ra, int ia, int sa, float rb,
                                       int ib, int sb) {
  if (f_lt(ra, rb)) return true;
  if (f_lt(rb, ra)) return false;
  return ia < ib || (ia == ib && sa < sb);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void __launch_bounds__(kRankThreads)
rank_kernel(const uint8_t* __restrict__ active,
            const float* __restrict__ row_min, const int* __restrict__ ids,
            int* __restrict__ scratch, int s, int c) {
  __shared__ float st_min[kStage];
  __shared__ int st_id[kStage];
  __shared__ int st_slot[kStage];
  __shared__ int part[kRankWarps][32];
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRankSlots + lane;
  const bool mine = i < s && active[base + i] != 0;
  const float ri = mine ? row_min[base + i] : 0.0f;
  const int ii = mine ? ids[base + i] : 0;
  int count = 0;
  for (int j0 = 0; j0 < s; j0 += kStage) {
    const int n = min(kStage, s - j0);
    __syncthreads();
    for (int q = threadIdx.x; q < n; q += kRankThreads) {
      const int64_t j = base + j0 + q;
      const bool on = active[j] != 0;
      st_min[q] = on ? row_min[j] : 0.0f;
      st_id[q] = on ? ids[j] : 0;
      st_slot[q] = on ? j0 + q : -1;
    }
    __syncthreads();
    if (mine) {
      const int lo = warp * (kStage / kRankWarps);
      const int hi = min(lo + kStage / kRankWarps, n);
      for (int q = lo; q < hi; ++q) {
        const int sl = st_slot[q];
        count += (sl >= 0 && key_lt(st_min[q], st_id[q], sl, ri, ii, i));
      }
    }
  }
  part[warp][lane] = count;
  __syncthreads();
  if (warp == 0 && i < s) {
    int rank = 0;
    for (int w = 0; w < kRankWarps; ++w) rank += part[w][lane];
    scratch[static_cast<int64_t>(blockIdx.y) * (s + 2 * static_cast<int64_t>(c)) + i] =
        rank;
  }
}

// Exclusive prefix sum of x over the block (blockDim.x a multiple of 32,
// at most 1024); *total gets the block's sum. sh holds 33 ints. Every
// thread of the block must call it.
__device__ int block_scan(int x, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) sh[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < warps ? sh[lane] : 0;
    int winc = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, d);
      if (lane >= d) winc += y;
    }
    sh[lane] = winc - w;
    if (lane == 31) sh[32] = winc;
  }
  __syncthreads();
  const int out = sh[warp] + inc - x;
  *total = sh[32];
  __syncthreads();
  return out;
}

struct UpdateArgs {
  // the slot table (V, S, ...) and the frame's detections (V, C, ...)
  const uint8_t* active;
  const int* ids;
  const float* pos;
  const float* info;
  const int* disappeared;
  const int* next_id;
  const int* dropped;
  const int* cand;
  const float* det_xy;
  const float* det_info;
  const uint8_t* det_valid;
  // the new state, contiguous as the old
  uint8_t* out_active;
  int* out_ids;
  float* out_pos;
  float* out_info;
  int* out_disappeared;
  int* out_next_id;
  int* out_dropped;
  // the frame's emission rows: video v's at v * frames * S slots (n_det
  // at v * frames) of (V, frames, S, ...) buffers
  uint8_t* em_mask;
  int* em_ids;
  float* em_pos;
  float* em_info;
  int* em_det_col;
  int* em_n_det;
  uint8_t* flags;  // (3, V, S): matched, registered, coasting
  int* scratch;    // (V, S + 2 C): ranks, column winners, columns by rank
  float max_disappeared;
  int v, s, c, k, frames;
};

__global__ void __launch_bounds__(kUpdateThreads) update_kernel(UpdateArgs a) {
  __shared__ int sh[33];
  const int t = threadIdx.x, nt = blockDim.x;
  const int s = a.s, c = a.c, k = a.k;
  const int64_t video = blockIdx.x;
  const int64_t bs = video * s, bc = video * c;
  int* scr = a.scratch + video * (s + 2 * static_cast<int64_t>(c));
  const int* rank = scr;
  int* winner = scr + s;
  int* col_of_rank = winner + c;

  int x = 0;
  for (int i = t; i < s; i += nt) x += a.active[bs + i] != 0;
  int n_obj;
  block_scan(x, sh, &n_obj);
  x = 0;
  for (int j = t; j < c; j += nt) {
    x += a.det_valid[bc + j] != 0;
    winner[j] = INT_MAX;
  }
  int n_det;
  block_scan(x, sh, &n_det);  // its barriers publish the winners' reset
  for (int i = t; i < s; i += nt) {
    const int col = a.cand[bs + i];
    if (a.active[bs + i] && col >= 0 && col < c && a.det_valid[bc + col])
      atomicMin(winner + col, rank[i]);
  }
  __syncthreads();
  const bool has_det = n_det > 0;
  const bool do_register = has_det && n_det > n_obj;

  // the unmatched valid columns in ascending order: col_of_rank[r] is the
  // column of the r-th registration
  int n_new = 0;
  if (do_register) {
    for (int j0 = 0; j0 < c; j0 += nt) {
      const int j = j0 + t;
      const int flag = j < c && a.det_valid[bc + j] && winner[j] == INT_MAX;
      int total;
      const int at = block_scan(flag, sh, &total);
      if (flag) col_of_rank[n_new + at] = j;
      n_new += total;
    }
  }
  __syncthreads();

  const int64_t em_row = video * a.frames * static_cast<int64_t>(s);
  const int64_t vs = static_cast<int64_t>(a.v) * s;
  int n_free = 0;
  for (int i0 = 0; i0 < s; i0 += nt) {
    const int i = i0 + t;
    const bool live = i < s;
    const int64_t at = bs + i;
    bool act = false, matched = false, age = false, alive = false;
    int col = -1, dis = 0;
    if (live) {
      act = a.active[at] != 0;
      col = a.cand[at];
      matched = act && col >= 0 && col < c && a.det_valid[bc + col] &&
                winner[col] == rank[i];
      age = has_det ? (act && !matched && n_obj >= n_det) : act;
      dis = matched ? 0 : a.disappeared[at];
      if (age) dis = wrap_add(dis, 1);
      const bool dereg = age && __int2float_rn(dis) > a.max_disappeared;
      alive = act && !dereg;
    }
    const int is_free = live && !alive;
    int total;
    const int free_rank = n_free + block_scan(is_free, sh, &total);
    n_free += total;
    if (!live) continue;
    const bool reg = is_free && free_rank < n_new;
    const int reg_col = reg ? col_of_rank[free_rank] : -1;
    const bool on = alive || reg;
    const int id = reg ? wrap_add(a.next_id[video], free_rank) : a.ids[at];
    if (reg) dis = 0;
    // position and info: the registered detection's, the matched one's,
    // or the slot's own (info zeroed on an aged slot)
    const int src = reg ? reg_col : matched ? col : -1;
    const float* p = src >= 0 ? a.det_xy + (bc + src) * k : a.pos + at * k;
    const float* f = src >= 0 ? a.det_info + (bc + src) * 3 : a.info + at * 3;
    const bool zero_info = !reg && age;
    const int64_t em = em_row + i;
    for (int q = 0; q < k; ++q) {
      const float value = p[q];
      a.out_pos[at * k + q] = value;
      a.em_pos[em * k + q] = value;
    }
    for (int q = 0; q < 3; ++q) {
      const float value = zero_info ? 0.0f : f[q];
      a.out_info[at * 3 + q] = value;
      a.em_info[em * 3 + q] = value;
    }
    a.out_active[at] = on;
    a.out_ids[at] = id;
    a.out_disappeared[at] = dis;
    a.em_mask[em] = on;
    a.em_ids[em] = on ? id : 0;
    a.em_det_col[em] = matched ? col : reg ? reg_col : -1;
    a.flags[at] = matched;
    a.flags[vs + at] = reg;
    a.flags[2 * vs + at] = on && !matched && !reg;
  }
  if (t == 0) {
    const int registered = min(n_new, n_free);
    a.out_next_id[video] = wrap_add(a.next_id[video], n_new);
    a.out_dropped[video] = wrap_add(a.dropped[video], n_new - registered);
    a.em_n_det[video * a.frames] = n_det;
  }
}

__global__ void __launch_bounds__(kMergeThreads)
merge_kernel(float* __restrict__ state_pos, float* __restrict__ emit_pos,
             const uint8_t* __restrict__ active,
             const float* __restrict__ corrected,
             const float* __restrict__ predicted, int64_t n, int s, int k,
             int64_t em_vstride) {
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kMergeThreads +
                     threadIdx.x;
  if (at >= n || !active[at]) return;
  const int64_t video = at / s, i = at % s;
  float* sp = state_pos + at * k;
  float* ep = emit_pos + video * em_vstride + i * k;
  for (int q = 0; q < 2; ++q) {
    sp[q] = predicted[2 * at + q];
    ep[q] = corrected[2 * at + q];
  }
}

}  // namespace

extern "C" {

// The slot table: active (V, S) bool, ids (V, S) int32, pos (V, S, K) and
// info (V, S, 3) float32, disappeared (V, S) int32, next_id and dropped
// (V,) int32; row_min (V, S) float32 and cand (V, S) int32 in slot order;
// det_xy (V, C, K), det_info (V, C, 3) float32, det_valid (V, C) bool; the
// new state shaped as the old; the emission rows of one frame of (V,
// frames, S, ...) buffers (n_det of a (V, frames) one); flags (3, V, S)
// bool; scratch (V, S + 2 C) int32. All contiguous on CUDA device
// `device`, launched on `stream`. Returns a cudaError_t (0 = launched).
int ysmr_frame_step(const void* active, const void* ids, const void* pos,
                    const void* info, const void* disappeared,
                    const void* next_id, const void* dropped,
                    const void* row_min, const void* cand,
                    const void* det_xy, const void* det_info,
                    const void* det_valid, void* out_active, void* out_ids,
                    void* out_pos, void* out_info, void* out_disappeared,
                    void* out_next_id, void* out_dropped, void* em_mask,
                    void* em_ids, void* em_pos, void* em_info,
                    void* em_det_col, void* em_n_det, void* flags,
                    void* scratch, float max_disappeared, int v, int s, int c,
                    int k, int frames, int device, void* stream) {
  if (v <= 0) return 0;
  if (s < 0 || c < 1 || k < 1 || frames < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s > 0) {
    for (int v0 = 0; v0 < v; v0 += kMaxVideos) {
      const int nv = min(kMaxVideos, v - v0);
      const int64_t off = static_cast<int64_t>(v0) * s;
      const dim3 grid((s + kRankSlots - 1) / kRankSlots, nv);
      rank_kernel<<<grid, kRankThreads, 0, st>>>(
          static_cast<const uint8_t*>(active) + off,
          static_cast<const float*>(row_min) + off,
          static_cast<const int*>(ids) + off,
          static_cast<int*>(scratch) +
              static_cast<int64_t>(v0) * (s + 2 * static_cast<int64_t>(c)),
          s, c);
    }
  }
  UpdateArgs a{static_cast<const uint8_t*>(active),
               static_cast<const int*>(ids),
               static_cast<const float*>(pos),
               static_cast<const float*>(info),
               static_cast<const int*>(disappeared),
               static_cast<const int*>(next_id),
               static_cast<const int*>(dropped),
               static_cast<const int*>(cand),
               static_cast<const float*>(det_xy),
               static_cast<const float*>(det_info),
               static_cast<const uint8_t*>(det_valid),
               static_cast<uint8_t*>(out_active),
               static_cast<int*>(out_ids),
               static_cast<float*>(out_pos),
               static_cast<float*>(out_info),
               static_cast<int*>(out_disappeared),
               static_cast<int*>(out_next_id),
               static_cast<int*>(out_dropped),
               static_cast<uint8_t*>(em_mask),
               static_cast<int*>(em_ids),
               static_cast<float*>(em_pos),
               static_cast<float*>(em_info),
               static_cast<int*>(em_det_col),
               static_cast<int*>(em_n_det),
               static_cast<uint8_t*>(flags),
               static_cast<int*>(scratch),
               max_disappeared,
               v, s, c, k, frames};
  update_kernel<<<v, kUpdateThreads, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// state_pos (V, S, K) float32, contiguous; emit_pos (V, S, K) float32 at
// video stride em_vstride (elements), unit strides over S and K; active
// (V, S) bool; corrected and predicted (V, S, 2) float32, contiguous.
int ysmr_gsff_merge(void* state_pos, void* emit_pos, const void* active,
                    const void* corrected, const void* predicted, int v,
                    int s, int k, long long em_vstride, int device,
                    void* stream) {
  const int64_t n = static_cast<int64_t>(v) * s;
  if (n <= 0) return 0;
  if (k < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((n + kMergeThreads - 1) / kMergeThreads);
  merge_kernel<<<blocks, kMergeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(state_pos), static_cast<float*>(emit_pos),
      static_cast<const uint8_t*>(active),
      static_cast<const float*>(corrected),
      static_cast<const float*>(predicted), n, s, k, em_vstride);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
