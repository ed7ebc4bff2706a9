// The tracker frame step's match-and-register block: the greedy
// first-come match of the slots' nearest detections, ageing and
// deregistration, registration of the unmatched detections in ascending
// column order, and the frame's emissions, for V videos' slot tables in
// two launches.
//
// Replaces the plain-XLA body of ysmr_tpu/pipeline/tracker.py:129
// _tracker_frame_update outside the distances and the GSFF step, with
// ysmr_tpu/ops/assignment.py:67 greedy_assign_from_candidates (no Pallas
// kernel: XLA fuses them inside the jitted scan). Same contract and the
// same bits as ysmr_tpu_torch/ops/frame_step.py::match_and_register_plain.
// The block is integer and selection logic; its
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
// Launch A (rank) counts those keys over tiles of (64 slots x S / 8
// keys), enough blocks to fill the card at V = 1, S = 4096 (512 blocks
// of 8 warps). (row_min, id) packs into one uint64 whose unsigned order
// is the sort's: the float32 mapped to an order-preserving uint32 (-0 as
// +0, every NaN as one value above +inf) over the id with its sign bit
// flipped. The slot decides only between equal keys: a key of a slot
// before i counts when it is <= slot i's key, i.e. < key + 1 (no live key
// reaches the top word, so the + 1 never wraps), a key after i when it is
// <. A warp whose key range lies wholly before or after its 64 slots
// compares each staged key once per slot with one threshold (two 32-bit
// compares); only the diagonal warps pick the threshold per key. A free
// slot's key is all ones and is never counted. Lane l owns slots 64 t + l
// and + 32; warp w compares them with its eighth of the block's staged
// keys (a broadcast 8-byte shared load a key). (Staging only the live
// keys, compacted, measured no faster at 3000 of 4096 live.) The warps'
// counts meet in
// shared memory and the eight blocks of a slot tile, one thread-block
// cluster, add theirs through distributed shared memory: block r of the
// cluster writes the ranks of 8 of the tile's 64 slots. No memset, no
// atomics, no second pass.
//
// Launch B (update), one thread-block cluster of up to 8 blocks (512
// threads) per video: block b owns an eighth of the slots and of the
// columns, a thread a contiguous run of each (one slot and one column at
// S = C = 4096). Each phase issues its loads first, then one block scan
// (two counts at once); the cluster adds the blocks' totals through
// distributed shared memory, four cluster barriers in all:
//   1. count the active slots and valid columns; reset the column
//      winners (scratch, in L2);
//   2. read the cluster's counts; each live slot's claim takes its
//      column's winner by atomicMin of its rank;
//   3. the unmatched valid columns (registrations) and, from the winners,
//      each slot's match, ageing, deregistration and whether it is free:
//      both exclusive prefix sums over the block;
//   4. the offsets of the blocks before: each registration's column goes
//      to scratch at its rank; then every slot's write: a free slot whose
//      rank is n_new or more stays free, the difference to n_new is
//      counted in dropped_registrations.
// Scratch is written with st.cg and read with ld.cg (L2), ordered by the
// cluster barriers (release / acquire at cluster scope). Signed int32
// sums wrap as torch's do (unsigned arithmetic).
//
// What bounds it on an H100: neither bytes nor operations. A dense frame
// step (S = C = 4096) moves about 0.5 MB (0.15 us at 3.35 TB/s) and
// compares 16.7 M key pairs (5.6 M of live slots). Measured at V = 1
// (NVIDIA H100 80GB HBM3, 700 W): rank 8.7 us, its integer compares
// (about 3.5 instructions a pair, on the integer pipes at half the float
// rate) over the whole card plus a launch and two cluster barriers;
// update 10 us, a chain of four cluster barriers and two block scans
// over 8 SMs, each phase a round trip to L2. The programmatic launch
// overlaps the update's first phase with the rank launch's tail, so the
// pair's device span is 17.7-18.5 us (79 us for the former one-block
// design). No allocation, no host synchronisation: the launches depend
// on the shapes only.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRankThreads = 256;
constexpr int kRankWarps = kRankThreads / 32;
constexpr int kRankTile = 64;   // slots of a rank block: two per lane
constexpr int kRankSplit = 8;   // blocks of a rank cluster: key ranges
constexpr int kRankOut = kRankTile / kRankSplit;  // ranks a block writes
constexpr int kStage = 1024;    // keys staged at once
constexpr int kUpdateThreads = 512;
constexpr int kUpdateCluster = 8;  // the portable cluster size
constexpr int kMaxVideos = 65535;  // the grids' y dimension
constexpr uint64_t kFreeKey = ~0ull;

// (row_min, id) as one uint64 in the stable sort's order: the float
// mapped to an order-preserving uint32 (-0 as +0, every NaN above +inf)
// over the id with its sign bit flipped
__device__ __forceinline__ uint64_t sort_key(float r, int id) {
  uint32_t m;
  if (r != r) {
    m = 0xff800001u;
  } else {
    uint32_t u = __float_as_uint(r);
    if (u == 0x80000000u) u = 0;
    m = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return (static_cast<uint64_t>(m) << 32) |
         (static_cast<uint32_t>(id) ^ 0x80000000u);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__global__ void __cluster_dims__(kRankSplit, 1, 1)
    __launch_bounds__(kRankThreads)
rank_kernel(const uint8_t* __restrict__ active,
            const float* __restrict__ row_min, const int* __restrict__ ids,
            int* __restrict__ scratch, int s, int c) {
  __shared__ uint64_t keys[kStage];
  __shared__ int part[kRankWarps][kRankTile];
  __shared__ int total[kRankTile];
  // the update launch may start its first phase now (it waits for the
  // ranks before it reads them)
  asm volatile("griddepcontrol.launch_dependents;");
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int tile0 = (blockIdx.x / kRankSplit) * kRankTile;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = tile0 + lane, i1 = i0 + 32;
  // own keys: < key + 1 for a slot before, < key for one after
  const uint64_t k0 = i0 < s && active[base + i0]
                          ? sort_key(row_min[base + i0], ids[base + i0])
                          : kFreeKey;
  const uint64_t k1 = i1 < s && active[base + i1]
                          ? sort_key(row_min[base + i1], ids[base + i1])
                          : kFreeKey;
  const uint64_t le0 = k0 + 1, le1 = k1 + 1;
  const int per = (s + kRankSplit - 1) / kRankSplit;
  const int jlo = min(s, split * per), jhi = min(s, jlo + per);
  int n0 = 0, n1 = 0;
  for (int j0 = jlo; j0 < jhi; j0 += kStage) {
    const int n = min(kStage, jhi - j0);
    __syncthreads();
    for (int q = threadIdx.x; q < n; q += kRankThreads) {
      const int64_t j = base + j0 + q;
      keys[q] = active[j] ? sort_key(row_min[j], ids[j]) : kFreeKey;
    }
    __syncthreads();
    const int per_warp = (n + kRankWarps - 1) / kRankWarps;
    const int qa = min(n, warp * per_warp), qb = min(n, qa + per_warp);
    if (j0 + qb <= tile0) {  // every key's slot before the warp's slots
#pragma unroll 8
      for (int q = qa; q < qb; ++q) {
        const uint64_t kj = keys[q];
        n0 += kj < le0;
        n1 += kj < le1;
      }
    } else if (j0 + qa >= tile0 + kRankTile) {  // every one after them
#pragma unroll 8
      for (int q = qa; q < qb; ++q) {
        const uint64_t kj = keys[q];
        n0 += kj < k0;
        n1 += kj < k1;
      }
    } else {
      for (int q = qa; q < qb; ++q) {
        const uint64_t kj = keys[q];
        const int j = j0 + q;
        n0 += kj < (j < i0 ? le0 : k0);
        n1 += kj < (j < i1 ? le1 : k1);
      }
    }
  }
  part[warp][lane] = n0;
  part[warp][lane + 32] = n1;
  __syncthreads();
  if (threadIdx.x < kRankTile) {
    int x = 0;
    for (int w = 0; w < kRankWarps; ++w) x += part[w][threadIdx.x];
    total[threadIdx.x] = x;
  }
  cluster.sync();
  if (threadIdx.x < kRankOut) {
    const int q = split * kRankOut + threadIdx.x;
    int rank = 0;
    for (int r = 0; r < kRankSplit; ++r)
      rank += cluster.map_shared_rank(total, r)[q];
    if (tile0 + q < s)
      scratch[static_cast<int64_t>(blockIdx.y) *
                  (s + 2 * static_cast<int64_t>(c)) +
              tile0 + q] = rank;
  }
  cluster.sync();  // the cluster's totals stay until every block read them
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  return x;
}

// Exclusive prefix sums of x and y over the block (blockDim.x a multiple
// of 32); the block's totals in tx, ty. sh holds 66 ints, used once.
__device__ int2 block_scan2(int x, int y, int* sh, int* tx, int* ty) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int ix = x, iy = y;
  for (int d = 1; d < 32; d <<= 1) {
    const int ux = __shfl_up_sync(0xffffffffu, ix, d);
    const int uy = __shfl_up_sync(0xffffffffu, iy, d);
    if (lane >= d) {
      ix += ux;
      iy += uy;
    }
  }
  if (lane == 31) {
    sh[warp] = ix;
    sh[32 + warp] = iy;
  }
  __syncthreads();
  if (warp == 0) {
    const int wx = lane < warps ? sh[lane] : 0;
    const int wy = lane < warps ? sh[32 + lane] : 0;
    int cx = wx, cy = wy;
    for (int d = 1; d < 32; d <<= 1) {
      const int ux = __shfl_up_sync(0xffffffffu, cx, d);
      const int uy = __shfl_up_sync(0xffffffffu, cy, d);
      if (lane >= d) {
        cx += ux;
        cy += uy;
      }
    }
    __syncwarp();
    sh[lane] = cx - wx;
    sh[32 + lane] = cy - wy;
    if (lane == 31) {
      sh[64] = cx;
      sh[65] = cy;
    }
  }
  __syncthreads();
  *tx = sh[64];
  *ty = sh[65];
  return make_int2(sh[warp] + ix - x, sh[32 + warp] + iy - y);
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
  int v, s, c, k, frames, video0;
};

// [lo, hi) of n items split into `parts` parts, part `part`
__device__ __forceinline__ int2 share(int n, int parts, int part) {
  const int per = (n + parts - 1) / parts;
  const int lo = min(n, part * per);
  return make_int2(lo, min(n, lo + per));
}

// A slot's inputs of the match: loaded once, in phase 1 (the rank, the
// rank launch's output, after the wait for it).
struct SlotIn {
  bool act, claim;  // claim: active, its column in range and valid
  int col, dis, rank;
};

__device__ __forceinline__ SlotIn load_slot(const UpdateArgs& a, int64_t at,
                                            int64_t bc) {
  SlotIn in;
  in.act = a.active[at] != 0;
  in.col = a.cand[at];
  in.dis = a.disappeared[at];
  in.rank = 0;
  in.claim = in.act && in.col >= 0 && in.col < a.c &&
             a.det_valid[bc + in.col] != 0;
  return in;
}

// A slot's match and ageing, from the winners of phase 2.
struct SlotEval {
  bool act, matched, age, alive;
  int col, dis;
};

__device__ __forceinline__ SlotEval eval_slot(const UpdateArgs& a,
                                              const SlotIn& in,
                                              const int* winner,
                                              bool has_det, int n_obj,
                                              int n_det) {
  SlotEval e;
  e.act = in.act;
  e.col = in.col;
  e.matched = in.claim && __ldcg(winner + in.col) == in.rank;
  e.age = has_det ? (e.act && !e.matched && n_obj >= n_det) : e.act;
  int dis = e.matched ? 0 : in.dis;
  if (e.age) dis = wrap_add(dis, 1);
  e.dis = dis;
  const bool dereg = e.age && __int2float_rn(dis) > a.max_disappeared;
  e.alive = e.act && !dereg;
  return e;
}

__global__ void __launch_bounds__(kUpdateThreads) update_kernel(UpdateArgs a) {
  __shared__ int counts[2];  // this block's active slots, valid columns
  __shared__ int totals[2];  // its registrations, free slots
  __shared__ int scan_a[66], scan_b[66];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = static_cast<int>(cluster.block_rank());
  const int cb = static_cast<int>(gridDim.x);  // the grid is one cluster wide
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31;
  const int s = a.s, c = a.c, k = a.k;
  const int64_t video = a.video0 + static_cast<int64_t>(blockIdx.y);
  const int64_t bs = video * s, bc = video * c;
  int* scr = a.scratch + video * (s + 2 * static_cast<int64_t>(c));
  const int* rank = scr;
  int* winner = scr + s;
  int* col_of_rank = winner + c;
  // the block's slots and columns, and the thread's contiguous runs (one
  // of each at S = C = 4096); the first slot's and column's values stay
  // in registers from phase to phase, the rest are loaded again
  const int2 sb = share(s, cb, b), cbk = share(c, cb, b);
  const int2 sr = share(sb.y - sb.x, nt, t), cr = share(cbk.y - cbk.x, nt, t);
  const int i_lo = sb.x + sr.x, i_hi = sb.x + sr.y;
  const int j_lo = cbk.x + cr.x, j_hi = cbk.x + cr.y;
  // a slot's inputs and rank (from phase 2 on)
  auto slot_in = [&](int i) {
    SlotIn in = load_slot(a, bs + i, bc);
    in.rank = rank[i];
    return in;
  };

  // 1. counts; the winners' reset (launched programmatically, this phase
  // may overlap the rank launch: it reads nothing the rank launch writes)
  SlotIn first = i_lo < i_hi ? load_slot(a, bs + i_lo, bc) : SlotIn{};
  const bool first_valid = j_lo < j_hi && a.det_valid[bc + j_lo] != 0;
  int x_obj = first.act, x_det = first_valid;
  for (int i = i_lo + 1; i < i_hi; ++i) x_obj += a.active[bs + i] != 0;
  for (int j = j_lo; j < j_hi; ++j) {
    if (j > j_lo) x_det += a.det_valid[bc + j] != 0;
    __stcg(winner + j, INT_MAX);
  }
  int tot_obj, tot_det;
  block_scan2(x_obj, x_det, scan_a, &tot_obj, &tot_det);
  if (t == 0) {
    counts[0] = tot_obj;
    counts[1] = tot_det;
  }
  cluster.sync();

  // 2. the cluster's counts; the claims, once the ranks are written
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (i_lo < i_hi) first.rank = rank[i_lo];
  int r_obj = 0, r_det = 0;
  if (lane < cb) {
    const int* r = cluster.map_shared_rank(counts, lane);
    r_obj = r[0];
    r_det = r[1];
  }
  const int n_obj = warp_sum(r_obj), n_det = warp_sum(r_det);
  for (int i = i_lo; i < i_hi; ++i) {
    const SlotIn in = i == i_lo ? first : slot_in(i);
    if (in.claim) atomicMin(winner + in.col, in.rank);
  }
  cluster.sync();

  // 3. registrations and free slots, counted and scanned
  const bool has_det = n_det > 0;
  const bool do_register = has_det && n_det > n_obj;
  auto unmatched = [&](int j, bool valid) {
    return do_register && valid && __ldcg(winner + j) == INT_MAX;
  };
  const bool first_new = j_lo < j_hi && unmatched(j_lo, first_valid);
  const SlotEval first_ev =
      eval_slot(a, first, winner, has_det, n_obj, n_det);
  int x_new = first_new, x_free = i_lo < i_hi && !first_ev.alive;
  for (int j = j_lo + 1; j < j_hi; ++j)
    x_new += unmatched(j, a.det_valid[bc + j] != 0);
  for (int i = i_lo + 1; i < i_hi; ++i)
    x_free += !eval_slot(a, slot_in(i), winner, has_det, n_obj, n_det).alive;
  int tot_new, tot_free;
  const int2 off = block_scan2(x_new, x_free, scan_b, &tot_new, &tot_free);
  if (t == 0) {
    totals[0] = tot_new;
    totals[1] = tot_free;
  }
  cluster.sync();

  // 4. the blocks' offsets; each registration's column at its rank
  int r_new = 0, r_free = 0, p_new = 0, p_free = 0;
  if (lane < cb) {
    const int* r = cluster.map_shared_rank(totals, lane);
    r_new = r[0];
    r_free = r[1];
    if (lane < b) {
      p_new = r_new;
      p_free = r_free;
    }
  }
  const int n_new = warp_sum(r_new), n_free = warp_sum(r_free);
  int at_new = warp_sum(p_new) + off.x;
  for (int j = j_lo; j < j_hi; ++j)
    if (j == j_lo ? first_new : unmatched(j, a.det_valid[bc + j] != 0))
      __stcg(col_of_rank + at_new++, j);
  cluster.sync();

  // 5. the slots' writes
  const int64_t em_row = video * a.frames * static_cast<int64_t>(s);
  const int64_t vs = static_cast<int64_t>(a.v) * s;
  int free_rank = warp_sum(p_free) + off.y;
  for (int i = i_lo; i < i_hi; ++i) {
    const int64_t at = bs + i;
    const SlotEval e = i == i_lo ? first_ev
                                 : eval_slot(a, slot_in(i), winner, has_det,
                                             n_obj, n_det);
    const bool is_free = !e.alive;
    const bool reg = is_free && free_rank < n_new;
    const int reg_col = reg ? __ldcg(col_of_rank + free_rank) : -1;
    const bool on = e.alive || reg;
    const int id = reg ? wrap_add(a.next_id[video], free_rank) : a.ids[at];
    const int dis = reg ? 0 : e.dis;
    free_rank += is_free;
    // position and info: the registered detection's, the matched one's,
    // or the slot's own (info zeroed on an aged slot)
    const int src = reg ? reg_col : e.matched ? e.col : -1;
    const float* p = src >= 0 ? a.det_xy + (bc + src) * k : a.pos + at * k;
    const float* f = src >= 0 ? a.det_info + (bc + src) * 3 : a.info + at * 3;
    const bool zero_info = !reg && e.age;
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
    a.em_det_col[em] = e.matched ? e.col : reg ? reg_col : -1;
    a.flags[at] = e.matched;
    a.flags[vs + at] = reg;
    a.flags[2 * vs + at] = on && !e.matched && !reg;
  }
  if (b == 0 && t == 0) {
    const int registered = min(n_new, n_free);
    a.out_next_id[video] = wrap_add(a.next_id[video], n_new);
    a.out_dropped[video] = wrap_add(a.dropped[video], n_new - registered);
    a.em_n_det[video * a.frames] = n_det;
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
      const dim3 grid((s + kRankTile - 1) / kRankTile * kRankSplit, nv);
      rank_kernel<<<grid, kRankThreads, 0, st>>>(
          static_cast<const uint8_t*>(active) + off,
          static_cast<const float*>(row_min) + off,
          static_cast<const int*>(ids) + off,
          static_cast<int*>(scratch) +
              static_cast<int64_t>(v0) * (s + 2 * static_cast<int64_t>(c)),
          s, c);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
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
               v, s, c, k, frames, 0};
  // the cluster: an eighth of the larger table a block, at most 512
  // threads, a warp at least
  const int most = max(s, c);
  const int cb = min(kUpdateCluster,
                     max(1, (most + kUpdateThreads - 1) / kUpdateThreads));
  const int per = (most + cb - 1) / cb;
  const int nt = min(kUpdateThreads, max(32, (per + 31) / 32 * 32));
  // a cluster per video; after the rank launch, launched programmatically
  // (its first phase overlaps the rank launch's tail)
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  for (int v0 = 0; v0 < v; v0 += kMaxVideos) {
    a.video0 = v0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cb, min(kMaxVideos, v - v0));
    cfg.blockDim = dim3(nt);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = s > 0 ? 2 : 1;
    err = cudaLaunchKernelEx(&cfg, update_kernel, a);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
