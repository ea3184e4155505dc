// Kernel K9: the vote engine's fold, one launch a DP group of chunks.
//
// It computes exactly what the plain PyTorch version
// canu_tpu_torch/ops/votepile.py:_fold_chunk computes (the fold of
// canu_tpu.ops.votepile._vote_chunk_core after its DP), for every job of a
// group at once, and adds it into the block's accumulator votes
// f32[G, 15, Lt] in place.  For job b (its columns t_bgn, t_span, e_span,
// slot, weight) and row i < n_rows, with js = the job's path (n_rows + 1
// entries), dj = js[i+1] - js[i], e_span' = min(e_span, W_e - 1):
//   live    i < t_span;  active = live & js[i+1] > 0 & js[i] < e_span';
//   chars   bchr = e_sub[js[i+1] - 1], ichr = e_sub[js[i]], i2chr =
//           e_sub[js[i] + 1], each position clamped to [0, W_e - 1];
//   masks   base dj >= 1, deletion dj == 0, insertion dj >= 2, second
//           insertion dj >= 3, each & active;
//   del     at a row where t_sub changes (row 0 always), the deletion rows
//           of that template run up to the next run start, clamped to 15;
//           0 elsewhere;
//   column  (t_bgn & t_mask) + i, t_mask = 2^log_rounds(Lt) - 1 (the
//           masked shift drops t_bgn's high bits; it is not a clamp); a
//           column at or past Lt is dropped.
// Each channel a row sets adds w, or del * w on the deletion channel, into
// votes[slot, ch, column], w = the job's weight rounded to bfloat16 (round
// to nearest even, as torch's cast).  A job whose slot lies outside
// 0..G-1 adds nothing (the plain version's one-hot row is empty), nor does
// a pad job (t_span 0, weight 0).
//
// Exactness.  The plain version folds with one float32 product; here each
// column's terms are summed in another order.  Both give the same float32
// sums because every term is a multiple of 2^-7 (the rounded weight is,
// and a flag or a count of at most 15 keeps it one) and every partial sum
// of a column stays below 2^17: such sums have at most 24 significant
// bits, so float32 adds them exactly in any order.  The wrapper
// (ops/kernels/votepile_cuda.py) raises before a launch whose weights
// break that: a rounded weight that is negative, not finite or not a
// multiple of 2^-7, or a slot whose 15 x summed weights over the block
// reach 2^17.  The correction's weights are 1 + meanQV / 256 in bfloat16,
// in [1, 2) (ops/falcon.py), RED's and the polish's 1.
//
// Replaces canu_tpu/ops/votepile.py:125 _vote_chunk_core's fold (after
// align_positions_lean), a jax.jit XLA program with no pl.pallas_call.
//
// What bounds it on an H100: the bytes, the group's inputs read once and
// the block's votes (31.5 MB at G 256, Lt 2,048) read and written once.
// The design gives every output column one owner, so nothing is added
// atomically in device memory and every row is read once, coalesced:
//   - a block of WARPS warps owns one slot's tile of TILE template
//     columns; the grid covers G x ceil(Lt / TILE) tiles, one launch for
//     every job of a group;
//   - the wrapper lists the group's voting jobs by slot (a stable order
//     and G + 1 offsets, built on the host from the columns it already
//     holds); the block's warps take its slot's jobs in turn, each reading
//     its job's columns, and skip those whose rows miss the tile;
//   - for a job that meets the tile, lane l reads rows r0 + 32 k + l (r0
//     the row at the tile's first column): js[i], js[i+1], t_sub[i],
//     t_sub[i-1] and the three e_sub characters;
//   - the deletion counts need no barrier: two ballots a 32-row group (run
//     starts, deletion rows) give each run start its deletion rows inside
//     the tile by popcounts, walked from the tile's last group down with
//     the carry of the run still open above; the run open at the tile's
//     right end takes the deletion rows past it from a forward walk, 32
//     rows a step, that stops at a run start, at T = min(t_span, n_rows)
//     (rows from lim = Lt - (t_bgn & t_mask) up to T still count toward a
//     run that starts below lim, as the plain version counts them) or at
//     15;
//   - the channels add up in the block's shared tile [15][TILE] (shared
//     atomics: the warps of a block fold different jobs into the same
//     columns); at the end the block reads, adds and writes its tile of
//     votes once, coalesced, and leaves a tile that no job met untouched.
// On the card (PERF.md, scripts/torch_fold_match_variants.py) this is
// slower than the design it replaces (a block a job, atomicAdds into
// the votes), whose atomics cost it almost nothing: here each
// (job, tile) pays its columns, its rows and its characters as three
// loads that wait on each other, a walk past the tile for an open run,
// and the block's read-add-write of the whole tile.  Of the shapes tried,
// TILE 64 and WARPS 8 ran fastest (TILE 128: 40 registers, 6 blocks an
// SM); one warp a tile with the channels in registers (111 registers),
// larger tiles, and a block reading its jobs' columns once into shared
// memory (60 registers) all ran slower.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

#ifndef FOLD_TILE
#define FOLD_TILE 64
#endif
#ifndef FOLD_WARPS
#define FOLD_WARPS 8
#endif

namespace {

constexpr int TILE = FOLD_TILE;     // template columns a block owns
constexpr int PER_LANE = TILE / 32;  // rows a lane reads a job, 32 apart
constexpr int WARPS = FOLD_WARPS;   // warps a block: each folds one job of the slot at a time
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int DEL_CLAMP = 15;
constexpr int N_CH = 15;
constexpr int CH_BASE = 0;
constexpr int CH_DEL = 4;
constexpr int CH_INS = 5;
constexpr int CH_INSBASE = 6;
constexpr int CH_INS2 = 10;
constexpr int CH_INS2BASE = 11;
constexpr int COL_T_BGN = 2;
constexpr int COL_T_SPAN = 3;
constexpr int COL_E_SPAN = 5;
constexpr int COL_WEIGHT = 8;
static_assert(TILE % 32 == 0 && TILE > 0, "a tile is whole 32-column groups");

// float -> bfloat16 -> float, round to nearest even (finite w)
__device__ __forceinline__ float bf16_round(float w) {
  unsigned u = __float_as_uint(w);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return __uint_as_float(u);
}

// int32 a - b wrapping, as the plain version's int32 tensors do
__device__ __forceinline__ int sub32(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clamp_pos(int p, int W_e) {
  return p < 0 ? 0 : (p > W_e - 1 ? W_e - 1 : p);
}

// the lanes at or above `lane`
__device__ __forceinline__ unsigned from_lane(int lane) { return ~((1u << lane) - 1u); }

// the lanes below the first set lane of m (all lanes when m is 0)
__device__ __forceinline__ unsigned before_first(unsigned m) {
  return m ? (1u << (__ffs(m) - 1)) - 1u : FULL;
}

__global__ void __launch_bounds__(WARPS * 32)
vote_fold_kernel(float* __restrict__ votes, int G, int Lt, int n_tiles,
                 const int32_t* __restrict__ js, const uint8_t* __restrict__ t_sub,
                 const uint8_t* __restrict__ e_sub, int W_e, const int32_t* __restrict__ cols,
                 int n, int n_rows, int t_mask, const int32_t* __restrict__ by_slot) {
  __shared__ float acc[N_CH][TILE];  // the tile's channels
  __shared__ int met_any;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = static_cast<int>(blockIdx.x / n_tiles);
  const int c0 = static_cast<int>(blockIdx.x % n_tiles) * TILE;
  const int32_t* jobs = by_slot + G + 1;  // by_slot: G + 1 offsets, then the jobs by slot
  for (int x = threadIdx.x; x < N_CH * TILE; x += WARPS * 32) (&acc[0][0])[x] = 0.0f;
  if (threadIdx.x == 0) met_any = 0;
  __syncthreads();

  bool met = false;
  const int q1 = by_slot[slot + 1];
  for (int q = by_slot[slot] + warp; q < q1; q += WARPS) {
    const int b = jobs[q];
    const int t_span = cols[COL_T_SPAN * n + b];
    const float w = bf16_round(__int_as_float(cols[COL_WEIGHT * n + b]));
    const int T = t_span < n_rows ? t_span : n_rows;
    const int tm = static_cast<int>(static_cast<unsigned>(cols[COL_T_BGN * n + b]) &
                                    static_cast<unsigned>(t_mask));
    const int lim = Lt - tm < T ? Lt - tm : T;  // rows below it land on the block
    const int r0 = c0 - tm;                     // the row at the tile's first column
    if (T <= 0 || w == 0.0f || r0 >= lim || r0 + TILE <= 0) continue;  // no row votes here
    met = true;
    const int e_span0 = cols[COL_E_SPAN * n + b];
    const int e_span = e_span0 < W_e - 1 ? e_span0 : W_e - 1;
    const int32_t* jb = js + static_cast<size_t>(b) * (n_rows + 1);
    const uint8_t* tb = t_sub + static_cast<size_t>(b) * n_rows;
    const uint8_t* eb = e_sub + static_cast<size_t>(b) * W_e;

    // the tile's rows: path ends, run starts and deletion rows (a row
    // outside 0..T-1 votes nothing and closes any run, as no deletion
    // row lies past T)
    int j0[PER_LANE], j1[PER_LANE];
    unsigned starts[PER_LANE], dels[PER_LANE];
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k) {
      const int i = r0 + 32 * k + lane;
      const bool row = i >= 0 && i < T;
      int a = 0, c = 0;
      bool st = true;
      if (row) {
        a = jb[i];
        c = jb[i + 1];
        st = i == 0 || tb[i] != tb[i - 1];
      }
      j0[k] = a;
      j1[k] = c;
      starts[k] = __ballot_sync(FULL, st);
      dels[k] = __ballot_sync(FULL, row && c > 0 && a < e_span && c == a);
    }

    // the deletion rows past the tile of the run open at its right end,
    // needed when that run starts on a row that votes
    int carry = 0;
    int last = -1;  // the tile's last run start, as a row
#pragma unroll
    for (int k = 0; k < PER_LANE; ++k)
      if (starts[k]) last = r0 + 32 * k + 31 - __clz(starts[k]);
    if (r0 + TILE < T && last >= 0 && last < lim) {
      for (int p0 = r0 + TILE;; p0 += 32) {
        const int p = p0 + lane;  // p >= 1: the tile holds a row of the job
        const bool row = p < T;
        bool st = true, del = false;
        if (row) {
          const int a = jb[p], c = jb[p + 1];
          st = tb[p] != tb[p - 1];
          del = c > 0 && a < e_span && c == a;
        }
        const unsigned stop = __ballot_sync(FULL, st);
        carry += __popc(__ballot_sync(FULL, del) & before_first(stop));
        if (stop || carry >= DEL_CLAMP) break;
      }
    }

    // from the tile's last 32-row group down: each run start's deletion
    // rows (inside the group up to the next run start, else to its end
    // plus the carry from the groups above), then each voting row's
    // channels into the shared tile
#pragma unroll
    for (int k = PER_LANE - 1; k >= 0; --k) {
      const unsigned later = starts[k] & ~((2u << lane) - 1u);  // starts above this lane
      const unsigned mine = dels[k] & from_lane(lane);
      const int cnt = later ? __popc(mine & before_first(later)) : __popc(mine) + carry;
      const int del = (starts[k] >> lane) & 1u ? (cnt < DEL_CLAMP ? cnt : DEL_CLAMP) : 0;
      carry = starts[k] ? __popc(dels[k] & before_first(starts[k])) : __popc(dels[k]) + carry;
      const int i = r0 + 32 * k + lane;
      if (i < 0 || i >= lim) continue;
      const int a = j0[k], c = j1[k];
      const int dj = sub32(c, a);
      const bool active = c > 0 && a < e_span;
      const int x = 32 * k + lane;
      const auto chr = [&](int p) { return eb[clamp_pos(p, W_e)] & 3; };  // bchr, ichr, i2chr
      if (active && dj >= 1) atomicAdd(&acc[CH_BASE + chr(sub32(c, 1))][x], w);
      if (del) atomicAdd(&acc[CH_DEL][x], static_cast<float>(del) * w);
      if (active && dj >= 2) {
        atomicAdd(&acc[CH_INS][x], w);
        atomicAdd(&acc[CH_INSBASE + chr(a)][x], w);
      }
      if (active && dj >= 3) {
        atomicAdd(&acc[CH_INS2][x], w);
        atomicAdd(&acc[CH_INS2BASE + chr(sub32(a, -1))][x], w);
      }
    }
  }

  if (met && lane == 0) met_any = 1;
  __syncthreads();
  if (!met_any) return;  // the whole block: no job of the slot reaches the tile
  float* vs = votes + static_cast<size_t>(slot) * N_CH * Lt;
  for (int x = threadIdx.x; x < N_CH * TILE; x += WARPS * 32) {
    const int ch = x / TILE, col = c0 + x % TILE;
    if (col < Lt) vs[static_cast<size_t>(ch) * Lt + col] += acc[ch][x % TILE];
  }
}

}  // namespace

// Fold the n jobs of a group into votes f32[G, 15, Lt] on `stream`: js
// int32[n, n_rows + 1], t_sub uint8[n, n_rows], e_sub uint8[n, W_e], cols
// int32[9, n] (rows 2, 3, 5, 8: t_bgn, t_span, e_span, the weight's float
// bits), t_mask = 2^log_rounds(Lt) - 1, by_slot int32[G + 1 + m]: the
// offsets of each slot's jobs (by_slot[0] = 0, by_slot[G] = m), then the m
// voting jobs ordered by slot (ops/kernels/votepile_cuda.py slot_order).
// Returns cudaGetLastError() of the launch, -1 for G or Lt below 1, -2 for
// n_rows below 1, -3 for W_e below 1, -4 for a negative t_mask, 0 at once
// for n 0.
extern "C" int canu_vote_fold(void* votes, int G, int Lt, const void* js, const void* t_sub,
                              const void* e_sub, int W_e, const void* cols, int n, int n_rows,
                              int t_mask, const void* by_slot, void* stream) {
  if (G < 1 || Lt < 1) return -1;
  if (n_rows < 1) return -2;
  if (W_e < 1) return -3;
  if (t_mask < 0) return -4;
  if (n <= 0) return 0;
  const int n_tiles = (Lt + TILE - 1) / TILE;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(G) * n_tiles);
  vote_fold_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(votes), G, Lt, n_tiles, static_cast<const int32_t*>(js),
      static_cast<const uint8_t*>(t_sub), static_cast<const uint8_t*>(e_sub), W_e,
      static_cast<const int32_t*>(cols), n, n_rows, t_mask,
      static_cast<const int32_t*>(by_slot));
  return static_cast<int>(cudaGetLastError());
}
