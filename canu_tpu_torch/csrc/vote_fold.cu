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
//   code    bchr | ichr << 2 | base << 4 | ins << 6 | ins2 << 7 |
//           i2chr << 8 | del << 10, decoded channel by channel as the
//           plain version decodes it;
//   column  (t_bgn & t_mask) + i, t_mask = 2^log_rounds(Lt) - 1 (the
//           masked shift drops t_bgn's high bits; it is not a clamp); a
//           column at or past Lt is dropped.
// Each channel the code sets adds w, or del * w on the deletion channel,
// into votes[slot, ch, column], w = the job's weight rounded to bfloat16
// (round to nearest even, as torch's cast).  A job whose slot lies outside
// 0..G-1 adds nothing (the plain version's one-hot row is empty), nor does
// a pad job (t_span 0, weight 0).
//
// Exactness.  The plain version folds with one float32 product; here the
// terms land by atomicAdd in any order.  Both give the same float32 sums
// because every term is a multiple of 2^-7 (the rounded weight is, and a
// flag or a count of at most 15 keeps it one) and every partial sum of a
// column stays below 2^17: such sums have at most 24 significant bits, so
// float32 adds them exactly in any order.  The wrapper
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
// The design (a simple one, not yet tuned):
//   - a block of 256 threads a job, one launch for every job of a group;
//     a pad job, or one whose slot is off the block, returns at once;
//   - only rows below T = min(n_rows, t_span) can vote, so only they are
//     read: pass 1 gives each thread a contiguous segment of them, in
//     which it counts the deletion rows of each template run and writes
//     the count (clamped to 15) at the run's start into a shared byte per
//     row; the run still open at the segment's end takes the counts of
//     the following segments up to the next run start (a walk over the
//     threads' shared heads, which stops at 15);
//   - pass 2 strides the rows over the threads (consecutive threads,
//     consecutive columns), rebuilds each row's code and adds its channels
//     with at most six atomicAdds, which coalesce into few L2 sectors for
//     a warp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_ROWS = 32768;  // the shared byte a row, within 48 KB
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
constexpr int COL_SLOT = 7;
constexpr int COL_WEIGHT = 8;

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

__global__ void __launch_bounds__(THREADS)
vote_fold_kernel(float* __restrict__ votes, int G, int Lt, const int32_t* __restrict__ js,
                 const uint8_t* __restrict__ t_sub, const uint8_t* __restrict__ e_sub, int W_e,
                 const int32_t* __restrict__ cols, int n, int n_rows, int t_mask) {
  extern __shared__ uint8_t del_at[];  // n_rows: the deletion count at each run start
  __shared__ int head[THREADS];        // a segment's deletion rows before its first run start
  __shared__ int opens[THREADS];       // whether a run starts in the segment
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int t_span = cols[COL_T_SPAN * n + b];
  const int slot = cols[COL_SLOT * n + b];
  const float w = bf16_round(__int_as_float(cols[COL_WEIGHT * n + b]));
  if (t_span <= 0 || slot < 0 || slot >= G || w == 0.0f) return;  // the whole block: it adds 0
  const int T = t_span < n_rows ? t_span : n_rows;
  const int e_span0 = cols[COL_E_SPAN * n + b];
  const int e_span = e_span0 < W_e - 1 ? e_span0 : W_e - 1;
  const int tm = static_cast<int>(static_cast<unsigned>(cols[COL_T_BGN * n + b]) &
                                  static_cast<unsigned>(t_mask));
  const int32_t* jb = js + static_cast<size_t>(b) * (n_rows + 1);
  const uint8_t* tb = t_sub + static_cast<size_t>(b) * n_rows;
  const uint8_t* eb = e_sub + static_cast<size_t>(b) * W_e;

  // pass 1: the deletion count of each template run, at its start
  const int seg = (T + THREADS - 1) / THREADS;
  const int lo = tid * seg;
  const int hi = lo + seg < T ? lo + seg : T;
  int before = 0, cur = -1, cnt = 0;
  for (int i = lo; i < hi; ++i) {
    if (i == 0 || tb[i] != tb[i - 1]) {
      if (cur >= 0) del_at[cur] = static_cast<uint8_t>(cnt < 15 ? cnt : 15);
      cur = i;
      cnt = 0;
    }
    const int j0 = jb[i], j1 = jb[i + 1];
    const int d = (j1 > 0 && j0 < e_span && j1 == j0) ? 1 : 0;
    if (cur >= 0) cnt += d; else before += d;
  }
  head[tid] = before;
  opens[tid] = cur >= 0;
  __syncthreads();
  if (cur >= 0) {  // the run open at the segment's end goes on into the next ones
    for (int u = tid + 1; u < THREADS && cnt < 15; ++u) {
      cnt += head[u];
      if (opens[u]) break;
    }
    del_at[cur] = static_cast<uint8_t>(cnt < 15 ? cnt : 15);
  }
  __syncthreads();

  // pass 2: each row's code, its channels added at its template column
  float* vs = votes + static_cast<size_t>(slot) * N_CH * Lt + tm;
  const int lim = Lt - tm < T ? Lt - tm : T;
  for (int i = tid; i < lim; i += THREADS) {
    const int j0 = jb[i], j1 = jb[i + 1];
    const int dj = sub32(j1, j0);
    const bool active = j1 > 0 && j0 < e_span;
    const int bchr = eb[clamp_pos(sub32(j1, 1), W_e)];
    const int ichr = eb[clamp_pos(j0, W_e)];
    const int i2chr = eb[clamp_pos(sub32(j0, -1), W_e)];
    const int del = (i == 0 || tb[i] != tb[i - 1]) ? del_at[i] : 0;
    const int code = bchr | (ichr << 2) | ((active && dj >= 1) << 4) | ((active && dj >= 2) << 6) |
                     ((active && dj >= 3) << 7) | (i2chr << 8) | (del << 10);
    float* v = vs + i;
    if ((code >> 4) & 1) atomicAdd(v + static_cast<size_t>(CH_BASE + (code & 3)) * Lt, w);
    const int d_cnt = (code >> 10) & 15;
    if (d_cnt) atomicAdd(v + static_cast<size_t>(CH_DEL) * Lt, static_cast<float>(d_cnt) * w);
    if ((code >> 6) & 1) {
      atomicAdd(v + static_cast<size_t>(CH_INS) * Lt, w);
      atomicAdd(v + static_cast<size_t>(CH_INSBASE + ((code >> 2) & 3)) * Lt, w);
    }
    if ((code >> 7) & 1) {
      atomicAdd(v + static_cast<size_t>(CH_INS2) * Lt, w);
      atomicAdd(v + static_cast<size_t>(CH_INS2BASE + ((code >> 8) & 3)) * Lt, w);
    }
  }
}

}  // namespace

// Fold the n jobs of a group into votes f32[G, 15, Lt] on `stream`: js
// int32[n, n_rows + 1], t_sub uint8[n, n_rows], e_sub uint8[n, W_e], cols
// int32[9, n] (rows 2, 3, 5, 7, 8: t_bgn, t_span, e_span, slot, the weight's
// float bits), t_mask = 2^log_rounds(Lt) - 1.  Returns cudaGetLastError() of
// the launch, -1 for G or Lt below 1, -2 for n_rows outside 1..MAX_ROWS, -3
// for W_e below 1, -4 for a negative t_mask, 0 at once for n 0.
extern "C" int canu_vote_fold(void* votes, int G, int Lt, const void* js, const void* t_sub,
                              const void* e_sub, int W_e, const void* cols, int n, int n_rows,
                              int t_mask, void* stream) {
  if (G < 1 || Lt < 1) return -1;
  if (n_rows < 1 || n_rows > MAX_ROWS) return -2;
  if (W_e < 1) return -3;
  if (t_mask < 0) return -4;
  if (n <= 0) return 0;
  vote_fold_kernel<<<n, THREADS, n_rows, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(votes), G, Lt, static_cast<const int32_t*>(js),
      static_cast<const uint8_t*>(t_sub), static_cast<const uint8_t*>(e_sub), W_e,
      static_cast<const int32_t*>(cols), n, n_rows, t_mask);
  return static_cast<int>(cudaGetLastError());
}
