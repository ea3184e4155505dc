// Kernel K4: the vote engine's banded forward + backward DP in the window
// frame, one warp a job, one launch a chunk.
//
// It computes exactly what the plain PyTorch version
// canu_tpu_torch/ops/trace.py:align_positions_lean_plain computes (the port
// of canu_tpu.ops.trace.align_positions_lean), bit for bit: per job and per
// template row i the least combine key K(i) = min over the window's lanes x
// of tot * Ww + x, tot = F + G, from which ops/trace.py derives j*(i) and
// the edit count (the cummax, clamps and gather of that tail stay PyTorch).
// Rows run in super-rows of SROW = 32 sharing the anchor a_p (the band start
// of row p*32); row i >= 1 lies in the frame of super-row (i-1)/32, row 0 in
// frame 0; lane x is evidence column j = a_p + x, el = e_len, tl = t_len,
// Ww = band + 128 lanes, e_pad = [0, e..., 0...]:
//   forward  F(0, x) = j <= el ? (ends_free ? 0 : j) : INF16;
//            row i from row i-1 (re-anchored where i-1 is a multiple of 32:
//            lane x takes lane x + d, d = a_p - a_{p-1}, INF16 past Ww):
//              m'(x) = min(F(i-1, x) + 1 - x, F(i-1, x-1) + dv(x) - x),
//              dv = t[i-1] != e_pad[a_p + x] where 1 <= j <= el, else INF16,
//              F(i-1, -1) = INF16;
//            F(i, x) = min(prefixmin(m')(x) + x, INF16) where j <= el and
//            i <= tl, else INF16.  Stored as Fm(i) = min over the Ww lanes
//            and Fu(i, x) = 255 where F >= INF16, else clamp(F - Fm, 0, 254).
//   backward G(n_rows) = bnd where tl == n_rows, else INF16 (frame Q-1),
//            bnd = j <= el ? (ends_free ? 0 : el - j) : INF16;
//            row i from row i+1 (re-anchored before row p*32, which lies in
//            frame p-1: lane x takes lane x - d, INF16 below 0):
//              s(x) = min(G(i+1, x) + 1 + x, G(i+1, x+1) + dv(x) + x, INF16),
//              dv = t[i] != e_pad[a + x + 1] where j < el, else INF16,
//              G(i+1, Ww) = INF16;
//            G(i, x) = min(suffixmin(s)(x) - x, INF16) where i < tl and
//            j <= el; bnd where i == tl; else INF16.
//   combine  K(i) = min over x < Ww of fk + gk: fk = BAD*Ww where Fu == 255
//            or Fm >= INF16, else (Fm + Fu) * Ww + x; gk = BAD*Ww where G >=
//            INF16, else G * Ww (BAD = 4 * INF16).
// The int32 arithmetic is the plain version's: a cell more than 254 above
// its row's minimum reads back as +254, kept cells of the backward rows can
// hold INF16 - x (the cap before the closure), and nothing else saturates.
//
// Replaces canu_tpu/ops/trace.py:175 align_positions_lean, a jax.jit XLA
// program (an outer lax.scan over super-rows with their 32 rows unrolled)
// with no pl.pallas_call; the port had run it as ~46,500 eager PyTorch
// launches a chunk of 256 jobs x 2,048 rows.
//
// What bounds it on an H100: the operations, ~32 a live cell of both
// passes (4.0e9 a chunk of 256 jobs x 2,048 rows at band 256: 0.24 ms at
// the int32 rate), over the bytes: the forward rows go to device memory
// for the backward pass to read back (201 MB a chunk, too much to keep on
// chip; 0.08 ms at 3.35 TB/s).  Each job is a chain of 2 x (n_rows + 1)
// dependent rows (every cell needs the row before, and the closure
// crosses the whole window), so in practice its latency rules (chip_smoke.py
// phase 12c: 2.3 ms a chunk on an H100 at 700 W).  The design:
//   - one warp a job, each lane holding C = 8 or 12 contiguous cells of the
//     row in registers (Ww padded to 32*C lanes; the pad cells are held at
//     INF16 on every row: they are the wall the backward diagonal reads past
//     the window, and no closure or minimum reads them otherwise);
//   - the closure: an in-lane prefix min (forward) or suffix min (backward),
//     then a 5-step shuffle scan of the lanes' ends (__shfl_up_sync forward,
//     __shfl_down_sync backward), so the backward rows keep the true lane
//     order and the combine's first-lane tie rule needs no reversal;
//   - no load on a row's chain: the evidence window of a frame (C + 1 bytes
//     a lane, constant over its 32 rows), the template characters (one a
//     lane a super-row) and the anchors are loaded a super-row ahead; the
//     backward pass stages the next super-row's 32 forward rows into shared
//     memory by cp.async, double buffered; the row minimum and the least key
//     are one __reduce_min_sync each;
//   - the re-anchoring shift, once a super-row, goes through shared memory.
// One warp a block, so 256 jobs put ~2 warps on an SM and the chain's
// latency is barely hidden: more jobs a launch, or several warps a job, is
// the redesign left for later.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int INF16 = 30000;
constexpr int SMAX = 4;
constexpr int SROW = 32;
constexpr int BAD = 4 * INF16;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int NONE = 1 << 29;  // a scan's carry where no lane feeds it

template <int C>
struct Shape {
  static constexpr int W32 = 32 * C;  // lanes of a stored row (Ww padded)
  static constexpr int WORDS = C / 4;  // a lane's Fu bytes, as words
  static constexpr int ROW_WORDS = W32 / 4;
  static constexpr int PIECES = SROW * W32 / 16;  // 16-byte pieces of a super-row
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The lane's evidence bytes of a frame anchored at a: ew[c] = e_pad[a + x0
// + c] for c = 0..C (forward rows read ew[c], backward rows ew[c + 1]).
template <int C>
__device__ __forceinline__ void load_window(int (&ew)[C + 1], const uint8_t* erow, int LE,
                                            int a, int x0) {
#pragma unroll
  for (int c = 0; c <= C; ++c) {
    const int k = a + x0 + c;
    ew[c] = (k >= 1 && k <= LE) ? erow[k - 1] : 0;
  }
}

// Start copying the 32 forward rows from row0 on into shared memory.
template <int C>
__device__ __forceinline__ void stage_rows(uint32_t* dst, const uint8_t* fu_b, int row0,
                                           int lane) {
  const uint8_t* src = fu_b + (size_t)row0 * Shape<C>::W32;
#pragma unroll
  for (int u = 0; u < Shape<C>::PIECES / 32; ++u) {
    const int q = lane + 32 * u;
    cp_async16(dst + 4 * q, src + 16 * q);
  }
}

// Bit c: cell x0 + c lies in the window at j = a + x0 + c <= el (kept
// cells), and its diagonal is valid (forward j >= 1, backward j < el).
template <int C>
__device__ __forceinline__ void frame_bits(int a, int x0, int Ww, int el, bool fwd,
                                           unsigned& keep, unsigned& diag) {
  keep = diag = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = a + x0 + c;
    if (x0 + c < Ww && j <= el) {
      keep |= 1u << c;
      if (fwd ? j >= 1 : j < el) diag |= 1u << c;
    }
  }
}

// Store forward row F as Fu (uint8, the lane's C bytes as words) and Fm.
template <int C>
__device__ __forceinline__ void store_row(const int (&F)[C], int x0, int Ww, uint8_t* furow,
                                          int32_t* fm, int lane) {
  int mn = INT_MAX;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (x0 + c < Ww) mn = min(mn, F[c]);
  mn = __reduce_min_sync(FULL, mn);
  uint32_t w[Shape<C>::WORDS];
#pragma unroll
  for (int k = 0; k < Shape<C>::WORDS; ++k) w[k] = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int v = F[c] >= INF16 ? 255 : min(max(F[c] - mn, 0), 254);
    w[c >> 2] |= uint32_t(v) << (8 * (c & 3));
  }
  uint32_t* dst = reinterpret_cast<uint32_t*>(furow + x0);
#pragma unroll
  for (int k = 0; k < Shape<C>::WORDS; ++k) dst[k] = w[k];
  if (lane == 0) *fm = mn;
}

// The least combine key of a row: G in registers, the forward row's bytes
// w (this lane's) and its minimum fm.
template <int C>
__device__ __forceinline__ int combine(const int (&G)[C], const uint32_t (&w)[Shape<C>::WORDS],
                                       int fm, int x0, int Ww, int badk) {
  int best = INT_MAX;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = x0 + c;
    const int fu = (w[c >> 2] >> (8 * (c & 3))) & 255;
    const int fk = (fu == 255 || fm >= INF16) ? badk : (fm + fu) * Ww + x;
    const int gk = G[c] >= INF16 ? badk : G[c] * Ww;
    if (x < Ww) best = min(best, fk + gk);
  }
  return __reduce_min_sync(FULL, best);
}

// Forward row i from row i - 1, both in the frame of a super-row.
template <int C>
__device__ __forceinline__ void f_row(int (&F)[C], const int (&ew)[C + 1], unsigned keep,
                                      unsigned diag, int tc, bool live, int x0, int lane) {
  int left = __shfl_up_sync(FULL, F[C - 1], 1);
  if (lane == 0) left = INF16;
  int m[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = x0 + c;
    const int dv = (diag >> c) & 1 ? int(tc != ew[c]) : INF16;
    m[c] = min(F[c] + 1 - x, (c == 0 ? left : F[c == 0 ? 0 : c - 1]) + dv - x);
  }
#pragma unroll
  for (int c = 1; c < C; ++c) m[c] = min(m[c], m[c - 1]);
  int T = m[C - 1];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, T, d);
    if (lane >= d) T = min(T, v);
  }
  int in = __shfl_up_sync(FULL, T, 1);
  if (lane == 0) in = NONE;
#pragma unroll
  for (int c = 0; c < C; ++c)
    F[c] = live && ((keep >> c) & 1) ? min(min(m[c], in) + x0 + c, INF16) : INF16;
}

// Backward row i from row i + 1, both in the frame anchored at a.
template <int C>
__device__ __forceinline__ void g_row(int (&G)[C], const int (&ew)[C + 1], unsigned keep,
                                      unsigned diag, int tc, int i, int tl, int el, int a,
                                      bool ends_free, int x0, int lane) {
  int right = __shfl_down_sync(FULL, G[0], 1);
  if (lane == 31) right = INF16;
  int s[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = x0 + c;
    const int nx = c + 1 < C ? G[c + 1 < C ? c + 1 : 0] : right;
    const int dv = (diag >> c) & 1 ? int(tc != ew[c + 1]) : INF16;
    s[c] = min(min(G[c] + 1 + x, nx + dv + x), INF16);
  }
#pragma unroll
  for (int c = C - 2; c >= 0; --c) s[c] = min(s[c], s[c + 1]);
  int T = s[0];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(FULL, T, d);
    if (lane + d < 32) T = min(T, v);
  }
  int in = __shfl_down_sync(FULL, T, 1);
  if (lane == 31) in = NONE;
  const bool kept = i < tl, at_end = i == tl;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = x0 + c;
    const bool k = (keep >> c) & 1;
    G[c] = kept && k ? min(min(s[c], in) - x, INF16)
                     : (at_end && k ? (ends_free ? 0 : el - (a + x)) : INF16);
  }
}

template <int C>
__global__ void __launch_bounds__(32) vote_dp_kernel(
    const uint8_t* __restrict__ t, int LT, const int32_t* __restrict__ t_len,
    const uint8_t* __restrict__ e, int LE, const int32_t* __restrict__ e_len,
    const int32_t* __restrict__ anchors, int Ww, int n_rows, int ends_free_i,
    uint8_t* __restrict__ Fu, int32_t* __restrict__ Fm, int32_t* __restrict__ K) {
  using S = Shape<C>;
  __shared__ int xs[S::W32];  // the re-anchoring shift
  __shared__ __align__(16) uint32_t stage[2][SROW * S::ROW_WORDS];  // backward: Fu of a super-row
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const bool ends_free = ends_free_i != 0;
  const int Q = n_rows / SROW;
  const int NR = n_rows + 1;
  const int tl = t_len[b];
  const int el = e_len[b];
  const uint8_t* trow = t + (size_t)b * LT;
  const uint8_t* erow = e + (size_t)b * LE;
  const int32_t* A = anchors + (size_t)b * Q;
  uint8_t* fu_b = Fu + (size_t)b * NR * S::W32;
  int32_t* fm_b = Fm + (size_t)b * NR;
  const int x0 = lane * C;
  const int badk = BAD * Ww;
  unsigned keep, diag;
  int ew[C + 1], ew_nx[C + 1];
#pragma unroll
  for (int c = 0; c <= C; ++c) ew_nx[c] = 0;

  // ---- forward: rows 0..n_rows, stored normalized ----
  int a_cur = A[0];
  int a_nx = Q > 1 ? A[1] : 0;
  load_window<C>(ew, erow, LE, a_cur, x0);
  int tv = trow[lane];
  int F[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = a_cur + x0 + c;
    F[c] = x0 + c < Ww && j <= el ? (ends_free ? 0 : j) : INF16;
  }
  store_row<C>(F, x0, Ww, fu_b, fm_b, lane);
  int a_prev = a_cur;
#pragma unroll 1
  for (int p = 0; p < Q; ++p) {
    const int lo = p * SROW;
    int a_nx2 = 0, tv_nx = 0;
    if (p + 1 < Q) {  // the next super-row's loads, used a super-row on
      load_window<C>(ew_nx, erow, LE, a_nx, x0);
      tv_nx = trow[lo + SROW + lane];
      if (p + 2 < Q) a_nx2 = A[p + 2];
    }
    if (p > 0) {  // re-anchor at a_p: lane x takes lane x + d
      const int d = a_cur - a_prev;
#pragma unroll
      for (int c = 0; c < C; ++c) xs[x0 + c] = F[c];
      __syncwarp();
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int k = x0 + c + d;
        F[c] = k >= 0 && k < Ww ? xs[k] : INF16;
      }
      __syncwarp();
    }
    frame_bits<C>(a_cur, x0, Ww, el, true, keep, diag);
#pragma unroll 1
    for (int r = 0; r < SROW; ++r) {
      const int i = lo + r + 1;
      f_row<C>(F, ew, keep, diag, __shfl_sync(FULL, tv, r), i <= tl, x0, lane);
      store_row<C>(F, x0, Ww, fu_b + (size_t)i * S::W32, fm_b + i, lane);
    }
    a_prev = a_cur;
    a_cur = a_nx;
    a_nx = a_nx2;
    tv = tv_nx;
#pragma unroll
    for (int c = 0; c <= C; ++c) ew[c] = ew_nx[c];
  }
  // every lane reads back rows other lanes wrote
  __threadfence_block();
  __syncwarp();

  // ---- backward with the combine folded in ----
  a_cur = A[Q - 1];
  int a_pv = A[Q >= 2 ? Q - 2 : 0];
  load_window<C>(ew, erow, LE, a_cur, x0);
  frame_bits<C>(a_cur, x0, Ww, el, false, keep, diag);
  int G[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    G[c] = tl == n_rows && ((keep >> c) & 1) ? (ends_free ? 0 : el - (a_cur + x0 + c)) : INF16;
  {
    uint32_t w[S::WORDS];
    const uint32_t* src = reinterpret_cast<const uint32_t*>(fu_b + (size_t)n_rows * S::W32 + x0);
#pragma unroll
    for (int k = 0; k < S::WORDS; ++k) w[k] = src[k];
    const int key = combine<C>(G, w, fm_b[n_rows], x0, Ww, badk);
    if (lane == 0) K[(size_t)b * NR + n_rows] = key;
  }
  stage_rows<C>(stage[0], fu_b, (Q - 1) * SROW, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  int fmv = fm_b[(Q - 1) * SROW + lane];
  tv = trow[(Q - 1) * SROW + lane];
  int cur = 0;
#pragma unroll 1
  for (int p = Q - 1; p >= 0; --p) {
    const int lo = p * SROW;
    const int a_pv2 = A[p >= 2 ? p - 2 : 0];
    load_window<C>(ew_nx, erow, LE, a_pv, x0);  // frame p-1: row lo, then super-row p-1
    int fm_nx = 0, tv_nx = 0;
    if (p > 0) {
      stage_rows<C>(stage[cur ^ 1], fu_b, lo - SROW, lane);
      fm_nx = fm_b[lo - SROW + lane];
      tv_nx = trow[lo - SROW + lane];
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const uint32_t* st = stage[cur] + lane * S::WORDS;
    int kr = 0;
    uint32_t w[S::WORDS];
#pragma unroll 1
    for (int r = SROW - 1; r >= 1; --r) {
      const int i = lo + r;
      g_row<C>(G, ew, keep, diag, __shfl_sync(FULL, tv, r), i, tl, el, a_cur, ends_free, x0,
               lane);
#pragma unroll
      for (int k = 0; k < S::WORDS; ++k) w[k] = st[r * S::ROW_WORDS + k];
      const int key = combine<C>(G, w, __shfl_sync(FULL, fmv, r), x0, Ww, badk);
      if (lane == r) kr = key;
    }
    // row lo lies in frame a_{p-1}: re-anchor (lane x takes lane x - d), then compute it
    const int d = a_cur - a_pv;
#pragma unroll
    for (int c = 0; c < C; ++c) xs[x0 + c] = G[c];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = x0 + c - d;
      G[c] = x0 + c < Ww && k >= 0 && k < Ww ? xs[k] : INF16;
    }
    __syncwarp();
    frame_bits<C>(a_pv, x0, Ww, el, false, keep, diag);
    g_row<C>(G, ew_nx, keep, diag, __shfl_sync(FULL, tv, 0), lo, tl, el, a_pv, ends_free, x0,
             lane);
#pragma unroll
    for (int k = 0; k < S::WORDS; ++k) w[k] = st[k];
    const int key = combine<C>(G, w, __shfl_sync(FULL, fmv, 0), x0, Ww, badk);
    if (lane == 0) kr = key;
    K[(size_t)b * NR + lo + lane] = kr;
    __syncwarp();  // every lane is done with stage[cur] before it is refilled
    a_cur = a_pv;
    a_pv = a_pv2;
    fmv = fm_nx;
    tv = tv_nx;
    cur ^= 1;
#pragma unroll
    for (int c = 0; c <= C; ++c) ew[c] = ew_nx[c];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int C>
int launch(const void* t, int LT, const void* t_len, const void* e, int LE, const void* e_len,
           const void* anchors, int B, int Ww, int n_rows, int ends_free, void* Fu, void* Fm,
           void* K, void* stream) {
  vote_dp_kernel<C><<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(t), LT, static_cast<const int32_t*>(t_len),
      static_cast<const uint8_t*>(e), LE, static_cast<const int32_t*>(e_len),
      static_cast<const int32_t*>(anchors), Ww, n_rows, ends_free, static_cast<uint8_t*>(Fu),
      static_cast<int32_t*>(Fm), static_cast<int32_t*>(K));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t uint8[B, LT] (LT >= n_rows), t_len int32[B], e uint8[B, LE], e_len
// int32[B], anchors int32[B, n_rows/32] (the band start of rows 0, 32, ...);
// scratch Fu uint8[B, n_rows+1, row_lanes] and Fm int32[B, n_rows+1]; out K
// int32[B, n_rows+1], the least combine key of every row.  Launches on
// `stream` and returns cudaGetLastError() of the launch, -1 for a band
// outside 1..256, -2 for n_rows not a positive multiple of 32 or above LT,
// -3 for row_lanes other than canu_vote_dp_row_lanes(band).
extern "C" int canu_vote_dp_row_lanes(int band) {
  return band + SMAX * SROW <= 256 ? 256 : 384;
}

extern "C" int canu_vote_dp(const void* t, int LT, const void* t_len, const void* e, int LE,
                            const void* e_len, const void* anchors, int B, int band, int n_rows,
                            int ends_free, int row_lanes, void* Fu, void* Fm, void* K,
                            void* stream) {
  if (band < 1 || band > 256) return -1;
  if (n_rows < SROW || n_rows % SROW != 0 || n_rows > LT) return -2;
  if (row_lanes != canu_vote_dp_row_lanes(band)) return -3;
  if (B <= 0) return 0;
  const int Ww = band + SMAX * SROW;
  if (row_lanes == 256)
    return launch<8>(t, LT, t_len, e, LE, e_len, anchors, B, Ww, n_rows, ends_free, Fu, Fm, K,
                     stream);
  return launch<12>(t, LT, t_len, e, LE, e_len, anchors, B, Ww, n_rows, ends_free, Fu, Fm, K,
                    stream);
}
