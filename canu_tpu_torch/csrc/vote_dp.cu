// Kernel K4: the vote engine's banded forward + backward DP in the window
// frame, two warps a job (the passes at once), one launch a group of
// chunks.
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
//            i <= tl, else INF16.  Read back as Fm(i) = min over the Ww
//            lanes and Fu(i, x) = 255 where F >= INF16, else clamp(F - Fm,
//            0, 254).
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
// G is never negative (s(x) >= x before the suffix min), so an int16 holds
// it exactly.
//
// Rows past T = clamp(tl, 0, n_rows) are INF16 in F and in G (or G starts
// there, at bnd), so nothing there reaches a row <= T: the kernel computes
// rows 0..T only, and gives rows past T the key BAD * Ww, which
// ops/trace.py _positions clamps to and masks anyway.
//
// Replaces canu_tpu/ops/trace.py:175 align_positions_lean, a jax.jit XLA
// program (an outer lax.scan over super-rows with their 32 rows unrolled)
// with no pl.pallas_call.
//
// What bounds it on an H100: the operations, ~32 a live cell of both
// passes (4.0e9 a chunk of 256 jobs x 2,048 rows at band 256: 0.24 ms at
// the int32 rate), over the bytes.  Every cell needs the row before and
// the closure crosses the whole window, so a job is a chain of dependent
// rows whose latency rules unless many jobs run at once.  The design:
//   - two warps a job: warp 0 runs the forward pass up from row 0, warp 1
//     the backward pass down from row T, at the same time.  They meet at
//     M = 32 * round(T / 64), a super-row boundary: the forward warp stores
//     rows 0..M (uint8 Fu and int32 Fm), the backward warp rows M+1..T (G
//     as int16), then one named barrier for the pair; after it the forward
//     warp folds the combine into rows M+1..T (its F normalized as the
//     stored rows are, the G rows staged), the backward warp into rows
//     M..0 (the F rows staged).  Each warp's chain is T + 1 rows, against
//     2 x (n_rows + 1) for one warp running both passes;
//   - each lane holds C = 8 or 12 contiguous cells of the row in registers
//     (Ww padded to 32*C lanes; the pad cells are held at INF16 on every
//     row: they are the wall the backward diagonal reads past the window,
//     and no closure or minimum reads them otherwise);
//   - the closure: an in-lane prefix min (forward) or suffix min
//     (backward), then a 5-step shuffle scan of the lanes' ends
//     (__shfl_up_sync forward, __shfl_down_sync backward), so the backward
//     rows keep the true lane order and the combine's first-lane tie rule
//     needs no reversal;
//   - no load on a row's chain: the evidence window of a frame, the
//     template characters (one a lane a super-row) and the anchors are
//     loaded a super-row ahead; after the barrier each warp stages the
//     other's rows 8 at a time into shared memory by cp.async, double
//     buffered (21,504 bytes of dynamic shared memory a block at 12 cells
//     a lane); the row minimum and the least key are one
//     __reduce_min_sync each;
//   - the re-anchoring shift, once a super-row, goes through shared memory;
//   - one launch takes every job of a group of chunks (thousands of
//     64-thread blocks), longest first (the caller's order); jobs end at
//     their own T, and the shorter jobs that follow fill the freed slots;
//   - __launch_bounds__(64, 10): 96 registers a thread and no spills, so
//     registers and shared memory both allow 10 blocks (20 warps) an SM.
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
constexpr int STG = 8;  // rows a staged piece (a quarter super-row)

template <int C>
struct Shape {
  static constexpr int W32 = 32 * C;      // lanes of a stored row (Ww padded)
  static constexpr int WORDS = C / 4;     // a lane's Fu bytes, as words
  static constexpr int GWORDS = C / 2;    // a lane's int16 G cells, as words
  static constexpr int ROW_WORDS = W32 / 4;
  static constexpr int GROW_WORDS = W32 / 2;
  // shared memory: two staged F pieces, two staged G pieces, a shift row a warp
  static constexpr int SMEM_BYTES = 4 * (2 * STG * (ROW_WORDS + GROW_WORDS) + 2 * W32);
  static_assert(SMEM_BYTES <= 48 * 1024, "launched without opting in to more shared memory");
};

// One job's inputs and geometry.
struct Job {
  const uint8_t* trow;
  const uint8_t* erow;
  const int32_t* A;
  int LE, Ww, tl, el, T, M, badk;
  bool ends_free;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The job's two warps meet: each has stored the rows the other reads next.
__device__ __forceinline__ void pair_barrier() {
  __threadfence_block();
  asm volatile("bar.sync 1, 64;\n" ::: "memory");
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

// Start copying STG rows of ROW_BYTES each from src into shared memory.
template <int ROW_BYTES>
__device__ __forceinline__ void stage_rows(uint32_t* dst, const void* src, int lane) {
  constexpr int PIECES = STG * ROW_BYTES / 16;
  static_assert(PIECES % 32 == 0, "whole 16-byte pieces a lane");
  const uint8_t* s = static_cast<const uint8_t*>(src);
#pragma unroll
  for (int u = 0; u < PIECES / 32; ++u) {
    const int q = lane + 32 * u;
    cp_async16(dst + 4 * q, s + 16 * q);
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

// The least F over the row's Ww lanes.
template <int C>
__device__ __forceinline__ int row_min(const int (&F)[C], int x0, int Ww) {
  int mn = INT_MAX;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (x0 + c < Ww) mn = min(mn, F[c]);
  return __reduce_min_sync(FULL, mn);
}

// F's uint8 read-back: 255 where F >= INF16, else clamp(F - fm, 0, 254).
__device__ __forceinline__ int fu_of(int f, int fm) {
  return f >= INF16 ? 255 : min(max(f - fm, 0), 254);
}

// Store forward row F as Fu (uint8, the lane's C bytes as words) and Fm.
template <int C>
__device__ __forceinline__ void store_row(const int (&F)[C], int x0, int Ww, uint8_t* furow,
                                          int32_t* fm, int lane) {
  const int mn = row_min<C>(F, x0, Ww);
  uint32_t w[Shape<C>::WORDS];
#pragma unroll
  for (int k = 0; k < Shape<C>::WORDS; ++k) w[k] = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) w[c >> 2] |= uint32_t(fu_of(F[c], mn)) << (8 * (c & 3));
  uint32_t* dst = reinterpret_cast<uint32_t*>(furow + x0);
#pragma unroll
  for (int k = 0; k < Shape<C>::WORDS; ++k) dst[k] = w[k];
  if (lane == 0) *fm = mn;
}

// Store backward row G exactly, as int16 (the lane's C cells as words).
template <int C>
__device__ __forceinline__ void store_g(const int (&G)[C], int16_t* grow, int x0) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(grow + x0);
#pragma unroll
  for (int k = 0; k < Shape<C>::GWORDS; ++k)
    dst[k] = uint32_t(G[2 * k]) | (uint32_t(G[2 * k + 1]) << 16);
}

// The combine's two halves of one lane-cell.
__device__ __forceinline__ int fkey(int fu, int fm, int x, int Ww, int badk) {
  return (fu == 255 || fm >= INF16) ? badk : (fm + fu) * Ww + x;
}

__device__ __forceinline__ int gkey(int g, int Ww, int badk) {
  return g >= INF16 ? badk : g * Ww;
}

// The least combine key of a row, backward side: G in registers, the
// forward row's bytes w (this lane's) and its minimum fm.
template <int C>
__device__ __forceinline__ int combine_b(const int (&G)[C], const uint32_t* w, int fm, int x0,
                                         int Ww, int badk) {
  int best = INT_MAX;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = x0 + c;
    const int fu = (w[c >> 2] >> (8 * (c & 3))) & 255;
    if (x < Ww) best = min(best, fkey(fu, fm, x, Ww, badk) + gkey(G[c], Ww, badk));
  }
  return __reduce_min_sync(FULL, best);
}

// The least combine key of a row, forward side: F in registers, read back
// through its row minimum as a stored row would be, and the staged G words
// gw (this lane's).
template <int C>
__device__ __forceinline__ int combine_f(const int (&F)[C], const uint32_t* gw, int x0, int Ww,
                                         int badk) {
  const int fm = row_min<C>(F, x0, Ww);
  int best = INT_MAX;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int x = x0 + c;
    const int g = (gw[c >> 1] >> (16 * (c & 1))) & 0xFFFF;
    if (x < Ww) best = min(best, fkey(fu_of(F[c], fm), fm, x, Ww, badk) + gkey(g, Ww, badk));
  }
  return __reduce_min_sync(FULL, best);
}

// Re-anchor a row held in registers by d lanes through shared memory: lane
// x takes lane x + d (the forward pass) or x - d (the backward pass, which
// passes -d), INF16 outside 0..Ww-1.
template <int C>
__device__ __forceinline__ void shift_row(int (&R)[C], int* xs, int d, int x0, int Ww) {
#pragma unroll
  for (int c = 0; c < C; ++c) xs[x0 + c] = R[c];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = x0 + c + d;
    R[c] = x0 + c < Ww && k >= 0 && k < Ww ? xs[k] : INF16;
  }
  __syncwarp();
}

// Forward row i from row i - 1, both in the frame of a super-row (every
// row the kernel computes is live: i <= T <= tl).
template <int C>
__device__ __forceinline__ void f_row(int (&F)[C], const int (&ew)[C + 1], unsigned keep,
                                      unsigned diag, int tc, int x0, int lane) {
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
    F[c] = (keep >> c) & 1 ? min(min(m[c], in) + x0 + c, INF16) : INF16;
}

// Backward row i from row i + 1, both in the frame of a super-row (every
// row the kernel computes below T is kept: i < T <= tl).
template <int C>
__device__ __forceinline__ void g_row(int (&G)[C], const int (&ew)[C + 1], unsigned keep,
                                      unsigned diag, int tc, int x0, int lane) {
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
#pragma unroll
  for (int c = 0; c < C; ++c)
    G[c] = (keep >> c) & 1 ? min(min(s[c], in) - (x0 + c), INF16) : INF16;
}

// Warp 0: F rows 0..M stored, then rows M+1..T combined with the staged G
// rows (slot i - M - 1 of the job's G scratch).
template <int C>
__device__ __forceinline__ void forward_warp(const Job& J, uint8_t* fu_b, int32_t* fm_b,
                                             const int16_t* g_b, int32_t* K_b, int n_rows,
                                             uint32_t* gst, int* xs, int lane) {
  using S = Shape<C>;
  const int x0 = lane * C;
  const int m = J.M / SROW;
  const int pT = J.T > 0 ? (J.T - 1) / SROW : -1;  // the last super-row holding a row <= T
  const int n_g = J.T - J.M;                       // G rows staged after the meeting
  for (int i = J.T + 1 + lane; i <= n_rows; i += 32) K_b[i] = J.badk;
  int a_cur = J.A[0];
  int a_nx = pT >= 1 ? J.A[1] : 0;
  int ew[C + 1], ew_nx[C + 1];
#pragma unroll
  for (int c = 0; c <= C; ++c) ew_nx[c] = 0;
  load_window<C>(ew, J.erow, J.LE, a_cur, x0);
  int tv = J.trow[lane];
  int F[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = a_cur + x0 + c;
    F[c] = x0 + c < J.Ww && j <= J.el ? (J.ends_free ? 0 : j) : INF16;
  }
  store_row<C>(F, x0, J.Ww, fu_b, fm_b, lane);
  if (m == 0) {
    pair_barrier();
    if (n_g > 0) stage_rows<2 * S::W32>(gst, g_b, lane);
    cp_async_commit();
  }
  int a_prev = a_cur;
  int piece = -1;
  unsigned keep, diag;
#pragma unroll 1
  for (int p = 0; p <= pT; ++p) {
    const int lo = p * SROW;
    int a_nx2 = 0, tv_nx = 0;
    if (p + 1 <= pT) {  // the next super-row's loads, used a super-row on
      load_window<C>(ew_nx, J.erow, J.LE, a_nx, x0);
      tv_nx = J.trow[lo + SROW + lane];
      if (p + 2 <= pT) a_nx2 = J.A[p + 2];
    }
    if (p > 0) shift_row<C>(F, xs, a_cur - a_prev, x0, J.Ww);  // re-anchor at a_p
    frame_bits<C>(a_cur, x0, J.Ww, J.el, true, keep, diag);
    if (p < m) {
#pragma unroll 1
      for (int r = 0; r < SROW; ++r) {
        const int i = lo + r + 1;
        f_row<C>(F, ew, keep, diag, __shfl_sync(FULL, tv, r), x0, lane);
        store_row<C>(F, x0, J.Ww, fu_b + (size_t)i * S::W32, fm_b + i, lane);
      }
      if (p == m - 1) {
        pair_barrier();
        if (n_g > 0) stage_rows<2 * S::W32>(gst, g_b, lane);
        cp_async_commit();
      }
    } else {
      const int nr = min(SROW, J.T - lo);
      int kr = 0;
#pragma unroll 1
      for (int r = 0; r < nr; ++r) {
        const int s = lo + r - J.M;  // row lo + r + 1's G slot
        if (s % STG == 0) {          // the first row of a staged piece
          ++piece;
          __syncwarp();  // every lane is done with the buffer refilled next
          if (s + STG < n_g)
            stage_rows<2 * S::W32>(gst + ((piece + 1) & 1) * STG * S::GROW_WORDS,
                                   g_b + (size_t)(s + STG) * S::W32, lane);
          cp_async_commit();
          cp_async_wait_1();
          __syncwarp();
        }
        f_row<C>(F, ew, keep, diag, __shfl_sync(FULL, tv, r), x0, lane);
        const uint32_t* gw =
            gst + (piece & 1) * STG * S::GROW_WORDS + (s % STG) * S::GROW_WORDS + lane * S::GWORDS;
        const int key = combine_f<C>(F, gw, x0, J.Ww, J.badk);
        if (lane == r) kr = key;
      }
      if (lane < nr) K_b[lo + 1 + lane] = kr;
    }
    a_prev = a_cur;
    a_cur = a_nx;
    a_nx = a_nx2;
    tv = tv_nx;
#pragma unroll
    for (int c = 0; c <= C; ++c) ew[c] = ew_nx[c];
  }
  cp_async_wait_all();
}

// Warp 1: G rows T..M+1 stored, then rows M..0 combined with the staged F
// rows.
template <int C>
__device__ __forceinline__ void backward_warp(const Job& J, const uint8_t* fu_b,
                                              const int32_t* fm_b, int16_t* g_b, int32_t* K_b,
                                              uint32_t* fst, int* xs, int lane) {
  using S = Shape<C>;
  const int x0 = lane * C;
  const int m = J.M / SROW;
  const int pT = J.T > 0 ? (J.T - 1) / SROW : 0;  // the frame of row T
  int a_cur = J.A[pT];
  int a_pv = J.A[pT >= 1 ? pT - 1 : 0];
  int ew[C + 1], ew_nx[C + 1];
#pragma unroll
  for (int c = 0; c <= C; ++c) ew_nx[c] = 0;
  load_window<C>(ew, J.erow, J.LE, a_cur, x0);
  unsigned keep, diag;
  frame_bits<C>(a_cur, x0, J.Ww, J.el, false, keep, diag);
  int G[C];
#pragma unroll
  for (int c = 0; c < C; ++c)
    G[c] = J.tl == J.T && ((keep >> c) & 1) ? (J.ends_free ? 0 : J.el - (a_cur + x0 + c))
                                            : INF16;
  int tv = J.trow[pT * SROW + lane];
  if (J.T > J.M) {
    store_g<C>(G, g_b + (size_t)(J.T - J.M - 1) * S::W32, x0);
#pragma unroll 1
    for (int p = pT;; --p) {  // down to p = m, whose row 32m = M is computed, not stored
      const int lo = p * SROW;
      const int a_pv2 = J.A[p >= 2 ? p - 2 : 0];
      load_window<C>(ew_nx, J.erow, J.LE, a_pv, x0);  // frame p-1: row lo, then super-row p-1
      const int tv_nx = p > 0 ? J.trow[lo - SROW + lane] : 0;
#pragma unroll 1
      for (int i = min(lo + SROW, J.T) - 1; i > lo; --i) {
        g_row<C>(G, ew, keep, diag, __shfl_sync(FULL, tv, i - lo), x0, lane);
        store_g<C>(G, g_b + (size_t)(i - J.M - 1) * S::W32, x0);
      }
      // row lo lies in frame a_{p-1}: re-anchor (lane x takes lane x - d), then compute it
      shift_row<C>(G, xs, a_pv - a_cur, x0, J.Ww);
      frame_bits<C>(a_pv, x0, J.Ww, J.el, false, keep, diag);
      g_row<C>(G, ew_nx, keep, diag, __shfl_sync(FULL, tv, 0), x0, lane);
      a_cur = a_pv;
      a_pv = a_pv2;
      tv = tv_nx;
#pragma unroll
      for (int c = 0; c <= C; ++c) ew[c] = ew_nx[c];
      if (p == m) break;
      store_g<C>(G, g_b + (size_t)(lo - J.M - 1) * S::W32, x0);
    }
  }
  // G holds row M (in frame m-1, or 0), a_cur that frame's anchor
  pair_barrier();
  {
    uint32_t w[S::WORDS];
    const uint32_t* src = reinterpret_cast<const uint32_t*>(fu_b + (size_t)J.M * S::W32 + x0);
#pragma unroll
    for (int k = 0; k < S::WORDS; ++k) w[k] = src[k];
    const int key = combine_b<C>(G, w, fm_b[J.M], x0, J.Ww, J.badk);
    if (lane == 0) K_b[J.M] = key;
  }
  if (m == 0) return;
  stage_rows<S::W32>(fst, fu_b + (size_t)(J.M - STG) * S::W32, lane);
  cp_async_commit();
  int fmv = fm_b[J.M - SROW + lane];
  int piece = -1;
#pragma unroll 1
  for (int p = m - 1; p >= 0; --p) {
    const int lo = p * SROW;
    const int a_pv2 = J.A[p >= 2 ? p - 2 : 0];
    load_window<C>(ew_nx, J.erow, J.LE, a_pv, x0);  // frame p-1: row lo, then super-row p-1
    int fm_nx = 0, tv_nx = 0;
    if (p > 0) {
      fm_nx = fm_b[lo - SROW + lane];
      tv_nx = J.trow[lo - SROW + lane];
    }
    int kr = 0;
    int base = 0;  // the staged piece's lowest row
    const uint32_t* st = nullptr;
#pragma unroll 1
    for (int r = SROW - 1; r >= 0; --r) {
      const int i = lo + r;
      if ((r + 1) % STG == 0) {  // the first (highest) row of a staged piece: rows i-STG+1..i
        ++piece;
        base = i + 1 - STG;
        __syncwarp();  // every lane is done with the buffer refilled next
        if (base >= STG)
          stage_rows<S::W32>(fst + ((piece + 1) & 1) * STG * S::ROW_WORDS,
                             fu_b + (size_t)(base - STG) * S::W32, lane);
        cp_async_commit();
        cp_async_wait_1();
        __syncwarp();
        st = fst + (piece & 1) * STG * S::ROW_WORDS + lane * S::WORDS;
      }
      if (r > 0) {
        g_row<C>(G, ew, keep, diag, __shfl_sync(FULL, tv, r), x0, lane);
      } else {  // row lo lies in frame a_{p-1}: re-anchor, then compute it
        shift_row<C>(G, xs, a_pv - a_cur, x0, J.Ww);
        frame_bits<C>(a_pv, x0, J.Ww, J.el, false, keep, diag);
        g_row<C>(G, ew_nx, keep, diag, __shfl_sync(FULL, tv, 0), x0, lane);
      }
      const int key = combine_b<C>(G, st + (i - base) * S::ROW_WORDS, __shfl_sync(FULL, fmv, r),
                                   x0, J.Ww, J.badk);
      if (lane == r) kr = key;
    }
    K_b[lo + lane] = kr;
    a_cur = a_pv;
    a_pv = a_pv2;
    fmv = fm_nx;
    tv = tv_nx;
#pragma unroll
    for (int c = 0; c <= C; ++c) ew[c] = ew_nx[c];
  }
  cp_async_wait_all();
}

template <int C>
__global__ void __launch_bounds__(64, 10) vote_dp_kernel(
    const uint8_t* __restrict__ t, int LT, const int32_t* __restrict__ t_len,
    const uint8_t* __restrict__ e, int LE, const int32_t* __restrict__ e_len,
    const int32_t* __restrict__ anchors, const int32_t* __restrict__ order, int Ww, int n_rows,
    int ends_free, int half_rows, uint8_t* __restrict__ Fu, int32_t* __restrict__ Fm,
    int16_t* __restrict__ Gs, int32_t* __restrict__ K) {
  using S = Shape<C>;
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = order[blockIdx.x];
  const int Q = n_rows / SROW;
  Job J;
  J.trow = t + (size_t)b * LT;
  J.erow = e + (size_t)b * LE;
  J.A = anchors + (size_t)b * Q;
  J.LE = LE;
  J.Ww = Ww;
  J.tl = t_len[b];
  J.el = e_len[b];
  J.T = min(max(J.tl, 0), n_rows);
  J.M = SROW * ((J.T + SROW) / (2 * SROW));
  J.badk = BAD * Ww;
  J.ends_free = ends_free != 0;
  uint8_t* fu_b = Fu + (size_t)b * (half_rows + 1) * S::W32;
  int32_t* fm_b = Fm + (size_t)b * (half_rows + 1);
  int16_t* g_b = Gs + (size_t)b * half_rows * S::W32;
  int32_t* K_b = K + (size_t)b * (n_rows + 1);
  uint32_t* fst = smem;
  uint32_t* gst = fst + 2 * STG * S::ROW_WORDS;
  int* xs = reinterpret_cast<int*>(gst + 2 * STG * S::GROW_WORDS) + warp * S::W32;
  if (warp == 0)
    forward_warp<C>(J, fu_b, fm_b, g_b, K_b, n_rows, gst, xs, lane);
  else
    backward_warp<C>(J, fu_b, fm_b, g_b, K_b, fst, xs, lane);
}

template <int C>
int launch(const void* t, int LT, const void* t_len, const void* e, int LE, const void* e_len,
           const void* anchors, const void* order, int B, int Ww, int n_rows, int ends_free,
           int half_rows, void* Fu, void* Fm, void* Gs, void* K, void* stream) {
  constexpr int smem = Shape<C>::SMEM_BYTES;
  vote_dp_kernel<C><<<B, 64, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(t), LT, static_cast<const int32_t*>(t_len),
      static_cast<const uint8_t*>(e), LE, static_cast<const int32_t*>(e_len),
      static_cast<const int32_t*>(anchors), static_cast<const int32_t*>(order), Ww, n_rows,
      ends_free, half_rows,
      static_cast<uint8_t*>(Fu), static_cast<int32_t*>(Fm), static_cast<int16_t*>(Gs),
      static_cast<int32_t*>(K));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// t uint8[B, LT] (LT >= n_rows), t_len int32[B], e uint8[B, LE], e_len
// int32[B], anchors int32[B, n_rows/32] (the band start of rows 0, 32, ...),
// order int32[B] (a permutation of the jobs: block i runs job order[i], so
// the longest jobs can start first); scratch, H = canu_vote_dp_half_rows(n_rows): Fu uint8[B, H+1, row_lanes],
// Fm int32[B, H+1] and Gs int16[B, H, row_lanes]; out K int32[B, n_rows+1],
// the least combine key of every row.  Launches B blocks of two warps on
// `stream` and returns cudaGetLastError() of the launch, -1 for a band outside 1..256, -2 for n_rows not a
// positive multiple of 32 or above LT, -3 for row_lanes other than
// canu_vote_dp_row_lanes(band), -4 for half_rows other than H.
extern "C" int canu_vote_dp_row_lanes(int band) {
  return band + SMAX * SROW <= 256 ? 256 : 384;
}

// The most rows either warp stores before the meeting, over every t_len:
// 32 * ceil(n_rows / 64) (M = 32 * round(T / 64) <= it, and T - M <= it).
extern "C" int canu_vote_dp_half_rows(int n_rows) {
  return SROW * ((n_rows / SROW + 1) / 2);
}

extern "C" int canu_vote_dp(const void* t, int LT, const void* t_len, const void* e, int LE,
                            const void* e_len, const void* anchors, const void* order, int B,
                            int band, int n_rows, int ends_free, int row_lanes, int half_rows,
                            void* Fu, void* Fm, void* Gs, void* K, void* stream) {
  if (band < 1 || band > 256) return -1;
  if (n_rows < SROW || n_rows % SROW != 0 || n_rows > LT) return -2;
  if (row_lanes != canu_vote_dp_row_lanes(band)) return -3;
  if (half_rows != canu_vote_dp_half_rows(n_rows)) return -4;
  if (B <= 0) return 0;
  const int Ww = band + SMAX * SROW;
  if (row_lanes == 256)
    return launch<8>(t, LT, t_len, e, LE, e_len, anchors, order, B, Ww, n_rows, ends_free,
                     half_rows, Fu, Fm, Gs, K, stream);
  return launch<12>(t, LT, t_len, e, LE, e_len, anchors, order, B, Ww, n_rows, ends_free,
                    half_rows, Fu, Fm, Gs, K, stream);
}
