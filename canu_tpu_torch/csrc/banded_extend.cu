// Kernels K2 and K3: the INF-walled banded semi-global extension.
//
// Both compute exactly what the plain PyTorch loop
// canu_tpu_torch/ops/align.py:banded_extend_plain computes (the port of
// canu_tpu.ops.align.banded_extend), bit for bit, for bands that are a
// multiple of 128:
//   band start  cm(i) = max(cm(i-1), clip(centers[i] - band/2, 0, max(b_len, 0))),
//               o(i)  = min(cm(i), o(i-1) + SMAX), o(0) = cm(0);
//   row 0       D(w) = o(0) + w where o(0) + w <= b_len, else INF;
//   row i       m(w) = min(up + 1, diag + sub) with up = D'(w + s),
//               diag = D'(w + s - 1), s = o(i) - o(i-1), INF outside the
//               band and diag valid only for 1 <= j <= b_len (j = o(i)+w);
//               D(w) = prefixmin(min(m - w, INF)) + w where j <= b_len;
//   captures    B exhausted: D at j == b_len, strict '<', earliest row
//               (row 0 included); A exhausted: the first minimum of the
//               row i == a_len; the A-exhausted end wins ties.
// Cells can hold INF + w and those values reach the outputs of failed
// extensions; the int32 arithmetic is reproduced, nothing saturates.
// Rows past a_len change nothing, so each extension stops at
// min(a_len, n_rows).
//
// canu_extend_warp (K2, bands 128-512) replaces canu_tpu/ops/pallas/
// extend_x8.py:_extend_x8_kernel (driven by banded_extend_pallas_x8), the
// engine of overlap verification at an ovlBandWidth other than 128;
// canu_extend_block (K3, bands 640-1024) replaces canu_tpu/ops/pallas/
// extend.py:_extend_kernel (driven by banded_extend_pallas), the same
// function one pair a program.  Both run one template, extend_kernel<C>:
// one warp per extension, each lane holding C = band/32 contiguous cells
// of the row in registers.  Blocks of WARPS = 4 extensions,
// __launch_bounds__ for MIN_BLOCKS = 5 of them an SM (C = 32 then takes
// 96 registers, 20 warps an SM) and an exit test every EXIT_EVERY = 8
// rows were within about 1% of the best of 2-16 warps, 1-8 blocks and
// 1-16 rows on the utg drives (PERF.md, section 6).
//
// What bounds them on an H100: a row is a dependent chain (the previous
// row's neighbour cells by shuffle, the closure across the lane's cells,
// a 5-step shuffle scan across the lanes), ~8k rows an extension, and a
// launch lasts as long as its longest extension.  What the design does:
//   - the closure D(w) = min over w' <= w of m(w') + (w - w'), capped at
//     INF + w, runs as D(w) = min(D(w-1) + 1, m(w)) in the lane (one
//     __viaddmin_s32 a cell, Hopper's DPX add-min), then a scan of the
//     lanes' last cells (T = min(T, T_left + d*C), lane 0 seeded with
//     INF - 1, which is the cap) and one add-min a cell for the carry in;
//   - the shift by s (0..SMAX) in one step: the SMAX cells a lane needs
//     from its right neighbour and the one from its left come by five
//     independent shuffles, and a warp-uniform switch picks the register
//     offsets, fixed at compile time in each case;
//   - no load on a row's chain: the band start never depends on the DP,
//     so 32 rows' starts are computed at once (a prefix max and a prefix
//     min over the lanes, one row a lane) from centres loaded a block of
//     32 rows ahead, with the A characters; B comes from a window of band
//     + 256 bytes in shared memory that covers 32 rows (the band moves at
//     most SMAX columns a row), filled by cp.async a block ahead, double
//     buffered; a lane's C bytes are C/4 + 1 words at a stride that puts
//     the lanes on distinct banks (a pad word every C/4 words where C/4
//     is a power of two);
//   - the cells past b_len are left as they fall and not reset to INF in
//     the row loop: no cell with j <= b_len reads them (up and diag of
//     column j are columns j and j-1), and the cells left of a column
//     never depend on it; the exit test and the A-exhausted capture read
//     only cells with j <= b_len and count the others as INF;
//   - the B-exhausted capture reads its cell in the owning lane only;
//   - more extensions a launch (ops/align.py groups up to MYERS_GROUP
//     chunks into one call), so each SM scheduler holds several warps.
//
// Early exit.  Every cell of row i is at least min(smallest cell of row
// i-1, INF): m adds 0 or 1 to a cell of the row before or is INF + 1, the
// closure adds w - w' >= 0, and the cap is INF + w.  So once the
// smallest cell of a row exceeds best_bx (the best B-exhausted cost so
// far), no later row can lower it: the B-exhausted capture needs a cell
// below best_bx ('<'), and the A-exhausted minimum of row a_len is above
// it, so the tie rule (A exhausted wins on <=) cannot pick it.  The
// outputs are then (best_bx, aend_bx, bend_bx), and the warp stops:
// every EXIT_EVERY rows each lane takes the minimum of its cells with j
// <= b_len and one __all_sync tests them against best_bx.  best_bx == INF never
// exits (cell 0 is at most INF); b_len < 0 leaves best_bx at INF; with
// a_len > n_rows the A-exhausted end is INF and the test is the same.
// tests/torch_cases.py extend_exit_rows applies the same test to each row
// of banded_extend_plain, and the tests hold the captures at the exit row
// equal to its outputs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int INF = 1 << 28;
constexpr int SMAX = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS = 4;  // extensions (warps) a block
constexpr int MIN_BLOCKS = 5;  // blocks an SM must hold (__launch_bounds__)
constexpr int ROWS = 32;  // rows a schedule block: one a lane
constexpr int EXIT_EVERY = 8;  // rows between early-exit tests

__device__ __forceinline__ int clip_start(int c, int half, int bhi) {
  return min(max(c - half, 0), bhi);
}

constexpr int log2_exact(int q) { return q <= 1 ? 0 : 1 + log2_exact(q / 2); }

// The B window of one warp: logical word q holds B bytes wb + 4q .. +3;
// it lies at physical word q + (q >> SH) when a lane's C/4 words would
// put the lanes on shared banks (C/4 a power of two, at least 2).
template <int C>
struct Win {
  static constexpr int BAND = 32 * C;
  static constexpr int Q = C / 4;  // words of a lane's cells
  static constexpr bool SWZ = Q >= 2 && (Q & (Q - 1)) == 0;
  static constexpr int SH = log2_exact(Q);
  static constexpr int WORDS = BAND / 4 + 64;  // band + 256 bytes
  static constexpr int PER_LANE = WORDS / 32;
  static constexpr int STRIDE = SWZ ? Q + 1 : Q;  // physical words between lanes
  static constexpr int PHYS = SWZ ? WORDS + (WORDS >> SH) + 1 : WORDS;
  __device__ static __forceinline__ int phys(int q) { return SWZ ? q + (q >> SH) : q; }
};

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start filling a window with B bytes from wb on (positions clamped into
// [0, LB - 1], as the plain loop's gather clamps them).
template <int C>
__device__ __forceinline__ void fill(uint32_t* buf, const uint8_t* brow, int LB, int wb,
                                     int lane, bool aligned) {
#pragma unroll
  for (int u = 0; u < Win<C>::PER_LANE; ++u) {
    const int q = lane + 32 * u;
    const int p = wb + 4 * q;
    uint32_t* dst = buf + Win<C>::phys(q);
    if (aligned && p >= 0 && p + 4 <= LB) {
      cp_async4(dst, brow + p);
    } else {
      uint32_t v = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) v |= uint32_t(brow[min(max(p + k, 0), LB - 1)]) << (8 * k);
      *dst = v;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Band starts and A characters of the rows i0 .. i0+31 (one a lane) from
// each lane's centre and A byte; cm_c and o_c carry cm and o of row i0-1
// in and the block's last row out.
__device__ __forceinline__ void schedule(int cen_v, int i0, int lane, int half, int bhi,
                                         int& cm_c, int& o_c, int& ov) {
  const int row = i0 + lane;
  int cm = clip_start(cen_v, half, bhi);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, cm, d);
    if (lane >= d) cm = max(cm, v);
  }
  cm = max(cm, cm_c);
  // o(i) - SMAX*i = min(cm(i) - SMAX*i, o(i-1) - SMAX*(i-1))
  int t = cm - SMAX * row;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, t, d);
    if (lane >= d) t = min(t, v);
  }
  t = min(t, o_c - SMAX * (i0 - 1));
  ov = t + SMAX * row;
  cm_c = __shfl_sync(FULL, cm, 31);
  o_c = __shfl_sync(FULL, ov, 31);
}

// m(c) = min(up + 1, diag + sub) for a shift of S: up = X(c + S), diag =
// X(c + S - 1) over X = [P, D[0..C-1], N[0..SMAX-1]].  The diagonal's
// validity needs no test here: j < 1 is lane 0's cell 0 at o(i) = 0,
// where P is INF and the cap INF + 0 rules; j > b_len cells are not read.
template <int C, int S>
__device__ __forceinline__ void row_m(int (&m)[C], const int (&D)[C], const int (&N)[SMAX],
                                      int P, const uint32_t (&ms)[C / 4]) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = c + S;
    const int up = k < C ? D[k < C ? k : 0] : N[k >= C ? k - C : 0];
    const int dk = k - 1;
    const int dg = dk < 0 ? P : (dk < C ? D[dk >= 0 && dk < C ? dk : 0] : N[dk >= C ? dk - C : 0]);
    const int sub = static_cast<int>(__byte_perm(ms[c >> 2], 0u, 0x4440u | unsigned(c & 3)));
    m[c] = __viaddmin_s32(up, 1, dg + sub);
  }
}

// D[k] for a lane-varying k, in the one lane that asks (a jump, not C selects)
#define PICK_CASE(k) \
  case k:                              \
    if constexpr (k < C) v = D[k < C ? k : 0]; \
    break;

template <int C>
__device__ __forceinline__ int pick(const int (&D)[C], int k) {
  int v = INF;
  switch (k) {
    PICK_CASE(0) PICK_CASE(1) PICK_CASE(2) PICK_CASE(3) PICK_CASE(4) PICK_CASE(5)
    PICK_CASE(6) PICK_CASE(7) PICK_CASE(8) PICK_CASE(9) PICK_CASE(10) PICK_CASE(11)
    PICK_CASE(12) PICK_CASE(13) PICK_CASE(14) PICK_CASE(15) PICK_CASE(16) PICK_CASE(17)
    PICK_CASE(18) PICK_CASE(19) PICK_CASE(20) PICK_CASE(21) PICK_CASE(22) PICK_CASE(23)
    PICK_CASE(24) PICK_CASE(25) PICK_CASE(26) PICK_CASE(27) PICK_CASE(28) PICK_CASE(29)
    PICK_CASE(30) PICK_CASE(31)
    default: break;
  }
  return v;
}
#undef PICK_CASE

template <int C>
__global__ void __launch_bounds__(32 * WARPS, MIN_BLOCKS) extend_kernel(
    const uint8_t* __restrict__ a, int LA, const int32_t* __restrict__ a_len,
    const uint8_t* __restrict__ b, int LB, const int32_t* __restrict__ b_len,
    const int32_t* __restrict__ centers, int n_cen, int B, int n_rows,
    int32_t* __restrict__ out) {
  using W = Win<C>;
  constexpr int BAND = W::BAND;
  constexpr int Q = W::Q;
  __shared__ uint32_t win[WARPS][2][W::PHYS];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int x = blockIdx.x * WARPS + wid;
  if (x >= B) return;  // x is uniform across the warp

  const int alen = a_len[x];
  const int blen = b_len[x];
  const int bhi = max(blen, 0);
  const int32_t* cen = centers + (size_t)x * n_cen;
  const uint8_t* arow = a + (size_t)x * LA;
  const uint8_t* brow = b + (size_t)x * LB;
  const bool aligned = (reinterpret_cast<uintptr_t>(brow) & 3) == 0;
  const int w0 = lane * C;
  constexpr int half = BAND / 2;

  int cm_c = clip_start(cen[0], half, bhi);
  int o = cm_c;  // o of the row before
  int o_c = o;
  int D[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = o + w0 + c;
    D[c] = j <= blen ? j : INF;
  }
  // B exhausted at row 0: D0 at j == b_len is b_len itself
  const int wcol0 = blen - o;
  const bool in0 = wcol0 >= 0 && wcol0 < BAND;
  int best_bx = in0 ? blen : INF;
  int aend_bx = 0;
  int bend_bx = in0 ? blen : 0;

  const int last = min(n_rows, alen);
  bool exited = false;
  if (last >= 1) {
    // the first two blocks' centres and A characters, the first block's
    // schedule and B window
    int cen_v = 0, a_v = 0, cen_nx = 0, a_nx = 0;
    if (1 + lane <= last) {
      cen_v = cen[1 + lane];
      a_v = arow[min(lane, LA - 1)];
    }
    if (1 + ROWS + lane <= last) {
      cen_nx = cen[1 + ROWS + lane];
      a_nx = arow[min(ROWS + lane, LA - 1)];
    }
    int ov;
    schedule(cen_v, 1, lane, half, bhi, cm_c, o_c, ov);
    int av = a_v;
    int wb = (__shfl_sync(FULL, ov, 0) - 1) & ~3;
    int cur = 0;
    fill<C>(win[wid][0], brow, LB, wb, lane, aligned);
    cp_async_wait();
    __syncwarp();

    for (int i0 = 1; i0 <= last; i0 += ROWS) {
      const int nb = i0 + ROWS;
      int ov_nx = 0, av_nx = 0, wb_nx = 0;
      if (nb <= last) {  // the next block's schedule and window, and the loads after it
        schedule(cen_nx, nb, lane, half, bhi, cm_c, o_c, ov_nx);
        av_nx = a_nx;
        wb_nx = (__shfl_sync(FULL, ov_nx, 0) - 1) & ~3;
        fill<C>(win[wid][cur ^ 1], brow, LB, wb_nx, lane, aligned);
        cen_nx = a_nx = 0;
        if (nb + ROWS + lane <= last) {
          cen_nx = cen[nb + ROWS + lane];
          a_nx = arow[min(nb + ROWS + lane - 1, LA - 1)];
        }
      }
      const uint32_t* pl = win[wid][cur] + lane * W::STRIDE;
      const int nrow = min(ROWS, last - i0 + 1);
#pragma unroll 1
      for (int t = 0; t < nrow; ++t) {
        const int o_i = __shfl_sync(FULL, ov, t);
        const int ach = __shfl_sync(FULL, av, t);
        const int s = o_i - o;  // warp-uniform, 0..SMAX
        int N[SMAX];
#pragma unroll
        for (int k = 0; k < SMAX; ++k) {
          N[k] = __shfl_down_sync(FULL, D[k], 1);
          if (lane == 31) N[k] = INF;
        }
        int P = __shfl_up_sync(FULL, D[C - 1], 1);
        if (lane == 0) P = INF;

        // the lane's B bytes at j - 1 = o_i + w0 - 1 .. + C - 1, against A
        const int rel = o_i - 1 - wb;
        const int r4 = rel >> 2;
        const int sh8 = (rel & 3) * 8;
        uint32_t Wd[Q + 1];
#pragma unroll
        for (int k = 0; k <= Q; ++k) Wd[k] = pl[W::SWZ ? r4 + k + ((r4 + k) >> W::SH) : r4 + k];
        const uint32_t a4 = uint32_t(ach) * 0x01010101u;
        uint32_t ms[Q];
#pragma unroll
        for (int k = 0; k < Q; ++k) ms[k] = __vsetne4(__funnelshift_r(Wd[k], Wd[k + 1], sh8), a4);

        int m[C];
        switch (s) {
          case 0: row_m<C, 0>(m, D, N, P, ms); break;
          case 1: row_m<C, 1>(m, D, N, P, ms); break;
          case 2: row_m<C, 2>(m, D, N, P, ms); break;
          case 3: row_m<C, 3>(m, D, N, P, ms); break;
          default: row_m<C, 4>(m, D, N, P, ms); break;
        }
        // the closure: in the lane, then across the lanes' last cells
#pragma unroll
        for (int c = 1; c < C; ++c) m[c] = __viaddmin_s32(m[c - 1], 1, m[c]);
        int T = min(m[C - 1], INF + w0 + C - 1);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) T = __viaddmin_s32(__shfl_up_sync(FULL, T, d), d * C, T);
        int in = __shfl_up_sync(FULL, T, 1);
        if (lane == 0) in = INF - 1;
#pragma unroll
        for (int c = 0; c < C; ++c) D[c] = __viaddmin_s32(in, c + 1, m[c]);
        o = o_i;

        // B exhausted at this row: the column j == b_len, in its owning lane
        const int wcol = blen - o;
        if (wcol >= 0 && wcol < BAND) {
          const int owner = wcol / C;
          int v = 0;
          if (lane == owner) v = pick<C>(D, wcol - owner * C);
          const int cost = __shfl_sync(FULL, v, owner);
          if (cost < best_bx) {
            best_bx = cost;
            aend_bx = i0 + t;
            bend_bx = blen;
          }
        }
        if (t % EXIT_EVERY == EXIT_EVERY - 1) {  // outputs fixed: stop
          int mn = INF;
          if (wcol >= BAND) {
#pragma unroll
            for (int c = 0; c < C; ++c) mn = min(mn, D[c]);
          } else {
            const int lim = wcol - w0;
#pragma unroll
            for (int c = 0; c < C; ++c) mn = min(mn, c <= lim ? D[c] : INF);
          }
          if (__all_sync(FULL, mn > best_bx)) {
            exited = true;
            break;
          }
        }
      }
      if (exited) break;
      if (nb <= last) {
        cp_async_wait();
        __syncwarp();
        ov = ov_nx;
        av = av_nx;
        wb = wb_nx;
        cur ^= 1;
      }
    }
    cp_async_wait();
  }

  if (exited) {
    if (lane == 0) {
      out[x] = best_bx;
      out[(size_t)B + x] = aend_bx;
      out[(size_t)2 * B + x] = bend_bx;
    }
    return;
  }
  // A exhausted: the first minimum of row a_len over its cells with j <=
  // b_len, the others INF (all INF if a_len is not a row of the extension)
  const bool fin = alen >= 0 && alen <= n_rows;
  const int lim = blen - o - w0;
  int bv = fin && 0 <= lim ? D[0] : INF;
  int bi = w0;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const int v = fin && c <= lim ? D[c] : INF;
    if (v < bv) {
      bv = v;
      bi = w0 + c;
    }
  }
  if (!fin) bi = 0;
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    const int ov = __shfl_xor_sync(FULL, bv, d);
    const int oi = __shfl_xor_sync(FULL, bi, d);
    if (ov < bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    const bool use_ax = bv <= best_bx;
    out[x] = use_ax ? bv : best_bx;
    out[(size_t)B + x] = use_ax ? alen : aend_bx;
    out[(size_t)2 * B + x] = use_ax ? (fin ? o : 0) + bi : bend_bx;
  }
}

template <int C>
int launch(const void* a, int LA, const void* a_len, const void* b, int LB, const void* b_len,
           const void* centers, int n_cen, int B, int n_rows, void* out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + WARPS - 1) / WARPS;
  extend_kernel<C><<<blocks, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), LA, static_cast<const int32_t*>(a_len),
      static_cast<const uint8_t*>(b), LB, static_cast<const int32_t*>(b_len),
      static_cast<const int32_t*>(centers), n_cen, B, n_rows, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Common arguments: a uint8[B, LA], a_len int32[B], b uint8[B, LB], b_len
// int32[B], centers int32[B, n_cen] with n_cen >= n_rows + 1; out
// int32[3, B] = (edits, a_used, b_used).  Both launch on `stream` and
// return cudaGetLastError() of the launch, or -1 for a band the kernel
// does not hold.
#define CANU_EXTEND_ARGS a, LA, a_len, b, LB, b_len, centers, n_cen, B, n_rows, out, stream

// K2: band 128, 256, 384 or 512.
extern "C" int canu_extend_warp(const void* a, int LA, const void* a_len, const void* b,
                                int LB, const void* b_len, const void* centers, int n_cen,
                                int B, int band, int n_rows, void* out, void* stream) {
  switch (band) {
    case 128: return launch<4>(CANU_EXTEND_ARGS);
    case 256: return launch<8>(CANU_EXTEND_ARGS);
    case 384: return launch<12>(CANU_EXTEND_ARGS);
    case 512: return launch<16>(CANU_EXTEND_ARGS);
    default: return -1;
  }
}

// K3: band 640, 768, 896 or 1024.
extern "C" int canu_extend_block(const void* a, int LA, const void* a_len, const void* b,
                                 int LB, const void* b_len, const void* centers, int n_cen,
                                 int B, int band, int n_rows, void* out, void* stream) {
  switch (band) {
    case 640: return launch<20>(CANU_EXTEND_ARGS);
    case 768: return launch<24>(CANU_EXTEND_ARGS);
    case 896: return launch<28>(CANU_EXTEND_ARGS);
    case 1024: return launch<32>(CANU_EXTEND_ARGS);
    default: return -1;
  }
}
