// Kernel K1: the row loop of the banded Myers bit-vector extension.
//
// Replaces canu_tpu/ops/pallas/myers_pallas.py:_myers_tile_kernel (:77,
// driven by myers_run_pallas) and computes exactly what the plain PyTorch
// loop canu_tpu_torch/ops/myers.py:_myers_segment computes, bit for bit.
//
// One extension per thread.  The 128-column band is 4 chained uint32
// words; the thread holds the band and all 43 state words of the carry in
// registers and runs every row of its extension in one launch: per row a
// conditional one-column window shift that inserts the entering B char
// into the 4 Peq bitplanes, the 4-word chained Myers column update with a
// +1 top boundary, and the captures (best cost at B exhaustion, the
// furthest in-envelope band-centre endpoint; the state at A exhaustion is
// the state after the thread's last row).  A lane does nothing once its
// row passes a_len, so the loop stops there.
//
// What bounds it on an H100: the integer ALU, not bytes.  A row is about
// 150 32-bit operations per thread against under 2 bytes of input, and a
// dependent chain runs through the 4 chained words of every row.  The
// first design lost most of the card on memory latency and occupancy:
// every row read its shift, A char and entering-char index from [row, B]
// streams and then gathered the entering char from the B read, two
// dependent round trips a row, and 4,096 extensions made 32 blocks of 128
// threads on 132 SMs.  This design:
//   * reads no row stream the carry can give: the shift is one bit a row
//     (s_bits, one uint32 per 32 rows, the schedule's slope is <= 1), the
//     entering index is clamp(o + 127, 0, LB - 1) from the carried window
//     start o, and A is read from its own row a[x, :];
//   * keeps every load off the row's dependency chain: A and B are walked
//     sequentially (the entering index rises by at most 1 a row) through
//     16-byte register windows, each loaded one window ahead of its use,
//     and the next shift word 32 rows ahead;
//   * runs blocks of 32 threads, so 4,096 extensions fill 128 SMs;
//   * shifts the 24 chained words (VP, VN, 16 Peq) with one funnel shift
//     each, by s itself: a shift by 0 leaves a word as it is, so no branch;
//   * computes the popcounts of window words 0 and 1 once a row for both
//     captures.
// The Pallas kernel kept the same streams out of memory by packing the
// shift bit and the A char in 3 bits a row and reading the entering char
// from 2-bit B words indexed by o + 127 (myers_pallas.py:82-87,152-165).
// Measured on an H100 (PERF.md): a launch lasts as long as its longest
// extension, and with one warp per SM sub-partition a row is latency-
// bound (4x the extensions in one launch cost little more time); blocks
// of 64 or 128 threads were no faster than 32.
//
// Kernels K10 and K11 complete K1's path (canu_tpu/ops/myers.py:443
// _run_pallas runs three jitted programs around the Pallas row loop):
//
// K10 (canu_myers_prologue) replaces canu_tpu/ops/myers.py:152 _myers_prep
// (the band schedule and its shift stream), :172 _myers_init (the row-0
// state) and :403 _carry_pack, and computes exactly what the plain chain
// canu_tpu_torch/ops/myers.py:_schedule -> _shift_bits and _myers_init ->
// _carry_pack computes: per extension, over rows i = 0..n_rows,
//   t(i)  = cummax(clip(centre(i) - 64, 0, max(b_len, 0))),
//   lo(i) = min_{j <= i}(t(j) - j) + i,  hi(i) = max_{j >= i}(t(j) - j) + i,
//   o(i)  = min((lo(i) + hi(i)) >> 1, t(0) + i),
// the shift bit of row i = o(i) - o(i-1) (0 or 1) for rows 1..n_run, and
// the row-0 carry planes at o(0).  The centres come as rows (stride 1:
// row i's centre is centers[min(i, C - 1)]) or, on the main path, on the
// 16-row grid verify interpolates them on (stride 16: centers[min(i, C -
// 1) >> 4]), 16x fewer bytes; they are never expanded.  A run of rows
// sharing one centre (a unit: 16 rows, or 1) has one t, T, so inside it
// t - i falls by one a row: the unit's min of t - i is T - its last row,
// its max T - its first, and a row's o is d + i with d = min((min(M, T -
// i) + max(H, T - i)) >> 1, t(0)), M the min of t - j before the unit and
// H the max after the row's unit, so a row costs a handful of operations
// and no scan.
//
// A lane owns a chunk of 32 rows, the rows of one shift word (word c:
// rows 32c + 1 .. 32c + 32, from o at rows 32c .. 32c + 32); a warp takes
// 32 chunks a step.  What a chunk needs of the rest of the extension is
// three numbers: the running max R entering it, the min M of t - j before
// it and the max H of t - j after it.  R is a prefix max of the chunks'
// own maxima; once R is known, a chunk's min and max of t - j are known,
// and M and H are a prefix min and a suffix max of those.  So K10 makes
// three passes over the extension's centres, each followed by its scans:
// (A) each chunk's max; the prefix max; (B) each chunk's min and max of t -
// j under its R; the prefix min and the suffix max; (C) the chunk's rows,
// its word.  Each pass combines lanes by warp shuffles, steps by one
// warp's scan of the steps' values in shared memory, and blocks through
// distributed shared memory: an extension is owned by one block or, where
// the launch has fewer extensions than the card has SMs (the judge: 3
// extensions x 3.4 M rows), by a thread-block cluster of up to 8 blocks,
// each over a contiguous range of chunks, which publish their range's
// three values and meet at cluster barriers.  Clusters, not a decoupled
// look-back: the suffix max H needs the later blocks, which a look-back
// cannot wait for without all blocks resident, and a cluster's blocks are
// resident together; three barriers, no device scratch, one launch.  The
// block's centres (its units and the next chunk's first) are staged once
// in shared memory by cp.async, padded one word in 32 so that the lanes'
// reads are free of bank conflicts, and the three passes read them there;
// a range too long for shared memory is read from the device each pass.
// What bounds K10 on the main path: the operations (about 7 a row and 8 a
// 16-row unit) once the centres are read on their grid (0.25 bytes a row).
//
// K11 (canu_myers_epilogue) replaces :418 _carry_unpack and :336
// _myers_finish: from K1's final planes, the A-exhausted row's 128 scores
// (fin_sf plus the exclusive prefix of fVP - fVN, a column counting only
// while fin_o + w <= b_len), its first minimum, the pick against the
// B-exhausted cost (ties to the A end) and the partial endpoints clamped
// to the reads; the six int32[B] results of the plain _myers_finish.  The
// pick is one __device__ function, end_pick: on the main path K1 runs it
// after its last row on the state it holds in registers and writes the six
// words instead of the 43 planes (canu_myers_rows with pick_out), so the
// extension is two launches, K10 and K1; canu_myers_epilogue is a thread an
// extension over the same function, from planes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;        // uint32 words per 128-column band
constexpr int BAND = 128;
constexpr int WIN = 16;      // bytes per register window (one uint4)
constexpr int BLOCK = 32;    // threads per block: 4,096 extensions fill 128 SMs
constexpr int INF = 1 << 28;  // an unreachable cost

// carry plane indices (canu_tpu's Pallas order), 43 planes of uint32[B]
constexpr int P_VP = 0;
constexpr int P_VN = P_VP + NW;
constexpr int P_PEQ = P_VN + NW;  // 4 chars x NW words, char-major
constexpr int P_SF = P_PEQ + 4 * NW;
constexpr int P_O = P_SF + 1;
constexpr int P_BEST = P_O + 1;
constexpr int P_AEND = P_BEST + 1;
constexpr int P_BEND = P_AEND + 1;
constexpr int P_FVP = P_BEND + 1;
constexpr int P_FVN = P_FVP + NW;
constexpr int P_FSF = P_FVN + NW;
constexpr int P_FO = P_FSF + 1;
constexpr int P_PEXT = P_FO + 1;
constexpr int P_PED = P_PEXT + 1;
constexpr int P_PA = P_PED + 1;
constexpr int P_PB = P_PA + 1;

// 32-bit two's-complement product, as XLA's int32 multiply wraps (a
// signed overflow would be undefined in C++).
__device__ __forceinline__ int mul_wrap(int x, int y) {
  return static_cast<int>(static_cast<uint32_t>(x) * static_cast<uint32_t>(y));
}

// the j-th 32-bit word of a window, j in 0..3
__device__ __forceinline__ uint32_t win_word(const uint4& v, int j) {
  return j < 2 ? (j == 0 ? v.x : v.y) : (j == 2 ? v.z : v.w);
}

struct Lane {
  uint32_t VP[NW], VN[NW], Peq[4][NW];
  int sf, o, best_bx, aend_bx, bend_bx, p_ext, p_ed, p_a, p_b;
};

// One DP row (absolute row i) of a live lane: ach the A char of the row,
// s its shift (0 or 1), onehot the entering B char as a bit mask (bit c
// set for char c < 4; only read when s == 1).
__device__ __forceinline__ void myers_row(Lane& L, int i, uint32_t ach, uint32_t s,
                                          uint32_t onehot, int blen, int cap_q) {
  // ---- window shift: the band moves down s columns (s is 0 or 1) ----
  L.sf += static_cast<int>(L.VP[0] & s) - static_cast<int>(L.VN[0] & s);
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t hp = k + 1 < NW ? L.VP[k + 1] : 1u;  // below-band wall: +1
    const uint32_t hn = k + 1 < NW ? L.VN[k + 1] : 0u;
    L.VP[k] = __funnelshift_r(L.VP[k], hp, s);
    L.VN[k] = __funnelshift_r(L.VN[k], hn, s);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      // bit 0 of hi enters bit 31; the top word takes the entering char
      const uint32_t hi = k + 1 < NW ? L.Peq[c][k + 1] : (onehot >> c);
      L.Peq[c][k] = __funnelshift_r(L.Peq[c][k], hi, s);
    }
  }

  // ---- Myers column update, words chained like edlib's blocks ----
  const bool lo = (ach & 1u) != 0u;
  const bool hi2 = (ach & 2u) != 0u;
  const bool valid = ach < 4u;
  uint32_t hp_in = 1u, hm_in = 0u;  // the window top grows +1 per row
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t e01 = lo ? L.Peq[1][k] : L.Peq[0][k];
    const uint32_t e23 = lo ? L.Peq[3][k] : L.Peq[2][k];
    const uint32_t eq_all = valid ? (hi2 ? e23 : e01) : 0u;
    const uint32_t Pv = L.VP[k], Mv = L.VN[k];
    const uint32_t Xv = eq_all | Mv;
    const uint32_t Eq = eq_all | hm_in;
    const uint32_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
    uint32_t Ph = Mv | ~(Xh | Pv);
    uint32_t Mh = Pv & Xh;
    const uint32_t hp_out = Ph >> 31, hm_out = Mh >> 31;
    Ph = (Ph << 1) | hp_in;
    Mh = (Mh << 1) | hm_in;
    L.VP[k] = Mh | ~(Xv | Ph);
    L.VN[k] = Ph & Xv;
    hp_in = hp_out;
    hm_in = hm_out;
  }
  L.sf += 1;

  // the score deltas of window words 0 and 1, shared by both captures
  const int d0 = __popc(L.VP[0]) - __popc(L.VN[0]);
  const int d1 = __popc(L.VP[1]) - __popc(L.VN[1]);

  // ---- B-exhaustion capture: column j == b_len inside the window ----
  // D(j) = sf + the deltas of window columns 0..wb-1: the whole words below
  // word wb/32, then the low wb%32 bits of that word.  This is the sum
  // over word_mask(wb, k) of the plain row, whose all-ones case (a shift
  // by 32, undefined in C++) never arises here.
  const int wb = blen - L.o;
  if (wb >= 0 && wb < BAND) {
    const int kw = wb >> 5;
    const uint32_t m = (1u << (wb & 31)) - 1u;
    const uint32_t vp = kw < 2 ? (kw == 0 ? L.VP[0] : L.VP[1]) : (kw == 2 ? L.VP[2] : L.VP[3]);
    const uint32_t vn = kw < 2 ? (kw == 0 ? L.VN[0] : L.VN[1]) : (kw == 2 ? L.VN[2] : L.VN[3]);
    int cost = L.sf + __popc(vp & m) - __popc(vn & m);
    if (kw > 0) cost += d0;
    if (kw > 1) cost += d1;
    if (kw > 2) cost += __popc(L.VP[2]) - __popc(L.VN[2]);
    if (cost < L.best_bx) {
      L.best_bx = cost;
      L.aend_bx = i;
      L.bend_bx = blen;
    }
  }

  // ---- furthest in-envelope endpoint on the band centre ----
  const int jc = L.o + BAND / 2;
  const int sc = L.sf + d0 + d1;
  const int ext = i + jc;
  const int sc_c = min(sc, 80000);
  const int ext_c = min(ext, 400000);
  if (jc <= blen && mul_wrap(sc_c, 20000) <= mul_wrap(cap_q, ext_c) && ext > L.p_ext) {
    L.p_ext = ext;
    L.p_ed = sc;
    L.p_a = i;
    L.p_b = jc;
  }
}

// Kernel K11's end pick (ops.myers._myers_finish) of extension x from its
// state at A exhaustion (fVP, fVN, fin_sf, fin_o), its best B-exhausted
// capture and its partial capture: out int32[6, B] = edits, a_used,
// b_used, p_edits, p_a, p_b.  The A-exhausted row's score at window column
// w is fin_sf plus the exclusive prefix of fVP - fVN, INF where fin_o + w >
// b_len; its first minimum is picked against the B-exhausted cost, ties to
// the A end.  Inlined into K1 it takes K1 from 89 to 91 registers, the
// same 3,072 registers a warp; every form that keeps it out of K1's
// registers (a call, a loop indexing fVP) puts fVP and fVN on the stack
// and made K1 8-9% slower on an H100 (ptxas -v and CUDA events, PERF.md).
__device__ __forceinline__ void end_pick(const uint32_t (&fVP)[NW], const uint32_t (&fVN)[NW],
                                         int fin_sf, int fin_o, int best_bx, int aend_bx,
                                         int bend_bx, int p_ed, int p_a, int p_b, int alen,
                                         int blen, int B, int x, int32_t* __restrict__ out) {
  int acc = fin_sf, cost = 0, wbest = 0;
  for (int w = 0; w < BAND; ++w) {
    const int k = w >> 5, u = w & 31;
    const uint32_t vp = k < 2 ? (k == 0 ? fVP[0] : fVP[1]) : (k == 2 ? fVP[2] : fVP[3]);
    const uint32_t vn = k < 2 ? (k == 0 ? fVN[0] : fVN[1]) : (k == 2 ? fVN[2] : fVN[3]);
    const int sc = fin_o + w <= blen ? acc : INF;
    if (w == 0 || sc < cost) {
      cost = sc;
      wbest = w;
    }
    acc += static_cast<int>((vp >> u) & 1u) - static_cast<int>((vn >> u) & 1u);
  }
  const bool use_ax = cost <= best_bx;
  out[x] = use_ax ? cost : best_bx;
  out[B + x] = use_ax ? alen : aend_bx;
  out[2 * B + x] = use_ax ? fin_o + wbest : bend_bx;
  out[3 * B + x] = p_ed;
  out[4 * B + x] = p_a < alen ? p_a : alen;
  out[5 * B + x] = p_b < blen ? p_b : blen;
}

// PICK: after the last row, run the end pick on the state in registers and
// write its six words to pick_out, not the 43 carry planes (the main path);
// else write the planes to carry_out (a segment that more rows continue,
// and the checks that hold K1 row by row).
template <bool PICK>
__global__ void __launch_bounds__(BLOCK) myers_rows_kernel(
    const uint32_t* __restrict__ carry0, uint32_t* __restrict__ carry_out,
    int32_t* __restrict__ pick_out,
    const uint8_t* __restrict__ a, int a_stride, const uint32_t* __restrict__ s_bits,
    const uint8_t* __restrict__ b, int b_stride, int LB, const int32_t* __restrict__ a_len,
    const int32_t* __restrict__ b_len, int B, int n_run, int cap_q) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= B) return;

  Lane L;
  uint32_t fVP[NW], fVN[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    L.VP[k] = carry0[(size_t)(P_VP + k) * B + x];
    L.VN[k] = carry0[(size_t)(P_VN + k) * B + x];
    fVP[k] = carry0[(size_t)(P_FVP + k) * B + x];
    fVN[k] = carry0[(size_t)(P_FVN + k) * B + x];
#pragma unroll
    for (int c = 0; c < 4; ++c) L.Peq[c][k] = carry0[(size_t)(P_PEQ + NW * c + k) * B + x];
  }
  L.sf = static_cast<int>(carry0[(size_t)P_SF * B + x]);
  L.o = static_cast<int>(carry0[(size_t)P_O * B + x]);
  L.best_bx = static_cast<int>(carry0[(size_t)P_BEST * B + x]);
  L.aend_bx = static_cast<int>(carry0[(size_t)P_AEND * B + x]);
  L.bend_bx = static_cast<int>(carry0[(size_t)P_BEND * B + x]);
  int fin_sf = static_cast<int>(carry0[(size_t)P_FSF * B + x]);
  int fin_o = static_cast<int>(carry0[(size_t)P_FO * B + x]);
  L.p_ext = static_cast<int>(carry0[(size_t)P_PEXT * B + x]);
  L.p_ed = static_cast<int>(carry0[(size_t)P_PED * B + x]);
  L.p_a = static_cast<int>(carry0[(size_t)P_PA * B + x]);
  L.p_b = static_cast<int>(carry0[(size_t)P_PB * B + x]);

  const int alen = a_len[x];
  const int blen = b_len[x];
  // rows past a_len change nothing (no shift, no update, no capture)
  const int last = min(n_run, alen);

  if (last > 0) {
    const uint4* arow = reinterpret_cast<const uint4*>(a + (size_t)x * a_stride);
    const uint4* brow = reinterpret_cast<const uint4*>(b + (size_t)x * b_stride);
    const uint32_t* scol = s_bits + x;  // shift word w of this lane: scol[w * B]
    const int b_wins = b_stride / WIN;
    const int n_wins = (last + WIN - 1) / WIN;  // A windows of the lane's rows
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

    // B window: the entering index e = clamp(o + 127, 0, LB - 1) of a
    // shifted row never falls (o never falls) and rises by one a shift,
    // so the chars come in order.  b_cur holds window bw, b_nxt the next;
    // bw starts at the first shift's e.
    int bw = min(max(L.o + BAND, 0), LB - 1) / WIN;
    uint4 b_cur = brow[bw];
    uint4 b_nxt = bw + 1 < b_wins ? brow[bw + 1] : zero;
    uint4 a_nxt = arow[0];
    uint32_t s_nxt = scol[0];
    uint32_t s_cur = 0u;

    for (int c = 0; c < n_wins; ++c) {
      const uint4 a_cur = a_nxt;
      if (c + 1 < n_wins) a_nxt = arow[c + 1];
      if ((c & 1) == 0) {  // one shift word per 32 rows, loaded 32 rows ahead
        s_cur = s_nxt;
        if (c + 2 < n_wins) s_nxt = scol[(size_t)(c / 2 + 1) * B];
      }
      const uint32_t s16 = s_cur >> ((c & 1) * 16);
      const int rows = min(WIN, last - c * WIN);
#pragma unroll 1
      for (int q = 0; q * 4 < rows; ++q) {  // 4 rows unrolled: one row body x 4 of code
        const uint32_t aw = win_word(a_cur, q);
        const uint32_t sq = s16 >> (4 * q);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (q * 4 + r < rows) {
            const uint32_t s = (sq >> r) & 1u;
            L.o += static_cast<int>(s);
            const int e = min(max(L.o + BAND - 1, 0), LB - 1);
            if (e / WIN > bw) {  // at most one window a row
              ++bw;
              b_cur = b_nxt;
              b_nxt = bw + 1 < b_wins ? brow[bw + 1] : zero;
            }
            const int j = e % WIN;
            const uint32_t bch = (win_word(b_cur, j >> 2) >> ((j & 3) * 8)) & 0xFFu;
            const uint32_t onehot = bch < 4u ? (1u << bch) : 0u;
            myers_row(L, c * WIN + q * 4 + r + 1, (aw >> (8 * r)) & 0xFFu, s, onehot, blen,
                      cap_q);
          }
        }
      }
    }

    // ---- A-exhaustion capture: row a_len is the lane's last row ----
    if (alen <= n_run) {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        fVP[k] = L.VP[k];
        fVN[k] = L.VN[k];
      }
      fin_sf = L.sf;
      fin_o = L.o;
    }
  }

  if constexpr (PICK) {
    end_pick(fVP, fVN, fin_sf, fin_o, L.best_bx, L.aend_bx, L.bend_bx, L.p_ed, L.p_a, L.p_b,
             alen, blen, B, x, pick_out);
  } else {
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      carry_out[(size_t)(P_VP + k) * B + x] = L.VP[k];
      carry_out[(size_t)(P_VN + k) * B + x] = L.VN[k];
      carry_out[(size_t)(P_FVP + k) * B + x] = fVP[k];
      carry_out[(size_t)(P_FVN + k) * B + x] = fVN[k];
#pragma unroll
      for (int c = 0; c < 4; ++c) carry_out[(size_t)(P_PEQ + NW * c + k) * B + x] = L.Peq[c][k];
    }
    carry_out[(size_t)P_SF * B + x] = static_cast<uint32_t>(L.sf);
    carry_out[(size_t)P_O * B + x] = static_cast<uint32_t>(L.o);
    carry_out[(size_t)P_BEST * B + x] = static_cast<uint32_t>(L.best_bx);
    carry_out[(size_t)P_AEND * B + x] = static_cast<uint32_t>(L.aend_bx);
    carry_out[(size_t)P_BEND * B + x] = static_cast<uint32_t>(L.bend_bx);
    carry_out[(size_t)P_FSF * B + x] = static_cast<uint32_t>(fin_sf);
    carry_out[(size_t)P_FO * B + x] = static_cast<uint32_t>(fin_o);
    carry_out[(size_t)P_PEXT * B + x] = static_cast<uint32_t>(L.p_ext);
    carry_out[(size_t)P_PED * B + x] = static_cast<uint32_t>(L.p_ed);
    carry_out[(size_t)P_PA * B + x] = static_cast<uint32_t>(L.p_a);
    carry_out[(size_t)P_PB * B + x] = static_cast<uint32_t>(L.p_b);
  }
}

}  // namespace

// carry0: uint32[43, B]; exactly one of carry_out (uint32[43, B], the
// final carry) and pick_out (int32[6, B], the end pick of the final carry);
// a: uint8[B, a_stride] (row i reads a[x, i-1], a_stride >= n_run);
// s_bits: uint32[ceil(n_run/32), B], bit (i-1) % 32 of word (i-1) / 32 =
// the shift of row i; b: uint8[B, b_stride], LB <= b_stride its logical
// width; a_len, b_len: int32[B].  a_stride and b_stride are multiples of
// 16 and a, b 16-byte aligned.  Launches on `stream`; returns
// cudaGetLastError() of the launch, or -1 for arguments it does not take.
extern "C" int canu_myers_rows(const void* carry0, void* carry_out, void* pick_out,
                               const void* a, int a_stride, const void* s_bits, const void* b,
                               int b_stride, int LB, const void* a_len, const void* b_len, int B,
                               int n_run, int cap_q, void* stream) {
  if (B <= 0) return 0;
  if (a_stride % WIN || b_stride % WIN || a_stride < n_run || LB < 1 || LB > b_stride ||
      (carry_out == nullptr) == (pick_out == nullptr))
    return -1;
  const int blocks = (B + BLOCK - 1) / BLOCK;
  auto kernel = pick_out ? myers_rows_kernel<true> : myers_rows_kernel<false>;
  kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(carry0), static_cast<uint32_t*>(carry_out),
      static_cast<int32_t*>(pick_out), static_cast<const uint8_t*>(a), a_stride,
      static_cast<const uint32_t*>(s_bits), static_cast<const uint8_t*>(b), b_stride, LB,
      static_cast<const int32_t*>(a_len), static_cast<const int32_t*>(b_len), B, n_run, cap_q);
  return static_cast<int>(cudaGetLastError());
}

// ---- K10 and K11 -------------------------------------------------------------

namespace {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int IMAX = 0x7FFFFFFF;
constexpr int IMIN = -0x7FFFFFFF - 1;
constexpr int PRO_WARPS = 8;                    // warps a block of K10
constexpr int PRO_THREADS = 32 * PRO_WARPS;
constexpr int PRO_MAX_BLOCKS = 8;               // blocks an extension: a portable cluster
constexpr int PRO_TILE_MAX = 40 * 1024;         // staged centres a block at most (160 KB)
constexpr int PRO_SMEM_MAX = 227 * 1024;        // dynamic shared bytes a block may have
constexpr int EPI_BLOCK = 128;                  // threads a block of K11

// int32 arithmetic that wraps, as torch's int32 tensors do
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

// max over lanes 0..lane-1 (lo for lane 0)
__device__ __forceinline__ int warp_excl_max(int v, int lane, int lo) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = y > v ? y : v;
  }
  const int e = __shfl_up_sync(FULL, v, 1);
  return lane ? e : lo;
}

// min over lanes 0..lane-1 (hi for lane 0)
__device__ __forceinline__ int warp_excl_min(int v, int lane, int hi) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = y < v ? y : v;
  }
  const int e = __shfl_up_sync(FULL, v, 1);
  return lane ? e : hi;
}

// max over lanes lane+1..31 (lo for lane 31)
__device__ __forceinline__ int warp_excl_suffix_max(int v, int lane, int lo) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_down_sync(FULL, v, d);
    if (lane + d < 32) v = y > v ? y : v;
  }
  const int e = __shfl_down_sync(FULL, v, 1);
  return lane < 31 ? e : lo;
}

// the clipped target of one row: min(max(centre - 64, 0), max(b_len, 0))
__device__ __forceinline__ int target(int centre, int bcl) {
  int t = wsub(centre, BAND / 2);
  t = t > 0 ? t : 0;
  return t < bcl ? t : bcl;
}

// the staged centre of unit e of a block's range: one padding word in 32,
// so that lanes reading units 32 apart (stride 1) or 2 apart (stride 16)
// meet no bank conflict
__host__ __device__ __forceinline__ int tile_at(int e) { return e + (e >> 5); }

__device__ __forceinline__ void cp_async4(int* dst, const int32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// One warp's in-place exclusive scans of a block's per-step values a[0..n)
// in shared memory: a[k] <- the max (min) of init and a[0..k-1], or the max
// of init and a[k+1..n-1]
__device__ void steps_excl_max(int* a, int n, int init, int lane) {
  int carry = init;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int x = i < n ? a[i] : IMIN;
    const int e = warp_excl_max(x, lane, IMIN);
    if (i < n) a[i] = carry > e ? carry : e;
    const int r = __reduce_max_sync(FULL, x);
    carry = carry > r ? carry : r;
  }
}

__device__ void steps_excl_min(int* a, int n, int init, int lane) {
  int carry = init;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int x = i < n ? a[i] : IMAX;
    const int e = warp_excl_min(x, lane, IMAX);
    if (i < n) a[i] = carry < e ? carry : e;
    const int r = __reduce_min_sync(FULL, x);
    carry = carry < r ? carry : r;
  }
}

__device__ void steps_excl_suffix_max(int* a, int n, int init, int lane) {
  int carry = init;
  for (int base = ((n - 1) >> 5) << 5; base >= 0; base -= 32) {
    const int i = base + lane;
    const int x = i < n ? a[i] : IMIN;
    const int e = warp_excl_suffix_max(x, lane, IMIN);
    if (i < n) a[i] = carry > e ? carry : e;
    const int r = __reduce_max_sync(FULL, x);
    carry = carry > r ? carry : r;
  }
}

// the max (min) of a[0..n) by one warp, id for n == 0
__device__ int steps_max(const int* a, int n, int lane) {
  int r = IMIN;
  for (int i = lane; i < n; i += 32) r = a[i] > r ? a[i] : r;
  return __reduce_max_sync(FULL, r);
}

__device__ int steps_min(const int* a, int n, int lane) {
  int r = IMAX;
  for (int i = lane; i < n; i += 32) r = a[i] < r ? a[i] : r;
  return __reduce_min_sync(FULL, r);
}

// A lane's chunk c: rows 32c .. 32c + 31 in CU = 32 >> L units of S = 1 <<
// L rows (unit u: rows S u .. S u + S - 1, centre index min(u, uLast)),
// and v[CU], the first unit of the next chunk; v the clipped targets.
template <int L>
struct Chunk {
  static constexpr int S = 1 << L, CU = 32 >> L;
  int v[CU + 1];
  int c;
  bool on;  // the chunk is one of the block's

  __device__ __forceinline__ void load(int c_, bool on_, const int* tile, int U0,
                                       const int32_t* crow, int uLast, bool staged, int bcl) {
    c = c_;
    on = on_;
#pragma unroll
    for (int k = 0; k <= CU; ++k) {
      const int u = c * CU + k;
      int raw = 0;
      if (on) raw = staged ? tile[tile_at(u - U0)] : __ldg(crow + (u < uLast ? u : uLast));
      v[k] = target(raw, bcl);
    }
  }

  // pass A: the chunk's max of the clipped targets (t >= 0: 0 is the empty max)
  __device__ __forceinline__ int max_target(int N) const {
    int lt = 0;
#pragma unroll
    for (int k = 0; k < CU; ++k)
      if (on && (c << 5) + k * S <= N) lt = v[k] > lt ? v[k] : lt;
    return lt;
  }

  // T[k], t of unit k under the entering running max R (k = CU: the next
  // chunk's first row), and the chunk's min m and max H of t - i
  __device__ __forceinline__ void envelope(int R, int N, int* T, int& m, int& H) const {
    int run = R;
#pragma unroll
    for (int k = 0; k <= CU; ++k) {
      run = v[k] > run ? v[k] : run;
      T[k] = run;
    }
    m = IMAX;
    H = IMIN;
#pragma unroll
    for (int k = 0; k < CU; ++k) {
      const int r0 = (c << 5) + k * S;
      if (on && r0 <= N) {
        const int rl = r0 + S - 1 < N ? r0 + S - 1 : N;
        m = T[k] - rl < m ? T[k] - rl : m;
        H = T[k] - r0 > H ? T[k] - r0 : H;
      }
    }
  }

  // pass C: the shift word of rows 32c + 1 .. 32c + 32 from o at rows 32c ..
  // 32c + 32, given the min M of t - j before the chunk and the max Hs of t
  // - j after it; bits past n_run 0.  d0 gets d at row 32c (o = d + i).
  __device__ __forceinline__ uint32_t word(const int* T, int N, int n_run, int M, int Hs, int t0,
                                           int& d0) const {
    int sfu[CU];  // max of t - j over the rows after unit k
    sfu[CU - 1] = Hs;
#pragma unroll
    for (int k = CU - 2; k >= 0; --k) {
      const int r0n = (c << 5) + (k + 1) * S;
      sfu[k] = r0n <= N && T[k + 1] - r0n > sfu[k + 1] ? T[k + 1] - r0n : sfu[k + 1];
    }
    uint32_t w = 0u;
    int mb = M, dprev = 0;
#pragma unroll
    for (int k = 0; k <= CU; ++k) {
      const int r0 = (c << 5) + k * S;
      const int hk = k < CU ? sfu[k] : Hs;
#pragma unroll
      for (int r = 0; r < (k < CU ? S : 1); ++r) {
        const int q = k * S + r;  // row 32c + q
        const int x = T[k] - (r0 + r);
        const int a = (mb < x ? mb : x) + (hk > x ? hk : x);
        const int d = (a >> 1) < t0 ? (a >> 1) : t0;
        if (q == 0)
          d0 = d;
        else
          w |= static_cast<uint32_t>(d != dprev - 1) << (q - 1);  // o(i) != o(i - 1)
        dprev = d;
      }
      if (k < CU && r0 <= N) {
        const int rl = r0 + S - 1 < N ? r0 + S - 1 : N;
        mb = T[k] - rl < mb ? T[k] - rl : mb;
      }
    }
    const int lim = n_run - (c << 5);  // rows 32c + 1 .. n_run have bits
    return lim >= 32 ? w : (lim > 0 ? w & ((1u << lim) - 1u) : 0u);
  }
};

// One extension a block, or a cluster of nb blocks (nb <= PRO_MAX_BLOCKS),
// block r of it over chunks [r q, (r + 1) q) of the extension's NCH =
// n_rows / 32 + 1; a warp takes 32 of its chunks a step.  Dynamic shared
// memory: the staged centres (tile_n words, 0 for none), then three words
// a step.
template <int L>
__global__ void __launch_bounds__(PRO_THREADS) myers_prologue_kernel(
    const int32_t* __restrict__ centers, long long c_stride, int uLast,
    const uint8_t* __restrict__ b, long long b_stride, int LB, const int32_t* __restrict__ a_len,
    const int32_t* __restrict__ b_len, int B, int n_rows, int n_run, int nb, int tile_n,
    uint32_t* __restrict__ s_bits, uint32_t* __restrict__ planes) {
  constexpr int CU = Chunk<L>::CU;
  extern __shared__ __align__(16) int pro_smem[];
  __shared__ int s_pub[3];  // the block's max target, min and max of t - j
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int x = blockIdx.x / nb, rank = blockIdx.x - x * nb;
  const int N = n_rows;
  const int NCH = (N >> 5) + 1;
  const int q = (NCH + nb - 1) / nb;
  const int c0 = rank * q, c1 = c0 + q < NCH ? c0 + q : NCH;
  const int nst = c1 > c0 ? (c1 - c0 + 31) >> 5 : 0;  // steps of the block
  const int nstq = (q + 31) >> 5;
  int* tile = pro_smem;
  int* s_r = pro_smem + tile_n;  // pass A's maxima, then the entering R
  int* s_m = s_r + nstq;         // pass B's minima, then the entering M
  int* s_h = s_m + nstq;         // pass B's maxima, then the max after the step

  const int32_t* crow = centers + static_cast<long long>(x) * c_stride;
  const int blen = b_len[x];
  const int bcl = blen > 0 ? blen : 0;
  const int t0 = target(__ldg(crow), bcl);
  const int U0 = c0 * CU;
  const bool staged = tile_n > 0;
  if (staged && nst) {
    const int nU = (c1 - c0) * CU + 1;  // and the next chunk's first unit
    for (int e = tid; e < nU; e += PRO_THREADS) {
      const int u = U0 + e;
      cp_async4(tile + tile_at(e), crow + (u < uLast ? u : uLast));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  // pass A: each step's max target
  Chunk<L> ch;
  for (int k = warp; k < nst; k += PRO_WARPS) {
    const int c = c0 + 32 * k + lane;
    ch.load(c, c < c1, tile, U0, crow, uLast, staged, bcl);
    const int r = __reduce_max_sync(FULL, ch.max_target(N));
    if (lane == 0) s_r[k] = r;
  }
  __syncthreads();
  if (warp == 0) {
    const int r = steps_max(s_r, nst, lane);
    if (lane == 0) s_pub[0] = r > 0 ? r : 0;
  }
  cg::cluster_group cl = cg::this_cluster();
  if (nb > 1)
    cl.sync();
  else
    __syncthreads();
  if (warp == 0) {
    int rin = 0;  // the running max entering the block: the earlier blocks' maxima
    if (nb > 1) {
      const int v = lane < rank ? *cl.map_shared_rank(&s_pub[0], lane) : 0;
      rin = __reduce_max_sync(FULL, v);
    }
    steps_excl_max(s_r, nst, rin, lane);
  }
  __syncthreads();

  // pass B: each step's min and max of t - i under its R
  int T[CU + 1], m, H;
  for (int k = warp; k < nst; k += PRO_WARPS) {
    const int c = c0 + 32 * k + lane;
    ch.load(c, c < c1, tile, U0, crow, uLast, staged, bcl);
    const int e = warp_excl_max(ch.max_target(N), lane, 0);
    ch.envelope(s_r[k] > e ? s_r[k] : e, N, T, m, H);
    m = __reduce_min_sync(FULL, m);
    H = __reduce_max_sync(FULL, H);
    if (lane == 0) {
      s_m[k] = m;
      s_h[k] = H;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int r = steps_min(s_m, nst, lane);
    if (lane == 0) s_pub[1] = r;
  } else if (warp == 1) {
    const int r = steps_max(s_h, nst, lane);
    if (lane == 0) s_pub[2] = r;
  }
  if (nb > 1)
    cl.sync();
  else
    __syncthreads();
  if (warp == 0) {
    int min_in = IMAX;  // the earlier blocks' min of t - j
    if (nb > 1) min_in = __reduce_min_sync(
        FULL, lane < rank ? *cl.map_shared_rank(&s_pub[1], lane) : IMAX);
    steps_excl_min(s_m, nst, min_in, lane);
  } else if (warp == 1) {
    int max_after = IMIN;  // the later blocks' max of t - j
    if (nb > 1) max_after = __reduce_max_sync(
        FULL, lane > rank && lane < nb ? *cl.map_shared_rank(&s_pub[2], lane) : IMIN);
    steps_excl_suffix_max(s_h, nst, max_after, lane);
  }
  __syncthreads();

  // pass C: each chunk's shift word; o(0) for the row-0 planes
  const int nw = (n_run + 31) >> 5;
  int o0 = 0;
  for (int k = warp; k < nst; k += PRO_WARPS) {
    const int c = c0 + 32 * k + lane;
    ch.load(c, c < c1, tile, U0, crow, uLast, staged, bcl);
    const int e = warp_excl_max(ch.max_target(N), lane, 0);
    ch.envelope(s_r[k] > e ? s_r[k] : e, N, T, m, H);
    const int me = warp_excl_min(m, lane, IMAX), he = warp_excl_suffix_max(H, lane, IMIN);
    int d0 = 0;
    const uint32_t w = ch.word(T, N, n_run, s_m[k] < me ? s_m[k] : me,
                               s_h[k] > he ? s_h[k] : he, t0, d0);
    if (ch.on && c < nw) s_bits[static_cast<long long>(c) * B + x] = w;
    if (k == 0) o0 = __shfl_sync(FULL, d0, 0);  // chunk c0's row: row 0 in block 0
  }

  // the row-0 carry at o0 = o(0), by block 0's warp 0: Peq bit u of word k
  // for char c is b[o0 + 32 k + u] == c with o0 + 32 k + u < LB (the index
  // clamped into b)
  if (rank == 0 && warp == 0) {
    uint32_t peq[4][NW];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const long long pos = static_cast<long long>(o0) + 32 * k + lane;
      const long long idx = pos < 0 ? 0 : (pos > LB - 1 ? LB - 1 : pos);
      const uint32_t chr = b[static_cast<long long>(x) * b_stride + idx];
      const bool inb = pos < LB;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        peq[c][k] = __ballot_sync(FULL, inb && chr == static_cast<uint32_t>(c));
    }
    const int wb0 = blen - o0;
    const bool in0 = wb0 >= 0 && wb0 < BAND;
    const bool fin0 = a_len[x] == 0;
    // planes 0..31 by lane, 32..42 by lanes 0..10; the Peq planes are
    // warp-uniform ballots, written by lane 0
    for (int p = lane; p < P_PB + 1; p += 32) {
      uint32_t v = 0u;
      if (p < P_VN) v = FULL;                         // VP: D(0, j) = j
      else if (p >= P_PEQ && p < P_SF) continue;      // Peq below
      else if (p == P_SF || p == P_O) v = static_cast<uint32_t>(o0);
      else if (p == P_BEST) v = static_cast<uint32_t>(in0 ? blen : INF);  // sf + wb0 = b_len
      else if (p == P_BEND) v = static_cast<uint32_t>(in0 ? blen : 0);
      else if (p >= P_FVP && p < P_FVN) v = fin0 ? FULL : 0u;
      else if (p == P_FSF || p == P_FO) v = fin0 ? static_cast<uint32_t>(o0) : 0u;
      planes[static_cast<long long>(p) * B + x] = v;
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < NW; ++k)
          planes[static_cast<long long>(P_PEQ + NW * c + k) * B + x] = peq[c][k];
    }
  }
  if (nb > 1) cl.sync();  // no block leaves while a peer may still read its s_pub
}

__global__ void __launch_bounds__(EPI_BLOCK) myers_epilogue_kernel(
    const uint32_t* __restrict__ planes, const int32_t* __restrict__ a_len,
    const int32_t* __restrict__ b_len, int B, int32_t* __restrict__ out) {
  const int x = blockIdx.x * EPI_BLOCK + threadIdx.x;
  if (x >= B) return;
  const auto P = [&](int p) { return planes[static_cast<long long>(p) * B + x]; };
  uint32_t fVP[NW], fVN[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    fVP[k] = P(P_FVP + k);
    fVN[k] = P(P_FVN + k);
  }
  end_pick(fVP, fVN, static_cast<int>(P(P_FSF)), static_cast<int>(P(P_FO)),
           static_cast<int>(P(P_BEST)), static_cast<int>(P(P_AEND)),
           static_cast<int>(P(P_BEND)), static_cast<int>(P(P_PED)), static_cast<int>(P(P_PA)),
           static_cast<int>(P(P_PB)), a_len[x], b_len[x], B, x, out);
}

template <int L>
int launch_prologue(const void* centers, long long c_stride, int uLast, const void* b,
                    long long b_stride, int LB, const void* a_len, const void* b_len, int B,
                    int n_rows, int n_run, int nb, void* s_bits, void* planes,
                    cudaStream_t stream) {
  constexpr int CU = Chunk<L>::CU;
  const int NCH = (n_rows >> 5) + 1;
  const int q = (NCH + nb - 1) / nb;
  const int nstq = (q + 31) >> 5;
  const int nU = q * CU + 1;
  int tile_n = tile_at(nU - 1) + 1;
  if (tile_n > PRO_TILE_MAX) tile_n = 0;  // read from the device each pass
  const long long smem = 4LL * (tile_n + 3LL * nstq);
  if (smem > PRO_SMEM_MAX) return -2;
  auto kernel = myers_prologue_kernel<L>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * nb);
  cfg.blockDim = dim3(PRO_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(nb);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = nb > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int32_t*>(centers), c_stride, uLast,
      static_cast<const uint8_t*>(b), b_stride, LB, static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), B, n_rows, n_run, nb, tile_n,
      static_cast<uint32_t*>(s_bits), static_cast<uint32_t*>(planes));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// centers: int32 rows, row x at centers + x c_stride, of ns >= 1 columns:
// with stride 1 row i's centre is column min(i, C - 1), with stride 16 (the
// 16-row grid) column min(i, C - 1) >> 4; b: uint8 rows of LB >= 1 bytes,
// row x at b + x b_stride; a_len, b_len: int32[B]; rows 0..n_rows are
// scheduled and the shifts of rows 1..n_run (n_run <= n_rows) written.
// nb: blocks an extension, 1..8 (a thread-block cluster above 1).  s_bits:
// uint32[ceil(n_run / 32), B]; planes: uint32[43, B] in K1's order.
// Launches on `stream`; returns the launch's cudaError, -1 for arguments it
// does not take, -2 for a block range too long for shared memory.
extern "C" int canu_myers_prologue(const void* centers, long long c_stride, int ns, int C,
                                   int stride, const void* b, long long b_stride, int LB,
                                   const void* a_len, const void* b_len, int B, int n_rows,
                                   int n_run, int nb, void* s_bits, void* planes,
                                   void* stream) {
  if (B <= 0) return 0;
  if (C < 1 || ns < 1 || LB < 1 || n_rows < 0 || n_run < 0 || n_run > n_rows || nb < 1 ||
      nb > PRO_MAX_BLOCKS || (stride != 1 && stride != 16))
    return -1;
  const int uLast = stride == 16 ? (C - 1) >> 4 : C - 1;
  if (uLast >= ns) return -1;
  const auto s = static_cast<cudaStream_t>(stream);
  return stride == 16 ? launch_prologue<4>(centers, c_stride, uLast, b, b_stride, LB, a_len,
                                            b_len, B, n_rows, n_run, nb, s_bits, planes, s)
                      : launch_prologue<0>(centers, c_stride, uLast, b, b_stride, LB, a_len,
                                            b_len, B, n_rows, n_run, nb, s_bits, planes, s);
}

// planes: uint32[43, B] (K1's output); a_len, b_len: int32[B]; out:
// int32[6, B] = edits, a_used, b_used, p_edits, p_a, p_b.  Launches on
// `stream`; returns cudaGetLastError() of the launch.
extern "C" int canu_myers_epilogue(const void* planes, const void* a_len, const void* b_len,
                                   int B, void* out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + EPI_BLOCK - 1) / EPI_BLOCK;
  myers_epilogue_kernel<<<blocks, EPI_BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), B, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
