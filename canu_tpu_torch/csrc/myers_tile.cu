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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;        // uint32 words per 128-column band
constexpr int BAND = 128;
constexpr int WIN = 16;      // bytes per register window (one uint4)
constexpr int BLOCK = 32;    // threads per block: 4,096 extensions fill 128 SMs

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

__global__ void __launch_bounds__(BLOCK) myers_rows_kernel(
    const uint32_t* __restrict__ carry0, uint32_t* __restrict__ carry_out,
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

}  // namespace

// carry0/carry_out: uint32[43, B]; a: uint8[B, a_stride] (row i reads
// a[x, i-1], a_stride >= n_run); s_bits: uint32[ceil(n_run/32), B], bit
// (i-1) % 32 of word (i-1) / 32 = the shift of row i; b: uint8[B,
// b_stride], LB <= b_stride its logical width; a_len, b_len: int32[B].
// a_stride and b_stride are multiples of 16 and a, b 16-byte aligned.
// Launches on `stream`; returns cudaGetLastError() of the launch, or -1
// for arguments it does not take.
extern "C" int canu_myers_rows(const void* carry0, void* carry_out, const void* a,
                               int a_stride, const void* s_bits, const void* b, int b_stride,
                               int LB, const void* a_len, const void* b_len, int B, int n_run,
                               int cap_q, void* stream) {
  if (B <= 0) return 0;
  if (a_stride % WIN || b_stride % WIN || a_stride < n_run || LB < 1 || LB > b_stride)
    return -1;
  const int blocks = (B + BLOCK - 1) / BLOCK;
  myers_rows_kernel<<<blocks, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(carry0), static_cast<uint32_t*>(carry_out),
      static_cast<const uint8_t*>(a), a_stride, static_cast<const uint32_t*>(s_bits),
      static_cast<const uint8_t*>(b), b_stride, LB, static_cast<const int32_t*>(a_len),
      static_cast<const int32_t*>(b_len), B, n_run, cap_q);
  return static_cast<int>(cudaGetLastError());
}
