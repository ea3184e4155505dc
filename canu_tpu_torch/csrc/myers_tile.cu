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
// _carry_pack computes: per extension, over rows i = 0..n_rows (the
// centres' last column repeated past their width),
//   t(i)  = cummax(clip(centre(i) - 64, 0, max(b_len, 0))),
//   lo(i) = min_{j <= i}(t(j) - j) + i,  hi(i) = max_{j >= i}(t(j) - j) + i,
//   o(i)  = min((lo(i) + hi(i)) >> 1, t(0) + i),
// the shift bit of row i = o(i) - o(i-1) (0 or 1) for rows 1..n_run, and
// the row-0 carry planes at o(0).  One warp an extension, 128 rows a step,
// four consecutive rows a lane (the centres read coalesced and transposed
// through shared memory): each lane scans its four rows, warp-shuffle
// scans carry the running max and min across the lanes, and 8 lanes' 4-bit
// nibbles make a 32-row shift word.  hi needs every later row, so there
// are two passes: the forward pass keeps only each step's entering running
// max and min in a device scratch the wrapper allocates (8 bytes a 128
// rows, int2[B, ceil((n_rows + 1) / 128)]), and the backward pass reads the
// centres again, recomputes t and lo from those and carries the suffix
// max down.  Storing t (4 bytes a row) instead would read 12 bytes a row
// in all against this design's 8.  The first design (a row a lane, 32
// rows a step) spent its time in the warp scans' shuffles (1.05 ms on a
// group of 16,384 x 8,193 rows on an H100, against 0.53 ms; PERF.md).  Row
// counts run from 512 to millions (the judge's pieces), so nothing of an
// extension's rows is held on chip.  What bounds K10: the bytes, the
// centres read twice; no PyTorch op runs over [B, n_rows + 1].
//
// K11 (canu_myers_epilogue) replaces :418 _carry_unpack and :336
// _myers_finish: from K1's final planes, the A-exhausted row's 128 scores
// (fin_sf plus the exclusive prefix of fVP - fVN, a column counting only
// while fin_o + w <= b_len), its first minimum, the pick against the
// B-exhausted cost (ties to the A end) and the partial endpoints clamped
// to the reads; the six int32[B] results of the plain _myers_finish.  A
// thread an extension; it reads 43 planes and writes 6 words.
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

// ---- K10 and K11 -------------------------------------------------------------

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int INF = 1 << 28;
constexpr int PRO_WARPS = 8;      // extensions (warps) a block of K10
constexpr int EPI_BLOCK = 128;    // threads a block of K11
constexpr int PRO_ROWS = 4;       // consecutive rows a lane of K10 holds
constexpr int PRO_STEP = 32 * PRO_ROWS;  // rows a warp of K10 takes a step

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

// Step s of a warp holds rows s * PRO_STEP .. + PRO_STEP - 1, lane l rows
// s * PRO_STEP + PRO_ROWS l + q (q < PRO_ROWS): a lane scans its own rows,
// the warp scans the lanes' results, so a step pays three 5-shuffle warp
// scans for 128 rows.  The centres arrive coalesced (row r + 32 j at lane
// r of load j) and are transposed through the warp's tile in shared memory.
struct ProStep {
  int c[PRO_ROWS];
};

__device__ __forceinline__ ProStep load_step(const int32_t* __restrict__ crow, int C, int s,
                                             int lane) {
  ProStep v;
#pragma unroll
  for (int j = 0; j < PRO_ROWS; ++j) {
    const int r = s * PRO_STEP + 32 * j + lane;
    v.c[j] = __ldg(crow + (r < C ? r : C - 1));
  }
  return v;
}

// the lane's PRO_ROWS consecutive centres of a loaded step
__device__ __forceinline__ void lane_rows(const ProStep& v, int* tile, int lane, int* c) {
  __syncwarp();  // the previous step's readers
#pragma unroll
  for (int j = 0; j < PRO_ROWS; ++j) tile[32 * j + lane] = v.c[j];
  __syncwarp();
#pragma unroll
  for (int q = 0; q < PRO_ROWS; ++q) c[q] = tile[PRO_ROWS * lane + q];
}

// t and the running min of t - i of the lane's rows i0 + q, from the
// step's entering running max tin and min min_in; returns in out the
// step's leaving pair
__device__ __forceinline__ void forward_rows(const int* c, int bcl, int i0, int lane, int tin,
                                             int min_in, int* t, int* m, int2& out) {
#pragma unroll
  for (int q = 0; q < PRO_ROWS; ++q) {
    t[q] = target(c[q], bcl);
    if (q) t[q] = t[q] > t[q - 1] ? t[q] : t[q - 1];
  }
  int before = warp_excl_max(t[PRO_ROWS - 1], lane, tin);
  before = before > tin ? before : tin;
#pragma unroll
  for (int q = 0; q < PRO_ROWS; ++q) {
    t[q] = t[q] > before ? t[q] : before;
    m[q] = t[q] - (i0 + q);
    if (q) m[q] = m[q] < m[q - 1] ? m[q] : m[q - 1];
  }
  int mb = warp_excl_min(m[PRO_ROWS - 1], lane, min_in);
  mb = mb < min_in ? mb : min_in;
#pragma unroll
  for (int q = 0; q < PRO_ROWS; ++q) m[q] = m[q] < mb ? m[q] : mb;
  out = make_int2(__shfl_sync(FULL, t[PRO_ROWS - 1], 31), __shfl_sync(FULL, m[PRO_ROWS - 1], 31));
}

__global__ void __launch_bounds__(PRO_WARPS * 32) myers_prologue_kernel(
    const int32_t* __restrict__ centers, long long c_stride, int C,
    const uint8_t* __restrict__ b, long long b_stride, int LB, const int32_t* __restrict__ a_len,
    const int32_t* __restrict__ b_len, int B, int n_rows, int n_run,
    uint32_t* __restrict__ s_bits, uint32_t* __restrict__ planes, int2* __restrict__ scratch) {
  __shared__ int s_tile[PRO_WARPS][PRO_STEP];
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * PRO_WARPS + (threadIdx.x >> 5);
  if (x >= B) return;  // a whole warp leaves together
  int* tile = s_tile[threadIdx.x >> 5];

  const int32_t* crow = centers + static_cast<long long>(x) * c_stride;
  const int blen = b_len[x];
  const int bcl = blen > 0 ? blen : 0;
  const int nst = (n_rows + 1 + PRO_STEP - 1) / PRO_STEP;  // steps over rows 0..n_rows
  const int nw = (n_run + 31) >> 5;                         // shift words
  int2* carry = scratch + static_cast<long long>(x) * nst;
  const int t0 = target(__ldg(crow), bcl);
  int c[PRO_ROWS], t[PRO_ROWS], m[PRO_ROWS];

  // forward: each step's entering running max of t and min of t - i (t >= 0,
  // so 0 is the empty max)
  int2 run = make_int2(0, 0x7FFFFFFF);
  ProStep nxt = load_step(crow, C, 0, lane);
  for (int s = 0; s < nst; ++s) {
    const ProStep cur = nxt;
    if (s + 1 < nst) nxt = load_step(crow, C, s + 1, lane);  // one step ahead
    if (lane == 0) carry[s] = run;
    lane_rows(cur, tile, lane, c);
    forward_rows(c, bcl, s * PRO_STEP + PRO_ROWS * lane, lane, run.x, run.y, t, m, run);
  }
  __syncwarp();  // lane 0's carries, read back by every lane

  // backward: the suffix max of t - i from the last row down, o and the
  // shift words (word w = rows 32 w + 1 .. 32 w + 32: bit r the shift of row
  // 32 w + r + 1, o(i + 1) - o(i); the o of the row after a lane's last from
  // the next lane, or for lane 31 the first row of step s + 1)
  int mcarry = -0x7FFFFFFF - 1;
  int o_next = 0;
  nxt = load_step(crow, C, nst - 1, lane);
  for (int s = nst - 1; s >= 0; --s) {
    const ProStep cur = nxt;
    if (s > 0) nxt = load_step(crow, C, s - 1, lane);
    const int i0 = s * PRO_STEP + PRO_ROWS * lane;
    int2 leave;
    lane_rows(cur, tile, lane, c);
    forward_rows(c, bcl, i0, lane, carry[s].x, carry[s].y, t, m, leave);
    int hm[PRO_ROWS];
#pragma unroll
    for (int q = PRO_ROWS - 1; q >= 0; --q) {
      hm[q] = i0 + q <= n_rows ? t[q] - (i0 + q) : -0x7FFFFFFF - 1;
      if (q + 1 < PRO_ROWS) hm[q] = hm[q] > hm[q + 1] ? hm[q] : hm[q + 1];
    }
    int after = warp_excl_suffix_max(hm[0], lane, mcarry);
    after = after > mcarry ? after : mcarry;
    int o[PRO_ROWS];
#pragma unroll
    for (int q = 0; q < PRO_ROWS; ++q) {
      const int i = i0 + q;
      hm[q] = hm[q] > after ? hm[q] : after;
      const int lo = m[q] + i, hi = hm[q] + i;
      o[q] = (lo + hi) >> 1;
      o[q] = o[q] < t0 + i ? o[q] : t0 + i;
    }
    int on = __shfl_down_sync(FULL, o[0], 1);
    if (lane == 31) on = o_next;
    uint32_t nib = 0u;
#pragma unroll
    for (int q = 0; q < PRO_ROWS; ++q) {
      const int o1 = q + 1 < PRO_ROWS ? o[q + 1] : on;
      nib |= static_cast<uint32_t>(i0 + q + 1 <= n_run && o1 != o[q]) << q;
    }
    // 8 lanes a 32-row word: lane 8 w + v holds bits 4 v .. 4 v + 3 of word w
    uint32_t word = nib << (PRO_ROWS * (lane & 7));
    word |= __shfl_xor_sync(FULL, word, 1);
    word |= __shfl_xor_sync(FULL, word, 2);
    word |= __shfl_xor_sync(FULL, word, 4);
    const int wi = s * (PRO_STEP / 32) + (lane >> 3);
    if ((lane & 7) == 0 && wi < nw) s_bits[static_cast<long long>(wi) * B + x] = word;
    mcarry = __shfl_sync(FULL, hm[0], 0);
    o_next = __shfl_sync(FULL, o[0], 0);
  }

  // the row-0 carry at o0 = o(0): Peq bit u of word k for char c is b[o0 +
  // 32 k + u] == c with o0 + 32 k + u < LB (the index clamped into b)
  const int o0 = o_next;
  uint32_t peq[4][NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const long long pos = static_cast<long long>(o0) + 32 * k + lane;
    const long long idx = pos < 0 ? 0 : (pos > LB - 1 ? LB - 1 : pos);
    const uint32_t ch = b[static_cast<long long>(x) * b_stride + idx];
    const bool inb = pos < LB;
#pragma unroll
    for (int c = 0; c < 4; ++c) peq[c][k] = __ballot_sync(FULL, inb && ch == static_cast<uint32_t>(c));
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

__global__ void __launch_bounds__(EPI_BLOCK) myers_epilogue_kernel(
    const uint32_t* __restrict__ planes, const int32_t* __restrict__ a_len,
    const int32_t* __restrict__ b_len, int B, int32_t* __restrict__ out) {
  const int x = blockIdx.x * EPI_BLOCK + threadIdx.x;
  if (x >= B) return;
  const auto P = [&](int p) { return planes[static_cast<long long>(p) * B + x]; };
  const int blen = b_len[x], alen = a_len[x];
  const int fin_sf = static_cast<int>(P(P_FSF)), fin_o = static_cast<int>(P(P_FO));
  const int best_bx = static_cast<int>(P(P_BEST));
  // the A-exhausted row: score(w) = fin_sf + sum_{v < w} (fVP_v - fVN_v),
  // INF where fin_o + w > b_len; the first minimum
  int acc = fin_sf, cost = 0, wbest = 0;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    const uint32_t vp = P(P_FVP + k), vn = P(P_FVN + k);
    for (int u = 0; u < 32; ++u) {
      const int w = 32 * k + u;
      const int sc = fin_o + w <= blen ? acc : INF;
      if (w == 0 || sc < cost) {
        cost = sc;
        wbest = w;
      }
      acc += static_cast<int>((vp >> u) & 1u) - static_cast<int>((vn >> u) & 1u);
    }
  }
  const bool use_ax = cost <= best_bx;
  const int p_a = static_cast<int>(P(P_PA)), p_b = static_cast<int>(P(P_PB));
  out[x] = use_ax ? cost : best_bx;
  out[B + x] = use_ax ? alen : static_cast<int>(P(P_AEND));
  out[2 * B + x] = use_ax ? fin_o + wbest : static_cast<int>(P(P_BEND));
  out[3 * B + x] = static_cast<int>(P(P_PED));
  out[4 * B + x] = p_a < alen ? p_a : alen;
  out[5 * B + x] = p_b < blen ? p_b : blen;
}

}  // namespace

// centers: int32 rows of C >= 1 columns, row x at centers + x c_stride; b:
// uint8 rows of LB >= 1 bytes, row x at b + x b_stride; a_len, b_len:
// int32[B]; rows 0..n_rows are scheduled and the shifts of rows 1..n_run
// (n_run <= n_rows) written.  s_bits: uint32[ceil(n_run / 32), B]; planes:
// uint32[43, B] in K1's order; scratch: int2[B, ceil((n_rows + 1) / 128)].
// Launches on `stream`; returns cudaGetLastError() of the launch, or -1
// for arguments it does not take.
extern "C" int canu_myers_prologue(const void* centers, long long c_stride, int C,
                                   const void* b, long long b_stride, int LB, const void* a_len,
                                   const void* b_len, int B, int n_rows, int n_run, void* s_bits,
                                   void* planes, void* scratch, void* stream) {
  if (B <= 0) return 0;
  if (C < 1 || LB < 1 || n_rows < 0 || n_run < 0 || n_run > n_rows) return -1;
  const int blocks = (B + PRO_WARPS - 1) / PRO_WARPS;
  myers_prologue_kernel<<<blocks, PRO_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(centers), c_stride, C, static_cast<const uint8_t*>(b),
      b_stride, LB, static_cast<const int32_t*>(a_len), static_cast<const int32_t*>(b_len), B,
      n_rows, n_run, static_cast<uint32_t*>(s_bits), static_cast<uint32_t*>(planes),
      static_cast<int2*>(scratch));
  return static_cast<int>(cudaGetLastError());
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
