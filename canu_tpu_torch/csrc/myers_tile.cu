// Kernel K1: the row loop of the banded Myers bit-vector extension.
//
// Replaces canu_tpu/ops/pallas/myers_pallas.py:_myers_tile_kernel (driven
// by myers_run_pallas) and computes exactly what the plain PyTorch loop
// canu_tpu_torch/ops/myers.py:_myers_segment computes, bit for bit.
//
// One extension per thread.  The 128-column band is 4 chained uint32
// words; the thread holds the band and all 43 state words of the carry in
// registers and runs every row of its extension in one launch: per row a
// conditional one-column window shift that inserts the entering B char
// into the 4 Peq bitplanes, the 4-word chained Myers column update with a
// +1 top boundary, and the three captures (best cost at B exhaustion, the
// state at A exhaustion, the furthest in-envelope band-centre endpoint).
// A lane does nothing once its row passes a_len, so the loop stops there.
//
// What bounds it on an H100: integer-ALU issue and latency per row, not
// bytes.  A row is ~150 dependent 32-bit ops per thread against 3 bytes +
// 4 bytes of row streams (laid out [row, B] so a warp's loads coalesce)
// and one byte gathered from the thread's own B read.  At the main path's
// 4096 extensions per group the launch is only 32 blocks of 128 threads
// on 132 SMs — one warp per SM cannot hide the dependency latency.
// Raising occupancy (more extensions per launch, or a warp per pair
// splitting the word chain) is left to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 4;        // uint32 words per 128-column band
constexpr int BAND = 128;
constexpr int INF = 1 << 28;

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

// low clip(w - 32k, 0, 32) bits set.  A shift by 32 is undefined in C++,
// so the full word is selected explicitly.
__device__ __forceinline__ uint32_t word_mask(int w, int k) {
  int m = min(max(w - 32 * k, 0), 32);
  return m >= 32 ? 0xFFFFFFFFu : ((1u << m) - 1u);
}

// 32-bit two's-complement product, as XLA's int32 multiply wraps (a
// signed overflow would be undefined in C++).
__device__ __forceinline__ int mul_wrap(int x, int y) {
  return static_cast<int>(static_cast<uint32_t>(x) * static_cast<uint32_t>(y));
}

__global__ void __launch_bounds__(128) myers_rows_kernel(
    const uint32_t* __restrict__ carry0, uint32_t* __restrict__ carry_out,
    const uint8_t* __restrict__ a_rows, const uint8_t* __restrict__ s_rows,
    const int32_t* __restrict__ ent_rows, const uint8_t* __restrict__ b, int LB,
    const int32_t* __restrict__ a_len, const int32_t* __restrict__ b_len, int B,
    int n_run, int cap_q) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= B) return;

  uint32_t VP[NW], VN[NW], Peq[4][NW], fVP[NW], fVN[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    VP[k] = carry0[(size_t)(P_VP + k) * B + x];
    VN[k] = carry0[(size_t)(P_VN + k) * B + x];
    fVP[k] = carry0[(size_t)(P_FVP + k) * B + x];
    fVN[k] = carry0[(size_t)(P_FVN + k) * B + x];
#pragma unroll
    for (int c = 0; c < 4; ++c) Peq[c][k] = carry0[(size_t)(P_PEQ + NW * c + k) * B + x];
  }
  int sf = static_cast<int>(carry0[(size_t)P_SF * B + x]);
  int o = static_cast<int>(carry0[(size_t)P_O * B + x]);
  int best_bx = static_cast<int>(carry0[(size_t)P_BEST * B + x]);
  int aend_bx = static_cast<int>(carry0[(size_t)P_AEND * B + x]);
  int bend_bx = static_cast<int>(carry0[(size_t)P_BEND * B + x]);
  int fin_sf = static_cast<int>(carry0[(size_t)P_FSF * B + x]);
  int fin_o = static_cast<int>(carry0[(size_t)P_FO * B + x]);
  int p_ext = static_cast<int>(carry0[(size_t)P_PEXT * B + x]);
  int p_ed = static_cast<int>(carry0[(size_t)P_PED * B + x]);
  int p_a = static_cast<int>(carry0[(size_t)P_PA * B + x]);
  int p_b = static_cast<int>(carry0[(size_t)P_PB * B + x]);

  const int alen = a_len[x];
  const int blen = b_len[x];
  const uint8_t* brow = b + (size_t)x * LB;
  // rows past a_len change nothing (no shift, no update, no capture)
  const int last = min(n_run, alen);

  for (int i = 1; i <= last; ++i) {
    const size_t off = (size_t)(i - 1) * B + x;
    const int s = s_rows[off];
    const int ach = a_rows[off];

    // ---- window shift: the band moves down one column ----
    if (s > 0) {
      const int e = min(max(ent_rows[off], 0), LB - 1);
      const uint32_t bch = brow[e];
      sf += static_cast<int>(VP[0] & 1u) - static_cast<int>(VN[0] & 1u);
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const uint32_t hp = k + 1 < NW ? VP[k + 1] : 1u;  // below-band wall: +1
        const uint32_t hn = k + 1 < NW ? VN[k + 1] : 0u;
        VP[k] = (VP[k] >> 1) | (hp << 31);
        VN[k] = (VN[k] >> 1) | (hn << 31);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const uint32_t hi = k + 1 < NW ? Peq[c][k + 1] : (bch == (uint32_t)c ? 1u : 0u);
          Peq[c][k] = (Peq[c][k] >> 1) | (hi << 31);
        }
      }
    }
    o += s;

    // ---- Myers column update, words chained like edlib's blocks ----
    uint32_t hp_in = 1u, hm_in = 0u;  // the window top grows +1 per row
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      const uint32_t eq_all = ach == 0 ? Peq[0][k] : ach == 1 ? Peq[1][k]
                            : ach == 2 ? Peq[2][k] : ach == 3 ? Peq[3][k] : 0u;
      const uint32_t Pv = VP[k], Mv = VN[k];
      const uint32_t Xv = eq_all | Mv;
      const uint32_t Eq = eq_all | hm_in;
      const uint32_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
      uint32_t Ph = Mv | ~(Xh | Pv);
      uint32_t Mh = Pv & Xh;
      const uint32_t hp_out = Ph >> 31, hm_out = Mh >> 31;
      Ph = (Ph << 1) | hp_in;
      Mh = (Mh << 1) | hm_in;
      VP[k] = Mh | ~(Xv | Ph);
      VN[k] = Ph & Xv;
      hp_in = hp_out;
      hm_in = hm_out;
    }
    sf += 1;

    // ---- B-exhaustion capture: column j == b_len inside the window ----
    const int wb = blen - o;
    if (wb >= 0 && wb < BAND) {
      int cost = sf;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        const uint32_t m = word_mask(wb, k);
        cost += __popc(VP[k] & m) - __popc(VN[k] & m);
      }
      if (cost < best_bx) {
        best_bx = cost;
        aend_bx = i;
        bend_bx = blen;
      }
    }

    // ---- A-exhaustion capture ----
    if (i == alen) {
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        fVP[k] = VP[k];
        fVN[k] = VN[k];
      }
      fin_sf = sf;
      fin_o = o;
    }

    // ---- furthest in-envelope endpoint on the band centre ----
    const int jc = o + BAND / 2;
    const int sc = sf + __popc(VP[0]) + __popc(VP[1]) - __popc(VN[0]) - __popc(VN[1]);
    const int ext = i + jc;
    const int sc_c = min(sc, 80000);
    const int ext_c = min(ext, 400000);
    if (jc <= blen && mul_wrap(sc_c, 20000) <= mul_wrap(cap_q, ext_c) && ext > p_ext) {
      p_ext = ext;
      p_ed = sc;
      p_a = i;
      p_b = jc;
    }
  }

#pragma unroll
  for (int k = 0; k < NW; ++k) {
    carry_out[(size_t)(P_VP + k) * B + x] = VP[k];
    carry_out[(size_t)(P_VN + k) * B + x] = VN[k];
    carry_out[(size_t)(P_FVP + k) * B + x] = fVP[k];
    carry_out[(size_t)(P_FVN + k) * B + x] = fVN[k];
#pragma unroll
    for (int c = 0; c < 4; ++c) carry_out[(size_t)(P_PEQ + NW * c + k) * B + x] = Peq[c][k];
  }
  carry_out[(size_t)P_SF * B + x] = static_cast<uint32_t>(sf);
  carry_out[(size_t)P_O * B + x] = static_cast<uint32_t>(o);
  carry_out[(size_t)P_BEST * B + x] = static_cast<uint32_t>(best_bx);
  carry_out[(size_t)P_AEND * B + x] = static_cast<uint32_t>(aend_bx);
  carry_out[(size_t)P_BEND * B + x] = static_cast<uint32_t>(bend_bx);
  carry_out[(size_t)P_FSF * B + x] = static_cast<uint32_t>(fin_sf);
  carry_out[(size_t)P_FO * B + x] = static_cast<uint32_t>(fin_o);
  carry_out[(size_t)P_PEXT * B + x] = static_cast<uint32_t>(p_ext);
  carry_out[(size_t)P_PED * B + x] = static_cast<uint32_t>(p_ed);
  carry_out[(size_t)P_PA * B + x] = static_cast<uint32_t>(p_a);
  carry_out[(size_t)P_PB * B + x] = static_cast<uint32_t>(p_b);
}

}  // namespace

// carry0/carry_out: uint32[43, B]; a_rows, s_rows: uint8[n_run, B];
// ent_rows: int32[n_run, B]; b: uint8[B, LB]; a_len, b_len: int32[B].
// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int canu_myers_rows(const void* carry0, void* carry_out, const void* a_rows,
                               const void* s_rows, const void* ent_rows, const void* b,
                               int LB, const void* a_len, const void* b_len, int B,
                               int n_run, int cap_q, void* stream) {
  if (B <= 0) return 0;
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  myers_rows_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(carry0), static_cast<uint32_t*>(carry_out),
      static_cast<const uint8_t*>(a_rows), static_cast<const uint8_t*>(s_rows),
      static_cast<const int32_t*>(ent_rows), static_cast<const uint8_t*>(b), LB,
      static_cast<const int32_t*>(a_len), static_cast<const int32_t*>(b_len), B, n_run,
      cap_q);
  return static_cast<int>(cudaGetLastError());
}
