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
// min(a_len, n_rows).  The band start comes from the recurrence above in
// the kernel: no [B, n_rows+1] schedule tensor is built.
//
// canu_extend_warp (K2) replaces canu_tpu/ops/pallas/extend_x8.py:
// _extend_x8_kernel (driven by banded_extend_pallas_x8), the engine of
// overlap verification at an ovlBandWidth other than 128.  One warp per
// extension, 8 warps per block; each lane holds band/32 contiguous cells
// of the row in registers.  up/diag at offsets s and s-1 come in-lane
// plus __shfl_down_sync from the next lane, one cell per step (s <= SMAX
// = 4, which is the whole slice of a lane at band 128), or one
// __shfl_up_sync for s = 0; the prefix-min is sequential in-lane, then a
// 5-step __shfl_up_sync scan of the lane minima.  The TPU kernel's
// layout (8 pairs in sublanes, a select over SMAX+2 rolled copies, a B
// window refilled every 32 rows) is not carried over: B characters are
// read straight from device memory at o(i) + w - 1, coalesced across the
// warp, and no pair waits for the longest of its group.
//
// canu_extend_block (K3) replaces canu_tpu/ops/pallas/extend.py:
// _extend_kernel (driven by banded_extend_pallas), one pair per program,
// which nothing in canu_tpu's pipeline calls; the port runs it for the
// bands K2 does not hold in registers (640 to 1024).  One block per
// extension, one thread per band cell, the previous row in shared memory
// (double buffered); the prefix-min is a warp scan plus a pass over the
// warp totals in shared memory, two __syncthreads per row.
//
// What bounds both on an H100: latency, not bytes or ALU throughput.  A
// row is a dependent chain (shuffles of the previous row, the prefix-min
// scan, ~20 dependent steps of a few cycles to ~30 each) and an
// extension has up to ~8k rows; a row reads band bytes of B.  K2 packs 8
// extensions per block so a 1,024-extension call is 128 blocks (one per
// SM) of 8 independent chains each; K3 puts 1,024 blocks of band threads
// on the card but pays two block barriers per row.  Shortening the chain
// (two cells per shuffle step, the scan across fewer lanes) and more
// extensions per SM are left to later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int INF = 1 << 28;
constexpr int SMAX = 4;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int WARPS_PER_BLOCK = 8;  // K2
constexpr int BLOCK_MAX_BAND = 1024;  // K3: one thread per cell

__device__ __forceinline__ int clip_start(int c, int half, int bhi) {
  return min(max(c - half, 0), bhi);
}

// T(w) <- T(w + 1) across the warp's band slice, INF entering at the end
template <int C>
__device__ __forceinline__ void shift_one(int (&T)[C], int lane) {
  int nx = __shfl_down_sync(FULL, T[0], 1);
  if (lane == 31) nx = INF;
#pragma unroll
  for (int c = 0; c + 1 < C; ++c) T[c] = T[c + 1];
  T[C - 1] = nx;
}

template <int C>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK) extend_warp_kernel(
    const uint8_t* __restrict__ a, int LA, const int32_t* __restrict__ a_len,
    const uint8_t* __restrict__ b, int LB, const int32_t* __restrict__ b_len,
    const int32_t* __restrict__ centers, int n_cen, int B, int n_rows,
    int32_t* __restrict__ out) {
  constexpr int BAND = 32 * C;
  const int lane = threadIdx.x & 31;
  const int x = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  if (x >= B) return;  // x is uniform across the warp

  const int alen = a_len[x];
  const int blen = b_len[x];
  const int bhi = max(blen, 0);
  const int32_t* cen = centers + (size_t)x * n_cen;
  const uint8_t* arow = a + (size_t)x * LA;
  const uint8_t* brow = b + (size_t)x * LB;
  const int w0 = lane * C;

  int cm = clip_start(cen[0], BAND / 2, bhi);
  int o = cm;
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
  int c_next = last >= 1 ? cen[1] : 0;
  int a_next = last >= 1 ? arow[0] : 0;
  for (int i = 1; i <= last; ++i) {
    cm = max(cm, clip_start(c_next, BAND / 2, bhi));
    const int ach = a_next;
    if (i < last) {  // the next row's scalars, ahead of this row's chain
      c_next = cen[i + 1];
      a_next = arow[min(i, LA - 1)];
    }
    const int o_i = min(cm, o + SMAX);
    const int s = o_i - o;  // warp-uniform, 0..SMAX

    int up[C], dg[C];
    if (s == 0) {
      const int pl = __shfl_up_sync(FULL, D[C - 1], 1);
      dg[0] = lane == 0 ? INF : pl;
#pragma unroll
      for (int c = 1; c < C; ++c) dg[c] = D[c - 1];
#pragma unroll
      for (int c = 0; c < C; ++c) up[c] = D[c];
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) dg[c] = D[c];
      for (int t = 1; t < s; ++t) shift_one<C>(dg, lane);
#pragma unroll
      for (int c = 0; c < C; ++c) up[c] = dg[c];
      shift_one<C>(up, lane);
    }

    int r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = w0 + c;
      const int j = o_i + w;
      const int bch = brow[min(max(j - 1, 0), LB - 1)];
      const int sub = ach != bch ? 1 : 0;
      const bool vdg = j >= 1 && j <= blen;
      const int m = min(up[c] + 1, vdg ? dg[c] + sub : INF);
      r[c] = min(m - w, INF);
    }
    // prefix-min: in-lane, then across the lanes' minima
#pragma unroll
    for (int c = 1; c < C; ++c) r[c] = min(r[c], r[c - 1]);
    int tot = r[C - 1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, tot, d);
      if (lane >= d) tot = min(tot, v);
    }
    int excl = __shfl_up_sync(FULL, tot, 1);
    if (lane == 0) excl = INF;  // r <= INF, so INF is min's identity here
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = w0 + c;
      D[c] = o_i + w <= blen ? min(r[c], excl) + w : INF;
    }
    o = o_i;

    // B exhausted at this row: the column j == b_len, via its owning lane
    const int wcol = blen - o;
    if (wcol >= 0 && wcol < BAND) {
      int v = 0;
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (w0 + c == wcol) v = D[c];
      const int cost = __shfl_sync(FULL, v, wcol / C);
      if (cost < best_bx) {
        best_bx = cost;
        aend_bx = i;
        bend_bx = blen;
      }
    }
  }

  // A exhausted: the first minimum of row a_len (all INF if a_len is not
  // a row of the extension)
  const bool fin = alen >= 0 && alen <= n_rows;
  int bv = fin ? D[0] : INF;
  int bi = w0;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const int v = fin ? D[c] : INF;
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

__global__ void __launch_bounds__(BLOCK_MAX_BAND) extend_block_kernel(
    const uint8_t* __restrict__ a, int LA, const int32_t* __restrict__ a_len,
    const uint8_t* __restrict__ b, int LB, const int32_t* __restrict__ b_len,
    const int32_t* __restrict__ centers, int n_cen, int B, int band, int n_rows,
    int32_t* __restrict__ out) {
  extern __shared__ int smem[];
  int* cur = smem;          // previous row
  int* nxt = smem + band;   // this row
  int* wmin = smem + 2 * band;  // warp minima of the prefix-min
  const int x = blockIdx.x;
  const int w = threadIdx.x;
  const int lane = w & 31;
  const int warp = w >> 5;

  const int alen = a_len[x];
  const int blen = b_len[x];
  const int bhi = max(blen, 0);
  const int32_t* cen = centers + (size_t)x * n_cen;
  const uint8_t* arow = a + (size_t)x * LA;
  const uint8_t* brow = b + (size_t)x * LB;
  const int half = band / 2;

  int cm = clip_start(cen[0], half, bhi);
  int o = cm;
  cur[w] = o + w <= blen ? o + w : INF;
  const int wcol0 = blen - o;
  const bool in0 = wcol0 >= 0 && wcol0 < band;
  int best_bx = in0 ? blen : INF;
  int aend_bx = 0;
  int bend_bx = in0 ? blen : 0;
  __syncthreads();

  const int last = min(n_rows, alen);
  for (int i = 1; i <= last; ++i) {
    cm = max(cm, clip_start(cen[i], half, bhi));
    const int o_i = min(cm, o + SMAX);
    const int s = o_i - o;
    const int up = w + s < band ? cur[w + s] : INF;
    const int dg = w + s - 1 >= 0 && w + s - 1 < band ? cur[w + s - 1] : INF;
    const int j = o_i + w;
    const int ach = arow[min(i - 1, LA - 1)];
    const int bch = brow[min(max(j - 1, 0), LB - 1)];
    const bool vdg = j >= 1 && j <= blen;
    const int m = min(up + 1, vdg ? dg + (ach != bch ? 1 : 0) : INF);
    int r = min(m - w, INF);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, r, d);
      if (lane >= d) r = min(r, v);
    }
    if (lane == 31) wmin[warp] = r;
    __syncthreads();
    for (int q = 0; q < warp; ++q) r = min(r, wmin[q]);
    nxt[w] = j <= blen ? r + w : INF;
    __syncthreads();
    o = o_i;

    const int wcol = blen - o;
    if (wcol >= 0 && wcol < band) {
      const int cost = nxt[wcol];
      if (cost < best_bx) {
        best_bx = cost;
        aend_bx = i;
        bend_bx = blen;
      }
    }
    int* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (w == 0) {
    const bool fin = alen >= 0 && alen <= n_rows;
    int bv = INF, bi = 0;
    if (fin) {
      bv = cur[0];
      for (int q = 1; q < band; ++q)
        if (cur[q] < bv) {
          bv = cur[q];
          bi = q;
        }
    }
    const bool use_ax = bv <= best_bx;
    out[x] = use_ax ? bv : best_bx;
    out[(size_t)B + x] = use_ax ? alen : aend_bx;
    out[(size_t)2 * B + x] = use_ax ? (fin ? o : 0) + bi : bend_bx;
  }
}

template <int C>
void launch_warp(const void* a, int LA, const void* a_len, const void* b, int LB,
                 const void* b_len, const void* centers, int n_cen, int B, int n_rows,
                 void* out, cudaStream_t stream) {
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  extend_warp_kernel<C><<<blocks, 32 * WARPS_PER_BLOCK, 0, stream>>>(
      static_cast<const uint8_t*>(a), LA, static_cast<const int32_t*>(a_len),
      static_cast<const uint8_t*>(b), LB, static_cast<const int32_t*>(b_len),
      static_cast<const int32_t*>(centers), n_cen, B, n_rows, static_cast<int32_t*>(out));
}

}  // namespace

// Common arguments: a uint8[B, LA], a_len int32[B], b uint8[B, LB], b_len
// int32[B], centers int32[B, n_cen] with n_cen >= n_rows + 1; out
// int32[3, B] = (edits, a_used, b_used).  Both launch on `stream` and
// return cudaGetLastError() of the launch, or -1 for a band the kernel
// does not hold.

// K2: band 128, 256, 384 or 512 (band/32 cells per lane in registers).
extern "C" int canu_extend_warp(const void* a, int LA, const void* a_len, const void* b,
                                int LB, const void* b_len, const void* centers, int n_cen,
                                int B, int band, int n_rows, void* out, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (band) {
    case 128: launch_warp<4>(a, LA, a_len, b, LB, b_len, centers, n_cen, B, n_rows, out, st); break;
    case 256: launch_warp<8>(a, LA, a_len, b, LB, b_len, centers, n_cen, B, n_rows, out, st); break;
    case 384: launch_warp<12>(a, LA, a_len, b, LB, b_len, centers, n_cen, B, n_rows, out, st); break;
    case 512: launch_warp<16>(a, LA, a_len, b, LB, b_len, centers, n_cen, B, n_rows, out, st); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

// K3: any multiple of 128 up to 1024 (one thread per cell).
extern "C" int canu_extend_block(const void* a, int LA, const void* a_len, const void* b,
                                 int LB, const void* b_len, const void* centers, int n_cen,
                                 int B, int band, int n_rows, void* out, void* stream) {
  if (band < 128 || band > BLOCK_MAX_BAND || band % 128 != 0) return -1;
  if (B <= 0) return 0;
  const size_t smem = (size_t)(2 * band + 32) * sizeof(int);
  extend_block_kernel<<<B, band, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), LA, static_cast<const int32_t*>(a_len),
      static_cast<const uint8_t*>(b), LB, static_cast<const int32_t*>(b_len),
      static_cast<const int32_t*>(centers), n_cen, B, band, n_rows,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
