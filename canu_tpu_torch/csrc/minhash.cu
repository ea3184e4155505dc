// Kernels K5 and K6: the MinHash stage's two device programs.
//
// K5 (canu_minhash_sketch) replaces canu_tpu/ops/minhash.py:53
// _sketch_kernel, a jax.jit XLA program with no pl.pallas_call, and
// computes exactly what the plain PyTorch version
// canu_tpu_torch/ops/minhash.py:_sketch_kernel_plain computes, bit for bit:
// for each read b of a padded block and each hash slot h,
//   out[b, h] = min over the kept windows p of mix32(key(p) ^ seeds[h]),
// UINT32_MAX where no window is kept.  A window p is on the read where
// p <= min(len_b, 16 W) - k; its key is the canonical k-mer min(fw, rc)
// for k <= 16 (ops/kmer.py extract_kmers), and for 16 < k <= 32 the
// two-lane canonical k-mer c folded by mix32(hi(c) ^ mix32(lo(c))) and
// moved off 0xFFFFFFFF by ^ 1 (extract_kmers2, _fold2_key).  A key is
// dropped where it equals fk[min(lower_bound(fk, key), F - 1)], compared
// as unsigned 32-bit values (fk sorted, F >= 1; a lone 0xFFFFFFFF is the
// no-op sentinel: no key equals it).  mix32 is murmur3's finalizer with
// uint32 multiply-wrap (ops/hashing.py).
//
// What bounds K5 on an H100: the operations.  A kept (window, slot) pair
// costs about 10 int32 operations (the seed xor, three shift-xors, two
// multiplies, the min) against 8 bytes of read a window, so every design
// that reads each input once is far from the memory rate.  The plain
// version built [B, h, P] int64 temporaries and re-read them per slice.
// This design:
//   - one block of 128 threads a (read, 256 hash slots): grid (B,
//     ceil(H / 256)); each thread owns 2 slots, their seeds and running
//     minima in registers, and writes each slot once at the end;
//   - the read is walked in tiles of 512 windows: each thread builds 4
//     windows' keys from the packed words (read through L1) and runs the
//     frequent-mer binary search through L2; the kept keys are compacted
//     into shared memory (a warp ballot and one shared atomic a warp: the
//     order of the kept keys varies, and the min does not care);
//   - every thread then hashes every kept key of the tile for its slots,
//     the keys read four at a time as one 16-byte broadcast load, so 8
//     independent hash chains are in flight a thread.
// No atomics touch device memory: one block owns each output.
//
// K6 (canu_slot_match_count, then canu_slot_match_compact) replaces
// canu_tpu/ops/minhash.py:111 _match_kernel, a jax.jit XLA program with no
// pl.pallas_call, and computes what ops/minhash.py:_match_kernel_plain
// computes, bit for bit:
//   cnt[i, j] = #{h : SA[i, h] == SB[j, h] != UINT32_MAX},
//   set(i, j) = cnt[i, j] >= min_matches (and i < j for a self block),
//   n_found   = #set, and the first max_out set cells in row-major order
//   as (ii, jj, c) (the fixed-size nonzero; the wrapper pre-fills the
//   padding with Na, Na, 0).
// What bounds it: the operations, 2 a (cell, slot) against 8 bytes a
// slot read once.  The count launch tiles the output like a matrix
// product: 64 x 64 cells a block of 256 threads, a 4 x 4 register tile a
// thread, the slots walked in stages of 32 through shared memory (stored
// slot-major, so a thread reads its 4 rows or 4 columns as one 16-byte
// load).  It writes cnt (the sharded ring reads it, parallel/mesh.py) and
// adds each row's set cells into row_set (integer atomics: the sum is
// exact in any order).  The wrapper turns row_set into each row's first
// output index (one exclusive scan of at most a few thousand totals); the
// compact launch, one block a row with set cells, writes them in column
// order through a block-wide ballot scan.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t UMAX = 0xFFFFFFFFu;

// ---- K5 ----------------------------------------------------------------------

constexpr int SK_THREADS = 128;
constexpr int SK_SLOTS = 2;                           // hash slots a thread
constexpr int SK_BLOCK_SLOTS = SK_THREADS * SK_SLOTS;  // hash slots a block
constexpr int SK_TILE = 4 * SK_THREADS;               // windows a tile

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// The key of window p of a read (its W packed words, base i at bits 2i of
// word i / 16; words past W read as 0).
__device__ __forceinline__ uint32_t window_key(const int64_t* wrow, int W, int p, int k) {
  const int w0 = p >> 4, off = p & 15;
  uint64_t lo = static_cast<uint32_t>(wrow[w0]);
  if (w0 + 1 < W) lo |= static_cast<uint64_t>(static_cast<uint32_t>(wrow[w0 + 1])) << 32;
  const uint64_t hi = w0 + 2 < W ? static_cast<uint32_t>(wrow[w0 + 2]) : 0u;
  // bases p .. p + 31 at bits 2j of v (k <= 32 bases reach bit 2 off + 2k <= 94)
  const uint64_t v = off ? (lo >> (2 * off)) | (hi << (64 - 2 * off)) : lo;
  uint64_t fw = 0, rc = 0;
  const int top = 2 * k - 2;
  for (int j = 0; j < k; ++j) {
    const uint64_t b = (v >> (2 * j)) & 3u;
    fw = (fw << 2) | b;
    rc = (rc >> 2) | ((3u - b) << top);
  }
  const uint64_t c = fw < rc ? fw : rc;
  if (k <= 16) return static_cast<uint32_t>(c);
  const uint32_t key = mix32(static_cast<uint32_t>(c >> 32) ^ mix32(static_cast<uint32_t>(c)));
  return key == UMAX ? key ^ 1u : key;
}

// fk[min(lower_bound(fk, key), F - 1)] == key, in unsigned order.
__device__ __forceinline__ bool frequent(const int64_t* fk, int F, uint32_t key) {
  int lo = 0, hi = F;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<uint32_t>(fk[mid]) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return static_cast<uint32_t>(fk[lo < F - 1 ? lo : F - 1]) == key;
}

__global__ void __launch_bounds__(SK_THREADS)
sketch_kernel(const int64_t* __restrict__ words, int W, const int32_t* __restrict__ lengths,
              const int64_t* __restrict__ seeds, int H, const int64_t* __restrict__ fk, int F,
              int k, int64_t* __restrict__ out) {
  __shared__ __align__(16) uint32_t keys[SK_TILE];
  __shared__ int n_kept;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int h0 = blockIdx.y * SK_BLOCK_SLOTS;
  uint32_t seed[SK_SLOTS], m[SK_SLOTS];
#pragma unroll
  for (int s = 0; s < SK_SLOTS; ++s) {
    const int h = h0 + s * SK_THREADS + tid;
    seed[s] = h < H ? static_cast<uint32_t>(seeds[h]) : 0u;
    m[s] = UMAX;
  }
  const int len = lengths[b];
  const int n_pos = (len < 16 * W ? len : 16 * W) - k + 1;
  const int64_t* wrow = words + static_cast<size_t>(b) * W;
  for (int p0 = 0; p0 < n_pos; p0 += SK_TILE) {
    if (tid == 0) n_kept = 0;
    __syncthreads();
    for (int q = tid; q < SK_TILE; q += SK_THREADS) {
      const int p = p0 + q;
      uint32_t key = 0;
      bool keep = false;
      if (p < n_pos) {
        key = window_key(wrow, W, p, k);
        keep = !frequent(fk, F, key);
      }
      const unsigned bal = __ballot_sync(FULL, keep);
      int base = 0;
      if (lane == 0 && bal) base = atomicAdd(&n_kept, __popc(bal));
      base = __shfl_sync(FULL, base, 0);
      if (keep) keys[base + __popc(bal & ((1u << lane) - 1u))] = key;
    }
    __syncthreads();
    const int n = n_kept;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      const uint4 kk = *reinterpret_cast<const uint4*>(&keys[j]);
#pragma unroll
      for (int s = 0; s < SK_SLOTS; ++s) {
        const uint32_t x0 = mix32(kk.x ^ seed[s]), x1 = mix32(kk.y ^ seed[s]);
        const uint32_t x2 = mix32(kk.z ^ seed[s]), x3 = mix32(kk.w ^ seed[s]);
        m[s] = min(m[s], min(min(x0, x1), min(x2, x3)));
      }
    }
    for (; j < n; ++j) {
      const uint32_t key = keys[j];
#pragma unroll
      for (int s = 0; s < SK_SLOTS; ++s) m[s] = min(m[s], mix32(key ^ seed[s]));
    }
    __syncthreads();  // the next tile overwrites keys and n_kept
  }
#pragma unroll
  for (int s = 0; s < SK_SLOTS; ++s) {
    const int h = h0 + s * SK_THREADS + tid;
    if (h < H) out[static_cast<size_t>(b) * H + h] = m[s];
  }
}

// ---- K6 ----------------------------------------------------------------------

constexpr int MT = 64;       // output rows and columns a block
constexpr int MS = 32;       // slots a stage
constexpr int MPAD = MT + 4;  // a staged slot's row stride (16-byte aligned, fewer conflicts)
constexpr int M_THREADS = 256;
constexpr int CM_THREADS = 256;

__global__ void __launch_bounds__(M_THREADS)
match_count_kernel(const int64_t* __restrict__ SA, int Na, const int64_t* __restrict__ SB,
                   int Nb, int H, int min_matches, int self_block, int32_t* __restrict__ cnt,
                   int32_t* __restrict__ row_set) {
  __shared__ __align__(16) uint32_t As[MS][MPAD];
  __shared__ __align__(16) uint32_t Bs[MS][MPAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = blockIdx.y * MT, j0 = blockIdx.x * MT;
  int acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
  for (int hs = 0; hs < H; hs += MS) {
    for (int e = tid; e < MT * MS; e += M_THREADS) {
      const int r = e / MS, h = e % MS, gh = hs + h;
      const int gi = i0 + r, gj = j0 + r;
      // an A slot off the block or past H never matches
      As[h][r] = gi < Na && gh < H ? static_cast<uint32_t>(SA[static_cast<size_t>(gi) * H + gh])
                                   : UMAX;
      Bs[h][r] = gj < Nb && gh < H ? static_cast<uint32_t>(SB[static_cast<size_t>(gj) * H + gh])
                                   : 0u;
    }
    __syncthreads();
#pragma unroll 8
    for (int h = 0; h < MS; ++h) {
      const uint4 a4 = *reinterpret_cast<const uint4*>(&As[h][ty * 4]);
      const uint4 b4 = *reinterpret_cast<const uint4*>(&Bs[h][tx * 4]);
      const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
      const uint32_t bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool ok = a[r] != UMAX;
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += (ok && a[r] == bv[c]) ? 1 : 0;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gi = i0 + ty * 4 + r;
    int n_set = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gj = j0 + tx * 4 + c;
      if (gi < Na && gj < Nb) {
        cnt[static_cast<size_t>(gi) * Nb + gj] = acc[r][c];
        n_set += acc[r][c] >= min_matches && (!self_block || gi < gj);
      }
    }
    // the 16 threads of a half-warp share ty, so the row's total is a
    // 16-lane sum
#pragma unroll
    for (int o = 8; o >= 1; o >>= 1) n_set += __shfl_xor_sync(FULL, n_set, o);
    if (tx == 0 && gi < Na && n_set) atomicAdd(&row_set[gi], n_set);
  }
}

__global__ void __launch_bounds__(CM_THREADS)
match_compact_kernel(const int32_t* __restrict__ cnt, int Nb, int min_matches, int self_block,
                     const int32_t* __restrict__ row_set, const int64_t* __restrict__ row_start,
                     int max_out, int64_t* __restrict__ ii, int64_t* __restrict__ jj,
                     int32_t* __restrict__ cc) {
  __shared__ int warp_set[CM_THREADS / 32];
  const int i = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (row_set[i] == 0) return;
  int64_t base = row_start[i];
  for (int js = 0; js < Nb && base < max_out; js += CM_THREADS) {
    const int j = js + tid;
    const int v = j < Nb ? cnt[static_cast<size_t>(i) * Nb + j] : 0;
    const bool set = j < Nb && v >= min_matches && (!self_block || i < j);
    const unsigned bal = __ballot_sync(FULL, set);
    if (lane == 0) warp_set[warp] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < CM_THREADS / 32; ++w) {
      const int t = warp_set[w];
      before += w < warp ? t : 0;
      total += t;
    }
    if (set) {
      const int64_t pos = base + before + __popc(bal & ((1u << lane) - 1u));
      if (pos < max_out) {
        ii[pos] = i;
        jj[pos] = j;
        cc[pos] = v;
      }
    }
    base += total;
    __syncthreads();  // warp_set is rewritten by the next stage
  }
}

}  // namespace

// words int64[B, W] (uint32 values, 16 bases a word), lengths int32[B],
// seeds int64[H] and fk int64[F] (uint32 values, fk sorted, F >= 1), k in
// 2..32; out int64[B, H].  Returns cudaGetLastError() of the launch, -1
// for k outside 2..32, -2 for F < 1, -3 for a negative size.
extern "C" int canu_minhash_sketch(const void* words, int B, int W, const void* lengths,
                                   const void* seeds, int H, const void* fk, int F, int k,
                                   void* out, void* stream) {
  if (k < 2 || k > 32) return -1;
  if (F < 1) return -2;
  if (B < 0 || W < 0 || H < 0) return -3;
  if (B == 0 || H == 0) return 0;
  const dim3 grid(B, (H + SK_BLOCK_SLOTS - 1) / SK_BLOCK_SLOTS);
  sketch_kernel<<<grid, SK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), W, static_cast<const int32_t*>(lengths),
      static_cast<const int64_t*>(seeds), H, static_cast<const int64_t*>(fk), F, k,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// SA int64[Na, H], SB int64[Nb, H] (uint32 values); out cnt int32[Na, Nb]
// and row_set int32[Na], which must hold zeros: each row's count of set
// cells is added to it.  Returns cudaGetLastError() of the launch, -3 for
// a negative size.
extern "C" int canu_slot_match_count(const void* SA, int Na, const void* SB, int Nb, int H,
                                     int min_matches, int self_block, void* cnt, void* row_set,
                                     void* stream) {
  if (Na < 0 || Nb < 0 || H < 0) return -3;
  if (Na == 0 || Nb == 0) return 0;
  const dim3 grid((Nb + MT - 1) / MT, (Na + MT - 1) / MT);
  match_count_kernel<<<grid, M_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(SA), Na, static_cast<const int64_t*>(SB), Nb, H, min_matches,
      self_block, static_cast<int32_t*>(cnt), static_cast<int32_t*>(row_set));
  return static_cast<int>(cudaGetLastError());
}

// cnt int32[Na, Nb] and row_set int32[Na] from canu_slot_match_count,
// row_start int64[Na] (the exclusive sum of row_set); writes the set cells
// of output index < max_out into ii, jj (int64) and cc (int32), each
// [max_out].  Returns cudaGetLastError() of the launch, -3 for a negative
// size.
extern "C" int canu_slot_match_compact(const void* cnt, int Na, int Nb, int min_matches,
                                       int self_block, const void* row_set,
                                       const void* row_start, int max_out, void* ii, void* jj,
                                       void* cc, void* stream) {
  if (Na < 0 || Nb < 0 || max_out < 0) return -3;
  if (Na == 0 || Nb == 0 || max_out == 0) return 0;
  match_compact_kernel<<<Na, CM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cnt), Nb, min_matches, self_block,
      static_cast<const int32_t*>(row_set), static_cast<const int64_t*>(row_start), max_out,
      static_cast<int64_t*>(ii), static_cast<int64_t*>(jj), static_cast<int32_t*>(cc));
  return static_cast<int>(cudaGetLastError());
}
