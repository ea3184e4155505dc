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
//   as (ii, jj, c), padded with (Na, Na, 0) (the fixed-size nonzero).
// What bounds it: the operations, 2 a (cell, slot) against 8 bytes a
// slot read once.  A block pair is two launches and nothing else on the
// stream (the wrapper allocates, and zeroes nothing):
//   - the count launch tiles the output like a matrix product: 64 x 64
//     cells a block of 256 threads, a 4 x 4 register tile a thread, the
//     slots walked in stages of 32 through shared memory (stored
//     slot-major, so a thread reads its 4 rows or 4 columns as one 16-byte
//     load).  It writes cnt (the sharded ring reads it, parallel/mesh.py)
//     and each row's set cells in the block's 64 columns, with plain
//     stores; in a self block it skips the blocks whose cells all have
//     i >= j, and it resets the compact launch's scan state;
//   - the compact launch takes each row's first output index from a scan
//     of the row totals inside the launch (a decoupled look-back over
//     64-row blocks ordered by a ticket, right for any Na), visits only
//     the 64-column tiles with set cells, writes them in row-major order
//     through warp ballots, writes n_found, and pads the rest of max_out
//     from blocks of its own that wait for n_found.
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

constexpr int MT = 32;        // output rows and columns a count block, and a tile_set column
constexpr int MS = 32;        // slots a stage
constexpr int MPAD = MT + 4;  // a staged slot's row stride (8-byte aligned, fewer conflicts)
constexpr int M_THREADS = 256;  // 16 x 16 threads, 2 x 2 cells each
constexpr int CM_THREADS = 256;  // tile_set entries a scan block, one a thread
constexpr int CM_PAD = 4096;     // padding entries a pad block of the compact launch
// the compact launch's scan state: a word a scan block, its flag in the
// top two bits (0 not yet published, the block's own total, or the total
// of every entry up to the block's last) and the value below them
constexpr unsigned long long ST_AGG = 1ull << 62;
constexpr unsigned long long ST_PREFIX = 2ull << 62;
constexpr unsigned long long ST_VAL = ST_AGG - 1;

__device__ __forceinline__ unsigned long long load_status(const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p, unsigned long long v) {
  __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The count launch: cnt[i, j] for every cell of the block pair, 32 x 32
// cells a block; with tile_set, each row's number of set cells in the
// block's 32 columns, tile_set[i, blockIdx.x], a plain store.  In a self
// block a block whose cells all have i >= j writes nothing (no cell is
// set there, and the compact launch reads neither cnt nor tile_set of
// it).  With scan, its n_scan words (the compact launch's ticket and
// scan state) are reset first, strided over every thread of the grid.
__global__ void __launch_bounds__(M_THREADS)
match_count_kernel(const int64_t* __restrict__ SA, int Na, const int64_t* __restrict__ SB,
                   int Nb, int H, int min_matches, int self_block, int32_t* __restrict__ cnt,
                   int32_t* __restrict__ tile_set, unsigned long long* __restrict__ scan,
                   int n_scan) {
  __shared__ __align__(16) uint32_t As[MS][MPAD];
  __shared__ __align__(16) uint32_t Bs[MS][MPAD];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  if (scan != nullptr) {
    const int stride = gridDim.x * gridDim.y * M_THREADS;
    for (int w = (blockIdx.y * gridDim.x + blockIdx.x) * M_THREADS + tid; w < n_scan; w += stride)
      scan[w] = 0;
  }
  const int i0 = blockIdx.y * MT, j0 = blockIdx.x * MT;
  if (i0 >= Na || j0 >= Nb || (self_block && blockIdx.y > blockIdx.x)) return;  // the whole block
  int acc[2][2] = {{0, 0}, {0, 0}};
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
      const uint2 a2 = *reinterpret_cast<const uint2*>(&As[h][ty * 2]);
      const uint2 b2 = *reinterpret_cast<const uint2*>(&Bs[h][tx * 2]);
      const uint32_t a[2] = {a2.x, a2.y};
      const uint32_t bv[2] = {b2.x, b2.y};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const bool ok = a[r] != UMAX;
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[r][c] += (ok && a[r] == bv[c]) ? 1 : 0;
      }
    }
    __syncthreads();
  }
  const int n_tiles = (Nb + MT - 1) / MT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int gi = i0 + ty * 2 + r;
    int n_set = 0;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int gj = j0 + tx * 2 + c;
      if (gi < Na && gj < Nb) {
        cnt[static_cast<size_t>(gi) * Nb + gj] = acc[r][c];
        n_set += acc[r][c] >= min_matches && (!self_block || gi < gj);
      }
    }
    // the 16 threads of a half-warp share ty, so the row's count is a
    // 16-lane sum
#pragma unroll
    for (int o = 8; o >= 1; o >>= 1) n_set += __shfl_xor_sync(FULL, n_set, o);
    if (tile_set != nullptr && tx == 0 && gi < Na)
      tile_set[static_cast<size_t>(gi) * n_tiles + blockIdx.x] = n_set;
  }
}

// The compact launch: n_scan_blocks blocks of CM_THREADS tile_set entries
// (row-major: the order of the output), then the pad blocks, in the order
// a ticket gives them (so a block only ever waits for blocks that already
// run).  A scan block takes its entries' counts (0 for a self block's
// tiles wholly at or below the diagonal, which it does not read), scans
// them, publishes its total, takes the total of the entries before it by
// a decoupled look-back (a warp reads 32 earlier words at a time and stops
// at the nearest prefix) and publishes its prefix; then each thread
// writes its entry's set cells (i < j tested before cnt is read) in
// column order at output index prefix + the cells before them, where
// that is below max_out.  The last scan block writes n_found.  A pad block
// waits for the last scan block's prefix (n_found) and writes (Na, Na, 0)
// on its share of [n_found, max_out).
__global__ void __launch_bounds__(CM_THREADS)
match_compact_kernel(const int32_t* __restrict__ cnt, const int32_t* __restrict__ tile_set,
                     int Na, int Nb, int min_matches, int self_block,
                     unsigned long long* __restrict__ scan, int n_scan_blocks, int max_out,
                     int64_t* __restrict__ ii, int64_t* __restrict__ jj, int32_t* __restrict__ cc,
                     int64_t* __restrict__ n_found) {
  __shared__ int ticket;
  __shared__ long long warp_total[CM_THREADS / 32];
  __shared__ long long before;  // the set cells of every entry before the block's
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) ticket = static_cast<int>(atomicAdd(scan, 1ull));
  __syncthreads();
  const int t = ticket;

  if (t >= n_scan_blocks) {  // a pad block
    if (tid == 0) {
      unsigned long long s = ST_PREFIX;  // no entries: n_found 0
      if (n_scan_blocks > 0) {
        do s = load_status(&scan[n_scan_blocks]); while (!(s & ST_PREFIX));
      } else if (t == 0) {
        *n_found = 0;
      }
      before = static_cast<long long>(s & ST_VAL);
    }
    __syncthreads();
    const long long p0 = static_cast<long long>(t - n_scan_blocks) * CM_PAD;
    const long long lo = before > p0 ? before : p0;
    const long long hi = p0 + CM_PAD < max_out ? p0 + CM_PAD : max_out;
    for (long long q = lo + tid; q < hi; q += CM_THREADS) {
      ii[q] = Na;
      jj[q] = Na;
      cc[q] = 0;
    }
    return;
  }

  // this thread's entry: row i, 32-column tile tt
  const int n_tiles = (Nb + MT - 1) / MT;
  const long long e = static_cast<long long>(t) * CM_THREADS + tid;
  const int i = static_cast<int>(e / (n_tiles > 0 ? n_tiles : 1));
  const int tt = static_cast<int>(e - static_cast<long long>(i) * n_tiles);
  const bool entry = e < static_cast<long long>(Na) * n_tiles && (!self_block || tt >= i / MT);
  const int v = entry ? tile_set[e] : 0;
  // the block's exclusive scan of the counts
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const long long wt = lane < CM_THREADS / 32 ? warp_total[lane] : 0;
    long long wincl = wt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(FULL, wincl, o);
      if (lane >= o) wincl += y;
    }
    if (lane < CM_THREADS / 32) warp_total[lane] = wincl - wt;  // each warp's first entry's offset
    const long long agg = __shfl_sync(FULL, wincl, 31);
    if (lane == 0) store_status(&scan[1 + t], (t == 0 ? ST_PREFIX : ST_AGG) | agg);
    // look back: lane l reads the word of block j - l
    long long sum = 0;
    for (int j = t - 1; j >= 0; j -= 32) {
      const int k = j - lane;
      unsigned long long s = k >= 0 ? load_status(&scan[1 + k]) : ST_PREFIX;
      while (__ballot_sync(FULL, (s >> 62) != 0) != FULL)
        if (!(s >> 62)) s = load_status(&scan[1 + k]);
      const unsigned pre = __ballot_sync(FULL, (s & ST_PREFIX) != 0);
      const int stop = pre ? __ffs(pre) - 1 : 31;
      sum += warp_sum(lane <= stop ? static_cast<long long>(s & ST_VAL) : 0);
      if (pre) break;
    }
    if (lane == 0) {
      if (t > 0) store_status(&scan[1 + t], ST_PREFIX | (sum + agg));
      if (t == n_scan_blocks - 1) *n_found = sum + agg;
      before = sum;
    }
  }
  __syncthreads();

  // the entry's set cells, in column order
  long long pos = before + warp_total[warp] + incl - v;
  if (v == 0 || pos >= max_out) return;
  const int32_t* crow = cnt + static_cast<size_t>(i) * Nb;
  const int jt = tt * MT;
  int c[MT];
#pragma unroll
  for (int x = 0; x < MT; ++x) {
    const int j = jt + x;
    c[x] = j < Nb && (!self_block || i < j) ? crow[j] : min_matches - 1;
  }
#pragma unroll
  for (int x = 0; x < MT; ++x) {
    if (c[x] >= min_matches && pos < max_out) {
      ii[pos] = i;
      jj[pos] = jt + x;
      cc[pos] = c[x];
      ++pos;
    }
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
// and, unless null, tile_set int32[Na, ceil(Nb / 32)] (each row's set
// cells a 32-column tile) and the compact launch's scan state int64[n_scan]
// (n_scan = ceil(Na * ceil(Nb / 32) / 256) + 1), which it resets.  In a
// self block (SA is SB) only the cells of tiles that hold an i < j are
// written.  Returns cudaGetLastError() of the launch, -3 for a negative
// size; with no scan state and no cell, 0 at once.
extern "C" int canu_slot_match_count(const void* SA, int Na, const void* SB, int Nb, int H,
                                     int min_matches, int self_block, void* cnt, void* tile_set,
                                     void* scan, int n_scan, void* stream) {
  if (Na < 0 || Nb < 0 || H < 0 || n_scan < 0) return -3;
  if (scan == nullptr && (Na == 0 || Nb == 0)) return 0;
  const int gx = (Nb + MT - 1) / MT, gy = (Na + MT - 1) / MT;
  const dim3 grid(gx > 0 ? gx : 1, gy > 0 ? gy : 1);
  match_count_kernel<<<grid, M_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(SA), Na, static_cast<const int64_t*>(SB), Nb, H, min_matches,
      self_block, static_cast<int32_t*>(cnt), static_cast<int32_t*>(tile_set),
      static_cast<unsigned long long*>(scan), n_scan);
  return static_cast<int>(cudaGetLastError());
}

// cnt, tile_set and scan from canu_slot_match_count on the same stream;
// writes the first max_out set cells in row-major order into ii, jj
// (int64) and cc (int32), each [max_out], (Na, Na, 0) after them, and the
// number of set cells into n_found (int64, counting cells past max_out
// too).  Returns cudaGetLastError() of the launch, -3 for a negative size.
extern "C" int canu_slot_match_compact(const void* cnt, const void* tile_set, int Na, int Nb,
                                       int min_matches, int self_block, void* scan, int max_out,
                                       void* ii, void* jj, void* cc, void* n_found,
                                       void* stream) {
  if (Na < 0 || Nb < 0 || max_out < 0) return -3;
  const long long entries = static_cast<long long>(Na) * ((Nb + MT - 1) / MT);
  const int n_scan_blocks = static_cast<int>((entries + CM_THREADS - 1) / CM_THREADS);
  const int n_pad = max_out > 0 ? (max_out + CM_PAD - 1) / CM_PAD : 1;
  match_compact_kernel<<<n_scan_blocks + n_pad, CM_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cnt), static_cast<const int32_t*>(tile_set), Na, Nb,
      min_matches, self_block, static_cast<unsigned long long*>(scan), n_scan_blocks, max_out,
      static_cast<int64_t*>(ii), static_cast<int64_t*>(jj), static_cast<int32_t*>(cc),
      static_cast<int64_t*>(n_found));
  return static_cast<int>(cudaGetLastError());
}
