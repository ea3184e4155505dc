// Kernels K7 and K8: verify's anchor-and-inputs step and the syncmer read
// index it reads.
//
// K7 (canu_verify_pre) replaces canu_tpu/ops/align.py:385 _verify_pre, a
// jax.jit XLA program with no pl.pallas_call, and computes exactly what the
// plain PyTorch version canu_tpu_torch/ops/align.py:_verify_pre_plain
// computes, bit for bit, for a group of G chunks of C pairs in one launch.
// For pair q = g C + p, with A = index row a_idx[q] and B = index row
// b_idx[q]:
//   1. the join: A's then B's syncmer keys (mker != INVALID), stably sorted
//      (a sort on (key, slot of the concatenation) is the same order); an
//      adjacent equal pair with one entry of each read is a hit, so with
//      duplicate keys only the last A entry and the first B entry of a run
//      match (ops/kmerjoin.py pair_matches);
//   2. the strand vote: n_same, n_opp, n_minor = min; with orient the
//      orientation is n_opp > n_same, else flipped[q];
//   3. posB on the oriented B (lenB - k - posB when flipped); the hits that
//      agree with the orientation; the lower median of their diagonals
//      among the 2 Pm - 1 join columns, the others 2^30 (2^30 with none);
//      the inliers within tol = max(100, int(float32(min(lenA, lenB)) *
//      0.3f));
//   4. the inliers sorted by (posA, join position) -- the stable posA sort
//      of the plain version -- and kept where posB exceeds every earlier
//      posB (the first against -1);
//   5. the MAX_ANCHORS (64) picks of the kept list: all of it when it has at
//      most 64 entries, else m (n_keep - 1) / 63; the seed at (n_anchor -
//      1) / 2, the forward and backward anchor lists relative to it, padded
//      with 2^24 + m;
//   6. the band centres: the float32 piecewise-linear interpolation of
//      each list at every 16th row (jnp.interp's operations, one rounding
//      each, the last, fp[i-1] + (delta / dx) * df, a fused multiply-add
//      as XLA's CPU backend compiles it), rounded half to even, stored as
//      that grid of n_rows / 16 + 1 columns (the Myers engine reads it so,
//      ops/align.py _interp_grid) or repeated to n_rows + 1 columns (the
//      INF-walled engine's rows, _interp_centers);
//   7. the four base rows: A from the seed (a_f), A reversed up to the
//      seed (a_b), the oriented B likewise (b_f, b_b, n_rows + band wide),
//      each a shift of t mod 2^ceil(log2 max(L, width)) with zeros past the
//      end (ops/align.py _shift_rows), and the lengths.
// Chunk g's forward rows are rows 2 g C + p of the outputs and its
// backward rows 2 g C + C + p: the layout the group's extension takes.
//
// What bounds K7 on an H100: the bytes.  A pair writes 2 n_rows + 2 (n_rows
// + band) bytes of bases and 8 (n_rows + 1) of centres as rows, 8 (n_rows /
// 16 + 1) on the grid (about 34 KB at n_rows 8,192 on the grid, 100 KB as
// rows).  The design, one block of 256 threads a pair:
//   - the join without a sort of the concatenation.  Since the join only
//     groups equal keys, it may order them by mix32(key), which is a
//     bijection of uint32: K8 writes each index row in (mix32(key),
//     position) order with its valid entries first, so a row is already
//     sorted.  Each read's mix32 keys and slots go to shared memory and one
//     barrier-or checks that order; a row that breaks it (a hand-made row,
//     or K8's rare tail of UINT32_MAX keys) is sorted there by (mix32,
//     slot).  Then each first B entry of a run finds A's last entry of its
//     key by a binary search: the hit.  Only hits and their count are
//     kept (11 + 11 + 1 bits each);
//   - the join position is only the tie-break of step 4, and among hits
//     (one a key) it orders them as their keys do, so step 4 sorts the
//     inliers by (posA, key): the same order;
//   - the lower median by a radix select over the diagonals (a histogram
//     of 8 bits a pass, one warp picking the digit), not a sort: only over
//     the bits below the highest in which the least and greatest diagonal
//     differ (2 passes for diagonals within +-32,768), over all 4 bytes
//     with the 2^30 columns counted where a diagonal reaches 2^30;
//   - the inliers' sort (posA, key) with a hit index carried, a bitonic
//     sort whose stages inside a warp's segment of at least 64 entries
//     synchronise the warp only (each warp pads its own segment): about 9
//     block barriers at 2,048 entries, none up to 64;
//   - warp-shuffle scans for the running max and the kept count, each
//     kept entry writing its pick (if any) straight into the 64 anchors;
//   - counts by warp reductions and per-warp partials, so a pair of reads
//     of ~8 kb takes ~13 block barriers in all;
//   - shared memory in phases: the hits (4 P2 bytes, P2 = pow2(Pm)), then
//     the join (12 P2), the diagonals, inliers and carried indices (14
//     P2) and the centre tiles in the same place: 36,864 B at Pm 2,048,
//     so 6 blocks of 256 threads an SM, whatever the reads' length;
//   - the band centres interpolated once a 16-row group (the x of a
//     thread's consecutive groups walks the anchor list forward) into a
//     shared tile, then stored 16 bytes a thread;
//   - the base rows 16 bases a thread: the two index words a window
//     straddles, shifted together, 2-bit fields reversed and complemented
//     in registers where the row runs backwards, spread to 16 bytes and
//     stored 16 bytes at a time (bytes at the row's unaligned ends).
//
// K8 (canu_syncmer) replaces canu_tpu/ops/minimizers.py:90 _syncmer_kernel,
// a jax.jit XLA program with no pl.pallas_call, and computes exactly what
// canu_tpu_torch/ops/minimizers.py:_syncmer_kernel_plain computes on a
// block of reads padded to Wb words: for each read and each position p < Pk
// = 16 Wb - k + 1,
//   sel(p) = hs(p + t) == min(hs(p .. p + k - s)) and p <= len - k, where
//   hs(i) = mix32(canonical s-mer at i), UINT32_MAX where i > len - s;
//   key(p) = sel(p) ? mix32(canonical k-mer key at p) : UINT32_MAX;
// then output slot c < min(n_sel, pm) holds the c-th position of the
// stable sort of all Pk keys: the selected positions of key < UINT32_MAX in
// (key, position) order, then every position of key UINT32_MAX (a selected
// k-mer whose mix32 is UINT32_MAX among the unselected ones) in position
// order.  The rest is INVALID_KMER, -1 and 0, and n_sel is cut at pm.
// The canonical k-mer key is min(fw, rc) for k <= 16 and the two-lane fold
// mix32(hi ^ mix32(lo)), moved off UINT32_MAX by ^ 1, for 16 < k <= 32
// (ops/kmer.py extract_kmers_any); the strand is rc < fw.
//
// One launch builds a whole index: block i takes read rows[i] with its own
// bucket's Wb = wbs[i] (the W its length bucket of ops/kmer.py
// length_bucketed_blocks pads to), reads its words from the index's word
// plane (stride W >= Wb) and writes its rows of mker/mpos/mstr.  Each row
// is then bit for bit what the call on its bucket's block gives.  What
// bounds K8: the operations (the rolling k-mers and s-mer hashes of every
// position) against 8 bytes of read a 16 positions.  The design, one block
// of 256 threads a read:
//   - tiles of 4,096 positions, 16 a thread (one index word): each thread
//     builds the first s-mer and k-mer of its run from two or three words
//     and rolls forward and reverse complement 2 bits a step; the tile's
//     s-mer hashes (and a halo of k - s) in shared memory;
//   - the selected (key, position) pairs in a shared buffer of pm entries
//     (16 KB at pm 2,048; no scratch in device memory); a read that selects
//     at most pm of key < UINT32_MAX (under ~10 kb at pm 2,048) sorts them
//     there; a longer read finds the pm-th smallest key by a radix select
//     (4 passes of 8 bits over recomputed tiles), keeps the keys below it
//     and, at it, the first positions in order (a block scan a tile), and
//     sorts those pm;
//   - the rare tail pass of positions of key UINT32_MAX in position order.
// A whole-index launch with a device scratch row a read for the sort (the
// former design) would need N x pow2(16 W - k + 1) x 8 B: at E. coli's
// 32,994 reads and global W of 512 words 32,994 x 8,192 x 8 B = 2.2 GB,
// and 2 MB a read once reads exceed 131,072 bases (W 16,384).
//
// K12 (canu_pair_stats) replaces canu_tpu/ops/minhash.py:296
// _pair_stats_kernel, a jax.jit XLA program with no pl.pallas_call (stage
// C of the MinHash path: place_candidates), and computes exactly what
// canu_tpu_torch/ops/minhash.py:_pair_stats_kernel computes for a pair of
// reads (its P = 16 W - k + 1 positions only pad past the reads, so the
// result does not depend on the chunk's W):
//   1. the join of both reads' canonical k-mers (ops/kmer.py
//      extract_kmers_any; positions p <= len - k): the stable sort of the
//      concatenation gives one hit a key present in both reads, A's last
//      entry (its largest position) against B's first (its smallest), and
//      B's entries of a key in the frequent table are dropped;
//   2. the strand vote: flipped = n_opp > n_same;
//   3. the diagonals posA - posB_eff (posB_eff = lenB - k - posB where
//      flipped) of the hits that agree with it, their lower median (index
//      (n - 1) // 2; 2^30 with none), the inliers within tol = max(100,
//      int(float32(min(lenA, lenB)) * 0.3f)), their count, the lower median
//      of their diagonals and their spans (posA, and posB in forward-B
//      coordinates; + k at the high ends; 2^30 / -1 when empty).
// One launch takes a whole place_candidates call: pair q is row a_idx[q]
// of a word plane against its row b_idx[q] (the read set's plane, or a
// chunk's two blocks stacked), each read at its own length.
// What bounds K12: the k-mers built, hashed and joined a position against
// 8 bytes of read a 16 positions (operations).  The design, one block of
// NT threads a pair, everything in shared memory:
//   - a table of A's keys only, S slots of (key, A's max of 2 pos + strand,
//     B's min), S = min(T, max(64, pow2(2 nA))) at a load of at most one
//     half: the key and A's value share a 64-bit word, so A inserts by one
//     shared-memory 64-bit atomicCAS (and a 64-bit atomicMax where the key
//     is already there with a smaller value); UINT32_MAX marks an empty
//     slot (no canonical key takes it); B only probes (a B key that A lacks
//     is no hit) and takes a 32-bit atomicMin beside the word;
//   - rounds where A has more positions than S / 2: round r takes the keys
//     whose mix32 falls in the r-th of ceil(nA / (S / 2)) equal ranges,
//     rebuilding both reads' k-mers from their words each round (an even
//     segment of at most 16 positions a thread, rolled 2 bits a step; the
//     words through L1).  Each thread counts the slots it claims (no shared
//     counter); a round whose distinct keys pass 3 S / 4, or whose probe
//     walks the whole table, is dropped and taken again over half the
//     range;
//   - no scan of the table: the B entry whose atomicMin finds a slot's B
//     side empty lists that slot as a hit unless its key is frequent (a
//     binary search of the table, the same as dropping B's entries, since
//     frequency is a property of the key); after B's probes each listed
//     slot becomes its hit, and the table is cleared only where another
//     round follows.  The hits stay in shared memory (HS of them) and only
//     a pair with more than HS possible hits, min(nA, nB), spills the rest
//     to its room in a device list the wrapper sizes from the lengths;
//   - the strand vote and counts by warp reductions, the two medians by
//     radix selects over the bits in which the least and greatest diagonal
//     differ (8 bits a pass, a shared histogram), over that copy.
// No device-memory table and no global atomic; the slots T and the shared
// hits HS are the wrapper's constants (verify_cuda.K12_SLOTS, K12_HITS),
// NT is K12_NT (verify_cuda.K12_THREADS; scripts/torch_pair_stats_variants.py
// builds other counts with -DK12_NT=...).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

#ifndef K12_NT
#define K12_NT 512
#endif

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t UMAX = 0xFFFFFFFFu;
constexpr int64_t INVALID_KMER = 0xFFFFFFFFll;
constexpr int MAX_ANCHORS = 64;
constexpr int BIG = 1 << 30;
constexpr int BIGF = 1 << 24;
constexpr int MAX_PM = 2048;    // K7's hits keep a slot in 11 bits; K8's buffer is pm entries
constexpr int SM_T = 4096;      // K8's positions a tile, 16 a thread
constexpr int SM_HALO = 32;     // k - s <= 17 s-mers past a tile's last position, rounded up
constexpr int INT_MIN32 = -2147483647 - 1;
constexpr int K7_MIN_BLOCKS = 6;  // blocks an SM K7 is built for (40 registers a thread)
constexpr int K8_MIN_BLOCKS = 6;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// _shift_rows' mask: a shift sees t mod 2^ceil(log2 max(L, out_len))
__device__ __forceinline__ int64_t shift_mask(int L, int out_len) {
  const int Lp = L > out_len ? L : out_len;
  int r = 0;
  while ((1 << r) < Lp) ++r;
  return (int64_t(1) << r) - 1;
}

// int32 arithmetic that wraps, as torch's int32 tensors do
__device__ __forceinline__ int wsub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? static_cast<int>(0u - static_cast<uint32_t>(a)) : a;
}

// ---- block primitives ------------------------------------------------------

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) {
    const int y = __shfl_down_sync(FULL, v, o);
    v = y < v ? y : v;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_umin(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t y = __shfl_down_sync(FULL, v, o);
    v = y < v ? y : v;
  }
  return v;
}

__device__ __forceinline__ uint32_t warp_umax(uint32_t v) {
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t y = __shfl_down_sync(FULL, v, o);
    v = y > v ? y : v;
  }
  return v;
}

// Exclusive prefix sum of v over the block's threads in thread order (one
// barrier); *total gets the block's sum.  s_w (NWARP ints) must not be
// reused by another scan before a barrier.
__device__ int block_excl_sum(int v, int* total, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_w[warp] = x;
  __syncthreads();
  int before = 0, tot = 0;
  for (int w = 0; w < NWARP; ++w) {
    const int t = s_w[w];
    before += w < warp ? t : 0;
    tot += t;
  }
  *total = tot;
  return before + x - v;
}

// Exclusive prefix max (INT_MIN for thread 0), one barrier; as above.
__device__ int block_excl_max(int v, int* s_w) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = y > x ? y : x;
  }
  const int up = __shfl_up_sync(FULL, x, 1);
  if (lane == 31) s_w[warp] = x;
  __syncthreads();
  int before = lane ? up : INT_MIN32;
  for (int w = 0; w < warp; ++w) before = s_w[w] > before ? s_w[w] : before;
  return before;
}

// compare-exchange of a[lo], a[hi] by (key, payload), ascending where up
template <typename K>
__device__ __forceinline__ void cmp_swap(K* a, uint16_t* pay, int lo, int hi, bool up) {
  const K x = a[lo], y = a[hi];
  if (pay != nullptr) {
    const uint16_t px = pay[lo], py = pay[hi];
    if ((x > y || (x == y && px > py)) == up) {
      a[lo] = y;
      a[hi] = x;
      pay[lo] = py;
      pay[hi] = px;
    }
  } else if ((x > y) == up) {
    a[lo] = y;
    a[hi] = x;
  }
}

// Ascending bitonic sort of a[0, n) by (key, payload) (pay may be null), n
// a power of two, by the whole block, entries from n_valid on taken as the
// largest key (the sort writes them); the caller synchronised after
// writing a[0, n_valid), and a is sorted for every thread on return.  A
// stage whose pairs lie inside a warp's segment (max(n / 8, min(n, 64))
// entries) synchronises that warp only; a wider stage runs over the block
// between two barriers.
template <typename K>
__device__ void block_sort(K* a, uint16_t* pay, int n, int n_valid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = n / NWARP > (n < 64 ? n : 64) ? n / NWARP : (n < 64 ? n : 64);
  const int half = seg >> 1, nseg = n / seg;
  if (warp < nseg) {  // the first stages stay in a warp's segment: pad it there
    for (int i = warp * seg + lane; i < (warp + 1) * seg; i += 32) {
      if (i >= n_valid) {
        a[i] = ~K(0);
        if (pay != nullptr) pay[i] = 0xFFFF;
      }
    }
  }
  __syncwarp();
  bool wide = false;  // a block-wide stage wrote since the last barrier
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= seg) {
        __syncthreads();
        for (int i = threadIdx.x; i < (n >> 1); i += THREADS) {
          const int lo = 2 * i - (i & (stride - 1));
          cmp_swap(a, pay, lo, lo + stride, (lo & size) == 0);
        }
        wide = true;
      } else {
        if (wide) {
          __syncthreads();
          wide = false;
        }
        if (warp < nseg) {
          for (int i = lane; i < half; i += 32) {
            const int gi = warp * half + i;
            const int lo = 2 * gi - (gi & (stride - 1));
            cmp_swap(a, pay, lo, lo + stride, (lo & size) == 0);
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
}

// ---- K7 -----------------------------------------------------------------------

// the shared layout of K7 (bytes): the hits, then a region that holds in
// turn the join, the diagonals + inliers + carried hit indices, the centre
// tiles
__host__ __device__ __forceinline__ int k7_hits_bytes(int P2) {
  return 4 * P2 > 6 * 4 * MAX_ANCHORS ? 4 * P2 : 6 * 4 * MAX_ANCHORS;
}
__host__ __device__ __forceinline__ int k7_diag_bytes(int P2) { return (4 * P2 + 15) & ~15; }
__host__ __device__ __forceinline__ int k7_region_bytes(int P2) {
  return k7_diag_bytes(P2) + 10 * P2 > 8192 ? k7_diag_bytes(P2) + 10 * P2 : 8192;
}

// 32 bits = 16 bases of a read's words (int64 holding uint32 values)
// starting at base p (any p; words outside [0, W) read as zero)
__device__ __forceinline__ uint32_t bases16_at(const int64_t* __restrict__ w, int W, int64_t p) {
  const int64_t j = p >> 4;  // floor, also for p < 0
  const int off = static_cast<int>(p & 15);
  const uint32_t lo = j >= 0 && j < W ? static_cast<uint32_t>(__ldg(w + j)) : 0u;
  if (off == 0) return lo;
  const uint32_t hi = j + 1 >= 0 && j + 1 < W ? static_cast<uint32_t>(__ldg(w + j + 1)) : 0u;
  return (lo >> (2 * off)) | (hi << (32 - 2 * off));
}

// reverse the order of the 16 2-bit fields of v
__device__ __forceinline__ uint32_t rev2(uint32_t v) {
  v = __brev(v);
  return ((v & 0x55555555u) << 1) | ((v >> 1) & 0x55555555u);
}

// 16 output bases e = 0..15: raw(r0 + dir e) ^ cm where elo <= e < ehi, 0
// elsewhere, as 4 words of 4 bytes
__device__ __forceinline__ uint4 bases_out16(const int64_t* __restrict__ w, int W, int64_t r0,
                                             bool rev, uint32_t cm, int64_t elo, int64_t ehi) {
  uint32_t v = rev ? rev2(bases16_at(w, W, r0 - 15)) : bases16_at(w, W, r0);
  v ^= cm;
  const int lo = elo < 0 ? 0 : (elo > 16 ? 16 : static_cast<int>(elo));
  const int hi = ehi < 0 ? 0 : (ehi > 16 ? 16 : static_cast<int>(ehi));
  uint32_t m = hi >= 16 ? FULL : (1u << (2 * hi)) - 1u;
  m &= lo >= 16 ? 0u : ~((1u << (2 * lo)) - 1u);
  if (hi <= lo) m = 0u;
  v &= m;
  uint32_t o[4];
  for (int qd = 0; qd < 4; ++qd) {
    uint32_t x = (v >> (8 * qd)) & 0xFFu;
    x = (x | (x << 12)) & 0x000F000Fu;
    x = (x | (x << 6)) & 0x03030303u;
    o[qd] = x;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// one base row of `width` bytes: out[i] = base (16 at a time) from
// bases_out16(r0(i0), ...) through `spec`, stored 16 bytes a thread where
// the row is 16-byte aligned, bytewise at its ends
template <typename S>
__device__ __forceinline__ void store_row(uint8_t* row, int width, S spec) {
  const int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15);
  const int h = head < width ? head : width;
  const int nq = (width - h) >> 4;
  for (int c = threadIdx.x; c < nq; c += THREADS) {
    const int i0 = h + 16 * c;
    *reinterpret_cast<uint4*>(row + i0) = spec(i0);
  }
  // the head [0, h) and the tail [h + 16 nq, width): at most 15 bytes each
  const int tail0 = h + 16 * nq;
  const int e = threadIdx.x;
  int i = -1;
  if (e < h) i = e;
  else if (e >= 16 && e - 16 < width - tail0) i = tail0 + e - 16;
  if (i >= 0) {
    const uint4 v = spec(i);
    row[i] = static_cast<uint8_t>(v.x & 3u);
  }
}

// the first xp entry above x (searchsorted right) among MAX_ANCHORS
__device__ __forceinline__ int search_right(float x, const float* xp) {
  int lo = 0, hi = MAX_ANCHORS;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xp[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// float32 jnp.interp of x on (xp, fp)[64] given lo = searchsorted(xp, x,
// right), rounded half to even (ops/align.py _interp_centers): explicit
// roundings, so nvcc contracts nothing but the one fused multiply-add
// that is meant
__device__ __forceinline__ int interp_at(float x, int lo, const float* xp, const float* fp) {
  const int i = lo < 1 ? 1 : (lo > MAX_ANCHORS - 1 ? MAX_ANCHORS - 1 : lo);
  const float df = __fsub_rn(fp[i], fp[i - 1]);
  const float dx = __fsub_rn(xp[i], xp[i - 1]);
  const float delta = __fsub_rn(x, xp[i - 1]);
  const bool dx0 = fabsf(dx) <= 1.42108547152020037e-14f;  // spacing(float32 eps)
  float f = dx0 ? fp[i - 1] : __fmaf_rn(__fdiv_rn(delta, dx), df, fp[i - 1]);
  if (x < xp[0]) f = fp[0];
  if (x > xp[MAX_ANCHORS - 1]) f = fp[MAX_ANCHORS - 1];
  return __float2int_rn(f);
}

// columns [c0, c1) of a centres row, column c = tile[(c >> 4) - j0]: 16
// bytes a thread on 16-byte boundaries, single ints at the ends
__device__ __forceinline__ void store_centres(int32_t* row, int c0, int c1, const int* tile,
                                              int j0) {
  const int head0 = static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(row + c0) & 15)) & 15) >> 2);
  const int h = head0 < c1 - c0 ? head0 : c1 - c0;
  const int nq = (c1 - c0 - h) >> 2;
  for (int qd = threadIdx.x; qd < nq; qd += THREADS) {
    const int c = c0 + h + 4 * qd;
    *reinterpret_cast<int4*>(row + c) =
        make_int4(tile[(c >> 4) - j0], tile[((c + 1) >> 4) - j0], tile[((c + 2) >> 4) - j0],
                  tile[((c + 3) >> 4) - j0]);
  }
  const int tail0 = c0 + h + 4 * nq;
  const int e = threadIdx.x;
  int c = -1;
  if (e < h) c = c0 + e;
  else if (e >= 4 && e - 4 < c1 - tail0) c = tail0 + e - 4;
  if (c >= 0) row[c] = tile[(c >> 4) - j0];
}

__global__ void __launch_bounds__(THREADS, K7_MIN_BLOCKS)
verify_pre_kernel(const int64_t* __restrict__ words, int W, const int32_t* __restrict__ length,
                  const int64_t* __restrict__ mker, const int32_t* __restrict__ mpos,
                  const int32_t* __restrict__ mstr, int Pm, const int64_t* __restrict__ a_idx,
                  const int64_t* __restrict__ b_idx, const uint8_t* __restrict__ flipped_in,
                  int C, int k, int band, int n_rows, int orient, int grid_centres,
                  uint8_t* __restrict__ out_a,
                  int32_t* __restrict__ out_alen, uint8_t* __restrict__ out_b,
                  int32_t* __restrict__ out_blen, int32_t* __restrict__ out_cen,
                  int32_t* __restrict__ out_nanchor, uint8_t* __restrict__ out_flipped,
                  int32_t* __restrict__ out_seedA, int32_t* __restrict__ out_seedB,
                  int32_t* __restrict__ out_nminor) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_w1[NWARP], s_w2[NWARP];
  // each warp's valid entries and first invalid slot of A and B, and its
  // unsorted-row bits (bit 0 A, bit 1 B)
  __shared__ int s_part[5][NWARP];
  // counters: hits, same, opp, diagonals, inliers, the radix select's
  // prefix and rank, the least and greatest diagonal (as ordered unsigned)
  __shared__ int s_c[9];
  enum { NH, SAME, OPP, N2, NI, PFX, RNK, UMN, UMX };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q = blockIdx.x, g = q / C, p = q - g * C;
  const int P2 = pow2_at_least(Pm);
  uint32_t* hits = reinterpret_cast<uint32_t*>(smem);
  unsigned char* r2 = smem + k7_hits_bytes(P2);
  // the join
  uint32_t* kA = reinterpret_cast<uint32_t*>(r2);
  uint32_t* kB = kA + P2;
  uint16_t* sA = reinterpret_cast<uint16_t*>(kB + P2);
  uint16_t* sB = sA + P2;
  // then the diagonals, the histograms (in the inliers' place), the
  // inliers and the hit index each carries
  int* D = reinterpret_cast<int*>(r2);
  int* hist = reinterpret_cast<int*>(r2 + k7_diag_bytes(P2));
  uint64_t* comp = reinterpret_cast<uint64_t*>(r2 + k7_diag_bytes(P2));
  uint16_t* pay = reinterpret_cast<uint16_t*>(r2 + k7_diag_bytes(P2) + 8 * P2);
  // the picks and anchor lists, in the hits' place once they are read
  int* pkA = reinterpret_cast<int*>(smem);
  int* pkB = pkA + MAX_ANCHORS;
  float* xf = reinterpret_cast<float*>(pkB + MAX_ANCHORS);
  float* ff = xf + MAX_ANCHORS;
  float* xb = ff + MAX_ANCHORS;
  float* fb = xb + MAX_ANCHORS;
  // the centre tiles, in the region's place once the picks are made
  int* tile = reinterpret_cast<int*>(r2);
  const int tile_half = k7_region_bytes(P2) / 8;

  const int64_t ra = a_idx[q], rb = b_idx[q];
  const int lenA = length[ra], lenB = length[rb];
  const int L = 16 * W;
  const int64_t* wA = words + ra * W;
  const int64_t* wB = words + rb * W;
  const int64_t* mkA = mker + ra * Pm;
  const int64_t* mkB = mker + rb * Pm;
  const int32_t *mpA = mpos + ra * Pm, *mpB = mpos + rb * Pm;
  const int32_t *msA = mstr + ra * Pm, *msB = mstr + rb * Pm;
  if (tid < 9) s_c[tid] = tid == UMN ? -1 : 0;  // read after the first barrier

  // 1. each read's (mix32(key), slot), invalid entries (UINT32_MAX, slot |
  // 0x8000) after every valid one, padded to P2
  {
    int nvA = 0, nvB = 0, fiA = Pm, fiB = Pm;
    for (int i = tid; i < P2; i += THREADS) {
      uint32_t xa = UMAX, xb2 = UMAX;
      uint16_t ya = 0xFFFF, yb = 0xFFFF;
      if (i < Pm) {
        const int64_t ka = mkA[i], kb = mkB[i];
        const bool va = ka != INVALID_KMER, vb = kb != INVALID_KMER;
        xa = va ? mix32(static_cast<uint32_t>(ka)) : UMAX;
        xb2 = vb ? mix32(static_cast<uint32_t>(kb)) : UMAX;
        ya = static_cast<uint16_t>(va ? i : (0x8000 | i));
        yb = static_cast<uint16_t>(vb ? i : (0x8000 | i));
        nvA += va;
        nvB += vb;
        if (!va && i < fiA) fiA = i;
        if (!vb && i < fiB) fiB = i;
      }
      kA[i] = xa;
      sA[i] = ya;
      kB[i] = xb2;
      sB[i] = yb;
    }
    nvA = warp_sum(nvA);
    nvB = warp_sum(nvB);
    fiA = warp_min(fiA);
    fiB = warp_min(fiB);
    if (lane == 0) {
      s_part[0][warp] = nvA;
      s_part[1][warp] = nvB;
      s_part[2][warp] = fiA;
      s_part[3][warp] = fiB;
    }
  }
  __syncthreads();
  int nA = 0, nB = 0, fA = Pm, fB = Pm;
  for (int w = 0; w < NWARP; ++w) {
    nA += s_part[0][w];
    nB += s_part[1][w];
    fA = s_part[2][w] < fA ? s_part[2][w] : fA;
    fB = s_part[3][w] < fB ? s_part[3][w] : fB;
  }
  {
    // a row is in order where its valid entries come first, their mix32
    // keys non-decreasing (ties are in slot order by construction)
    int bad = (nA != fA) | ((nB != fB) << 1);
    for (int i = tid + 1; i < nA; i += THREADS) bad |= kA[i - 1] > kA[i];
    for (int i = tid + 1; i < nB; i += THREADS) bad |= (kB[i - 1] > kB[i]) << 1;
    bad = (__ballot_sync(FULL, bad & 1) != 0u) | ((__ballot_sync(FULL, bad & 2) != 0u) << 1);
    if (lane == 0) s_part[4][warp] = bad;
  }
  __syncthreads();
  int bad = 0;
  for (int w = 0; w < NWARP; ++w) bad |= s_part[4][w];
  if (bad & 1) block_sort(kA, sA, P2, P2);
  if (bad & 2) block_sort(kB, sB, P2, P2);

  // 2. hits: each first B entry of a run against A's last entry of its key
  {
    int same = 0, opp = 0;
    for (int i = tid; i < nB; i += THREADS) {
      const uint32_t x = kB[i];
      if (i > 0 && kB[i - 1] == x) continue;
      int lo = 0, hi = nA;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kA[mid] <= x)
          lo = mid + 1;
        else
          hi = mid;
      }
      if (lo == 0 || kA[lo - 1] != x) continue;
      const int ia = sA[lo - 1], ib = sB[i];
      const bool agree = (__ldg(msA + ia) & 1) == (__ldg(msB + ib) & 1);
      same += agree;
      opp += !agree;
      const int h = atomicAdd(&s_c[NH], 1);
      hits[h] = static_cast<uint32_t>(ia) | (static_cast<uint32_t>(ib) << 11) |
                (static_cast<uint32_t>(agree) << 22);
    }
    same = warp_sum(same);
    opp = warp_sum(opp);
    if (lane == 0) {
      atomicAdd(&s_c[SAME], same);
      atomicAdd(&s_c[OPP], opp);
    }
  }
  __syncthreads();
  const int nh = s_c[NH], n_same = s_c[SAME], n_opp = s_c[OPP];
  const bool fl = orient ? n_opp > n_same : flipped_in[q] != 0;

  // 3. the diagonals of the hits of this orientation, the lower median
  {
    int n2 = 0;
    uint32_t umn = UMAX, umx = 0;
    for (int h = tid; h < nh; h += THREADS) {
      const uint32_t hv = hits[h];
      if (((hv >> 22) & 1u) == static_cast<uint32_t>(fl)) continue;
      const int pa = __ldg(mpA + (hv & 0x7FFu)), pb = __ldg(mpB + ((hv >> 11) & 0x7FFu));
      const int dg = wsub(pa, fl ? wsub(wsub(lenB, k), pb) : pb);
      D[h] = dg;
      const uint32_t u = static_cast<uint32_t>(dg) ^ 0x80000000u;
      umn = u < umn ? u : umn;
      umx = u > umx ? u : umx;
      ++n2;
    }
    for (int i = tid; i < 512; i += THREADS) hist[i] = 0;
    n2 = warp_sum(n2);
    umn = warp_umin(umn);
    umx = warp_umax(umx);
    if (lane == 0) {
      atomicAdd(&s_c[N2], n2);
      atomicMin(reinterpret_cast<unsigned int*>(&s_c[UMN]), umn);
      atomicMax(reinterpret_cast<unsigned int*>(&s_c[UMX]), umx);
    }
  }
  __syncthreads();
  const int n2 = s_c[N2];
  int med = BIG;
  if (n2 > 0) {
    // the (n2 - 1) / 2-th smallest of the 2 Pm - 1 join columns, the
    // columns off this orientation's hits being 2^30.  Where every
    // diagonal lies below 2^30 the answer is one of them, and the radix
    // select runs over the bits below the highest one in which the least
    // and the greatest differ (2 passes for diagonals within +-32,768);
    // else over all 32 bits with the 2^30 columns counted.
    const uint32_t umn = static_cast<uint32_t>(s_c[UMN]), umx = static_cast<uint32_t>(s_c[UMX]);
    const uint32_t ubig = static_cast<uint32_t>(BIG) ^ 0x80000000u;
    const bool virt = umx >= ubig;
    const int nvirt = virt ? 2 * Pm - 1 - n2 : 0;
    const int hb = virt ? 31 : (umn == umx ? -1 : 31 - __clz(umn ^ umx));
    uint32_t prefix = hb >= 31 ? 0u : (umn >> (hb + 1)) << (hb + 1);
    int r = (n2 - 1) / 2;
    for (int pass = 0, shift = hb < 0 ? -8 : 8 * (hb >> 3); shift >= 0; ++pass, shift -= 8) {
      int* hs = hist + 256 * (pass & 1);
      if (pass >= 1)
        for (int i = tid; i < 256; i += THREADS) hist[256 * ((pass + 1) & 1) + i] = 0;
      for (int h = tid; h < nh; h += THREADS) {
        if (((hits[h] >> 22) & 1u) == static_cast<uint32_t>(fl)) continue;
        const uint32_t u = static_cast<uint32_t>(D[h]) ^ 0x80000000u;
        if (shift == 24 || ((u ^ prefix) >> (shift + 8)) == 0u)
          atomicAdd(&hs[(u >> shift) & 255u], 1);
      }
      if (tid == 0 && nvirt > 0 && (shift == 24 || ((ubig ^ prefix) >> (shift + 8)) == 0u))
        atomicAdd(&hs[(ubig >> shift) & 255u], nvirt);
      __syncthreads();
      if (warp == 0) {
        int c[8], sum = 0;
        for (int j = 0; j < 8; ++j) {
          c[j] = hs[8 * lane + j];
          sum += c[j];
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        int before = incl - sum;
        if (before <= r && r < incl) {
          int d = 8 * lane;
          for (int j = 0; j < 8; ++j) {
            if (r < before + c[j]) {
              d = 8 * lane + j;
              break;
            }
            before += c[j];
          }
          s_c[PFX] = static_cast<int>(prefix | (static_cast<uint32_t>(d) << shift));
          s_c[RNK] = r - before;
        }
      }
      __syncthreads();
      prefix = static_cast<uint32_t>(s_c[PFX]);
      r = s_c[RNK];
    }
    med = static_cast<int>(prefix ^ 0x80000000u);
  }
  const int min_len = lenA < lenB ? lenA : lenB;
  const int tol_f = static_cast<int>(__fmul_rn(__int2float_rn(min_len), 0.3f));
  const int tol = tol_f > 100 ? tol_f : 100;

  // 4. the inliers by (posA, key), posA as an ordered unsigned, carrying
  // the hit index
  for (int h = tid; h < nh; h += THREADS) {
    const uint32_t hv = hits[h];
    if (((hv >> 22) & 1u) == static_cast<uint32_t>(fl)) continue;
    if (wabs(wsub(D[h], med)) > tol) continue;
    const int pa = __ldg(mpA + (hv & 0x7FFu));
    if (pa == BIG) continue;
    const uint32_t key = static_cast<uint32_t>(__ldg(mkA + (hv & 0x7FFu)));
    const int slot = atomicAdd(&s_c[NI], 1);
    comp[slot] = (static_cast<uint64_t>(static_cast<uint32_t>(pa) ^ 0x80000000u) << 32) | key;
    pay[slot] = static_cast<uint16_t>(h);
  }
  __syncthreads();
  const int ni = s_c[NI];
  const int n_ins = pow2_at_least(ni > 1 ? ni : 1);
  block_sort(comp, pay, n_ins, ni);

  // the running max over the sorted inliers' posB (posA - diagonal):
  // entry i is kept where its posB exceeds the max of the entries before
  // it (-1 before the first); each kept entry that is a pick writes it
  const int per = (ni + THREADS - 1) / THREADS;
  const int i_lo = tid * per < ni ? tid * per : ni;
  const int i_hi = i_lo + per < ni ? i_lo + per : ni;
  auto pos_a = [&](int i) {
    return static_cast<int>(static_cast<uint32_t>(comp[i] >> 32) ^ 0x80000000u);
  };
  auto pos_b = [&](int i) { return wsub(pos_a(i), D[pay[i]]); };
  int m_loc = INT_MIN32;
  for (int i = i_lo; i < i_hi; ++i) {
    const int pb = pos_b(i);
    m_loc = pb > m_loc ? pb : m_loc;
  }
  const int before = block_excl_max(m_loc, s_w1);
  int run = before, n_kept_loc = 0;
  for (int i = i_lo; i < i_hi; ++i) {
    const int pb = pos_b(i);
    n_kept_loc += pb > (i == 0 ? -1 : run);
    run = pb > run ? pb : run;
  }
  int n_keep = 0;
  int rank = block_excl_sum(n_kept_loc, &n_keep, s_w2);
  // 5. the picks: pick m is kept entry m where n_keep <= 64, else entry
  // m (n_keep - 1) / 63, a strictly increasing map
  run = before;
  for (int i = i_lo; i < i_hi; ++i) {
    const int pb = pos_b(i);
    if (pb > (i == 0 ? -1 : run)) {
      int m = -1;
      if (n_keep <= MAX_ANCHORS) {
        m = rank;
      } else {
        const int d = n_keep - 1;
        const int mm = (63 * rank + d - 1) / d;
        if (mm < MAX_ANCHORS && (mm * d) / 63 == rank) m = mm;
      }
      if (m >= 0) {
        pkA[m] = pos_a(i);
        pkB[m] = pb;
      }
      ++rank;
    }
    run = pb > run ? pb : run;
  }
  if (tid < MAX_ANCHORS && tid >= n_keep) pkA[tid] = pkB[tid] = -1;
  __syncthreads();
  const int n_anchor = n_keep < MAX_ANCHORS ? n_keep : MAX_ANCHORS;
  const int seed_m = (n_anchor - 1 > 0 ? n_anchor - 1 : 0) / 2;
  const int seedA = pkA[seed_m] > 0 ? pkA[seed_m] : 0;
  const int seedB = pkB[seed_m] > 0 ? pkB[seed_m] : 0;
  if (tid < MAX_ANCHORS) {
    const int m = tid;
    const int i_f = seed_m + m < MAX_ANCHORS - 1 ? seed_m + m : MAX_ANCHORS - 1;
    int fa = pkA[i_f] - seedA, fbv = pkB[i_f] - seedB;
    const bool vf = seed_m + m < n_anchor && fa >= 0;
    fa = vf ? fa : BIGF + m;
    fbv = vf ? fbv : BIGF + m;
    const int i_b = seed_m - m > 0 ? seed_m - m : 0;
    const int aAb = pkA[i_b];
    int ba = seedA - aAb, bbv = seedB - pkB[i_b];
    const bool vb = m <= seed_m && aAb >= 0;
    ba = vb ? ba : BIGF + m;
    bbv = vb ? bbv : BIGF + m;
    // the picks are read by every thread above: the lists go after them
    xf[m] = __int2float_rn(fa);
    ff[m] = __int2float_rn(fbv);
    xb[m] = __int2float_rn(ba);
    fb[m] = __int2float_rn(bbv);
  }
  if (tid == 0) {
    out_nanchor[q] = n_anchor;
    out_flipped[q] = fl;
    out_seedA[q] = seedA;
    out_seedB[q] = seedB;
    out_nminor[q] = n_same < n_opp ? n_same : n_opp;
    const int64_t rf = 2 * static_cast<int64_t>(g) * C + p, rbk = rf + C;
    out_alen[rf] = lenA - seedA;
    out_alen[rbk] = seedA;
    out_blen[rf] = lenB - seedB;
    out_blen[rbk] = seedB;
  }
  __syncthreads();

  // 6. the centres: one interpolation a 16-row group into a shared tile
  // (threads 0-127 the forward list, 128-255 the backward one, each a run
  // of consecutive groups, walking the anchors forward), then the rows
  const int64_t row_f = 2 * static_cast<int64_t>(g) * C + p, row_b = row_f + C;
  const int ns = (n_rows >> 4) + 1;
  const int wc = grid_centres ? ns : n_rows + 1;
  int32_t* cf = out_cen + row_f * wc;
  int32_t* cb = out_cen + row_b * wc;
  for (int j0 = 0; j0 < ns; j0 += tile_half) {
    const int nt = ns - j0 < tile_half ? ns - j0 : tile_half;
    const int dir = tid >> 7, t = tid & 127;
    const float* xp = dir ? xb : xf;
    const float* fp = dir ? fb : ff;
    const int tper = (nt + 127) >> 7;
    const int s0 = t * tper, s1 = s0 + tper < nt ? s0 + tper : nt;
    if (s0 < s1) {
      int lo = search_right(__int2float_rn(16 * (j0 + s0)), xp);
      for (int j = s0; j < s1; ++j) {
        const float x = __int2float_rn(16 * (j0 + j));
        while (lo < MAX_ANCHORS && xp[lo] <= x) ++lo;
        tile[dir * tile_half + j] = interp_at(x, lo, xp, fp);
      }
    }
    __syncthreads();
    if (grid_centres) {
      for (int j = tid; j < nt; j += THREADS) {
        cf[j0 + j] = tile[j];
        cb[j0 + j] = tile[tile_half + j];
      }
    } else {
      const int c0 = 16 * j0, c1 = 16 * (j0 + nt) < wc ? 16 * (j0 + nt) : wc;
      store_centres(cf, c0, c1, tile, j0);
      store_centres(cb, c0, c1, tile + tile_half, j0);
    }
    if (j0 + tile_half < ns) __syncthreads();  // the next tile overwrites this one
  }

  // 7. the base rows, 16 bases a thread
  const int wb = n_rows + band;
  const int64_t te_af = seedA & shift_mask(L, n_rows);
  const int64_t te_ab = (L - seedA) & shift_mask(L, n_rows);
  const int64_t te_bf = seedB & shift_mask(L, wb);
  const int64_t te_bb = (L - seedB) & shift_mask(L, wb);
  const int64_t te_o = (fl ? L - lenB : 0) & shift_mask(L, L);
  const int64_t lim_b = L < lenB ? L : lenB;  // forward B: s < L and s < lenB
  store_row(out_a + row_f * n_rows, n_rows, [&](int i0) {
    const int64_t s0 = i0 + te_af;  // out[i] = raw(s), s = i + te < L
    return bases_out16(wA, W, s0, false, 0u, 0, L - s0);
  });
  store_row(out_a + row_b * n_rows, n_rows, [&](int i0) {
    const int64_t s0 = i0 + te_ab;  // out[i] = raw(L - 1 - s), s < L
    return bases_out16(wA, W, L - 1 - s0, true, 0u, 0, L - s0);
  });
  store_row(out_b + row_f * wb, wb, [&](int i0) {
    const int64_t s0 = i0 + te_bf;  // out[i] = oriented(s), s < L
    if (!fl) return bases_out16(wB, W, s0, false, 0u, 0, lim_b - s0);
    // oriented(s) = 3 - raw(L - 1 - te_o - s) where s < lenB, s + te_o < L
    const int64_t lim = lim_b < L - te_o ? lim_b : L - te_o;
    return bases_out16(wB, W, L - 1 - te_o - s0, true, 3u * 0x55555555u, 0, lim - s0);
  });
  store_row(out_b + row_b * wb, wb, [&](int i0) {
    const int64_t s0 = i0 + te_bb;  // out[i] = oriented(L - 1 - s), s < L
    // L - 1 - s < lenB: s >= L - lenB
    if (!fl) return bases_out16(wB, W, L - 1 - s0, true, 0u, L - lenB - s0, L - s0);
    // oriented(L - 1 - s) = 3 - raw(s - te_o) where also s >= te_o
    const int64_t first = L - lenB > te_o ? L - lenB : te_o;
    return bases_out16(wB, W, s0 - te_o, false, 3u * 0x55555555u, first - s0, L - s0);
  });
}

// ---- K8 -----------------------------------------------------------------------

__device__ __forceinline__ uint64_t word_at(const int64_t* __restrict__ w, int Wr, int j) {
  return j < Wr ? static_cast<uint64_t>(static_cast<uint32_t>(__ldg(w + j))) : 0ull;
}

// reverse the order of the 32 2-bit fields of v
__device__ __forceinline__ uint64_t rev2_64(uint64_t v) {
  v = __brevll(v);
  return ((v & 0x5555555555555555ull) << 1) | ((v >> 1) & 0x5555555555555555ull);
}

__device__ __forceinline__ uint64_t field_mask(int n) {
  return n >= 32 ? ~0ull : (1ull << (2 * n)) - 1ull;
}

// the forward and reverse-complement n-mers (n <= 32) of the first n bases
// of v (base j at bits 2j)
__device__ __forceinline__ void nmer_of(uint64_t v, int n, uint64_t& fw, uint64_t& rc) {
  const uint64_t m = field_mask(n);
  rc = ~v & m;
  fw = rev2_64(v & m) >> (64 - 2 * n);
}

// the canonical key of a k-mer (ops/kmer.py extract_kmers_any) from its
// forward and reverse complement
__device__ __forceinline__ uint32_t canonical_key(uint64_t fw, uint64_t rc, int k) {
  const uint64_t c = rc < fw ? rc : fw;
  if (k <= 16) return static_cast<uint32_t>(c);
  const uint32_t key = mix32(static_cast<uint32_t>(c >> 32) ^ mix32(static_cast<uint32_t>(c)));
  return key == UMAX ? key ^ 1u : key;
}

struct SyncRead {
  const int64_t* w;
  int Wr, len, k, s, t, nw, Pk, Ps;
};

// One tile of positions [p0, p0 + SM_T): the s-mer hashes into s_hs, then
// f(p, key, selected) for each of the thread's 16 positions p0 + 16 tid +
// e < Pk in order.  Starts with a barrier (the previous tile's readers)
// and has one between the hashes and the keys.
template <typename F>
__device__ __forceinline__ void syncmer_tile(const SyncRead& R, int p0, uint32_t* s_hs, F f) {
  __syncthreads();
  const int nruns = (SM_T + R.nw - 1 + 15) >> 4;
  const uint64_t ms = field_mask(R.s);
  for (int run = threadIdx.x; run < nruns; run += THREADS) {
    const int q = p0 + 16 * run, j = q >> 4;
    const uint64_t lo = word_at(R.w, R.Wr, j) | (word_at(R.w, R.Wr, j + 1) << 32);
    uint64_t fw, rc;
    nmer_of(lo, R.s, fw, rc);
    for (int e = 0; e < 16; ++e) {
      const int qi = q + e;
      uint32_t hv = UMAX;
      if (qi < R.Ps && qi <= R.len - R.s) hv = mix32(static_cast<uint32_t>(rc < fw ? rc : fw));
      s_hs[16 * run + e] = hv;
      const uint64_t b = (lo >> (2 * (e + R.s))) & 3u;  // e + s <= 31
      fw = ((fw << 2) | b) & ms;
      rc = (rc >> 2) | ((3u - b) << (2 * R.s - 2));
    }
  }
  __syncthreads();
  const int q = p0 + 16 * threadIdx.x;
  if (q >= R.Pk) return;
  const int j = q >> 4;
  const uint64_t lo = word_at(R.w, R.Wr, j) | (word_at(R.w, R.Wr, j + 1) << 32);
  const uint64_t hi = word_at(R.w, R.Wr, j + 2);
  const uint64_t mk = field_mask(R.k);
  uint64_t fw, rc;
  nmer_of(lo, R.k, fw, rc);
  const uint32_t* hs = s_hs + 16 * threadIdx.x;
  for (int e = 0; e < 16; ++e) {
    const int p = q + e;
    if (p >= R.Pk) break;
    uint32_t wm = UMAX;
    for (int jj = 0; jj < R.nw; ++jj) wm = hs[e + jj] < wm ? hs[e + jj] : wm;
    const bool sel = p <= R.len - R.k && hs[e + R.t] == wm;
    f(p, sel ? mix32(canonical_key(fw, rc, R.k)) : UMAX, sel);
    const int nb = e + R.k;  // the base entering the next k-mer: <= 46
    const uint64_t b = (nb < 32 ? lo >> (2 * nb) : hi >> (2 * (nb - 32))) & 3u;
    fw = ((fw << 2) | b) & mk;
    rc = (rc >> 2) | ((3u - b) << (2 * R.k - 2));
  }
}

// slot c of the read's output rows: position pos's canonical key (INVALID
// past len - k), pos and strand
__device__ __forceinline__ void write_slot(const SyncRead& R, int64_t o, int pos,
                                           int64_t* out_mk, int32_t* out_pos, int32_t* out_str) {
  const int j = pos >> 4, off = pos & 15;
  const uint64_t lo = word_at(R.w, R.Wr, j) | (word_at(R.w, R.Wr, j + 1) << 32);
  const uint64_t hi = word_at(R.w, R.Wr, j + 2);
  const uint64_t v = off ? (lo >> (2 * off)) | (hi << (64 - 2 * off)) : lo;
  uint64_t fw, rc;
  nmer_of(v, R.k, fw, rc);
  out_mk[o] = pos <= R.len - R.k ? static_cast<int64_t>(canonical_key(fw, rc, R.k)) : INVALID_KMER;
  out_pos[o] = pos;
  out_str[o] = rc < fw;
}

__global__ void __launch_bounds__(THREADS, K8_MIN_BLOCKS)
syncmer_kernel(const int64_t* __restrict__ words, int W, const int32_t* __restrict__ lengths,
               const int32_t* __restrict__ rows, const int32_t* __restrict__ wbs, int k, int s,
               int t, int pm, int64_t* __restrict__ out_mk, int32_t* __restrict__ out_pos,
               int32_t* __restrict__ out_str, int32_t* __restrict__ out_nsel) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint32_t s_hs[SM_T + SM_HALO];  // the tile's s-mer hashes
  __shared__ int s_hist[512];
  __shared__ int s_w[NWARP];
  __shared__ int s_c[4];  // selected, kept (key < UINT32_MAX), the select's prefix and rank
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem);  // (key << 32 | position), pow2(pm)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = rows[blockIdx.x];
  SyncRead R;
  R.Wr = wbs[blockIdx.x];
  R.w = words + static_cast<int64_t>(row) * W;
  R.len = lengths[row];
  R.k = k;
  R.s = s;
  R.t = t;
  R.nw = k - s + 1;
  R.Pk = 16 * R.Wr - k + 1;
  R.Ps = 16 * R.Wr - s + 1;
  if (tid < 4) s_c[tid] = 0;
  // (the first tile's barrier orders these stores before any use)

  // pass 1: count the selected; keep the pairs of key < UINT32_MAX while
  // they fit
  int n_sel_loc = 0;
  for (int p0 = 0; p0 < R.Pk; p0 += SM_T) {
    syncmer_tile(R, p0, s_hs, [&](int p, uint32_t key, bool sel) {
      n_sel_loc += sel;
      if (key != UMAX) {
        const int slot = atomicAdd(&s_c[1], 1);
        if (slot < pm) buf[slot] = (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(p);
      }
    });
  }
  n_sel_loc = warp_sum(n_sel_loc);
  if (lane == 0) atomicAdd(&s_c[0], n_sel_loc);
  __syncthreads();
  const int n_sel = s_c[0], n_lt = s_c[1];
  const int n_out = n_sel < pm ? n_sel : pm;
  const int n_head = n_lt < n_out ? n_lt : n_out;
  int n_keep = n_lt;
  if (n_lt > pm) {
    // the pm smallest (key, position): the pm-th smallest key T by a radix
    // select, every key below it, and at T the first positions in order
    uint32_t prefix = 0;
    int r = pm - 1;
    for (int pass = 0; pass < 4; ++pass) {
      const int shift = 24 - 8 * pass;
      int* hs = s_hist + 256 * (pass & 1);
      for (int i = tid; i < 256; i += THREADS) hs[i] = 0;
      for (int p0 = 0; p0 < R.Pk; p0 += SM_T) {
        syncmer_tile(R, p0, s_hs, [&](int, uint32_t key, bool) {
          if (key != UMAX && (pass == 0 || ((key ^ prefix) >> (shift + 8)) == 0u))
            atomicAdd(&hs[(key >> shift) & 255u], 1);
        });
      }
      __syncthreads();
      if (warp == 0) {
        int c[8], sum = 0;
        for (int j = 0; j < 8; ++j) {
          c[j] = hs[8 * lane + j];
          sum += c[j];
        }
        int incl = sum;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        int before = incl - sum;
        if (before <= r && r < incl) {
          int d = 8 * lane;
          for (int j = 0; j < 8; ++j) {
            if (r < before + c[j]) {
              d = 8 * lane + j;
              break;
            }
            before += c[j];
          }
          s_c[2] = static_cast<int>(prefix | (static_cast<uint32_t>(d) << shift));
          s_c[3] = r - before;
        }
      }
      __syncthreads();
      prefix = static_cast<uint32_t>(s_c[2]);
      r = s_c[3];
    }
    const uint32_t T = prefix;
    const int need_eq = r + 1;  // entries of key T among the pm smallest
    if (tid == 0) s_c[1] = 0;
    int eq_taken = 0;
    for (int p0 = 0; p0 < R.Pk; p0 += SM_T) {
      uint32_t eqmask = 0;
      const int q = p0 + 16 * tid;
      syncmer_tile(R, p0, s_hs, [&](int p, uint32_t key, bool) {
        if (key < T) {
          const int slot = atomicAdd(&s_c[1], 1);
          buf[slot] = (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(p);
        } else if (key == T) {
          eqmask |= 1u << (p - q);
        }
      });
      int tot = 0;
      int rk = eq_taken + block_excl_sum(__popc(eqmask), &tot, s_w);
      for (uint32_t m = eqmask; m; m &= m - 1) {
        if (rk < need_eq) {
          const int slot = atomicAdd(&s_c[1], 1);
          buf[slot] = (static_cast<uint64_t>(T) << 32) |
                      static_cast<uint32_t>(q + __ffs(m) - 1);
        }
        ++rk;
      }
      eq_taken += tot;
    }
    n_keep = pm;
  }
  __syncthreads();
  const int n_sort = pow2_at_least(n_keep > 1 ? n_keep : 1);
  block_sort(buf, static_cast<uint16_t*>(nullptr), n_sort, n_keep);
  const int64_t base = static_cast<int64_t>(row) * pm;
  for (int c = tid; c < pm; c += THREADS) {
    if (c < n_head) {
      write_slot(R, base + c, static_cast<int>(static_cast<uint32_t>(buf[c])), out_mk, out_pos,
                 out_str);
    } else if (c >= n_out) {
      out_mk[base + c] = INVALID_KMER;
      out_pos[base + c] = -1;
      out_str[base + c] = 0;
    }
  }
  if (tid == 0 && out_nsel != nullptr) out_nsel[row] = n_out;

  // slots [n_head, n_out): the positions of key UINT32_MAX in position
  // order (only where a selected k-mer's mix32 is UINT32_MAX)
  const int need = n_out - n_head;
  int taken = 0;
  for (int p0 = 0; p0 < R.Pk && taken < need; p0 += SM_T) {
    uint32_t umask = 0;
    const int q = p0 + 16 * tid;
    syncmer_tile(R, p0, s_hs, [&](int p, uint32_t key, bool) {
      if (key == UMAX) umask |= 1u << (p - q);
    });
    int tot = 0;
    int rk = taken + block_excl_sum(__popc(umask), &tot, s_w);
    for (uint32_t m = umask; m; m &= m - 1) {
      if (rk < need) write_slot(R, base + n_head + rk, q + __ffs(m) - 1, out_mk, out_pos, out_str);
      ++rk;
    }
    taken += tot;
  }
}

// ---- K12 -----------------------------------------------------------------------

constexpr unsigned long long EMPTY_SLOT = ~0ull;  // a table slot before A's key (UINT32_MAX)
constexpr int EMPTY_B = 0x7FFFFFFF;                // and its B side before B's
constexpr int K12_MIN_SLOTS = 64;

// A pair's table: S slots (a power of two, 64..T, at least 2 nA where T
// allows) and the rounds that take A's nA positions through it
// (ceil(nA / (S / 2)); none without a position in either read).
// verify_cuda.pair_stats_plan is its copy.
__device__ __forceinline__ void k12_plan(int nA, int nB, int T, int& S, int& rounds) {
  S = pow2_at_least(2 * nA);
  S = S < K12_MIN_SLOTS ? K12_MIN_SLOTS : (S > T ? T : S);
  rounds = nA > 0 && nB > 0 ? (nA + S / 2 - 1) / (S / 2) : 0;
}

// f(p, key, strand) for the k-mers at positions p0 .. p0 + L - 1 below n
// (L <= 16) of a read of Wr words, rolling forward and reverse complement
// 2 bits a step from the four words the segment reads
template <typename Fn>
__device__ __forceinline__ void kmer_seg(const int64_t* __restrict__ w, int Wr, int p0, int L,
                                         int n, int k, Fn f) {
  const int j = p0 >> 4, off = p0 & 15;
  uint64_t lo = word_at(w, Wr, j) | (word_at(w, Wr, j + 1) << 32);
  uint64_t hi = word_at(w, Wr, j + 2) | (word_at(w, Wr, j + 3) << 32);
  if (off) {  // base p0 + i at bits 2 i of (hi:lo), i < 64 - off
    lo = (lo >> (2 * off)) | (hi << (64 - 2 * off));
    hi >>= 2 * off;
  }
  const uint64_t mk = field_mask(k);
  uint64_t fw, rc;
  nmer_of(lo, k, fw, rc);
  const int e_end = n - p0 < L ? n - p0 : L;
  for (int e = 0; e < e_end; ++e) {
    f(p0 + e, canonical_key(fw, rc, k), rc < fw);
    const int nb = e + k;  // the base entering the next k-mer: <= 47
    const uint64_t b = (nb < 32 ? lo >> (2 * nb) : hi >> (2 * (nb - 32))) & 3u;
    fw = ((fw << 2) | b) & mk;
    rc = (rc >> 2) | ((3u - b) << (2 * k - 2));
  }
}

// positions a thread's segment takes so that n positions fill NT threads,
// at most 16
template <int NT>
__device__ __forceinline__ int seg_len(int n) {
  const int L = (n + NT - 1) / NT;
  return L < 1 ? 1 : (L > 16 ? 16 : L);
}

// torch.searchsorted(fk, key) (left) clamped to F - 1, then fk[idx] == key
__device__ __forceinline__ bool is_frequent(const int64_t* __restrict__ fk, int F, uint32_t key) {
  int lo = 0, hi = F;
  const int64_t x = key;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(fk + mid) < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return __ldg(fk + (lo < F - 1 ? lo : F - 1)) == x;
}

// a hit: posA, posB, agree (A's strand == B's), packed as (posA, 2 posB +
// agree)
struct PairCtx {
  int lenB, k, flipped, med, tol;
  // the hit's diagonal on the oriented B, and whether it counts: mode 0
  // the hits that agree with the vote, mode 1 those within tol of med
  __device__ __forceinline__ bool take(int2 h, int mode, int& d) const {
    const int pa = h.x, pb = h.y >> 1, agree = h.y & 1;
    if (agree == flipped) return false;
    d = wsub(pa, flipped ? wsub(wsub(lenB, k), pb) : pb);
    return mode == 0 || wabs(wsub(d, med)) <= tol;
  }
};

// A pair's hits: the first HS in shared memory, the rest in its room of
// the device list
struct HitList {
  int2* s;
  int2* d;
  int HS;
  __device__ __forceinline__ int2 get(int h) const { return h < HS ? s[h] : __ldcg(d + (h - HS)); }
  __device__ __forceinline__ void put(int h, int2 v) const {
    if (h < HS)
      s[h] = v;
    else
      __stcg(d + (h - HS), v);
  }
};

// The r-th smallest diagonal (r < n) of the hits ctx.take(h, mode) keeps,
// their least and greatest as ordered unsigned umn, umx: a radix select
// over the bits below the highest in which umn and umx differ, 8 a pass.
// Every thread returns it; hist holds 256 ints, s_sel 2.
template <int NT>
__device__ int select_diag(const HitList& hits, int nh, const PairCtx& ctx, int mode, int r,
                           uint32_t umn, uint32_t umx, int* hist, int* s_sel) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hb = umn == umx ? -1 : 31 - __clz(umn ^ umx);
  uint32_t prefix = hb >= 31 ? 0u : (umn >> (hb + 1)) << (hb + 1);
  for (int shift = hb < 0 ? -8 : 8 * (hb >> 3); shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += NT) hist[i] = 0;
    __syncthreads();
    for (int h = tid; h < nh; h += NT) {
      int d;
      if (!ctx.take(hits.get(h), mode, d)) continue;
      const uint32_t u = static_cast<uint32_t>(d) ^ 0x80000000u;
      if (shift == 24 || ((u ^ prefix) >> (shift + 8)) == 0u) atomicAdd(&hist[(u >> shift) & 255u], 1);
    }
    __syncthreads();
    if (warp == 0) {
      int c[8], sum = 0;
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[8 * lane + j];
        sum += c[j];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
      }
      int before = incl - sum;
      if (before <= r && r < incl) {
        int d = 8 * lane;
        for (int j = 0; j < 8; ++j) {
          if (r < before + c[j]) {
            d = 8 * lane + j;
            break;
          }
          before += c[j];
        }
        s_sel[0] = static_cast<int>(prefix | (static_cast<uint32_t>(d) << shift));
        s_sel[1] = r - before;
      }
    }
    __syncthreads();
    prefix = static_cast<uint32_t>(s_sel[0]);
    r = s_sel[1];
    __syncthreads();  // s_sel read by all before the next pass writes it
  }
  return static_cast<int>(prefix ^ 0x80000000u);
}

// One block of NT threads a pair q = blockIdx.x: A = row a_idx[q] and B =
// row b_idx[q] of (words, lens), W words wide.  Dynamic shared memory: HS
// hits (int2), then the table's T keys, A sides and B sides.  out
// int32[7, M]; rounds_out[q] (unless null) the rounds the pair took,
// retries included.
template <int NT>
__global__ void __launch_bounds__(NT, 1024 / NT) pair_stats_kernel(
    const int64_t* __restrict__ words, const int32_t* __restrict__ lens, int W,
    const int32_t* __restrict__ a_idx, const int32_t* __restrict__ b_idx, int M,
    const int64_t* __restrict__ fk, int F, int k, int T, int HS,
    const int64_t* __restrict__ hit_off, int2* __restrict__ dhits,
    int32_t* __restrict__ out, int32_t* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_hist[256];
  __shared__ int s_sel[2];
  // hits, same, opp, the agreeing hits and their least and greatest
  // diagonal (ordered unsigned), the inliers' count, spans and least and
  // greatest diagonal; the round's claimed slots and its full-table flag
  __shared__ int s_c[16];
  enum { NH, SAME, OPP, N2, UMN, UMX, NI, ALO, AHI, BLO, BHI, UMN2, UMX2, CLAIM, OVER };

  int2* s_hits = reinterpret_cast<int2*>(smem);
  // a slot: A's key in the high word, A's largest 2 pos + strand in the low
  // one (one 64-bit max keeps both), and B's smallest beside it
  unsigned long long* slotA = reinterpret_cast<unsigned long long*>(s_hits + HS);
  int* sideB = reinterpret_cast<int*>(slotA + T);
  volatile int* v_over = s_c + OVER;

  const int tid = threadIdx.x, lane = tid & 31;
  const int q = blockIdx.x;
  const int P = 16 * W - k + 1;
  const int ra = a_idx[q], rb = b_idx[q];
  const int la = lens[ra], lb = lens[rb];
  const int64_t* wA = words + static_cast<long long>(ra) * W;
  const int64_t* wB = words + static_cast<long long>(rb) * W;
  int nA = la - k + 1, nB = lb - k + 1;
  nA = nA < 0 ? 0 : (nA > P ? P : nA);
  nB = nB < 0 ? 0 : (nB > P ? P : nB);
  int WA = (la + 15) >> 4, WB = (lb + 15) >> 4;  // each read at its own length
  WA = WA > W ? W : WA;
  WB = WB > W ? W : WB;
  const HitList hits{s_hits, hit_off != nullptr ? dhits + hit_off[q] : nullptr, HS};
  int S, rounds;
  k12_plan(nA, nB, T, S, rounds);
  const uint32_t smask = static_cast<uint32_t>(S - 1);
  const int limit = 3 * (S >> 2);
  const int LA = seg_len<NT>(nA), LB = seg_len<NT>(nB);

  if (tid < 16)  // counts 0; least UINT32_MAX (unsigned) or 2^30; greatest 0 or -1
    s_c[tid] = tid == UMN || tid == UMN2 || tid == AHI || tid == BHI ? -1
               : (tid == ALO || tid == BLO ? BIG : 0);
  for (int i = tid; i < S; i += NT) {
    slotA[i] = EMPTY_SLOT;
    sideB[i] = EMPTY_B;
  }
  __syncthreads();

  int taken = 0, same = 0, opp = 0, nh0 = 0;  // nh0: the hits before this round
  const uint64_t span = 1ull << 32;
  uint64_t width = rounds ? (span + rounds - 1) / rounds : span, lo = rounds ? 0 : span;
  while (lo < span) {
    const uint64_t hi = lo + width < span ? lo + width : span;
    ++taken;
    // A's keys of the range: A's largest 2 pos + strand a key.  A thread
    // counts the slots it claims; a probe that walks the whole table
    // flags it full
    int claims = 0;
    for (int p0 = tid * LA; p0 < nA && !*v_over; p0 += NT * LA) {
      kmer_seg(wA, WA, p0, LA, nA, k, [&](int p, uint32_t key, bool strand) {
        const uint32_t h = mix32(key);
        if (h < lo || h >= hi) return;
        const unsigned long long v = (static_cast<unsigned long long>(key) << 32) |
                                     static_cast<uint32_t>(2 * p + static_cast<int>(strand));
        uint32_t slot = h & smask;
        for (int step = 0; step < S; ++step) {
          const unsigned long long prev = atomicCAS(slotA + slot, EMPTY_SLOT, v);
          if (prev == EMPTY_SLOT) {
            ++claims;
            return;
          }
          if (static_cast<uint32_t>(prev >> 32) == key) {
            if (prev < v) atomicMax(slotA + slot, v);
            return;
          }
          slot = (slot + 1) & smask;
        }
        *v_over = 1;
      });
    }
    claims = warp_sum(claims);
    if (lane == 0 && claims) atomicAdd(&s_c[CLAIM], claims);
    __syncthreads();
    if (s_c[OVER] || s_c[CLAIM] > limit) {  // more keys than 3 S / 4: half the range again
      for (int i = tid; i < S; i += NT) slotA[i] = EMPTY_SLOT;
      __syncthreads();  // every thread has read OVER and CLAIM
      if (tid == 0) s_c[OVER] = s_c[CLAIM] = 0;
      __syncthreads();
      width = (width + 1) >> 1;
      continue;
    }
    // B's keys of the range probe it: B's smallest 2 pos + strand a key A
    // has; the first B entry of a key that is not frequent lists its slot
    for (int p0 = tid * LB; p0 < nB; p0 += NT * LB) {
      kmer_seg(wB, WB, p0, LB, nB, k, [&](int p, uint32_t key, bool strand) {
        const uint32_t h = mix32(key);
        if (h < lo || h >= hi) return;
        uint32_t slot = h & smask;
        while (true) {
          const uint32_t kk = static_cast<uint32_t>(slotA[slot] >> 32);
          if (kk == key) {
            if (atomicMin(sideB + slot, 2 * p + static_cast<int>(strand)) == EMPTY_B &&
                !is_frequent(fk, F, key))
              hits.put(atomicAdd(&s_c[NH], 1), make_int2(static_cast<int>(slot), 0));
            return;
          }
          if (kk == UMAX) return;
          slot = (slot + 1) & smask;
        }
      });
    }
    __syncthreads();
    // the round's hits from their slots, the vote; the table cleared where
    // another round follows
    if (tid == 0) s_c[CLAIM] = 0;
    const int nh1 = s_c[NH];
    for (int h = nh0 + tid; h < nh1; h += NT) {
      const int slot = hits.get(h).x;
      const int va = static_cast<int>(static_cast<uint32_t>(slotA[slot])), vb = sideB[slot];
      const int agree = (va & 1) == (vb & 1);
      same += agree;
      opp += !agree;
      hits.put(h, make_int2(va >> 1, ((vb >> 1) << 1) | agree));
    }
    nh0 = nh1;
    if (hi < span) {
      __syncthreads();  // every listed slot read
      for (int i = tid; i < S; i += NT) {
        slotA[i] = EMPTY_SLOT;
        sideB[i] = EMPTY_B;
      }
    }
    __syncthreads();
    lo = hi;
  }
  same = warp_sum(same);
  opp = warp_sum(opp);
  if (lane == 0) {
    atomicAdd(&s_c[SAME], same);
    atomicAdd(&s_c[OPP], opp);
  }
  __syncthreads();
  const int nh = s_c[NH];
  PairCtx ctx{lb, k, s_c[OPP] > s_c[SAME] ? 1 : 0, 0, 0};
  // the agreeing hits' count and diagonal range
  {
    int n2 = 0;
    uint32_t umn = UMAX, umx = 0u;
    for (int h = tid; h < nh; h += NT) {
      int d;
      if (!ctx.take(hits.get(h), 0, d)) continue;
      const uint32_t u = static_cast<uint32_t>(d) ^ 0x80000000u;
      umn = u < umn ? u : umn;
      umx = u > umx ? u : umx;
      ++n2;
    }
    n2 = warp_sum(n2);
    umn = warp_umin(umn);
    umx = warp_umax(umx);
    if (lane == 0) {
      atomicAdd(&s_c[N2], n2);
      atomicMin(reinterpret_cast<unsigned int*>(&s_c[UMN]), umn);
      atomicMax(reinterpret_cast<unsigned int*>(&s_c[UMX]), umx);
    }
  }
  __syncthreads();
  const int n2 = s_c[N2];
  ctx.med = n2 > 0 ? select_diag<NT>(hits, nh, ctx, 0, (n2 - 1) / 2,
                                     static_cast<uint32_t>(s_c[UMN]),
                                     static_cast<uint32_t>(s_c[UMX]), s_hist, s_sel)
                   : BIG;
  const int min_len = la < lb ? la : lb;
  const int tol_f = static_cast<int>(__fmul_rn(__int2float_rn(min_len), 0.3f));
  ctx.tol = tol_f > 100 ? tol_f : 100;
  // the inliers: count, spans, diagonal range
  {
    int ni = 0, alo = BIG, ahi = -1, blo = BIG, bhi = -1;
    uint32_t umn = UMAX, umx = 0u;
    for (int h = tid; h < nh; h += NT) {
      const int2 hv = hits.get(h);
      int d;
      if (!ctx.take(hv, 1, d)) continue;
      const uint32_t u = static_cast<uint32_t>(d) ^ 0x80000000u;
      umn = u < umn ? u : umn;
      umx = u > umx ? u : umx;
      const int pa = hv.x, pb = hv.y >> 1;
      alo = pa < alo ? pa : alo;
      ahi = pa + k > ahi ? pa + k : ahi;
      blo = pb < blo ? pb : blo;
      bhi = pb + k > bhi ? pb + k : bhi;
      ++ni;
    }
    ni = warp_sum(ni);
    alo = warp_min(alo);
    blo = warp_min(blo);
    ahi = -warp_min(-ahi);
    bhi = -warp_min(-bhi);
    umn = warp_umin(umn);
    umx = warp_umax(umx);
    if (lane == 0) {
      atomicAdd(&s_c[NI], ni);
      atomicMin(&s_c[ALO], alo);
      atomicMax(&s_c[AHI], ahi);
      atomicMin(&s_c[BLO], blo);
      atomicMax(&s_c[BHI], bhi);
      atomicMin(reinterpret_cast<unsigned int*>(&s_c[UMN2]), umn);
      atomicMax(reinterpret_cast<unsigned int*>(&s_c[UMX2]), umx);
    }
  }
  __syncthreads();
  const int ni = s_c[NI];
  const int med2 = ni > 0 ? select_diag<NT>(hits, nh, ctx, 1, (ni - 1) / 2,
                                            static_cast<uint32_t>(s_c[UMN2]),
                                            static_cast<uint32_t>(s_c[UMX2]), s_hist, s_sel)
                          : BIG;
  if (tid == 0) {
    out[q] = ctx.flipped;
    out[M + q] = med2;
    out[2 * M + q] = ni;
    out[3 * M + q] = s_c[ALO];
    out[4 * M + q] = s_c[AHI];
    out[5 * M + q] = s_c[BLO];
    out[6 * M + q] = s_c[BHI];
    if (rounds_out != nullptr) rounds_out[q] = taken;
  }
}

}  // namespace

// words int64[Npad, W] (uint32 values), length int32[Npad], mker int64[Npad,
// Pm] (uint32 values), mpos and mstr int32[Npad, Pm]: the ReadIndex; a_idx,
// b_idx int64[n_pairs] (rows of it), flipped uint8[n_pairs]; C pairs a
// chunk (n_pairs a multiple of C), k, band, n_rows, orient, grid_centres.
// Outputs: a uint8[2 n_pairs, n_rows], a_len int32[2 n_pairs], b
// uint8[2 n_pairs, n_rows + band], b_len int32[2 n_pairs], centers
// int32[2 n_pairs, n_rows + 1] (grid_centres: int32[2 n_pairs, n_rows / 16
// + 1], the 16-row grid), n_anchor, seedA, seedB, n_minor int32[n_pairs],
// flipped_out uint8[n_pairs].  Returns cudaGetLastError() of the launch (or of the
// shared-memory attribute), -1 for Pm outside 1..2048, -3 for a negative or
// empty size, -4 for n_pairs not a multiple of C.
extern "C" int canu_verify_pre(const void* words, int W, const void* length, const void* mker,
                               const void* mpos, const void* mstr, int Pm, const void* a_idx,
                               const void* b_idx, const void* flipped, int n_pairs, int C, int k,
                               int band, int n_rows, int orient, int grid_centres, void* a,
                               void* a_len, void* b, void* b_len, void* centers,
                               void* n_anchor, void* flipped_out,
                               void* seedA, void* seedB, void* n_minor, void* stream) {
  if (Pm < 1 || Pm > MAX_PM) return -1;
  if (W < 1 || n_pairs < 0 || C < 1 || band < 0 || n_rows < 1) return -3;
  if (n_pairs % C) return -4;
  if (n_pairs == 0) return 0;
  const int P2 = pow2_at_least(Pm);
  const size_t smem = static_cast<size_t>(k7_hits_bytes(P2)) + k7_region_bytes(P2);
  cudaError_t err = cudaFuncSetAttribute(verify_pre_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  verify_pre_kernel<<<n_pairs, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), W, static_cast<const int32_t*>(length),
      static_cast<const int64_t*>(mker), static_cast<const int32_t*>(mpos),
      static_cast<const int32_t*>(mstr), Pm, static_cast<const int64_t*>(a_idx),
      static_cast<const int64_t*>(b_idx), static_cast<const uint8_t*>(flipped), C, k, band,
      n_rows, orient, grid_centres, static_cast<uint8_t*>(a), static_cast<int32_t*>(a_len),
      static_cast<uint8_t*>(b), static_cast<int32_t*>(b_len), static_cast<int32_t*>(centers),
      static_cast<int32_t*>(n_anchor), static_cast<uint8_t*>(flipped_out),
      static_cast<int32_t*>(seedA), static_cast<int32_t*>(seedB),
      static_cast<int32_t*>(n_minor));
  return static_cast<int>(cudaGetLastError());
}

// words int64[*, W] (uint32 values) and lengths int32[*]: a word plane and
// its lengths; n reads, read i at row rows[i] (int32) padded to wbs[i] <= W
// words, 16 wbs[i] >= k - 1; k in 2..32 with its syncmer (s, t), pm in
// 1..2048.  Writes rows rows[i] of mker int64[*, pm], mpos, mstr int32[*,
// pm] and, unless null, n_sel int32[*].  Returns cudaGetLastError() of the
// launch, -1 for k, s, t or pm out of range, -3 for a bad size.
extern "C" int canu_syncmer(const void* words, int W, const void* lengths, const void* rows,
                            const void* wbs, int n, int k, int s, int t, int pm, void* mker,
                            void* mpos, void* mstr, void* n_sel, void* stream) {
  if (k < 2 || k > 32 || s < 2 || s > 16 || s > k || k - s + 1 > SM_HALO || t < 0 ||
      t > k - s || pm < 1 || pm > MAX_PM)
    return -1;
  if (n < 0 || W < 1) return -3;
  if (n == 0) return 0;
  const size_t smem = 8 * static_cast<size_t>(pow2_at_least(pm));
  syncmer_kernel<<<n, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), W, static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(wbs), k, s, t, pm,
      static_cast<int64_t*>(mker), static_cast<int32_t*>(mpos), static_cast<int32_t*>(mstr),
      static_cast<int32_t*>(n_sel));
  return static_cast<int>(cudaGetLastError());
}

// K12's shared bytes at (slots, hits), set as the kernel's limit: slots a
// power of two of at least 64 and hits at least 32, within 227 KB.
// Returns -2 for a plan the kernel does not take, else the CUDA error of
// the shared-memory attributes.
static int k12_setup(int slots, int hits, size_t* smem) {
  if (slots < K12_MIN_SLOTS || (slots & (slots - 1)) || hits < 32 ||
      8 * static_cast<long long>(hits) + 12 * static_cast<long long>(slots) > 227 * 1024)
    return -2;
  *smem = 8 * static_cast<size_t>(hits) + 12 * static_cast<size_t>(slots);
  cudaError_t err = cudaFuncSetAttribute(pair_stats_kernel<K12_NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(*smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(pair_stats_kernel<K12_NT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

// words int64[N, W] (uint32 values, 16 bases a word) and lens int32[N]:
// the word plane (the read set's for a place_candidates call); pair q is
// row a_idx[q] against row b_idx[q] (int32[M]); fk int64[F >= 1] (uint32
// values, sorted): the frequent k-mers; k in 2..32.  slots, hits: the
// launch plan (k12_setup) at K12_NT threads a block.  hit_off int64[M]
// (or null when no pair has more than `hits` possible hits) is each
// pair's room in dhits (int2), at least min(nA, nB) - hits entries.  out
// int32[7, M]: flipped, the second median, n_inliers, a_lo, a_hi, b_lo,
// b_hi; rounds int32[M] (or null) each pair's rounds.  Returns
// cudaGetLastError() of the launch, -1 for k out of range, -2 for a plan
// the kernel does not take, -3 for a bad size.
extern "C" int canu_pair_stats(const void* words, const void* lens, int W, const void* a_idx,
                               const void* b_idx, int M, const void* fk, int F, int k, int slots,
                               int hits, const void* hit_off, void* dhits, void* out,
                               void* rounds, void* stream) {
  if (k < 2 || k > 32) return -1;
  if (W < 1 || M < 0 || F < 1 || 16 * W - k + 1 < 1) return -3;
  size_t smem;
  const int rc = k12_setup(slots, hits, &smem);
  if (rc != 0) return rc;
  if (M == 0) return 0;
  pair_stats_kernel<K12_NT><<<M, K12_NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), static_cast<const int32_t*>(lens), W,
      static_cast<const int32_t*>(a_idx), static_cast<const int32_t*>(b_idx), M,
      static_cast<const int64_t*>(fk), F, k, slots, hits, static_cast<const int64_t*>(hit_off),
      static_cast<int2*>(dhits), static_cast<int32_t*>(out), static_cast<int32_t*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

// What the card gives K12 at a launch plan: out[0..4] resident blocks an
// SM, registers a thread, dynamic and static shared bytes a block, and
// threads a block (K12_NT).  Returns -2 for a plan the kernel does not
// take, else the first CUDA error or 0.
extern "C" int canu_pair_stats_resources(int slots, int hits, int* out) {
  size_t smem;
  const int rc = k12_setup(slots, hits, &smem);
  if (rc != 0) return rc;
  const void* kern = reinterpret_cast<const void*>(pair_stats_kernel<K12_NT>);
  cudaFuncAttributes fa;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, K12_NT, smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kern);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = fa.numRegs;
  out[2] = static_cast<int>(smem);
  out[3] = static_cast<int>(fa.sharedSizeBytes);
  out[4] = K12_NT;
  return 0;
}

// What the card gives each kernel at index rows of Pm (K7) and pm (K8)
// entries: out[0..3] K7's resident blocks an SM, registers a thread,
// dynamic and static shared bytes a block; out[4..7] the same for K8.
// Returns the first CUDA error, else 0.
extern "C" int canu_verify_resources(int Pm, int pm, int* out) {
  if (Pm < 1 || Pm > MAX_PM || pm < 1 || pm > MAX_PM) return -1;
  const int P2 = pow2_at_least(Pm);
  const int smem7 = k7_hits_bytes(P2) + k7_region_bytes(P2);
  const int smem8 = 8 * pow2_at_least(pm);
  cudaError_t err = cudaFuncSetAttribute(verify_pre_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem7);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes fa;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], verify_pre_kernel, THREADS, smem7);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, verify_pre_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[1] = fa.numRegs;
  out[2] = smem7;
  out[3] = static_cast<int>(fa.sharedSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], syncmer_kernel, THREADS, smem8);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, syncmer_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[5] = fa.numRegs;
  out[6] = smem8;
  out[7] = static_cast<int>(fa.sharedSizeBytes);
  return 0;
}
