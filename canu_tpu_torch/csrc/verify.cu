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
//      (2^30 with none); the inliers within tol = max(100, int(float32(
//      min(lenA, lenB)) * 0.3f));
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
//      as XLA's CPU backend compiles it), rounded half to even and
//      repeated to n_rows + 1 columns;
//   7. the four base rows: A from the seed (a_f), A reversed up to the
//      seed (a_b), the oriented B likewise (b_f, b_b, n_rows + band wide),
//      each a shift of t mod 2^ceil(log2 max(L, width)) with zeros past the
//      end (ops/align.py _shift_rows), and the lengths.
// Chunk g's forward rows are rows 2 g C + p of the outputs and its
// backward rows 2 g C + C + p: the layout the group's extension takes.
//
// What bounds K7 on an H100: the bytes.  A pair writes 2 n_rows + 2 (n_rows
// + band) bytes of bases and 8 (n_rows + 1) of centres (about 100 KB at
// n_rows 8,192) against three sorts of at most 2 Pm entries.  This design
// is the simple one: one block of 256 threads a pair, the pair's join in
// shared memory (the keys of the join, the hits, the sorted inliers: 29 Pm
// bytes, ~58 KB at Pm 2,048, whatever the reads' length), bitonic sorts in
// shared memory, block scans for the running max and the compaction, the
// 64 anchors of each direction in shared memory, each centre interpolated
// where it is stored, and coalesced stores of 4 bases a thread read from
// the index's words in global memory.
//
// K8 (canu_syncmer) replaces canu_tpu/ops/minimizers.py:90 _syncmer_kernel,
// a jax.jit XLA program with no pl.pallas_call, and computes exactly what
// canu_tpu_torch/ops/minimizers.py:_syncmer_kernel_plain computes: for each
// read b of a padded block and each position p < Pk = 16 W - k + 1,
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
// What bounds K8: the operations (the rolling k-mers and s-mer hashes of
// every position) against 8 bytes of read a 16 positions.  One block of 256
// threads a read: the s-mer hashes of a tile of 1,024 positions in shared
// memory (the read's words from global memory), the selected (key,
// position) pairs appended to the read's row of a device scratch buffer,
// then one bitonic sort there and the stores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC; bound through ctypes (plain C interface).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr uint32_t UMAX = 0xFFFFFFFFu;
constexpr int64_t INVALID_KMER = 0xFFFFFFFFll;
constexpr int MAX_ANCHORS = 64;
constexpr int BIG = 1 << 30;
constexpr int BIGF = 1 << 24;
constexpr int MAX_PM = 2048;  // K7's join keeps (hit << 12 | slot) in 24 bits
constexpr int SM_TILE = 1024;  // K8's positions a tile
constexpr int SM_HALO = 32;    // k - s + 1 <= 18 s-mers past a tile's last position
constexpr int INT_MIN32 = -2147483647 - 1;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ int pow2_at_least(int n) {
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

// Ascending bitonic sort of a[0, n), n a power of two, by the whole block;
// the caller synchronised after writing a, and a is sorted for every
// thread on return.
template <typename T>
__device__ void bitonic_sort(T* a, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool up = (lo & size) == 0;
        const T x = a[lo], y = a[hi];
        if ((x > y) == up) {
          a[lo] = y;
          a[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

// Block-wide exclusive scans of one value a thread, in thread order, over
// s_scan[THREADS] (Hillis-Steele); every thread calls them.
__device__ int block_excl_sum(int v, int* total, int* s_scan) {
  const int tid = threadIdx.x;
  s_scan[tid] = v;
  __syncthreads();
  for (int o = 1; o < THREADS; o <<= 1) {
    const int y = tid >= o ? s_scan[tid - o] : 0;
    __syncthreads();
    s_scan[tid] += y;
    __syncthreads();
  }
  const int incl = s_scan[tid];
  *total = s_scan[THREADS - 1];
  __syncthreads();
  return incl - v;
}

__device__ int block_excl_max(int v, int* s_scan) {
  const int tid = threadIdx.x;
  s_scan[tid] = v;
  __syncthreads();
  for (int o = 1; o < THREADS; o <<= 1) {
    const int y = tid >= o ? s_scan[tid - o] : INT_MIN32;
    __syncthreads();
    s_scan[tid] = s_scan[tid] > y ? s_scan[tid] : y;
    __syncthreads();
  }
  const int excl = tid ? s_scan[tid - 1] : INT_MIN32;
  __syncthreads();
  return excl;
}

// ---- K7 -----------------------------------------------------------------------

// base j of a read's words (int64 holding uint32 values, 16 bases a word)
__device__ __forceinline__ int raw_base(const int64_t* __restrict__ w, int j) {
  return (static_cast<uint32_t>(__ldg(w + (j >> 4))) >> (2 * (j & 15))) & 3;
}

// base j < L of the oriented B: the read, or its reverse complement shifted
// back to column 0 by (L - lenB) & mask, zero from lenB on
__device__ __forceinline__ int oriented_base(const int64_t* __restrict__ w, int j, int L, int lenB, bool fl,
                                             int64_t te) {
  if (j >= lenB) return 0;
  if (!fl) return raw_base(w, j);
  const int64_t i = j + te;
  return i < L ? 3 - raw_base(w, static_cast<int>(L - 1 - i)) : 0;
}

// float32 jnp.interp of x on (xp, fp)[64], xp non-decreasing, rounded half
// to even (ops/align.py _interp_centers): explicit roundings, so nvcc
// contracts nothing but the one fused multiply-add that is meant
__device__ int interp_center(float x, const float* xp, const float* fp) {
  int lo = 0, hi = MAX_ANCHORS;  // searchsorted(right=True): the count of xp <= x
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xp[mid] <= x)
      lo = mid + 1;
    else
      hi = mid;
  }
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

// 4 output bases from column i4 of a row `width` wide, stored as one word
// where the row allows it
template <typename F>
__device__ __forceinline__ void store4(uint8_t* row, int width, int i4, F base) {
  uint32_t v = 0;
  const int n = width - i4 < 4 ? width - i4 : 4;
  for (int e = 0; e < n; ++e) v |= static_cast<uint32_t>(base(i4 + e)) << (8 * e);
  if (n == 4 && (width & 3) == 0) {
    *reinterpret_cast<uint32_t*>(row + i4) = v;
  } else {
    for (int e = 0; e < n; ++e) row[i4 + e] = static_cast<uint8_t>(v >> (8 * e));
  }
}

__global__ void __launch_bounds__(THREADS)
verify_pre_kernel(const int64_t* __restrict__ words, int W, const int32_t* __restrict__ length,
                  const int64_t* __restrict__ mker, const int32_t* __restrict__ mpos,
                  const int32_t* __restrict__ mstr, int Pm, const int64_t* __restrict__ a_idx,
                  const int64_t* __restrict__ b_idx, const uint8_t* __restrict__ flipped_in,
                  int C, int k, int band, int n_rows, int orient, uint8_t* __restrict__ out_a,
                  int32_t* __restrict__ out_alen, uint8_t* __restrict__ out_b,
                  int32_t* __restrict__ out_blen, int32_t* __restrict__ out_cen,
                  int32_t* __restrict__ out_nanchor, uint8_t* __restrict__ out_flipped,
                  int32_t* __restrict__ out_seedA, int32_t* __restrict__ out_seedB,
                  int32_t* __restrict__ out_nminor) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_scan[THREADS];
  __shared__ int s_n, s_nh, s_n2, s_ni, s_same, s_opp, s_med, s_keep;
  __shared__ bool s_fl;
  __shared__ int s_aA[MAX_ANCHORS], s_aB[MAX_ANCHORS];
  __shared__ float s_xf[MAX_ANCHORS], s_ff[MAX_ANCHORS], s_xb[MAX_ANCHORS], s_fb[MAX_ANCHORS];

  const int tid = threadIdx.x;
  const int q = blockIdx.x, g = q / C, p = q - g * C;
  const int P2 = pow2_at_least(Pm);
  const int NJ = 2 * P2;
  // shared layout: the join's keys (reused by the median, the inlier sort
  // and the sorted inliers), the hits (at most one a key: a key's A
  // entries sort before its B entries, so at most Pm)
  uint64_t* s_join = reinterpret_cast<uint64_t*>(smem);
  int* h_posA = reinterpret_cast<int*>(s_join + NJ);
  int* h_posB = h_posA + Pm;
  int* h_j = h_posB + Pm;
  unsigned char* h_agree = reinterpret_cast<unsigned char*>(h_j + Pm);

  const int64_t ra = a_idx[q], rb = b_idx[q];
  const int lenA = length[ra], lenB = length[rb];
  const int L = 16 * W;
  const int64_t* wA = words + ra * W;
  const int64_t* wB = words + rb * W;
  if (tid == 0) s_n = s_nh = s_n2 = s_ni = s_same = s_opp = 0;
  __syncthreads();

  // 1. the join: (key, slot of the concatenation), the valid keys only
  const int64_t* mkA = mker + ra * Pm;
  const int64_t* mkB = mker + rb * Pm;
  for (int i = tid; i < 2 * Pm; i += THREADS) {
    const int64_t key = i < Pm ? mkA[i] : mkB[i - Pm];
    if (key != INVALID_KMER) {
      const int slot = atomicAdd(&s_n, 1);
      s_join[slot] = (static_cast<uint64_t>(static_cast<uint32_t>(key)) << 32) |
                     static_cast<uint32_t>(i);
    }
  }
  __syncthreads();
  const int nv = s_n;
  const int n_sort = pow2_at_least(nv > 1 ? nv : 1);
  for (int i = nv + tid; i < n_sort; i += THREADS) s_join[i] = ~0ull;
  __syncthreads();
  bitonic_sort(s_join, n_sort);

  // 2. hits at adjacent equal keys of the two reads, and the strand vote
  const int32_t *mpA = mpos + ra * Pm, *mpB = mpos + rb * Pm;
  const int32_t *msA = mstr + ra * Pm, *msB = mstr + rb * Pm;
  for (int j = tid; j + 1 < nv; j += THREADS) {
    const uint64_t x = s_join[j], y = s_join[j + 1];
    if ((x >> 32) != (y >> 32)) continue;
    const int ix = static_cast<int>(static_cast<uint32_t>(x));
    const int iy = static_cast<int>(static_cast<uint32_t>(y));
    const bool bx = ix >= Pm, by = iy >= Pm;
    if (bx == by) continue;
    const int ia = bx ? iy : ix, ib = bx ? ix - Pm : iy - Pm;
    const bool agree = (msA[ia] & 1) == (msB[ib] & 1);
    const int h = atomicAdd(&s_nh, 1);
    h_posA[h] = mpA[ia];
    h_posB[h] = mpB[ib];
    h_j[h] = j;
    h_agree[h] = agree;
    atomicAdd(agree ? &s_same : &s_opp, 1);
  }
  __syncthreads();
  const int nh = s_nh;
  if (tid == 0) s_fl = orient ? s_opp > s_same : flipped_in[q] != 0;
  __syncthreads();
  const bool fl = s_fl;

  // 3. the lower median of the diagonals of the hits of this orientation
  int* s_medv = reinterpret_cast<int*>(s_join);
  const int n_med = pow2_at_least(nh > 1 ? nh : 1);
  for (int h = tid; h < n_med; h += THREADS) {
    int v = BIG;
    if (h < nh && (h_agree[h] != 0) != fl) {
      v = h_posA[h] - (fl ? lenB - k - h_posB[h] : h_posB[h]);
      atomicAdd(&s_n2, 1);
    }
    s_medv[h] = v;
  }
  __syncthreads();
  bitonic_sort(s_medv, n_med);
  if (tid == 0) s_med = s_n2 > 0 ? s_medv[(s_n2 - 1) / 2] : BIG;
  __syncthreads();
  const int med = s_med;
  const int min_len = lenA < lenB ? lenA : lenB;
  const int tol_f = static_cast<int>(__fmul_rn(__int2float_rn(min_len), 0.3f));
  const int tol = tol_f > 100 ? tol_f : 100;

  // 4. the inliers, sorted by (posA, join position); posA as an ordered
  // unsigned key
  uint64_t* s_ins = s_join;
  for (int h = tid; h < nh; h += THREADS) {
    if ((h_agree[h] != 0) == fl) continue;
    const int pa = h_posA[h];
    const int diag = pa - (fl ? lenB - k - h_posB[h] : h_posB[h]);
    const int dev = diag - med;
    if ((dev < 0 ? -dev : dev) > tol || pa == BIG) continue;
    const int slot = atomicAdd(&s_ni, 1);
    s_ins[slot] = (static_cast<uint64_t>(static_cast<uint32_t>(pa) ^ 0x80000000u) << 32) |
                  (static_cast<uint32_t>(h_j[h]) << 12) | static_cast<uint32_t>(h);
  }
  __syncthreads();
  const int ni = s_ni;
  const int n_ins = pow2_at_least(ni > 1 ? ni : 1);
  for (int i = ni + tid; i < n_ins; i += THREADS) s_ins[i] = ~0ull;
  __syncthreads();
  bitonic_sort(s_ins, n_ins);
  int* s_pas = reinterpret_cast<int*>(s_join + P2);
  int* s_pbs = s_pas + Pm;
  for (int i = tid; i < ni; i += THREADS) {
    const int h = static_cast<int>(s_ins[i] & 0xFFFu);
    s_pas[i] = h_posA[h];
    s_pbs[i] = fl ? lenB - k - h_posB[h] : h_posB[h];
  }
  __syncthreads();

  // the running max: entry i is kept where its posB exceeds the max of the
  // entries before it (-1 before the first); kept entries compacted in
  // order into h_posA / h_posB
  const int per = (ni + THREADS - 1) / THREADS;
  const int lo = tid * per < ni ? tid * per : ni;
  const int hi = lo + per < ni ? lo + per : ni;
  int m_loc = INT_MIN32;
  for (int i = lo; i < hi; ++i) m_loc = s_pbs[i] > m_loc ? s_pbs[i] : m_loc;
  const int before = block_excl_max(m_loc, s_scan);
  int run = before, n_kept_loc = 0;
  for (int i = lo; i < hi; ++i) {
    const int pb = s_pbs[i];
    n_kept_loc += pb > (i == 0 ? -1 : run);
    run = pb > run ? pb : run;
  }
  int n_keep = 0;
  int rank = block_excl_sum(n_kept_loc, &n_keep, s_scan);
  run = before;
  for (int i = lo; i < hi; ++i) {
    const int pb = s_pbs[i];
    if (pb > (i == 0 ? -1 : run)) {
      h_posA[rank] = s_pas[i];
      h_posB[rank] = pb;
      ++rank;
    }
    run = pb > run ? pb : run;
  }
  if (tid == 0) s_keep = n_keep;
  __syncthreads();
  n_keep = s_keep;

  // 5. the picks, the seed, the anchor lists
  if (tid < MAX_ANCHORS) {
    const int m = tid;
    const int denom = n_keep - 1 > 1 ? n_keep - 1 : 1;
    int pick = n_keep <= MAX_ANCHORS ? m : (m * denom) / (MAX_ANCHORS - 1);
    const int last = n_keep - 1 > 0 ? n_keep - 1 : 0;
    pick = pick < last ? pick : last;
    const bool va = m < n_keep;
    s_aA[m] = va ? h_posA[pick] : -1;
    s_aB[m] = va ? h_posB[pick] : -1;
  }
  __syncthreads();
  const int n_anchor = n_keep < MAX_ANCHORS ? n_keep : MAX_ANCHORS;
  const int seed_m = (n_anchor - 1 > 0 ? n_anchor - 1 : 0) / 2;
  const int seedA = s_aA[seed_m] > 0 ? s_aA[seed_m] : 0;
  const int seedB = s_aB[seed_m] > 0 ? s_aB[seed_m] : 0;
  if (tid < MAX_ANCHORS) {
    const int m = tid;
    const int i_f = seed_m + m < MAX_ANCHORS - 1 ? seed_m + m : MAX_ANCHORS - 1;
    int fa = s_aA[i_f] - seedA, fb = s_aB[i_f] - seedB;
    const bool vf = seed_m + m < n_anchor && fa >= 0;
    fa = vf ? fa : BIGF + m;
    fb = vf ? fb : BIGF + m;
    s_xf[m] = __int2float_rn(fa);
    s_ff[m] = __int2float_rn(fb);
    const int i_b = seed_m - m > 0 ? seed_m - m : 0;
    const int aAb = s_aA[i_b];
    int ba = seedA - aAb, bb = seedB - s_aB[i_b];
    const bool vb = m <= seed_m && aAb >= 0;
    ba = vb ? ba : BIGF + m;
    bb = vb ? bb : BIGF + m;
    s_xb[m] = __int2float_rn(ba);
    s_fb[m] = __int2float_rn(bb);
  }
  __syncthreads();

  // 6. the centres on the stride-16 grid, repeated to n_rows + 1 columns,
  // then the rows
  if (tid == 0) {
    out_nanchor[q] = n_anchor;
    out_flipped[q] = fl;
    out_seedA[q] = seedA;
    out_seedB[q] = seedB;
    out_nminor[q] = s_same < s_opp ? s_same : s_opp;
    const int64_t rf = 2 * static_cast<int64_t>(g) * C + p, rbk = rf + C;
    out_alen[rf] = lenA - seedA;
    out_alen[rbk] = seedA;
    out_blen[rf] = lenB - seedB;
    out_blen[rbk] = seedB;
  }
  __syncthreads();
  const int64_t row_f = 2 * static_cast<int64_t>(g) * C + p, row_b = row_f + C;
  const int wc = n_rows + 1;
  int32_t* cf = out_cen + row_f * wc;
  int32_t* cb = out_cen + row_b * wc;
  for (int r = tid; r < wc; r += THREADS) {
    const float x = __int2float_rn(r & ~15);
    cf[r] = interp_center(x, s_xf, s_ff);
    cb[r] = interp_center(x, s_xb, s_fb);
  }

  // 7. the base rows
  const int wb = n_rows + band;
  const int64_t te_af = seedA & shift_mask(L, n_rows);
  const int64_t te_ab = (L - seedA) & shift_mask(L, n_rows);
  const int64_t te_bf = seedB & shift_mask(L, wb);
  const int64_t te_bb = (L - seedB) & shift_mask(L, wb);
  const int64_t te_o = (fl ? L - lenB : 0) & shift_mask(L, L);
  uint8_t* af = out_a + row_f * n_rows;
  uint8_t* ab = out_a + row_b * n_rows;
  uint8_t* bf = out_b + row_f * wb;
  uint8_t* bbk = out_b + row_b * wb;
  for (int i4 = 4 * tid; i4 < n_rows; i4 += 4 * THREADS) {
    store4(af, n_rows, i4, [&](int i) {
      const int64_t s = i + te_af;
      return s < L ? raw_base(wA, static_cast<int>(s)) : 0;
    });
    store4(ab, n_rows, i4, [&](int i) {
      const int64_t s = i + te_ab;
      return s < L ? raw_base(wA, static_cast<int>(L - 1 - s)) : 0;
    });
  }
  for (int i4 = 4 * tid; i4 < wb; i4 += 4 * THREADS) {
    store4(bf, wb, i4, [&](int i) {
      const int64_t s = i + te_bf;
      return s < L ? oriented_base(wB, static_cast<int>(s), L, lenB, fl, te_o) : 0;
    });
    store4(bbk, wb, i4, [&](int i) {
      const int64_t s = i + te_bb;
      return s < L ? oriented_base(wB, static_cast<int>(L - 1 - s), L, lenB, fl, te_o) : 0;
    });
  }
}

// the join (2 P2 keys), the hits' posA, posB, join position and strand
size_t verify_pre_smem(int Pm) {
  int P2 = 1;
  while (P2 < Pm) P2 <<= 1;
  return 16 * static_cast<size_t>(P2) + 13 * static_cast<size_t>(Pm);
}

// ---- K8 -----------------------------------------------------------------------

// forward and reverse-complement k-mers (k <= 32) at position p of a read
// of W words, p + k <= 16 W
__device__ __forceinline__ uint64_t word_at(const int64_t* __restrict__ w, int i) {
  return static_cast<uint32_t>(__ldg(w + i));
}

__device__ __forceinline__ void kmer_at(const int64_t* __restrict__ w, int W, int p, int k,
                                        uint64_t& fw, uint64_t& rc) {
  const int w0 = p >> 4, off = p & 15;
  uint64_t lo = word_at(w, w0);
  if (w0 + 1 < W) lo |= word_at(w, w0 + 1) << 32;
  const uint64_t hi = w0 + 2 < W ? word_at(w, w0 + 2) : 0u;
  const uint64_t v = off ? (lo >> (2 * off)) | (hi << (64 - 2 * off)) : lo;
  fw = 0;
  rc = 0;
  const int top = 2 * k - 2;
  for (int j = 0; j < k; ++j) {
    const uint64_t b = (v >> (2 * j)) & 3u;
    fw = (fw << 2) | b;
    rc = (rc >> 2) | ((3u - b) << top);
  }
}

// the canonical key of a k-mer (ops/kmer.py extract_kmers_any) and its strand
__device__ __forceinline__ uint32_t canonical_key(const int64_t* __restrict__ w, int W, int p, int k,
                                                  bool* strand) {
  uint64_t fw, rc;
  kmer_at(w, W, p, k, fw, rc);
  *strand = rc < fw;
  const uint64_t c = rc < fw ? rc : fw;
  if (k <= 16) return static_cast<uint32_t>(c);
  const uint32_t key = mix32(static_cast<uint32_t>(c >> 32) ^ mix32(static_cast<uint32_t>(c)));
  return key == UMAX ? key ^ 1u : key;
}

// hs(i) for the s-mers [i0, i0 + n) into s_hs (UINT32_MAX off the read or
// past Ps), then each position of [p0, p0 + SM_TILE) gets its key
__device__ __forceinline__ void smer_tile(const int64_t* __restrict__ w, int W, int len, int s, int Ps,
                                          int i0, int n, uint32_t* s_hs) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int si = i0 + i;
    uint32_t hv = UMAX;
    if (si < Ps && si <= len - s) {
      bool st;
      hv = mix32(canonical_key(w, W, si, s, &st));
    }
    s_hs[i] = hv;
  }
}

__device__ __forceinline__ uint32_t syncmer_key(const int64_t* __restrict__ w, int W, int len, int k, int t,
                                                int nw, int p, int p0, const uint32_t* s_hs,
                                                bool* selected) {
  uint32_t wm = UMAX;
  for (int j = 0; j < nw; ++j) {
    const uint32_t h = s_hs[p - p0 + j];
    wm = h < wm ? h : wm;
  }
  *selected = p <= len - k && s_hs[p - p0 + t] == wm;
  if (!*selected) return UMAX;
  bool st;
  return mix32(canonical_key(w, W, p, k, &st));
}

__device__ __forceinline__ void write_slot(const int64_t* __restrict__ w, int W, int len, int k, int pm,
                                           int b, int c, int pos, int64_t* out_mk,
                                           int32_t* out_pos, int32_t* out_str) {
  bool st;
  const uint32_t key = canonical_key(w, W, pos, k, &st);
  const size_t o = static_cast<size_t>(b) * pm + c;
  out_mk[o] = pos <= len - k ? static_cast<int64_t>(key) : INVALID_KMER;
  out_pos[o] = pos;
  out_str[o] = st;
}

__global__ void __launch_bounds__(THREADS)
syncmer_kernel(const int64_t* __restrict__ words, int W, const int32_t* __restrict__ lengths,
               int k, int s, int t, int pm, uint64_t* __restrict__ scratch, int cap,
               int64_t* __restrict__ out_mk, int32_t* __restrict__ out_pos,
               int32_t* __restrict__ out_str, int32_t* __restrict__ out_nsel) {
  __shared__ int s_scan[THREADS];
  __shared__ int s_nsel, s_nlt;
  __shared__ uint32_t s_hs[SM_TILE + SM_HALO];  // the tile's s-mer hashes
  const int b = blockIdx.x, tid = threadIdx.x;
  uint64_t* buf = scratch + static_cast<size_t>(b) * cap;
  const int64_t* w = words + static_cast<int64_t>(b) * W;
  const int len = lengths[b];
  const int Pk = 16 * W - k + 1, Ps = 16 * W - s + 1, nw = k - s + 1;
  if (tid == 0) s_nsel = s_nlt = 0;
  __syncthreads();

  // the selected positions; those of key < UINT32_MAX into buf
  for (int p0 = 0; p0 < Pk; p0 += SM_TILE) {
    smer_tile(w, W, len, s, Ps, p0, SM_TILE + nw - 1, s_hs);
    __syncthreads();
    for (int p = p0 + tid; p < p0 + SM_TILE && p < Pk; p += THREADS) {
      bool sel;
      const uint32_t key = syncmer_key(w, W, len, k, t, nw, p, p0, s_hs, &sel);
      if (sel) atomicAdd(&s_nsel, 1);
      if (key != UMAX) {
        const int slot = atomicAdd(&s_nlt, 1);
        buf[slot] = (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(p);
      }
    }
    __syncthreads();
  }
  const int n_sel = s_nsel, n_lt = s_nlt;
  const int n_out = n_sel < pm ? n_sel : pm;
  const int n_sort = pow2_at_least(n_lt > 1 ? n_lt : 1);
  for (int i = n_lt + tid; i < n_sort; i += THREADS) buf[i] = ~0ull;
  __syncthreads();
  bitonic_sort(buf, n_sort);
  const int n_head = n_lt < n_out ? n_lt : n_out;
  for (int c = tid; c < pm; c += THREADS) {
    const size_t o = static_cast<size_t>(b) * pm + c;
    if (c < n_head) {
      write_slot(w, W, len, k, pm, b, c, static_cast<int>(static_cast<uint32_t>(buf[c])),
                 out_mk, out_pos, out_str);
    } else if (c >= n_out) {
      out_mk[o] = INVALID_KMER;
      out_pos[o] = -1;
      out_str[o] = 0;
    }
  }
  if (tid == 0) out_nsel[b] = n_out;

  // slots [n_lt, n_out): the positions of key UINT32_MAX in position order
  // (only where a selected k-mer's mix32 is UINT32_MAX)
  const int need = n_out - n_head;
  int taken = 0;
  for (int p0 = 0; p0 < Pk && taken < need; p0 += SM_TILE) {
    __syncthreads();
    smer_tile(w, W, len, s, Ps, p0, SM_TILE + nw - 1, s_hs);
    __syncthreads();
    for (int q0 = p0; q0 < p0 + SM_TILE && q0 < Pk && taken < need; q0 += THREADS) {
      const int p = q0 + tid;
      bool sel;
      const int flag = p < Pk && p < p0 + SM_TILE &&
                       syncmer_key(w, W, len, k, t, nw, p, p0, s_hs, &sel) == UMAX;
      int total = 0;
      const int r = taken + block_excl_sum(flag, &total, s_scan);
      if (flag && r < need)
        write_slot(w, W, len, k, pm, b, n_head + r, p, out_mk, out_pos, out_str);
      taken += total;
    }
  }
}

}  // namespace

// words int64[Npad, W] (uint32 values), length int32[Npad], mker int64[Npad,
// Pm] (uint32 values), mpos and mstr int32[Npad, Pm]: the ReadIndex; a_idx,
// b_idx int64[n_pairs] (rows of it), flipped uint8[n_pairs]; C pairs a
// chunk (n_pairs a multiple of C), k, band, n_rows, orient.  Outputs: a
// uint8[2 n_pairs, n_rows], a_len int32[2 n_pairs], b uint8[2 n_pairs,
// n_rows + band], b_len int32[2 n_pairs], centers int32[2 n_pairs, n_rows +
// 1], n_anchor, seedA, seedB, n_minor int32[n_pairs], flipped_out
// uint8[n_pairs].  Returns cudaGetLastError() of the launch (or of the
// shared-memory attribute), -1 for Pm outside 1..2048, -3 for a negative or
// empty size, -4 for n_pairs not a multiple of C.
extern "C" int canu_verify_pre(const void* words, int W, const void* length, const void* mker,
                               const void* mpos, const void* mstr, int Pm, const void* a_idx,
                               const void* b_idx, const void* flipped, int n_pairs, int C, int k,
                               int band, int n_rows, int orient, void* a, void* a_len, void* b,
                               void* b_len, void* centers, void* n_anchor, void* flipped_out,
                               void* seedA, void* seedB, void* n_minor, void* stream) {
  if (Pm < 1 || Pm > MAX_PM) return -1;
  if (W < 1 || n_pairs < 0 || C < 1 || band < 0 || n_rows < 1) return -3;
  if (n_pairs % C) return -4;
  if (n_pairs == 0) return 0;
  const size_t smem = verify_pre_smem(Pm);
  cudaError_t err = cudaFuncSetAttribute(verify_pre_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  verify_pre_kernel<<<n_pairs, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), W, static_cast<const int32_t*>(length),
      static_cast<const int64_t*>(mker), static_cast<const int32_t*>(mpos),
      static_cast<const int32_t*>(mstr), Pm, static_cast<const int64_t*>(a_idx),
      static_cast<const int64_t*>(b_idx), static_cast<const uint8_t*>(flipped), C, k, band,
      n_rows, orient, static_cast<uint8_t*>(a), static_cast<int32_t*>(a_len),
      static_cast<uint8_t*>(b), static_cast<int32_t*>(b_len), static_cast<int32_t*>(centers),
      static_cast<int32_t*>(n_anchor), static_cast<uint8_t*>(flipped_out),
      static_cast<int32_t*>(seedA), static_cast<int32_t*>(seedB),
      static_cast<int32_t*>(n_minor));
  return static_cast<int>(cudaGetLastError());
}

// words int64[B, W] (uint32 values), lengths int32[B], k in 2..32 with its
// syncmer (s, t), pm >= 1; scratch uint64[B, cap], cap at least the power
// of two at least 16 W - k + 1 (a read's selected positions and their
// sort).  Outputs mker int64[B, pm], mpos, mstr int32[B, pm], n_sel
// int32[B].  Returns cudaGetLastError() of the launch, -1 for k, s or t out
// of range, -3 for a bad size or a missing scratch buffer.
extern "C" int canu_syncmer(const void* words, int B, int W, const void* lengths, int k, int s,
                            int t, int pm, void* scratch, int cap, void* mker, void* mpos,
                            void* mstr, void* n_sel, void* stream) {
  if (k < 2 || k > 32 || s < 2 || s > 16 || s > k || k - s + 1 > SM_HALO || t < 0 || t > k - s)
    return -1;
  if (B < 0 || W < 1 || pm < 1 || 16 * W < k - 1) return -3;
  if (B == 0) return 0;
  const int Pk = 16 * W - k + 1;
  int need = 1;
  while (need < Pk) need <<= 1;
  if (scratch == nullptr || cap < need) return -3;
  syncmer_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(words), W, static_cast<const int32_t*>(lengths), k, s, t, pm,
      static_cast<uint64_t*>(scratch), cap, static_cast<int64_t*>(mker),
      static_cast<int32_t*>(mpos), static_cast<int32_t*>(mstr), static_cast<int32_t*>(n_sel));
  return static_cast<int>(cudaGetLastError());
}
