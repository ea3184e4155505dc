"""Device k-mer extraction and counting (counterpart of canu_tpu.ops.kmer).

k <= 16 packs a canonical k-mer into one 32-bit lane; 16 < k <= 32 packs
it into two (hi, lo), counted exactly, while the matching path (sketches,
syncmer seeds) uses a 32-bit fold of the two lanes as its key.  Packed
read blocks unpack with shifts and masks, canonical k-mers come from
branch-free bit twiddling, and counting is one device sort over the whole
read set plus a run-length reduction.  Only the count histogram and the
frequent-mer table leave the device.  Above the device's instance budget
(MAX_INSTANCES, MAX_INSTANCES2) the numpy host counter counts instead.

uint32 lanes are held in int64 tensors, so INVALID_KMER (0xFFFFFFFF)
sorts after every valid k-mer as it does in the unsigned original.  Two
lanes are never combined into one int64 key: (hi << 32) | lo is negative
for hi >= 2**31, which would sort INVALID (and, at k=32, every k-mer
starting with G or T) first.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..stores.readset import ReadSet
from ..utils import bitpack
from ..utils.bitpack import n_words
from .hashing import MASK32, mix32, u32_numpy, u32_tensor

# Sorts after every valid canonical k-mer: a canonical min(fw, rc) can
# never be 0xFFFFFFFF, since its own revcomp 0x0 would be smaller.
INVALID_KMER = 0xFFFFFFFF


def unpack_bases(words: torch.Tensor) -> torch.Tensor:
    """[..., W] packed words (uint32 values) -> uint8[..., W*16] base codes."""
    shifts = 2 * torch.arange(16, dtype=torch.int64, device=words.device)
    expanded = (words.to(torch.int64)[..., :, None] >> shifts) & 3
    return expanded.reshape(*words.shape[:-1], words.shape[-1] * 16).to(torch.uint8)


def reverse_2bit_groups(x: torch.Tensor) -> torch.Tensor:
    """Reverse the sixteen 2-bit groups of each uint32 value."""
    x = ((x >> 16) | (x << 16)) & MASK32
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    return x


def revcomp_kmer(kmers: torch.Tensor, k: int) -> torch.Tensor:
    """Reverse complement of packed k-mers (first base most significant)."""
    mask = MASK32 if k == 16 else (1 << (2 * k)) - 1
    comp = (~kmers) & mask
    return reverse_2bit_groups((comp << (32 - 2 * k)) & MASK32)


def extract_kmers(words: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical k-mers of a padded read block.

    words [B, W] packed reads (uint32 values, zero-padded); lengths [B].
    Returns canon int64[B, P] (INVALID_KMER where the window falls off the
    read) and strand bool[B, P] (True where the reverse complement was
    canonical), P = W*16 - k + 1.
    """
    if not 2 <= k <= 16:
        raise ValueError(f"extract_kmers needs 2 <= k <= 16, got {k}")
    bases = unpack_bases(words)
    B, L = bases.shape
    P = L - k + 1
    fw = torch.zeros((B, P), dtype=torch.int64, device=words.device)
    for j in range(k):
        fw = (fw << 2) | bases[:, j : j + P].to(torch.int64)
    fw = fw & MASK32
    rc = revcomp_kmer(fw, k)
    canon = torch.minimum(fw, rc)
    strand = rc < fw
    pos = torch.arange(P, dtype=torch.int64, device=words.device)[None, :]
    valid = pos <= (lengths.to(torch.int64)[:, None] - k)
    canon = torch.where(valid, canon, INVALID_KMER)
    return canon, strand


def extract_kmers2(words: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical k-mers for 16 < k <= 32 as two uint32 lanes.

    Returns (hi, lo) int64[B, P] holding uint32 values, strand bool[B, P]
    and valid bool[B, P]; the exact 2k-bit canonical k-mer is
    (hi << 32) | lo.  Off-read windows are NOT replaced by INVALID_KMER
    (``valid`` marks them), as in canu_tpu.
    """
    if not 16 < k <= 32:
        raise ValueError(f"extract_kmers2 needs 16 < k <= 32, got {k}")
    bases = unpack_bases(words)
    B, L = bases.shape
    P = L - k + 1
    hi = torch.zeros((B, P), dtype=torch.int64, device=words.device)
    lo = torch.zeros((B, P), dtype=torch.int64, device=words.device)
    for j in range(k):
        hi = ((hi << 2) | (lo >> 30)) & MASK32
        lo = ((lo << 2) | bases[:, j : j + P].to(torch.int64)) & MASK32
    hmask = (1 << (2 * k - 32)) - 1
    hi = hi & hmask
    # reverse complement: complement, reverse all 64 bits (each lane's
    # 2-bit groups reversed and the lanes swapped), right-align to 2k bits
    rh = reverse_2bit_groups(~lo & MASK32)
    rl = reverse_2bit_groups(~hi & MASK32)
    s = 64 - 2 * k
    if s:
        rc_lo = ((rl >> s) | (rh << (32 - s))) & MASK32
        rc_hi = rh >> s
    else:
        rc_lo, rc_hi = rl, rh
    rc_hi = rc_hi & hmask
    fw_first = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
    c_hi = torch.where(fw_first, hi, rc_hi)
    c_lo = torch.where(fw_first, lo, rc_lo)
    pos = torch.arange(P, dtype=torch.int64, device=words.device)[None, :]
    valid = pos <= (lengths.to(torch.int64)[:, None] - k)
    return c_hi, c_lo, ~fw_first, valid


def fold2(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """32-bit key of a two-lane k-mer (canu_tpu's mix32 fold)."""
    return mix32(hi ^ mix32(lo))


def _fold2_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """fold2, moved off INVALID_KMER so a key never equals the sentinel."""
    key = fold2(hi, lo)
    return torch.where(key == INVALID_KMER, key ^ 1, key)


def extract_kmers_any(words: torch.Tensor, lengths: torch.Tensor, k: int):
    """Canonical k-mer keys + strand for any k in 2..32.

    k <= 16: the exact packed k-mers (extract_kmers).  k > 16: the 32-bit
    fold of the exact two-lane k-mer, which is all the matching path
    needs (sketch slots, syncmer seeds and anchor joins are hash-based).
    INVALID_KMER marks off-read windows in both cases.
    """
    if k <= 16:
        return extract_kmers(words, lengths, k)
    hi, lo, strand, valid = extract_kmers2(words, lengths, k)
    return torch.where(valid, _fold2_key(hi, lo), INVALID_KMER), strand


def sort_count(kmers_flat: torch.Tensor):
    """Sort a flat k-mer array and run-length count it.

    Returns (sorted, counts): counts[i] is the run length at run START
    positions and 0 elsewhere; INVALID_KMER entries sort to the end and
    get count 0.
    """
    s, _ = torch.sort(kmers_flat)
    n = s.shape[0]
    is_start = torch.ones(n, dtype=torch.bool, device=s.device)
    is_start[1:] = s[1:] != s[:-1]
    run_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    per_run = torch.bincount(run_id, minlength=n)
    counts = torch.where(is_start & (s != INVALID_KMER), per_run[run_id], 0)
    return s, counts


def sort_count2(hi_flat: torch.Tensor, lo_flat: torch.Tensor):
    """Two-lane sort + run-length count: (hi_sorted, lo_sorted, counts).

    Lexicographic (hi, lo) order from two stable sorts, by lo and then by
    hi; INVALID_KMER in both lanes marks padding and sorts last.
    """
    order = torch.argsort(lo_flat, stable=True)
    hi1, lo1 = hi_flat[order], lo_flat[order]
    order = torch.argsort(hi1, stable=True)
    hs, ls = hi1[order], lo1[order]
    n = hs.shape[0]
    is_start = torch.ones(n, dtype=torch.bool, device=hs.device)
    is_start[1:] = (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1])
    run_id = torch.cumsum(is_start.to(torch.int64), 0) - 1
    per_run = torch.bincount(run_id, minlength=n)
    live = (hs != INVALID_KMER) | (ls != INVALID_KMER)
    counts = torch.where(is_start & live, per_run[run_id], 0)
    return hs, ls, counts


def histogram_device(counts: torch.Tensor, max_count: int = 65535) -> torch.Tensor:
    """hist[c] = number of runs with length exactly c (c clipped to
    max_count); hist[0] counts non-start positions and is meaningless."""
    return torch.bincount(torch.clamp(counts, max=max_count), minlength=max_count + 1)


def select_frequent_device(sorted_kmers: torch.Tensor, counts: torch.Tensor,
                           threshold: int, max_out: int):
    """(kmer, count) pairs with count > threshold in a fixed-size table.

    Returns (kmers[max_out], counts[max_out], n_found); unused slots hold
    INVALID_KMER / 0.  n_found > max_out means the table was truncated.
    """
    mask = counts > threshold
    idx = torch.nonzero(mask)[:, 0]
    n_found = int(idx.shape[0])
    km = torch.full((max_out,), INVALID_KMER, dtype=torch.int64, device=counts.device)
    ct = torch.zeros(max_out, dtype=counts.dtype, device=counts.device)
    take = min(n_found, max_out)
    km[:take] = sorted_kmers[idx[:take]]
    ct[:take] = counts[idx[:take]]
    return km, ct, n_found


# ---- block planning (numpy) -------------------------------------------------


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def length_bucketed_blocks(readset: ReadSet, block_size: int) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (ids, pad_words) blocks with reads sorted by descending
    length and pad_words rounded to a power of two (padding waste < 2x)."""
    order = np.argsort(-readset.length, kind="stable")
    ids = (order + 1).astype(np.int32)
    for i in range(0, len(ids), block_size):
        chunk = ids[i : i + block_size]
        wmax = n_words(int(readset.length[chunk - 1].max()))
        yield chunk, _pow2_at_least(max(1, wmax))


def bucket_widths(readset: ReadSet, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(ids int32[N], pad_words int32[N]): the reads in the order
    length_bucketed_blocks yields them, each with its block's pad_words."""
    ids, wbs = [], []
    for chunk, W in length_bucketed_blocks(readset, block_size):
        ids.append(chunk)
        wbs.append(np.full(len(chunk), W, np.int32))
    if not ids:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    return np.concatenate(ids).astype(np.int32), np.concatenate(wbs)


def block_tensors(readset: ReadSet, ids: np.ndarray, W: int, device: torch.device):
    """(words int64[B, W], lengths int32[B]) of reads ``ids`` on ``device``."""
    words, lengths = readset.block_words(ids, W)
    return u32_tensor(words, device), torch.from_numpy(lengths.astype(np.int32)).to(device)


# ---- whole-readset counting -------------------------------------------------


class DeviceKmerCounts:
    """Sorted k-mers + run-length counts living on the device."""

    def __init__(self, k: int, sorted_kmers: torch.Tensor, counts: torch.Tensor):
        self.k = k
        self.sorted_kmers = sorted_kmers
        self.counts = counts

    def histogram(self, max_count: int = 65535) -> np.ndarray:
        return histogram_device(self.counts, max_count).cpu().numpy()

    def n_distinct(self) -> int:
        return int((self.counts > 0).sum())

    def n_total(self) -> int:
        return int(self.counts.sum())

    def frequent(self, threshold: int, max_out: int = 1 << 20) -> "FrequentKmers":
        km, ct, n_found = select_frequent_device(
            self.sorted_kmers, self.counts, int(threshold), max_out)
        if n_found > max_out:
            warnings.warn(f"frequent-kmer table truncated: {n_found} > max_out={max_out}")
            n_found = max_out
        km = u32_numpy(km[:n_found])
        ct = ct[:n_found].cpu().numpy()
        total = self.n_total()
        return FrequentKmers(
            k=self.k,
            kmers=km,
            fraction=(ct / max(1, total)).astype(np.float32),
            threshold=int(threshold),
            total_kmers=total,
        )

    def to_host(self) -> "KmerCounts":
        counts = self.counts.cpu().numpy()
        kmers = u32_numpy(self.sorted_kmers)
        keep = counts > 0
        return KmerCounts(self.k, kmers[keep], counts[keep].astype(np.int64))


def _exact64(hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def _folded_table(k: int, hi: torch.Tensor, lo: torch.Tensor, ct: np.ndarray,
                  threshold: int, total: int) -> "FrequentKmers":
    """FrequentKmers of two-lane k-mers: folded keys in a stable order of
    the keys (numpy's, as canu_tpu's), the exact k-mers beside them."""
    folded = u32_numpy(_fold2_key(hi, lo))
    exact = _exact64(u32_numpy(hi), u32_numpy(lo))
    order = np.argsort(folded, kind="stable")
    return FrequentKmers(
        k=k, kmers=folded[order],
        fraction=(ct[order] / max(1, total)).astype(np.float32),
        threshold=int(threshold), total_kmers=total, kmers_exact=exact[order],
    )


class DeviceKmerCounts2:
    """Exact two-lane (k > 16) k-mer counts living on the device; the API
    of DeviceKmerCounts.  Only the frequent table folds the keys."""

    def __init__(self, k: int, hi: torch.Tensor, lo: torch.Tensor, counts: torch.Tensor):
        self.k = k
        self.hi = hi
        self.lo = lo
        self.counts = counts

    def histogram(self, max_count: int = 65535) -> np.ndarray:
        return histogram_device(self.counts, max_count).cpu().numpy()

    def n_distinct(self) -> int:
        return int((self.counts > 0).sum())

    def n_total(self) -> int:
        return int(self.counts.sum())

    def frequent(self, threshold: int, max_out: int = 1 << 20) -> "FrequentKmers":
        mask = self.counts > threshold
        return _folded_table(self.k, self.hi[mask], self.lo[mask],
                             self.counts[mask].cpu().numpy(), threshold, self.n_total())

    def to_host(self) -> "KmerCounts":
        keep = self.counts > 0
        return KmerCounts(self.k, _exact64(u32_numpy(self.hi[keep]), u32_numpy(self.lo[keep])),
                          self.counts[keep].cpu().numpy().astype(np.int64))


# instance budgets of the device sort, one lane / two lanes (canu_tpu's);
# above them the host counter takes over
MAX_INSTANCES = 1 << 27
MAX_INSTANCES2 = 1 << 26

# calls of count_readset_host (chip_smoke.py checks a drive's path by it)
HOST_COUNTS = 0


def count_readset_host(readset: ReadSet, k: int) -> "KmerCounts":
    """Host canonical k-mer counter (numpy) for read sets whose instance
    table exceeds the device budget; a host function by design, as in
    canu_tpu: it keeps the instance table off the device.

    One pass computes forward and reverse-complement k-mers with k shifted
    adds (uint32 for k <= 16, uint64 otherwise: exact k-mers, not folded)
    and np.unique sorts and counts them once (the reference's meryl is a
    host counter too).
    """
    global HOST_COUNTS
    HOST_COUNTS += 1
    assert 1 < k <= 32
    dt = np.uint32 if k <= 16 else np.uint64
    empty = KmerCounts(k, np.zeros(0, dt), np.zeros(0, np.int64))
    words = np.asarray(readset.words)
    n = len(words) * bitpack.BASES_PER_WORD
    if n == 0 or readset.n_reads == 0:
        return empty
    allb = bitpack.unpack_words(words, n)
    base0 = (readset.word_off[:-1] * bitpack.BASES_PER_WORD).astype(np.int64)
    L = readset.length.astype(np.int64)
    # valid k-mer start positions: within a read, start + k <= read end
    delta = np.zeros(n + 1, np.int32)
    np.add.at(delta, base0, 1)
    np.add.at(delta, base0 + np.maximum(L - k + 1, 0), -1)
    vm = np.cumsum(delta[:-1]) > 0
    m = n - k + 1
    if m <= 0:
        return empty
    fwd = np.zeros(m, dt)
    rc = np.zeros(m, dt)
    for j in range(k):
        bj = allb[j : j + m].astype(dt)
        fwd = (fwd << dt(2)) | bj
        rc |= (dt(3) - bj) << dt(2 * j)
    canon = np.minimum(fwd, rc)[vm[:m]]
    del fwd, rc
    u, c = np.unique(canon, return_counts=True)
    return KmerCounts(k, u, c.astype(np.int64))


def count_readset_device(readset: ReadSet, k: int = 16, block_size: int = 512,
                         max_instances: Optional[int] = None, device=None):
    """Count canonical k-mers of a whole ReadSet with one device sort.

    k <= 16 counts one lane (DeviceKmerCounts), 16 < k <= 32 the exact
    two-lane k-mers (DeviceKmerCounts2).  Per-block k-mer arrays stay on
    the device and are concatenated; nothing large crosses back to the
    host.  Above ``max_instances`` k-mer instances (MAX_INSTANCES /
    MAX_INSTANCES2 by default) the host counter takes over and a host
    KmerCounts comes back: every consumer (histogram, thresholds,
    frequent_kmers) takes either.
    """
    dev = resolve_device(device)
    two = k > 16
    if max_instances is None:
        max_instances = MAX_INSTANCES2 if two else MAX_INSTANCES
    est = int(readset.length.astype(np.int64).sum())
    if est > max_instances:
        return count_readset_host(readset, k)
    parts = []
    for ids, W in length_bucketed_blocks(readset, block_size):
        words, lengths = block_tensors(readset, ids, W, dev)
        if two:
            hi, lo, _, valid = extract_kmers2(words, lengths, k)
            parts.append((torch.where(valid, hi, INVALID_KMER).reshape(-1),
                          torch.where(valid, lo, INVALID_KMER).reshape(-1)))
        else:
            canon, _ = extract_kmers(words, lengths, k)
            parts.append(canon.reshape(-1))
    if two:
        if not parts:
            e = torch.full((1,), INVALID_KMER, dtype=torch.int64, device=dev)
            parts = [(e, e)]
        hs, ls, c = sort_count2(torch.cat([p[0] for p in parts]),
                                torch.cat([p[1] for p in parts]))
        return DeviceKmerCounts2(k, hs, ls, c)
    if not parts:
        parts = [torch.full((1,), INVALID_KMER, dtype=torch.int64, device=dev)]
    s, c = sort_count(torch.cat(parts))
    return DeviceKmerCounts(k, s, c)


# ---- host tables (numpy; byte-compatible with canu_tpu's) -------------------


@dataclass
class KmerCounts:
    """Host-side k-mer counts (sorted unique k-mers + counts)."""

    k: int
    unique: np.ndarray  # sorted; uint32, or uint64 exact k-mers for k > 16
    counts: np.ndarray  # int64

    @property
    def n_distinct(self) -> int:
        return len(self.unique)

    @property
    def n_total(self) -> int:
        return int(self.counts.sum())

    def histogram(self, max_count: Optional[int] = None) -> np.ndarray:
        """hist[c] = number of distinct k-mers occurring exactly c times."""
        return np.bincount(np.minimum(self.counts, max_count) if max_count else self.counts)

    def merge(self, other: "KmerCounts") -> "KmerCounts":
        assert self.k == other.k
        u = np.concatenate([self.unique, other.unique])
        c = np.concatenate([self.counts, other.counts])
        order = np.argsort(u, kind="stable")
        u, c = u[order], c[order]
        if len(u) == 0:
            return KmerCounts(self.k, u, c)
        starts = np.concatenate([[True], u[1:] != u[:-1]])
        out_c = np.zeros(int(starts.sum()), dtype=np.int64)
        np.add.at(out_c, np.cumsum(starts) - 1, c)
        return KmerCounts(self.k, u[starts], out_c)

    # ---- database algebra (the reference meryl's binary and unary ops,
    # meryl-binaryOp.C, meryl-unaryOp.C: add/sub/min/max/and/or + count
    # filters) ------------------------------------------------------------

    def _aligned(self, other: "KmerCounts"):
        """Counts of both DBs over the union key set (0 where absent)."""
        assert self.k == other.k
        u = np.union1d(self.unique, other.unique)
        ca = np.zeros(len(u), np.int64)
        cb = np.zeros(len(u), np.int64)
        ca[np.searchsorted(u, self.unique)] = self.counts
        cb[np.searchsorted(u, other.unique)] = other.counts
        return u, ca, cb

    def _from_aligned(self, u: np.ndarray, c: np.ndarray) -> "KmerCounts":
        keep = c > 0
        return KmerCounts(self.k, u[keep], c[keep])

    def union_sum(self, other: "KmerCounts") -> "KmerCounts":
        """meryl add: union of keys, counts summed."""
        return self.merge(other)

    def union_min(self, other: "KmerCounts") -> "KmerCounts":
        """meryl or+min: union of keys, the least of the present counts."""
        u, ca, cb = self._aligned(other)
        both = (ca > 0) & (cb > 0)
        return self._from_aligned(u, np.where(both, np.minimum(ca, cb), ca + cb))

    def union_max(self, other: "KmerCounts") -> "KmerCounts":
        """meryl or+max: union of keys, the larger count."""
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.maximum(ca, cb))

    def intersect_min(self, other: "KmerCounts") -> "KmerCounts":
        """meryl and (min): keys in both, the lesser count."""
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.where((ca > 0) & (cb > 0), np.minimum(ca, cb), 0))

    def intersect_max(self, other: "KmerCounts") -> "KmerCounts":
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.where((ca > 0) & (cb > 0), np.maximum(ca, cb), 0))

    def intersect_sum(self, other: "KmerCounts") -> "KmerCounts":
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.where((ca > 0) & (cb > 0), ca + cb, 0))

    def subtract(self, other: "KmerCounts") -> "KmerCounts":
        """meryl sub: counts subtracted, clipped at 0 (keys vanish at 0)."""
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.maximum(ca - cb, 0))

    def difference(self, other: "KmerCounts") -> "KmerCounts":
        """Keys of self that other lacks."""
        u, ca, cb = self._aligned(other)
        return self._from_aligned(u, np.where(cb == 0, ca, 0))

    def at_least(self, threshold: int) -> "KmerCounts":
        """Count filter: keep count >= threshold."""
        m = self.counts >= threshold
        return KmerCounts(self.k, self.unique[m], self.counts[m])

    def at_most(self, threshold: int) -> "KmerCounts":
        m = self.counts <= threshold
        return KmerCounts(self.k, self.unique[m], self.counts[m])

    # ---- persistence (the reference meryl's .mcidx/.mcdat database) ------

    def save(self, path: str) -> None:
        """Write the counted database to one compressed .npz file."""
        np.savez_compressed(path if str(path).endswith(".npz") else f"{path}.npz",
                            k=np.int64(self.k), unique=self.unique, counts=self.counts)

    @staticmethod
    def load(path: str) -> "KmerCounts":
        """Read a database ``save`` wrote.  The k-mers keep the saved dtype:
        uint32 for k <= 16, the exact uint64 k-mers above (canu_tpu casts
        them to uint32, which keeps about 0.1% of a k=22 DB)."""
        p = str(path)
        if not p.endswith(".npz") and os.path.exists(p + ".npz"):
            p = p + ".npz"
        with np.load(p) as z:
            return KmerCounts(int(z["k"]), z["unique"], z["counts"].astype(np.int64))


def count_reads(readset: ReadSet, k: int = 16, block_size: int = 512,
                device=None) -> KmerCounts:
    """Canonical k-mer counts of a read set as the host table (tools and
    tests); counted on ``device`` (the card unless the caller asks for the
    CPU).  The pipeline keeps count_readset_device's tables on the device
    instead."""
    kc = count_readset_device(readset, k, block_size, device=device)
    return kc.to_host() if hasattr(kc, "to_host") else kc


@dataclass
class FrequentKmers:
    """Frequent k-mer table with tf fractions for MinHash down-weighting
    (the mhap ignore file of the reference's Meryl.pm:648-720)."""

    k: int
    kmers: np.ndarray  # uint32, sorted (k > 16: folded 32-bit keys)
    fraction: np.ndarray  # float32 — count / total k-mers
    threshold: int
    total_kmers: int
    # k > 16 only: the exact 2k-bit k-mers (uint64), aligned with kmers
    kmers_exact: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return len(self.kmers)


# ---- thresholds / frequent-mer selection -----------------------------------


def _threshold_from_histogram(hist: np.ndarray, n_distinct: int, fraction: float) -> int:
    cum = np.cumsum(hist[1:])
    target = fraction * n_distinct
    c = int(np.searchsorted(cum, target)) + 1
    return max(1, c)


def threshold_from_distinct_fraction(kc, fraction: float) -> int:
    """Smallest count c such that k-mers with count <= c cover `fraction`
    of distinct k-mers (the reference's *MerDistinct rule,
    Meryl.pm:585-611).  Accepts KmerCounts or DeviceKmerCounts(2)."""
    if isinstance(kc, (DeviceKmerCounts, DeviceKmerCounts2)):
        hist = kc.histogram()
        nd = int(hist[1:].sum())
    else:
        if kc.n_distinct == 0:
            return 1
        hist = kc.histogram()
        nd = kc.n_distinct
    if nd == 0:
        return 1
    return _threshold_from_histogram(hist, nd, fraction)


def estimate_coverage_threshold(kc, multiplier: float = 4.0) -> int:
    """Valley/peak repeat threshold (estimate-mer-threshold equivalent):
    the error-kmer valley, the coverage peak after it, multiplier * peak."""
    hist = (kc.histogram(100_000) if isinstance(kc, (DeviceKmerCounts, DeviceKmerCounts2))
            else kc.histogram(max_count=100_000))
    if len(hist) < 4:
        return max(2, len(hist))
    h = hist[1:]  # h[i] = #distinct with count i+1
    valley = 0
    for i in range(1, len(h) - 1):
        if h[i] <= h[i - 1] and h[i] <= h[i + 1]:
            valley = i
            break
    peak = valley + int(np.argmax(h[valley:])) if valley < len(h) else valley
    return max(2, int(multiplier * (peak + 1)))


def frequent_kmers(kc, threshold: Optional[int] = None,
                   distinct_fraction: float = 0.9995) -> FrequentKmers:
    """Frequent-mer table from KmerCounts or DeviceKmerCounts(2)."""
    if threshold is None:
        threshold = threshold_from_distinct_fraction(kc, distinct_fraction)
    if isinstance(kc, (DeviceKmerCounts, DeviceKmerCounts2)):
        return kc.frequent(int(threshold))
    mask = kc.counts > threshold
    if kc.k > 16:
        exact = kc.unique[mask].astype(np.uint64)
        hi = torch.from_numpy((exact >> np.uint64(32)).astype(np.int64))
        lo = torch.from_numpy((exact & np.uint64(MASK32)).astype(np.int64))
        return _folded_table(kc.k, hi, lo, kc.counts[mask], threshold, kc.n_total)
    return FrequentKmers(
        k=kc.k,
        kmers=kc.unique[mask],
        fraction=(kc.counts[mask] / max(1, kc.n_total)).astype(np.float32),
        threshold=int(threshold),
        total_kmers=kc.n_total,
    )


def union_frequent(a: FrequentKmers, b: FrequentKmers) -> FrequentKmers:
    """Union of two frequent-mer tables of one k: the reference's
    OvlFrequentMers, user-supplied mers kept out of seeding beside the
    counted ones.  Duplicate keys keep the larger fraction."""
    assert a.k == b.k, (a.k, b.k)
    kmers = np.concatenate([a.kmers, b.kmers])
    frac = np.concatenate([a.fraction, b.fraction])
    exact = None
    if a.kmers_exact is not None or b.kmers_exact is not None:
        exact = np.concatenate([
            t.kmers_exact if t.kmers_exact is not None else np.zeros(len(t.kmers), np.uint64)
            for t in (a, b)])
    order = np.lexsort((-frac, kmers))
    kmers, frac = kmers[order], frac[order]
    keep = np.concatenate([[True], kmers[1:] != kmers[:-1]])
    return FrequentKmers(
        k=a.k, kmers=kmers[keep], fraction=frac[keep],
        threshold=min(a.threshold, b.threshold),
        total_kmers=max(a.total_kmers, b.total_kmers),
        kmers_exact=exact[order][keep] if exact is not None else None,
    )


def frequent_from_fasta(path: str, k: int) -> FrequentKmers:
    """Frequent-mer table of every k-mer of every record of a FASTA (the
    reference's OvlFrequentMers file), each with fraction 1.0."""
    from ..io.fastx import read_fastx

    codes = [bitpack.seq_to_codes(r.seq) for r in read_fastx(path) if len(r.seq) >= k]
    if not codes:
        return FrequentKmers(k=k, kmers=np.zeros(0, np.uint32),
                             fraction=np.zeros(0, np.float32), threshold=0, total_kmers=0)
    rs = ReadSet.from_codes_list(codes, [f"m{i}" for i in range(len(codes))])
    fk = frequent_kmers(count_readset_host(rs, k), threshold=0)
    fk.fraction[:] = 1.0
    return fk
