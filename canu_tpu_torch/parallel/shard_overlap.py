"""The sharded pipeline stages: distributed meryl, ring all-vs-all
candidates, sharded verification (counterpart of
canu_tpu.parallel.shard_overlap, on torch.distributed).

These are what pipeline.stages calls when shardedCompute is on, in place
of the reference's grid decomposition:

  * k-mer counting: each rank extracts its own contiguous block of reads'
    k-mers and routes each to its owner rank by hash range with ONE
    all_to_all (parallel.mesh.sharded_kmer_count_step), the reference's
    bucketize/sort disk shuffle (ovStoreBucketizer.C, SURVEY §2.13(3)) as
    a collective;
  * candidate discovery: sketches are split into read blocks, one a rank;
    each of n//2 + 1 ring steps matches the local block against a block
    passed round the ring, so a rank's memory stays O(N/n) (the
    hash-block x query-block job matrix of OverlapMhap.pm:191-296 as ring
    steps);
  * half-ring dedup: a block pair (r, r') is matched exactly once (the
    self block keeps i < j, the last step of an even ring only r < r'),
    so the candidate set is the single-device block x block pass's;
  * verification: each rank verifies its own slice of the candidates
    (contiguous in sharded_verify_candidates, strided in the
    process-sharded stage path) and the rows are gathered, or exchanged
    by a_id range straight into store shards.
"""

from __future__ import annotations

import numpy as np
import torch

from .launch import (all_gather, all_gather_rows, from_wire, host_max, rank_world, ring_shift,
                     to_wire)
from .mesh import UINT32_MAX, _count_matches, _world

# ---- distributed meryl -------------------------------------------------------


def _mesh_rows(readset, n: int, W: int, device):
    """This rank's contiguous row block (words int64[per, W], lengths
    int32[per]) on ``device``, with the read set padded to Npad =
    ceil(N / n) * n rows of empty reads; returns (words, lengths, Npad).
    No rank builds the full padded plane."""
    from ..ops.kmer import block_tensors

    N = readset.n_reads
    Npad = -(-max(N, 1) // n) * n
    per = Npad // n
    r0 = rank_world()[0] * per
    ids = np.arange(r0 + 1, min(r0 + per, N) + 1, dtype=np.int64)
    words = torch.zeros((per, W), dtype=torch.int64, device=device)
    lengths = torch.zeros(per, dtype=torch.int32, device=device)
    if len(ids):
        w, ln = block_tensors(readset, ids, W, device)
        words[: len(ids)], lengths[: len(ids)] = w, ln
    return words, lengths, Npad


def sharded_count_readset(readset, k: int = 16, mesh=None, bin_capacity: int = 0,
                          device=None):
    """Distributed k-mer counting; returns the host KmerCounts of the
    single-device count (hash-range routing makes local counts global) on
    every rank.  k <= 16 counts one uint32 lane, 16 < k <= 32 exact two
    lanes (the reference's ovl/utg k=22).  Raises RuntimeError when a
    bin overflowed (raise bin_capacity)."""
    from ..device import resolve_device
    from ..ops.kmer import INVALID_KMER, KmerCounts
    from ..utils.bitpack import n_words
    from .mesh import sharded_kmer_count_step, sharded_kmer_count_step2

    dev = resolve_device(device)
    n = _world(mesh)
    W = 1 << max(0, int(n_words(max(1, readset.max_length)) - 1).bit_length())
    words, lengths, _ = _mesh_rows(readset, n, W, dev)
    if k > 16:
        hi, lo, ct, _hist, dropped = sharded_kmer_count_step2(
            mesh, k=k, bin_capacity=bin_capacity)(words, lengths)
        if int(dropped) > 0:
            raise RuntimeError("sharded k-mer count dropped k-mers; raise bin_capacity")
        hi = from_wire(all_gather(to_wire(hi))).cpu().numpy().astype(np.uint64)
        lo = from_wire(all_gather(to_wire(lo))).cpu().numpy().astype(np.uint64)
        ct = all_gather(ct.to(torch.int32)).cpu().numpy()
        km = (hi << np.uint64(32)) | lo
        keep = (km != np.uint64(0xFFFFFFFFFFFFFFFF)) & (ct > 0)
        km, ct = km[keep], ct[keep].astype(np.int64)
        order = np.argsort(km, kind="stable")
        return KmerCounts(k, km[order], ct[order])
    km, ct, _hist, dropped = sharded_kmer_count_step(mesh, k=k, bin_capacity=bin_capacity)(
        words, lengths)
    if int(dropped) > 0:
        raise RuntimeError("sharded k-mer count dropped k-mers; raise bin_capacity")
    km = from_wire(all_gather(to_wire(km))).cpu().numpy().astype(np.uint32)
    ct = all_gather(ct.to(torch.int32)).cpu().numpy()
    keep = (km != INVALID_KMER) & (ct > 0)
    km, ct = km[keep], ct[keep].astype(np.int64)
    order = np.argsort(km, kind="stable")
    return KmerCounts(k, km[order], ct[order])


# ---- ring all-vs-all candidates ---------------------------------------------


def sharded_find_candidates(sketches: np.ndarray, min_matches: int = 3, mesh=None,
                            cap_per_step: int = 1 << 17, device=None) -> np.ndarray:
    """Ring all-vs-all candidate pairs over the world's ranks.

    Returns int64[M, 3] (a_id, b_id, slot_matches), a_id < b_id, sorted:
    the contract and the pair set of ops.minhash.find_candidates, on every
    rank.  Each rank matches its block of ceil(N / n) reads against the
    block that n//2 + 1 ring steps pass it (from rank r + 1, to rank
    r - 1).  A step that finds more than cap_per_step pairs on any rank
    raises.
    """
    from ..device import resolve_device
    from ..ops.hashing import u32_tensor

    dev = resolve_device(device)
    n = _world(mesh)
    r = rank_world()[0]
    N, H = sketches.shape
    B = -(-max(N, 1) // n)
    local = np.full((B, H), UINT32_MAX, np.uint32)  # padding rows never match
    part = sketches[r * B : (r + 1) * B]
    local[: len(part)] = part
    sk = u32_tensor(local, dev)
    rot = sk
    found, nfound = [], 0
    ii = torch.arange(B, device=dev)
    for t in range(n // 2 + 1):
        src = (r + t) % n
        cnt = _count_matches(sk, rot, min_matches)
        mask = cnt >= min_matches
        if t == 0:
            mask &= ii[:, None] < ii[None, :]
        if not (t < (n + 1) // 2 or r < src):
            mask = torch.zeros_like(mask)
        nz = torch.nonzero(mask)[:cap_per_step]  # row-major, as a fixed-size nonzero
        nfound = max(nfound, int(mask.sum()))
        found.append(torch.stack([r * B + nz[:, 0] + 1, src * B + nz[:, 1] + 1,
                                  cnt[nz[:, 0], nz[:, 1]].to(torch.int64)], dim=1))
        if t < n // 2:
            rot = from_wire(ring_shift(to_wire(rot)))
    worst = host_max(nfound)
    if worst > cap_per_step:
        raise RuntimeError(f"candidate overflow in ring step: {worst} > cap={cap_per_step}")
    rows = all_gather_rows(torch.cat(found)).cpu().numpy()
    rows = rows[(rows[:, 0] <= N) & (rows[:, 1] <= N)]  # drop pairs into padding rows
    flip = rows[:, 0] > rows[:, 1]
    rows[flip, 0], rows[flip, 1] = rows[flip, 1], rows[flip, 0]
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]


# ---- sharded banded verification --------------------------------------------


def sharded_verify_candidates(readset, pairs: np.ndarray, mesh=None, k: int = 16,
                              band: int = 128, device=None) -> np.ndarray:
    """Banded verification split by candidate ownership.

    Each rank verifies its contiguous slice of the candidate list with the
    anchor + INF-walled extension (ops.align._verify_pre ->
    banded_extend -> _verify_post: canu_tpu's engine='xla', so kernel K2
    on a card at band 128) over the replicated read index.  Returns the
    raw verification rows int32[M, 13] in candidate order on every rank,
    bit-identical to the single-device computation on the same pairs.
    """
    from ..device import resolve_device
    from ..ops.align import _verify_post, _verify_pre, banded_extend
    from ..ops.minimizers import get_read_index

    dev = resolve_device(device)
    n = _world(mesh)
    r = rank_world()[0]
    index = get_read_index(readset, k=k, device=dev)
    n_rows = index.words.shape[1] * 16
    M = len(pairs)
    per = -(-max(M, 1) // n)
    a_idx = np.full(per * n, index.n_reads, np.int64)  # the index's all-zero padding row
    b_idx = np.full(per * n, index.n_reads, np.int64)
    a_idx[:M] = pairs[:, 0] - 1
    b_idx[:M] = pairs[:, 1] - 1
    sl = slice(r * per, (r + 1) * per)
    ai = torch.from_numpy(a_idx[sl]).to(dev)
    bi = torch.from_numpy(b_idx[sl]).to(dev)
    ext_in, n_anchor, flipped, seedA, seedB, n_minor = _verify_pre(
        index, ai, bi, torch.zeros(per, dtype=torch.bool, device=dev), k, band, n_rows,
        orient=True)
    e, au, bu = banded_extend(*ext_in, band, n_rows)
    rows = _verify_post(n_anchor, flipped, seedA, seedB, n_minor, e, au, bu, e, au, bu)
    return all_gather(rows).cpu().numpy()[:M]


# ---- process-sharded full-featured verification ------------------------------


def allgather_overlap_table(table, device=None):
    """Every rank's OverlapTable, concatenated in rank order, on every rank.

    Records travel as int32[m, 8] (erate_q and flipped fit), padded to the
    largest rank's count: ~32 B an overlap, the cheap side of an exchange
    whose verification work is ~10^4x larger."""
    from ..device import resolve_device
    from ..ops.align import OverlapTable
    from ..stores.overlaps import _COLS

    if rank_world()[1] == 1:
        return table
    packed = np.stack([getattr(table, c).astype(np.int32) for c in _COLS], axis=1) \
        if len(table) else np.zeros((0, 8), np.int32)
    rows = all_gather_rows(torch.from_numpy(packed).to(resolve_device(device))).cpu().numpy()
    return OverlapTable(
        a_id=rows[:, 0].astype(np.int32), b_id=rows[:, 1].astype(np.int32),
        flipped=rows[:, 2].astype(bool), a_bgn=rows[:, 3].astype(np.int32),
        a_end=rows[:, 4].astype(np.int32), b_bgn=rows[:, 5].astype(np.int32),
        b_end=rows[:, 6].astype(np.int32), erate_q=rows[:, 7].astype(np.uint16))


def table_to_sym_rows(table) -> np.ndarray:
    """Symmetrize an A->B OverlapTable into int32[2m, 8] store rows in
    stores.overlaps._COLS order (every overlap stored twice, before the
    range exchange, so each mirror row goes to its own a_id range's
    owner)."""
    m = len(table)
    rows = np.empty((2 * m, 8), np.int32)
    fwd = (table.a_id, table.b_id, table.flipped, table.a_bgn, table.a_end, table.b_bgn,
           table.b_end, table.erate_q)
    rev = (table.b_id, table.a_id, table.flipped, table.b_bgn, table.b_end, table.a_bgn,
           table.a_end, table.erate_q)
    for c in range(8):
        rows[:m, c] = fwd[c]
        rows[m:, c] = rev[c]
    return rows


def _local_pairs(pairs: np.ndarray) -> np.ndarray:
    """This rank's strided slice of the candidates: similar length
    distributions on every rank, so verify's length-sorted chunks stay
    full everywhere."""
    r, n = rank_world()
    return pairs[r::n] if n > 1 else pairs


def process_sharded_store_rows(readset, pairs: np.ndarray, **verify_kwargs) -> np.ndarray:
    """Verify this rank's strided candidate slice, symmetrize, and exchange
    by a_id range: returns the int32[m_r, 8] rows this rank owns, sorted.
    A rank's table memory is O(total / n), not O(total), as in the
    reference's bucketize/sort build (SURVEY.md §3.3)."""
    from ..ops.align import verify_overlaps
    from .storesort import process_range_exchange

    verify_kwargs.pop("sink", None)
    tab = verify_overlaps(readset, _local_pairs(pairs), **verify_kwargs)
    rows = table_to_sym_rows(tab)
    del tab
    return process_range_exchange(rows, readset.n_reads, device=verify_kwargs.get("device"))


def process_sharded_verify(readset, pairs: np.ndarray, **verify_kwargs):
    """Full-featured banded verification split by rank: each rank runs
    ops.align.verify_overlaps (partial overlaps, the palindromic
    re-verify, the engine by band: the whole stage surface) on its strided
    slice of the candidates, then every rank gets the whole table.  The
    reference's hash x ref job matrix (OverlapMhap.pm:191-296) applied to
    verification: independent slices, no communication until the
    store-input exchange.  A sink is process-local, so it is dropped: the
    caller spills after the exchange."""
    from ..ops.align import verify_overlaps

    verify_kwargs.pop("sink", None)
    tab = verify_overlaps(readset, _local_pairs(pairs), **verify_kwargs)
    return allgather_overlap_table(tab, device=verify_kwargs.get("device"))
