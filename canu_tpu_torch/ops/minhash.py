"""MinHash sketch overlap candidates (counterpart of canu_tpu.ops.minhash).

  stage A  sketch: per read, H independent min-hash slots over its
           canonical k-mers, frequent k-mers dropped (the reference's
           ignore-file contract, OverlapMhap.pm:382-396);
  stage B  match: block x block slot-agreement counting on the device
           (the all-vs-all job matrix of OverlapMhap.pm:191-296), or, for
           large read sets, the hash-join (find_candidates_join): reads
           that share a (slot, value) bucket are paired, O(N H log(N H))
           sorting instead of O(N^2) compares.

  stage C  placement (place_candidates): for candidate pairs, the
           shared-k-mer join gives an orientation vote, a median diagonal
           and the inlier spans.  The pipeline folds it into verification
           (ops.align), as canu_tpu's does; canu_tpu's tests call it.

On the card stage A is kernel K5 and stage B's block matcher kernel K6
(ops/kernels/minhash_cuda.py, csrc/minhash.cu), stage C's pair statistics
kernel K12 (ops/kernels/verify_cuda.py, csrc/verify.cu); on the CPU their
plain PyTorch versions, which the kernels are held to bit for bit.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..stores.readset import ReadSet
from ..utils.bitpack import n_words
from .hashing import hash_seeds, mix32, u32_numpy, u32_tensor
from .kmer import INVALID_KMER, FrequentKmers, block_tensors, extract_kmers_any, length_bucketed_blocks
from .kmerjoin import masked_median, pair_matches

UINT32_MAX = 0xFFFFFFFF

# hash slots evaluated together in _sketch_kernel: bounds the [B, h, P]
# temporary at SKETCH_ELEMS int64 elements
SKETCH_ELEMS = 1 << 23

# calls of the plain sketch, the plain slot count and the plain pair
# statistics on a CUDA tensor (chip_smoke.py requires 0 on the path: the
# card runs K5, K6 and K12)
PLAIN_CUDA_SKETCHES = PLAIN_CUDA_MATCHES = PLAIN_CUDA_PAIR_STATS = 0


def _fk_array(frequent: "FrequentKmers | None") -> np.ndarray:
    """Frequent-kmer array, never empty: INVALID_KMER never equals a
    canonical k-mer, so a 1-sentinel array is a no-op filter."""
    if frequent is not None and frequent.n:
        return frequent.kmers
    return np.full(1, UINT32_MAX, np.uint32)


# ---- stage A: sketches ------------------------------------------------------


def _sketch_kernel(words, lengths, seeds, fk_kmers, k: int) -> torch.Tensor:
    """Sketches of one padded read block.

    words [B, W] packed reads, lengths [B], seeds int64[H] (uint32 values),
    fk_kmers int64[F] sorted frequent k-mers.  Returns int64[B, H] min-hash
    values (UINT32_MAX for empty reads).  On CUDA tensors one launch of
    kernel K5 (ops/kernels/minhash_cuda.py), which raises on what it does
    not take; on the CPU _sketch_kernel_plain.
    """
    if not words.is_cuda:
        return _sketch_kernel_plain(words, lengths, seeds, fk_kmers, k)
    from .kernels import minhash_cuda

    return minhash_cuda.sketch(words, lengths, seeds, fk_kmers, k)


def _sketch_kernel_plain(words, lengths, seeds, fk_kmers, k: int) -> torch.Tensor:
    """_sketch_kernel as PyTorch ops, hash slots in slices of SKETCH_ELEMS
    [B, h, P] temporaries: the CPU's sketch, and the reference kernel K5
    is held to."""
    global PLAIN_CUDA_SKETCHES
    if words.is_cuda:
        PLAIN_CUDA_SKETCHES += 1
    canon, _ = extract_kmers_any(words, lengths, k)  # [B, P]
    valid = canon != INVALID_KMER
    if fk_kmers.shape[0] > 0:
        idx = torch.searchsorted(fk_kmers, canon)
        idx = torch.clamp(idx, max=fk_kmers.shape[0] - 1)
        valid = valid & ~(fk_kmers[idx] == canon)
    B, P = canon.shape
    H = seeds.shape[0]
    out = torch.empty((B, H), dtype=torch.int64, device=canon.device)
    step = max(1, SKETCH_ELEMS // max(1, B * P))
    for h0 in range(0, H, step):
        sd = seeds[h0 : h0 + step]
        hv = mix32(canon[:, None, :] ^ sd[None, :, None])
        hv = torch.where(valid[:, None, :], hv, UINT32_MAX)
        out[:, h0 : h0 + step] = hv.amin(dim=2)
    return out


def build_sketches(readset: ReadSet, k: int = 16, n_hashes: int = 128,
                   frequent: Optional[FrequentKmers] = None, block_size: int = 256,
                   seed: int = 0xA5EED, device=None) -> np.ndarray:
    """Sketch every read; returns uint32[N, H] (host), rows = read_id-1."""
    dev = resolve_device(device)
    seeds = u32_tensor(hash_seeds(n_hashes, seed), dev)
    fk = u32_tensor(_fk_array(frequent), dev)
    out = np.full((readset.n_reads, n_hashes), UINT32_MAX, dtype=np.uint32)
    # every block is launched before any is fetched, so the host packs the
    # next block while the card sketches this one
    pending = []
    for ids, W in length_bucketed_blocks(readset, block_size):
        words, lengths = block_tensors(readset, ids, W, dev)
        pending.append((ids, _sketch_kernel(words, lengths, seeds, fk, k)))
    for ids, sk in pending:
        out[ids - 1] = u32_numpy(sk)
    return out


# ---- stage B: block x block slot matching -----------------------------------


def _slot_counts_plain(SA: torch.Tensor, SB: torch.Tensor) -> torch.Tensor:
    """slot_counts as PyTorch ops, one compare-and-add a slot."""
    global PLAIN_CUDA_MATCHES
    if SA.is_cuda:
        PLAIN_CUDA_MATCHES += 1
    cnt = torch.zeros((SA.shape[0], SB.shape[0]), dtype=torch.int32, device=SA.device)
    for h in range(SA.shape[1]):
        a = SA[:, h]
        cnt += ((a[:, None] == SB[None, :, h]) & (a != UINT32_MAX)[:, None]).to(torch.int32)
    return cnt


def slot_counts(SA: torch.Tensor, SB: torch.Tensor) -> torch.Tensor:
    """Slot agreements int32[Na, Nb] of two sketch blocks SA [Na, H], SB
    [Nb, H] (UINT32_MAX slots never match): kernel K6's count launch on
    CUDA tensors, _slot_counts_plain on the CPU."""
    if not SA.is_cuda:
        return _slot_counts_plain(SA, SB)
    from .kernels import minhash_cuda

    return minhash_cuda.slot_counts(SA, SB)


def _match_kernel(SA: torch.Tensor, SB: torch.Tensor, min_matches: int,
                  self_block: bool, max_out: int):
    """Count agreeing sketch slots for every (i, j) of a block pair.

    SA [Na, H], SB [Nb, H] sketches.  Returns (ii, jj, cnt, n_found):
    row-major candidate lists padded to max_out with index Na and count 0
    (the fixed-size nonzero of canu_tpu), and n_found a 0-d int64 tensor
    on the device (it may exceed max_out); for a self block only i < j is
    reported.  UINT32_MAX slots (empty reads) never match.  On CUDA
    tensors kernel K6 (its count and compact launches, nothing fetched);
    on the CPU _match_kernel_plain.
    """
    if not SA.is_cuda:
        return _match_kernel_plain(SA, SB, min_matches, self_block, max_out)
    from .kernels import minhash_cuda

    return minhash_cuda.match_block(SA, SB, min_matches, self_block, max_out)


def _match_kernel_plain(SA: torch.Tensor, SB: torch.Tensor, min_matches: int,
                        self_block: bool, max_out: int):
    """_match_kernel as PyTorch ops: the CPU's matcher, and the reference
    kernel K6 is held to."""
    Na = SA.shape[0]
    cnt = _slot_counts_plain(SA, SB)
    mask = cnt >= min_matches
    if self_block:
        mask = torch.triu(mask, diagonal=1)
    nz = torch.nonzero(mask)
    take = min(int(nz.shape[0]), max_out)
    ii = torch.full((max_out,), Na, dtype=torch.int64, device=SA.device)
    jj = torch.full((max_out,), Na, dtype=torch.int64, device=SA.device)
    c = torch.zeros(max_out, dtype=torch.int32, device=SA.device)
    ii[:take] = nz[:take, 0]
    jj[:take] = nz[:take, 1]
    c[:take] = cnt[nz[:take, 0], nz[:take, 1]]
    return ii, jj, c, torch.tensor(nz.shape[0], dtype=torch.int64, device=SA.device)


def find_candidates(sketches: np.ndarray, min_matches: int = 3, block_size: int = 1024,
                    max_out_per_blockpair: int = 1 << 17, device=None) -> np.ndarray:
    """All-vs-all candidate pairs from sketches.

    Returns int64[M, 3] (a_id, b_id, slot_matches) with a_id < b_id
    (1-based), sorted by (a_id, b_id).  The reference's hash-block x
    query-block job matrix (OverlapMhap.pm:214-296) is a host loop over
    device block pairs; every pair is launched before any result is
    fetched, then every pair's n_found comes back in one copy and the
    candidate columns in one copy a group of pairs, as canu_tpu drains.
    """
    dev = resolve_device(device)
    N = len(sketches)
    S = u32_tensor(sketches, dev)
    starts = list(range(0, N, block_size))
    pending = []
    for bi, sa in enumerate(starts):
        SA = S[sa : min(sa + block_size, N)]
        for sb in starts[bi:]:
            SB = S[sb : min(sb + block_size, N)]
            out = _match_kernel(SA, SB, min_matches, sa == sb, max_out_per_blockpair)
            pending.append((sa, sb, out))
    if not pending:
        return np.zeros((0, 3), dtype=np.int64)
    nf_all = torch.stack([out[3] for _, _, out in pending]).cpu().numpy()
    if int(nf_all.max()) > max_out_per_blockpair:
        bad = int(np.argmax(nf_all))
        raise RuntimeError(
            f"candidate overflow in block pair ({pending[bad][0]},{pending[bad][1]}): "
            f"{int(nf_all[bad])}; raise max_out_per_blockpair or min_matches"
        )
    rows = []
    GROUP = 8
    for g0 in range(0, len(pending), GROUP):
        grp, nfs = pending[g0 : g0 + GROUP], nf_all[g0 : g0 + GROUP]
        nfmax = int(nfs.max())
        if nfmax == 0:
            continue
        packed = torch.stack([torch.stack([ii[:nfmax], jj[:nfmax], cc[:nfmax].to(torch.int64)])
                              for _, _, (ii, jj, cc, _) in grp]).cpu().numpy()  # [K, 3, nfmax]
        for g, (sa, sb, _) in enumerate(grp):
            nf = int(nfs[g])
            if nf:
                rows.append(np.stack([packed[g, 0, :nf] + sa + 1, packed[g, 1, :nf] + sb + 1,
                                      packed[g, 2, :nf]], axis=1))
    if not rows:
        return np.zeros((0, 3), dtype=np.int64)
    out = np.concatenate(rows)
    flip = out[:, 0] > out[:, 1]
    out[flip, 0], out[flip, 1] = out[flip, 1], out[flip, 0]
    return out[np.lexsort((out[:, 1], out[:, 0]))]


# calls of find_candidates_join (chip_smoke.py checks a drive's path by it)
JOIN_CALLS = 0


def find_candidates_join(sketches: np.ndarray, min_matches: int = 3, slot_chunk: int = 64,
                         bucket_cap: int = 2048, device=None) -> np.ndarray:
    """All-vs-all candidates by an LSH hash-join on the device.

    A pair matches in slot h iff sketches[i, h] == sketches[j, h] !=
    UINT32_MAX; pairs with >= min_matches matching slots are kept.  Reads
    are bucketed by (slot, value) keys, one stable sort per group of
    slot_chunk slots, and each bucket's pairs expand through one gather
    and triu per bucket size.  Buckets of more than bucket_cap reads (a
    repeat family the frequent-mer filter missed) are dropped with a
    warning, as MHAP's tf-idf down-weighting would (OverlapMhap.pm:
    382-396); below the cap the result equals find_candidates'.  Each slot
    group's pairs reduce to (pair key, slots) before the groups merge.

    Returns canu_tpu's int64[M, 3] (a_id, b_id, slot_matches), 1-based,
    a_id < b_id, sorted.
    """
    global JOIN_CALLS
    N, H = sketches.shape
    if N < 2:
        return np.zeros((0, 3), dtype=np.int64)
    JOIN_CALLS += 1
    dev = resolve_device(device)
    S = u32_tensor(np.ascontiguousarray(sketches), dev)
    reads_all = torch.arange(N, dtype=torch.int64, device=dev)
    dropped = 0
    per_group = []  # (pair keys, slot counts) of each slot group
    for h0 in range(0, H, slot_chunk):
        h1 = min(h0 + slot_chunk, H)
        vals = S[:, h0:h1].T.reshape(-1)  # slot-major [hc * N]
        slots = torch.arange(h0, h1, dtype=torch.int64, device=dev).repeat_interleave(N)
        reads = reads_all.repeat(h1 - h0)
        keep = vals != UINT32_MAX
        keys, order = torch.sort((slots << 32)[keep] | vals[keep], stable=True)
        reads = reads[keep][order]
        new = torch.ones_like(keys, dtype=torch.bool)
        new[1:] = keys[1:] != keys[:-1]
        starts = torch.nonzero(new)[:, 0]
        sizes = torch.diff(starts, append=starts.new_tensor([keys.shape[0]]))
        big = sizes > bucket_cap
        dropped += int(big.sum())
        keepb = ~big & (sizes > 1)
        pair_keys = []
        for s in torch.unique(sizes[keepb]).tolist():
            sel = starts[keepb & (sizes == s)]
            members = reads[sel[:, None] + torch.arange(s, device=dev)[None, :]]
            members = torch.sort(members, dim=1).values
            li, lj = torch.triu_indices(s, s, 1, device=dev)
            pair_keys.append((members[:, li] * (N + 1) + members[:, lj]).reshape(-1))
        if pair_keys:
            per_group.append(torch.unique(torch.cat(pair_keys), return_counts=True))
    if dropped:
        logging.getLogger("canu_tpu_torch.minhash").warning(
            "hash-join: dropped %d buckets larger than %d reads "
            "(unfiltered repeat hash values)", dropped, bucket_cap)
    if not per_group:
        return np.zeros((0, 3), dtype=np.int64)
    uniq, inv = torch.unique(torch.cat([u for u, _ in per_group]), return_inverse=True)
    cnt = torch.zeros_like(uniq).index_add_(0, inv, torch.cat([c for _, c in per_group]))
    keep = cnt >= min_matches
    uniq, cnt = uniq[keep], cnt[keep]
    # the key a * (N + 1) + b (a < b <= N - 1) orders rows by (a_id, b_id)
    return torch.stack([uniq // (N + 1) + 1, uniq % (N + 1) + 1, cnt], dim=1).cpu().numpy()


@dataclass
class OverlapCandidates:
    """Placed overlap candidates awaiting alignment verification (the
    numpy table of canu_tpu.ops.minhash.OverlapCandidates).  b_lo/b_hi are
    forward-B coordinates even when ``flipped``."""

    a_id: np.ndarray  # int32, 1-based
    b_id: np.ndarray
    flipped: np.ndarray  # bool
    diag: np.ndarray  # int32
    n_shared: np.ndarray  # int32 inlier shared k-mers
    a_lo: np.ndarray
    a_hi: np.ndarray
    b_lo: np.ndarray
    b_hi: np.ndarray

    def __len__(self) -> int:
        return len(self.a_id)


# ---- stage C: shared-kmer placement ----------------------------------------


def _pair_stats_kernel(wordsA, lenA, wordsB, lenB, fk_kmers, k: int):
    """Per candidate pair: orientation vote + median diagonal + span.

    All tensors are [C, ...] (one row per pair).  Returns (flipped
    bool[C], diag int32[C], n_inliers int32[C], a_lo, a_hi, b_lo, b_hi
    int32[C]) where the spans cover the inlier k-mer matches (the B span
    in forward-B coordinates).  Shared k-mers come from the one-sort
    adjacency join (ops.kmerjoin).  The plain version of kernel K12
    (``_pair_stats_rows``); place_candidates runs it on the CPU.
    """
    global PLAIN_CUDA_PAIR_STATS
    if wordsA.is_cuda:
        PLAIN_CUDA_PAIR_STATS += 1
    canonA, strandA = extract_kmers_any(wordsA, lenA, k)  # [C, P]
    canonB, strandB = extract_kmers_any(wordsB, lenB, k)
    P = canonA.shape[1]
    validA = canonA != INVALID_KMER
    validB = canonB != INVALID_KMER
    if fk_kmers.shape[0] > 0:
        idx = torch.clamp(torch.searchsorted(fk_kmers, canonB), max=fk_kmers.shape[0] - 1)
        validB = validB & (fk_kmers[idx] != canonB)
    pos = torch.arange(P, dtype=torch.int32, device=canonA.device)[None, :].expand(canonA.shape)
    hit, posA_m, posB_m, agree = pair_matches(canonA, validA, strandA, pos, canonB, validB,
                                              strandB, pos)
    n_same = (hit & agree).sum(dim=1, dtype=torch.int32)
    n_opp = (hit & ~agree).sum(dim=1, dtype=torch.int32)
    flipped = n_opp > n_same

    # B position mapped into forward-A-compatible coordinates
    posB_fl = lenB[:, None] - k - posB_m  # position in rc(B)
    posB_eff = torch.where(flipped[:, None], posB_fl, posB_m)
    sel = hit & (agree != flipped[:, None])  # matches agreeing with the vote
    diag = posA_m - posB_eff
    big = 2**30
    med = masked_median(diag, sel)

    # inliers: diagonal within an indel-proportional tolerance (float32
    # product truncated, as canu_tpu computes it with x64 off)
    min_len = torch.minimum(lenA, lenB)
    tol = torch.clamp((min_len.to(torch.float32) * torch.tensor(0.30, dtype=torch.float32))
                      .to(torch.int32), min=100)
    inl = sel & ((diag - med[:, None]).abs() <= tol[:, None])
    n_inl = inl.sum(dim=1, dtype=torch.int32)

    # spans over inlier matches (A coords; B span in forward-B coords)
    a_lo = torch.where(inl, posA_m, big).amin(dim=1)
    a_hi = torch.where(inl, posA_m + k, -1).amax(dim=1)
    b_lo = torch.where(inl, posB_m, big).amin(dim=1)
    b_hi = torch.where(inl, posB_m + k, -1).amax(dim=1)
    med2 = masked_median(diag, inl)
    return flipped, med2, n_inl, a_lo, a_hi, b_lo, b_hi


def _pair_stats_rows(words, lengths, a_idx, b_idx, fk_kmers, k: int):
    """Stage C's statistics of every pair of a call on the card: kernel K12
    in one launch over the read set's word plane (int32[7, M])."""
    from .kernels.verify_cuda import pair_stats_rows

    return pair_stats_rows(words, lengths, a_idx, b_idx, fk_kmers, k)


def chunk_block(readset: ReadSet, chunk_pairs: np.ndarray, chunk: int):
    """A chunk's padded arrays as the CPU path builds them: (wordsA, lenA,
    wordsB, lenB) numpy, W the power of two of the chunk's longest read's
    words, the rows past the chunk's pairs empty up to `chunk`."""
    a_ids = chunk_pairs[:, 0].astype(np.int64)
    b_ids = chunk_pairs[:, 1].astype(np.int64)
    wmax = n_words(int(max(readset.length[a_ids - 1].max(), readset.length[b_ids - 1].max())))
    W = 1 << max(0, int(wmax - 1).bit_length())
    wa, la = readset.block_words(a_ids, W)
    wb, lb = readset.block_words(b_ids, W)
    C = len(chunk_pairs)
    if C < chunk:
        padw = np.zeros((chunk - C, W), np.uint32)
        padl = np.zeros(chunk - C, np.int32)
        wa, la = np.vstack([wa, padw]), np.concatenate([la, padl])
        wb, lb = np.vstack([wb, padw]), np.concatenate([lb, padl])
    return wa, la.astype(np.int32), wb, lb.astype(np.int32)


_PLACED = tuple(f.name for f in fields(OverlapCandidates))


def place_candidates(readset: ReadSet, pairs: np.ndarray, k: int = 16,
                     frequent: Optional[FrequentKmers] = None, min_shared: int = 4,
                     chunk: int = 256, device=None) -> OverlapCandidates:
    """Run stage C on candidate (a_id, b_id) pairs and keep the pairs with
    at least min_shared inlier shared k-mers
    (canu_tpu.ops.minhash.place_candidates).  On the card every pair goes
    through kernel K12 in one launch over the read set's word plane, each
    read at its own length, and one fetch; on the CPU `chunk` pairs a call
    of the plain statistics (the last padded to it), as canu_tpu runs it.
    A pair's statistics do not depend on its chunk: the padding lies past
    both reads."""
    dev = resolve_device(device)
    fk = u32_tensor(_fk_array(frequent), dev)
    a_ids = pairs[:, 0].astype(np.int64)
    b_ids = pairs[:, 1].astype(np.int64)
    if dev.type == "cuda":
        from .votepile import device_words

        words, lengths = device_words(readset, dev)
        rows = torch.from_numpy(np.stack([a_ids - 1, b_ids - 1]).astype(np.int32)).to(dev)
        fl, dg, ni, alo, ahi, blo, bhi = _pair_stats_rows(words, lengths, rows[0], rows[1],
                                                          fk, k).cpu().numpy()  # one fetch
        keep = ni >= min_shared
        vals = (a_ids, b_ids, fl != 0, dg, ni, alo, ahi, blo, bhi)
        cols = {name: [v[keep]] for name, v in zip(_PLACED, vals)}
    else:
        cols = {n: [] for n in _PLACED}
        for s in range(0, len(pairs), chunk):
            wa, la, wb, lb = chunk_block(readset, pairs[s : s + chunk], chunk)
            C = min(chunk, len(pairs) - s)
            stats = _pair_stats_kernel(u32_tensor(wa, dev), torch.from_numpy(la),
                                       u32_tensor(wb, dev), torch.from_numpy(lb), fk, k)
            fl, dg, ni, alo, ahi, blo, bhi = torch.stack(
                [t[:C].to(torch.int32) for t in stats]).numpy()
            keep = ni >= min_shared
            vals = (a_ids[s : s + C], b_ids[s : s + C], fl != 0, dg, ni, alo, ahi, blo, bhi)
            for name, v in zip(_PLACED, vals):
                cols[name].append(v[keep])
    dtypes = {"flipped": bool}
    return OverlapCandidates(**{
        n: (np.concatenate(cols[n]) if cols[n] else np.zeros(0)).astype(dtypes.get(n, np.int32))
        for n in _PLACED})
