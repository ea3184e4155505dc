"""MinHash sketch overlap candidates (counterpart of canu_tpu.ops.minhash).

  stage A  sketch: per read, H independent min-hash slots over its
           canonical k-mers, frequent k-mers dropped (the reference's
           ignore-file contract, OverlapMhap.pm:382-396);
  stage B  match: block x block slot-agreement counting on the device
           (the all-vs-all job matrix of OverlapMhap.pm:191-296), or, for
           large read sets, the hash-join (find_candidates_join): reads
           that share a (slot, value) bucket are paired, O(N H log(N H))
           sorting instead of O(N^2) compares.

Placement (stage C) is folded into verification (ops.align), as in the
pipeline of canu_tpu.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..stores.readset import ReadSet
from .hashing import hash_seeds, mix32, u32_numpy, u32_tensor
from .kmer import INVALID_KMER, FrequentKmers, block_tensors, extract_kmers_any, length_bucketed_blocks

UINT32_MAX = 0xFFFFFFFF

# hash slots evaluated together in _sketch_kernel: bounds the [B, h, P]
# temporary at SKETCH_ELEMS int64 elements
SKETCH_ELEMS = 1 << 23


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
    values (UINT32_MAX for empty reads).
    """
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
    for ids, W in length_bucketed_blocks(readset, block_size):
        words, lengths = block_tensors(readset, ids, W, dev)
        out[ids - 1] = u32_numpy(_sketch_kernel(words, lengths, seeds, fk, k))
    return out


# ---- stage B: block x block slot matching -----------------------------------


def _match_kernel(SA: torch.Tensor, SB: torch.Tensor, min_matches: int,
                  self_block: bool, max_out: int):
    """Count agreeing sketch slots for every (i, j) of a block pair.

    SA [Na, H], SB [Nb, H] sketches.  Returns (ii, jj, cnt, n_found):
    row-major candidate lists padded to max_out with index Na and count 0
    (the fixed-size nonzero of canu_tpu); for a self block only i < j is
    reported.  UINT32_MAX slots (empty reads) never match.
    """
    Na, Nb = SA.shape[0], SB.shape[0]
    cnt = torch.zeros((Na, Nb), dtype=torch.int32, device=SA.device)
    for h in range(SA.shape[1]):
        a = SA[:, h]
        eq = (a[:, None] == SB[None, :, h]) & (a != UINT32_MAX)[:, None]
        cnt += eq.to(torch.int32)
    mask = cnt >= min_matches
    if self_block:
        mask = torch.triu(mask, diagonal=1)
    nz = torch.nonzero(mask)
    n_found = int(nz.shape[0])
    take = min(n_found, max_out)
    ii = torch.full((max_out,), Na, dtype=torch.int64, device=SA.device)
    jj = torch.full((max_out,), Na, dtype=torch.int64, device=SA.device)
    c = torch.zeros(max_out, dtype=torch.int32, device=SA.device)
    ii[:take] = nz[:take, 0]
    jj[:take] = nz[:take, 1]
    c[:take] = cnt[nz[:take, 0], nz[:take, 1]]
    return ii, jj, c, n_found


def find_candidates(sketches: np.ndarray, min_matches: int = 3, block_size: int = 1024,
                    max_out_per_blockpair: int = 1 << 17, device=None) -> np.ndarray:
    """All-vs-all candidate pairs from sketches.

    Returns int64[M, 3] (a_id, b_id, slot_matches) with a_id < b_id
    (1-based), sorted by (a_id, b_id).  The reference's hash-block x
    query-block job matrix (OverlapMhap.pm:214-296) is a host loop over
    device block pairs.
    """
    dev = resolve_device(device)
    N = len(sketches)
    S = u32_tensor(sketches, dev)
    starts = list(range(0, N, block_size))
    done = []
    for bi, sa in enumerate(starts):
        SA = S[sa : min(sa + block_size, N)]
        for sb in starts[bi:]:
            SB = S[sb : min(sb + block_size, N)]
            out = _match_kernel(SA, SB, min_matches, sa == sb, max_out_per_blockpair)
            done.append((sa, sb, out))
    nf_all = np.array([out[3] for _, _, out in done], np.int64)
    if len(nf_all) and int(nf_all.max()) > max_out_per_blockpair:
        bad = int(np.argmax(nf_all))
        raise RuntimeError(
            f"candidate overflow in block pair ({done[bad][0]},{done[bad][1]}): "
            f"{int(nf_all[bad])}; raise max_out_per_blockpair or min_matches"
        )
    rows = []
    for sa, sb, (ii, jj, cc, nf) in done:
        if nf == 0:
            continue
        rows.append(np.stack([
            ii[:nf].cpu().numpy() + sa + 1,
            jj[:nf].cpu().numpy() + sb + 1,
            cc[:nf].cpu().numpy().astype(np.int64),
        ], axis=1))
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
