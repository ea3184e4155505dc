"""Shared-k-mer join between read pairs via one sort (counterpart of
canu_tpu.ops.kmerjoin).

Both reads' (kmer, payload) rows are concatenated and sorted once; a
cross-read match is an equal-key ADJACENT pair with one entry from each
read.  The sort is stable, the order XLA gives on equal keys, so the
adjacency (and with it every hit) matches canu_tpu exactly.
"""

from __future__ import annotations

import torch

from .kmer import INVALID_KMER


def pair_matches(canonA, validA, strandA, posA, canonB, validB, strandB, posB):
    """Cross-read equal-kmer matches for a batch of pairs.

    All inputs [C, P].  Returns masked match arrays of width 2P-1:
    hit bool, mposA, mposB int32, magree bool (strand flags equal).
    """
    keyA = torch.where(validA, canonA, INVALID_KMER)
    keyB = torch.where(validB, canonB, INVALID_KMER)
    keys = torch.cat([keyA, keyB], dim=1)
    pay_pos = torch.cat([posA, posB], dim=1).to(torch.int32)
    pay_meta = torch.cat([strandA.to(torch.int32), strandB.to(torch.int32) | 2], dim=1)
    ks, order = torch.sort(keys, dim=1, stable=True)
    pos_s = torch.gather(pay_pos, 1, order)
    meta_s = torch.gather(pay_meta, 1, order)
    eq = (ks[:, 1:] == ks[:, :-1]) & (ks[:, :-1] != INVALID_KMER)
    tag_l = (meta_s[:, :-1] & 2) != 0
    tag_r = (meta_s[:, 1:] & 2) != 0
    hit = eq & (tag_l != tag_r)
    # the A-side entry is whichever neighbour has tag 0
    a_is_left = ~tag_l
    mposA = torch.where(a_is_left, pos_s[:, :-1], pos_s[:, 1:])
    mposB = torch.where(a_is_left, pos_s[:, 1:], pos_s[:, :-1])
    strA = torch.where(a_is_left, meta_s[:, :-1], meta_s[:, 1:]) & 1
    strB = torch.where(a_is_left, meta_s[:, 1:], meta_s[:, :-1]) & 1
    return hit, mposA, mposB, strA == strB


def masked_median(values, mask, big=2**30):
    """Per-row (lower) median of masked int values via one sort. [C, W] -> [C]."""
    srt, _ = torch.sort(torch.where(mask, values, big), dim=1)
    n = mask.sum(dim=1)
    idx = torch.clamp(n - 1, min=0) // 2
    return torch.gather(srt, 1, idx[:, None].to(torch.int64))[:, 0]
