"""Consensus of tigs (counterpart of canu_tpu.ops.consensus).

quick_mosaic is the reference's `utgcns -quick` mosaic (Canu src/utgcns/
utgcns.C:60-530, unitigConsensus::generateQuick): reads stitched across
the tig left to right, each contributing the bases past the previous
read's end.  polish_tig is the plurality polish on the vote engine
(ops.votepile, PyTorch ops on the device of the read planes): the
backbone is cut into VOTE_SEG-base segments, every placed read votes
into each segment it overlaps, and the called edits are applied, for up
to ``rounds`` rounds.  mode="dag" (cnsConsensus=dag) calls each segment
with the tag-chain consensus of ops.dagcon instead of the plurality.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..stores.readset import ReadSet
from ..stores.tigs import Tig
from ..utils import bitpack


def oriented_codes(readset: ReadSet, read_id: int, rev: bool) -> np.ndarray:
    codes = readset.get_codes(int(read_id))
    return bitpack.revcomp_codes(codes) if rev else codes


def quick_mosaic(readset: ReadSet, tig: Tig) -> np.ndarray:
    """Mosaic consensus codes for a tig (positions are hang estimates, so
    junctions may be locally off by the overlap's indel imbalance)."""
    order = np.argsort(tig.bgn, kind="stable")
    out: list[np.ndarray] = []
    cur_end = None
    for i in order:
        codes = oriented_codes(readset, tig.read_id[i], bool(tig.rev[i]))
        bgn, end = int(tig.bgn[i]), int(tig.end[i])
        if cur_end is None:
            out.append(codes)
            cur_end = end
            continue
        if end <= cur_end:  # contained in the span already emitted
            continue
        skip = max(0, cur_end - bgn)  # bases of this read already covered; a gap butt-joins
        if skip < len(codes):
            out.append(codes[skip:])
        cur_end = end
    if not out:
        return np.zeros(0, np.uint8)
    return np.concatenate(out)


# backbone segment length == the vote engine's template segment
# (ops.falcon.VOTE_SEG), so polish and correction share one geometry
_POLISH_SEG = 2048


def polish_tig(
    readset: ReadSet,
    tig: Tig,
    backbone: np.ndarray,
    band: int = 256,
    min_cov: int = 2,
    slack: int = 100,
    max_coverage: int = 40,
    rounds: int = 3,
    mode: str = "plurality",
    device=None,
) -> np.ndarray:
    """Iteratively plurality-polish a mosaic backbone with the tig's reads
    on ``device`` (the pbdagcon + mergeRefine role of the reference's
    utgcns: reads aligned to a backbone, per-column consensus, repeated
    until the sequence stops changing).  Placements are hang estimates, so
    evidence windows carry ``slack`` that is aligned ends-free; after each
    round the placements are remapped through the segments' length
    changes, until the edit count dies out or ``rounds`` is reached.
    mode: "plurality" (the vote engine) or "dag" (the tag-chain consensus).
    """
    from .votepile import device_words

    dev = resolve_device(device)
    e_words, e_len_d = device_words(readset, dev)
    bgn = tig.bgn.astype(np.int64).copy()
    end = tig.end.astype(np.int64).copy()
    for _ in range(max(1, rounds)):
        backbone, bgn, end, n_edits = _polish_round(
            readset, e_words, e_len_d, tig, backbone, bgn, end,
            band=band, min_cov=min_cov, slack=slack, max_coverage=max_coverage, mode=mode,
        )
        if n_edits <= max(0, len(backbone) // 100_000):
            break
    # clip single-read contig ends: a tail covered by one read is
    # read-quality sequence that voting cannot improve, so the consensus
    # ends at the last 2-read column.  Single-read tigs keep their extent.
    if len(tig.read_id) >= 2 and len(backbone):
        B_len = len(backbone)
        delta = np.zeros(B_len + 1, np.int64)
        np.add.at(delta, np.clip(bgn, 0, B_len), 1)
        np.add.at(delta, np.clip(end, 0, B_len), -1)
        depth = np.cumsum(delta[:-1])
        good = np.flatnonzero(depth >= 2)
        if len(good):
            backbone = backbone[good[0] : good[-1] + 1]
    return backbone


def _polish_round(
    readset: ReadSet,
    e_words, e_len_d,
    tig: Tig,
    backbone: np.ndarray,
    bgn: np.ndarray,
    end: np.ndarray,
    band: int,
    min_cov: int,
    slack: int,
    max_coverage: int,
    mode: str = "plurality",
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """One repileup: segment the backbone, vote, apply edits, remap."""
    from .votepile import (
        BLOCK_POS_BUDGET,
        VoteJobs,
        _finalize_plurality,
        _pow2_at_least,
        decode_pieces,
        pile_votes,
        segment_codes_plane,
    )

    dev = e_words.device
    B_len = len(backbone)
    S = _POLISH_SEG
    if B_len == 0:
        return backbone, bgn, end, 0

    # stashContains (Canu src/utgcns/stashContains.C): longest placements
    # first, skip reads whose span is already max_coverage deep
    order = np.argsort(-(end - bgn), kind="stable")
    depth = np.zeros(B_len + 1, np.int32)
    keep_rows = []
    for i in order:
        lo = int(max(0, bgn[i]))
        hi = int(min(B_len, end[i]))
        if hi - lo < 100:
            continue
        if depth[lo:hi].min() >= max_coverage:
            continue
        depth[lo:hi] += 1
        keep_rows.append(i)
    if not keep_rows:
        return backbone, bgn, end, 0
    rows = np.array(keep_rows, np.int64)
    lo = np.clip(bgn[rows], 0, B_len)
    hi = np.clip(end[rows], 0, B_len)
    rid = tig.read_id[rows].astype(np.int64)
    rev = tig.rev[rows].astype(bool)
    ln = readset.length[rid - 1].astype(np.int64)

    # fan each read out to the segments it overlaps (columnar)
    j0 = lo // S
    j1 = np.maximum(lo, hi - 1) // S
    counts = (j1 - j0 + 1).astype(np.int64)
    job_read = np.repeat(np.arange(len(rows)), counts)
    js = (np.repeat(j0, counts)
          + (np.arange(len(job_read)) - np.repeat(np.cumsum(counts) - counts, counts)))
    s0 = js * S
    s1 = np.minimum(s0 + S, B_len)
    rlo, rhi = lo[job_read], hi[job_read]
    rln = ln[job_read]
    # window edges: at a read's own end, pull the template in by `slack`
    # (placement error must not force template past the actual read); at
    # a segment-interior edge, extend the evidence by `slack` instead
    rstart = rlo >= s0
    rend = rhi <= s1
    t_ab = np.where(rstart, np.minimum(rlo + slack, s1), s0)
    t_ae = np.where(rend, np.maximum(rhi - slack, t_ab), s1)
    e_b = np.clip(np.where(rstart, 0, t_ab - rlo - slack), 0, rln)
    e_e = np.clip(np.where(rend, rln, t_ae - rlo + slack), 0, rln)
    t_span = t_ae - t_ab
    e_span = e_e - e_b
    ok = (t_span >= 64) & (e_span >= np.maximum(64, t_span // 2))
    job_read, js = job_read[ok], js[ok]
    t_ab, t_span = t_ab[ok], t_span[ok]
    e_b, e_span = e_b[ok], e_span[ok]

    # template plane: the segments themselves
    n_seg = (B_len + S - 1) // S
    seg_codes = [backbone[j * S : min((j + 1) * S, B_len)] for j in range(n_seg)]
    t_words, t_len_d, pad_row = segment_codes_plane(seg_codes, S, dev)
    Lt = _pow2_at_least(S)

    if mode == "dag":
        # tag-chain consensus: each read's alignment path on the device,
        # the heaviest consistent chain on the host
        from .dagcon import dag_segments

        jobs = VoteJobs(
            t_idx=js.astype(np.int32),
            e_idx=(rid[job_read] - 1).astype(np.int32),
            t_bgn=(t_ab - js * S).astype(np.int32),
            t_span=t_span.astype(np.int32),
            e_lo=e_b.astype(np.int32),
            e_span=e_span.astype(np.int32),
            flipped=rev[job_read],
            slot=np.zeros(len(js), np.int32),
        )
        new_segs, n_edits = dag_segments(seg_codes, t_words, t_len_d, e_words, e_len_d, jobs,
                                         Lt=Lt, band=band, min_cov=min_cov)
        return _stitch_and_remap(new_segs, bgn, end, S, B_len, n_seg) + (n_edits,)

    G = max(8, min(256, BLOCK_POS_BUDGET // Lt))
    new_segs: list[np.ndarray] = [None] * n_seg  # type: ignore[list-item]
    n_edits = 0
    order_j = np.argsort(js, kind="stable")
    bounds = np.searchsorted(js[order_j], np.arange(0, n_seg + G, G))
    for bi, blk0 in enumerate(range(0, n_seg, G)):
        blk1 = min(blk0 + G, n_seg)
        take = order_j[bounds[bi] : bounds[bi + 1]]
        jobs = VoteJobs(
            t_idx=js[take].astype(np.int32),
            e_idx=(rid[job_read[take]] - 1).astype(np.int32),
            t_bgn=(t_ab[take] - js[take] * S).astype(np.int32),
            t_span=t_span[take].astype(np.int32),
            # e_b is already oriented (0 = the base placed at bgn): the
            # vote engine's e_lo convention in both orientations
            e_lo=e_b[take].astype(np.int32),
            e_span=e_span[take].astype(np.int32),
            flipped=rev[job_read[take]],
            slot=(js[take] - blk0).astype(np.int32),
        )
        votes = pile_votes(t_words, t_len_d, e_words, e_len_d, jobs, G, Lt, band=band,
                           ends_free=True)
        t_idx_block = np.full(G, pad_row, np.int32)
        t_idx_block[: blk1 - blk0] = np.arange(blk0, blk1, dtype=np.int32)
        packed, _cov = _finalize_plurality(t_words, t_len_d, torch.from_numpy(t_idx_block).to(dev),
                                           votes, float(min_cov), Lt, True)
        packed = packed.cpu().numpy()
        for g, j in enumerate(range(blk0, blk1)):
            row = packed[g, : len(seg_codes[j])]
            pieces = decode_pieces(row)
            sub = int(np.sum((row & 3) != seg_codes[j]))
            indel = int(np.sum(((row >> 5) & 3) != 0))  # delete/insert flags
            n_edits += sub + indel
            new_segs[j] = pieces[0][1] if pieces else seg_codes[j]

    nb, nbgn, nend = _stitch_and_remap(new_segs, bgn, end, S, B_len, n_seg)
    return nb, nbgn, nend, n_edits


def _stitch_and_remap(
    new_segs: list[np.ndarray],
    bgn: np.ndarray,
    end: np.ndarray,
    S: int,
    B_len: int,
    n_seg: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate polished segments and remap read placements through
    the per-segment length changes (proportional within a segment)."""
    new_lens = np.array([len(s) for s in new_segs], np.int64)
    new_off = np.zeros(n_seg + 1, np.int64)
    np.cumsum(new_lens, out=new_off[1:])
    new_backbone = np.concatenate(new_segs) if n_seg else np.zeros(0, np.uint8)

    def remap(pos: np.ndarray) -> np.ndarray:
        p = np.clip(pos, 0, B_len)
        j = np.minimum(p // S, n_seg - 1)
        old_len = np.minimum((j + 1) * S, B_len) - j * S
        frac = (p - j * S) / np.maximum(old_len, 1)
        return (new_off[j] + np.round(frac * new_lens[j])).astype(np.int64)

    return new_backbone, remap(bgn), remap(end)
