"""Falcon-sense read correction (counterpart of canu_tpu.ops.falcon, the
``falcon`` consensus mode).

The reference's correction value chain — generateCorrectionLayouts
(evidence pick by score), filterCorrectionLayouts (which reads to
correct: longest first up to corOutCoverage x genomeSize) and
falconsense (alignTag weighted plurality voting) — on the device vote
engine (ops.votepile):

  * evidence selection is one columnar numpy pass over the overlap store;
  * templates are cut into VOTE_SEG-base segments, packed whole into
    blocks of up to G segments; each block's evidence windows are aligned
    and voted on the device, and one packed decision per template column
    comes back;
  * the corrected read is the plurality call over positions with
    coverage >= min_cov, split into pieces at low-coverage gaps as
    falcon-sense splits uncorrectable regions.

Block indices are deterministic for a given store and configuration, so
a caller persists each block's output and resumes with ``done_blocks``.
``mode="dag"`` (corConsensus=dag) runs the same blocks through the
tag-chain consensus of ops.dagcon instead of the plurality.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..stores.overlaps import OverlapStore
from ..stores.readset import ReadSet
from ..utils import bitpack
from . import votepile
from .hashing import u32_tensor
from .votepile import (
    VoteJobs,
    _finalize_plurality,
    decode_pieces,
    device_words,
    pile_votes,
)


def select_templates(rs: ReadSet, genome_size: float, out_coverage: int) -> np.ndarray:
    """Longest reads first until out_coverage * genome_size total bases
    (filterCorrectionLayouts.C:383-384 semantics). 1-based ids."""
    order = np.argsort(-rs.length, kind="stable")
    csum = np.cumsum(rs.length[order])
    n_keep = int(np.searchsorted(csum, out_coverage * genome_size)) + 1
    ids = np.sort(order[:n_keep] + 1)
    return ids.astype(np.int32)


def select_templates_expensive(rs: ReadSet, st: OverlapStore, genome_size: float,
                               out_coverage: int) -> np.ndarray:
    """corFilter=expensive: rank reads by expected corrected length — the
    evidence-covered portion of the read — instead of raw length.  Budget
    = out_coverage * genome_size of expected corrected bases.  1-based
    ids."""
    from ..utils.intervals import covered_intervals_all

    own, b, e = covered_intervals_all(st.a_id, st.a_bgn, st.a_end, 1)
    cov_len = np.zeros(rs.n_reads + 1, np.int64)
    np.add.at(cov_len, own, e - b)
    score = np.minimum(rs.length.astype(np.int64), cov_len[1:])
    order = np.argsort(-score, kind="stable")
    csum = np.cumsum(score[order])
    n_keep = int(np.searchsorted(csum, out_coverage * genome_size)) + 1
    ids = np.sort(order[:n_keep] + 1).astype(np.int32)
    return ids[score[ids - 1] > 0]


def select_evidence_rows(
    st: OverlapStore,
    template_ids: np.ndarray,
    lengths: np.ndarray,
    max_evidence_coverage: int,
    min_evidence_length: int,
    max_evidence_erate: float = 0.0,
) -> np.ndarray:
    """Store row indices of the evidence kept per template: best-scoring
    overlaps first until the per-template coverage budget
    (corMaxEvidenceCoverage), as one columnar pass over the store.
    max_evidence_erate > 0 drops noisier evidence first
    (corMaxEvidenceErate)."""
    is_tpl = np.zeros(st.n_reads + 2, bool)
    is_tpl[template_ids] = True
    rows = np.flatnonzero(is_tpl[st.a_id])
    if len(rows) == 0:
        return rows
    span = (st.a_end[rows] - st.a_bgn[rows]).astype(np.int64)
    ok = span >= max(100, min_evidence_length, 1)
    if max_evidence_erate > 0:
        ok &= st.erate_q[rows] <= int(max_evidence_erate * 10000)
    rows, span = rows[ok], span[ok]
    a = st.a_id[rows]
    score = span * (1.0 - st.erate_q[rows].astype(np.float64) / 10000.0)
    order = np.lexsort((-score, a))
    rows, span, a = rows[order], span[order], a[order]
    # segmented prefix sums: evidence bases already accepted for this
    # template before this row
    new_seg = np.concatenate([[True], a[1:] != a[:-1]])
    cs = np.cumsum(span)
    seg_off = np.maximum.accumulate(np.where(new_seg, cs - span, 0))
    acc_prev = (cs - span) - seg_off
    budget = max_evidence_coverage * lengths[a - 1].astype(np.int64)
    return rows[acc_prev < budget]


def evidence_vote_jobs(st: OverlapStore, rows: np.ndarray, lengths: np.ndarray,
                       mean_qv: np.ndarray | None = None) -> VoteJobs:
    """Store rows -> columnar vote jobs (oriented evidence coordinates).

    With per-read mean QVs (raw FASTQ input), each evidence job's votes
    weigh 1 + meanQV/256: a quality tie-break at ~1-phred granularity."""
    tid = st.a_id[rows]
    b_id = st.b_id[rows]
    fl = st.flipped[rows]
    t_bgn = st.a_bgn[rows].astype(np.int32)
    t_span = (st.a_end[rows] - st.a_bgn[rows]).astype(np.int32)
    lb = lengths[b_id - 1].astype(np.int32)
    e_lo = np.where(fl, lb - st.b_end[rows], st.b_bgn[rows]).astype(np.int32)
    e_span = (st.b_end[rows] - st.b_bgn[rows]).astype(np.int32)
    keep = (e_span > 0) & (t_span > 0)
    weight = None
    if mean_qv is not None:
        weight = (1.0 + mean_qv[b_id[keep] - 1] / 256.0).astype(np.float32)
    return VoteJobs(
        t_idx=(tid[keep] - 1).astype(np.int32),
        e_idx=(b_id[keep] - 1).astype(np.int32),
        t_bgn=t_bgn[keep],
        t_span=t_span[keep],
        e_lo=e_lo[keep],
        e_span=e_span[keep],
        flipped=fl[keep].astype(bool),
        slot=np.zeros(int(keep.sum()), np.int32),  # filled per block
        weight=weight,
    )


# Canonical vote geometry: templates are cut into VOTE_SEG-base segments
# that become template rows of the vote engine, one shape whatever the
# read length (the forward rows of a chunk are n_rows x B x window bytes)
VOTE_SEG = 2048
# evidence slack at interior cut points: segment-boundary evidence
# coordinates interpolate the overlap's endpoints, so the true path
# enters the window up to the local indel drift away; below band // 2
VOTE_SEG_SLACK = 96


def _segment_table(lengths: np.ndarray, template_ids: np.ndarray, S: int):
    """Per-template segment counts and row offsets (template_ids order)."""
    tl = lengths[template_ids - 1].astype(np.int64)
    nseg = np.maximum(1, -(-tl // S)).astype(np.int64)
    row0 = np.zeros(len(template_ids) + 1, np.int64)
    np.cumsum(nseg, out=row0[1:])
    return tl, nseg, row0


def _segment_plane(rs: ReadSet, template_ids: np.ndarray, nseg: np.ndarray,
                   row0: np.ndarray, S: int, device):
    """Device plane of template segments: [R(pow2), S/16] packed words
    (int64 holding uint32).

    Segments are word-aligned slices of the read words (S % 16 == 0).
    Rows are padded to a power of two, at least 1,024; the last row is
    all-zero pad.  Returns (t_words, seg_len on the device, seg_len on
    the host, pad_row)."""
    from ..utils.bitpack import BASES_PER_WORD

    SW = S // BASES_PER_WORD
    n_total = int(row0[-1])
    seg_t = np.repeat(np.arange(len(template_ids)), nseg)  # template order idx
    seg_k = np.arange(n_total) - np.repeat(row0[:-1], nseg)
    tid0 = template_ids[seg_t].astype(np.int64) - 1
    seg_len = np.minimum(S, rs.length[tid0].astype(np.int64) - seg_k * S).astype(np.int32)
    src_w0 = rs.word_off[tid0] + seg_k * SW
    nw = (seg_len.astype(np.int64) + BASES_PER_WORD - 1) // BASES_PER_WORD
    col = np.arange(SW, dtype=np.int64)
    idx = src_w0[:, None] + col[None, :]
    valid = col[None, :] < nw[:, None]
    words_src = np.asarray(rs.words)
    plane_rows = np.where(valid, words_src[np.clip(idx, 0, len(words_src) - 1)],
                          np.uint32(0)).astype(np.uint32)
    R = max(1024, 1 << max(0, int(n_total).bit_length()))
    plane = np.zeros((R, SW), np.uint32)
    plane[:n_total] = plane_rows
    len_plane = np.zeros(R, np.int32)
    len_plane[:n_total] = seg_len
    return (u32_tensor(plane, device), torch.from_numpy(len_plane).to(device), seg_len,
            R - 1)


def _segment_jobs(jobs: VoteJobs, row0: np.ndarray, tpos: np.ndarray, S: int,
                  slack: int) -> VoteJobs:
    """Split evidence jobs at template segment boundaries (columnar).

    t_idx of the result indexes segment plane rows.  Interior cut points
    get linearly interpolated evidence coordinates, widened by ``slack``
    (the alignment is ends-free, so extra evidence at a cut costs
    nothing; too little would force-fit the path)."""
    t_end = (jobs.t_bgn + jobs.t_span).astype(np.int64)
    t_bgn = jobs.t_bgn.astype(np.int64)
    k0 = t_bgn // S
    k1 = np.maximum(t_bgn, t_end - 1) // S
    cnt = (k1 - k0 + 1).astype(np.int64)
    J = np.repeat(np.arange(len(jobs)), cnt)
    k = k0[J] + (np.arange(len(J)) - np.repeat(np.cumsum(cnt) - cnt, cnt))
    a = np.maximum(t_bgn[J], k * S)
    b = np.minimum(t_end[J], (k + 1) * S)
    sp = np.maximum(jobs.t_span[J].astype(np.int64), 1)
    e_lo = jobs.e_lo[J].astype(np.int64)
    e_span = jobs.e_span[J].astype(np.int64)
    ej_a = e_lo + (a - t_bgn[J]) * e_span // sp
    ej_b = e_lo + (b - t_bgn[J]) * e_span // sp
    e_b = np.maximum(ej_a - np.where(a > t_bgn[J], slack, 0), e_lo)
    e_e = np.minimum(ej_b + np.where(b < t_end[J], slack, 0), e_lo + e_span)
    keep = (b > a) & (e_e > e_b)
    seg_row = (row0[tpos[jobs.t_idx[J] + 1]] + k).astype(np.int32)
    return VoteJobs(
        t_idx=seg_row[keep],
        e_idx=jobs.e_idx[J][keep],
        t_bgn=(a - k * S)[keep].astype(np.int32),
        t_span=(b - a)[keep].astype(np.int32),
        e_lo=e_b[keep].astype(np.int32),
        e_span=(e_e - e_b)[keep].astype(np.int32),
        flipped=jobs.flipped[J][keep],
        slot=np.zeros(int(keep.sum()), np.int32),  # filled per chapter
        weight=None if jobs.weight is None else jobs.weight[J][keep],
    )


def _pack_template_blocks(template_ids: np.ndarray, tl: np.ndarray, nseg: np.ndarray,
                          G: int) -> list[np.ndarray]:
    """Pack whole templates (longest first) into blocks of <= G segments.

    A template with more than G segments gets a block of its own (its
    chapters loop inside run_vote_blocks).  Returns template-order index
    arrays: the job-array partition of the reference's
    CorrectReads.pm:122-141."""
    order = np.argsort(-tl, kind="stable")
    blocks: list[np.ndarray] = []
    cur: list[int] = []
    cur_n = 0
    for i in order:
        k = int(nseg[i])
        if k > G:
            blocks.append(np.array([i], dtype=np.int64))
            continue
        if cur_n + k > G:
            blocks.append(np.array(cur, dtype=np.int64))
            cur, cur_n = [], 0
        cur.append(int(i))
        cur_n += k
    if cur:
        blocks.append(np.array(cur, dtype=np.int64))
    return blocks


# host wall seconds of the correction's parts, summed over the blocks it
# ran: template and evidence selection, the block geometry, enqueueing
# the vote chunks and the finalize, fetching the packed rows (which waits
# for the device) and decoding them; and correction_phase's own: writing
# the block files, concatenating them and re-reading the whole gzip to
# count its records; the chip check reads them
PROFILE: dict = {}


def _lap(name: str, t0: float) -> float:
    now = time.perf_counter()
    PROFILE[name] = PROFILE.get(name, 0.0) + (now - t0)
    return now


def run_vote_blocks(rs: ReadSet, jobs: VoteJobs, template_ids: np.ndarray, band: int,
                    finalize, skip=frozenset(), device=None):
    """Shared block loop on the canonical segment geometry.

    Cuts templates into VOTE_SEG-base segments, piles votes per chapter
    of <= G segments on the device, finalizes (a callable (t_words,
    t_lens, t_idx, votes, Lt) -> device tensor [G, Lt]), stitches
    segment rows back into full-read rows, and yields (block_index,
    tids, rows2d[len(tids), max_len]) per block.  ``skip`` suppresses
    all device work for those block indices (resume)."""
    dev = resolve_device(device)
    S, slack = VOTE_SEG, VOTE_SEG_SLACK
    G = max(8, min(256, votepile.BLOCK_POS_BUDGET // S))
    t0 = time.perf_counter()
    words_d, len_d = device_words(rs, dev)
    tl, nseg, row0 = _segment_table(rs.length, template_ids, S)
    tpos = np.zeros(rs.n_reads + 1, np.int64)
    tpos[template_ids] = np.arange(len(template_ids))
    t_words, t_len_d, seg_len, pad_row = _segment_plane(rs, template_ids, nseg, row0, S, dev)
    sjobs = _segment_jobs(jobs, row0, tpos, S, slack)

    blocks = _pack_template_blocks(template_ids, tl, nseg, G)
    n_total = int(row0[-1])
    # seg row -> (global chapter, slot): chapters are consecutive G-slices
    # of each block's segment-row list
    chap_of = np.zeros(n_total, np.int64)
    slot_of = np.zeros(n_total, np.int32)
    chapters_per_block: list[int] = []
    gchap = 0
    for tsel in blocks:
        seg_rows = np.concatenate([np.arange(row0[i], row0[i] + nseg[i]) for i in tsel])
        n_ch = -(-len(seg_rows) // G)
        for c in range(n_ch):
            ch = seg_rows[c * G : (c + 1) * G]
            chap_of[ch] = gchap
            slot_of[ch] = np.arange(len(ch), dtype=np.int32)
            gchap += 1
        chapters_per_block.append(n_ch)
    jc = chap_of[sjobs.t_idx]
    order = np.argsort(jc, kind="stable")
    bounds = np.searchsorted(jc[order], np.arange(gchap + 1))
    t0 = _lap("setup", t0)

    gchap = 0
    for bi, tsel in enumerate(blocks):
        n_ch = chapters_per_block[bi]
        if bi in skip:
            gchap += n_ch
            continue
        seg_rows = np.concatenate([np.arange(row0[i], row0[i] + nseg[i]) for i in tsel])
        chapter_res: list[np.ndarray] = []
        for c in range(n_ch):
            ch = seg_rows[c * G : (c + 1) * G]
            take = order[bounds[gchap] : bounds[gchap + 1]]
            gchap += 1
            cjobs = VoteJobs(
                t_idx=sjobs.t_idx[take],
                e_idx=sjobs.e_idx[take],
                t_bgn=sjobs.t_bgn[take],
                t_span=sjobs.t_span[take],
                e_lo=sjobs.e_lo[take],
                e_span=sjobs.e_span[take],
                flipped=sjobs.flipped[take],
                slot=slot_of[sjobs.t_idx[take]],
                weight=None if sjobs.weight is None else sjobs.weight[take],
            )
            t0 = time.perf_counter()
            votes = pile_votes(t_words, t_len_d, words_d, len_d, cjobs, G, S, band=band,
                               ends_free=True)
            t0 = _lap("votes", t0)
            t_idx_block = np.full(G, pad_row, np.int32)
            t_idx_block[: len(ch)] = ch
            res = finalize(t_words, t_len_d, torch.from_numpy(t_idx_block).to(dev), votes, S)
            t0 = _lap("finalize", t0)
            chapter_res.append(res.cpu().numpy())
            t0 = _lap("fetch", t0)
        # stitch segment rows back into full-read rows
        max_len = int(tl[tsel].max())
        dt = chapter_res[0].dtype if chapter_res else np.int32
        rows2d = np.zeros((len(tsel), max_len), dt)
        pos = 0  # running index into the block's seg_rows
        for g, i in enumerate(tsel):
            off = 0
            for _k in range(int(nseg[i])):
                c, s = divmod(pos, G)
                sl = int(seg_len[row0[i] + _k])
                rows2d[g, off : off + sl] = chapter_res[c][s, :sl]
                off += sl
                pos += 1
        yield bi, template_ids[tsel], rows2d


def correct_reads(rs: ReadSet, st: OverlapStore, genome_size: float, out_coverage: int = 40,
                  max_evidence_coverage: int = 40, min_evidence_length: int = 0,
                  band: int = 256, min_cov: int = 4, min_piece: int = 1000,
                  qv_weight: bool = True, max_evidence_erate: float = 0.0,
                  mode: str = "falcon", device=None) -> Iterator[tuple[str, str]]:
    """Yield (name, corrected_sequence) for the selected templates."""
    for _bi, items in correct_reads_blocks(
        rs, st, genome_size, out_coverage, max_evidence_coverage, min_evidence_length,
        band, min_cov, min_piece, qv_weight, max_evidence_erate=max_evidence_erate,
        mode=mode, device=device,
    ):
        yield from items


def correct_reads_blocks(
    rs: ReadSet,
    st: OverlapStore,
    genome_size: float,
    out_coverage: int = 40,
    max_evidence_coverage: int = 40,
    min_evidence_length: int = 0,
    band: int = 256,
    min_cov: int = 4,
    min_piece: int = 1000,
    qv_weight: bool = True,
    done_blocks=frozenset(),
    max_evidence_erate: float = 0.0,
    mode: str = "falcon",
    template_filter: str = "quick",
    device=None,
) -> Iterator[tuple[int, list[tuple[str, str]]]]:
    """Yield (block_index, [(name, corrected_seq), ...]) per template block
    on ``device``.  Block indices are deterministic for a given
    store + config; ``done_blocks`` skips blocks a caller already holds.

    mode: 'falcon' (device vote piles + per-column plurality) or 'dag' (the
    tag-chain consensus, the reference's corConsensus selection).
    template_filter: 'quick' (raw length) or 'expensive' (evidence-covered
    length)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if template_filter == "expensive":
        template_ids = select_templates_expensive(rs, st, genome_size, out_coverage)
    else:
        template_ids = select_templates(rs, genome_size, out_coverage)
    rows = select_evidence_rows(st, template_ids, rs.length, max_evidence_coverage,
                                min_evidence_length, max_evidence_erate)
    mean_qv = rs.mean_quals() if (qv_weight and rs.has_quals) else None
    jobs = evidence_vote_jobs(st, rows, rs.length, mean_qv=mean_qv)
    # only templates with any evidence produce output (falcon-sense skips
    # evidence-free reads)
    has_ev = np.zeros(rs.n_reads + 1, bool)
    has_ev[jobs.t_idx + 1] = True
    template_ids = template_ids[has_ev[template_ids]]
    _lap("select", t0)
    if len(template_ids) == 0:
        return
    if mode == "dag":
        yield from _dag_correct_blocks(rs, jobs, template_ids, band, min_cov, min_piece,
                                       done_blocks, dev)
        return

    def finalize(words_d, len_d, t_idx, votes, Lt):
        packed, _cov = _finalize_plurality(words_d, len_d, t_idx, votes, float(min_cov), Lt,
                                           False)
        return packed

    for bi, bt, packed in run_vote_blocks(rs, jobs, template_ids, band, finalize,
                                          skip=done_blocks, device=dev):
        t0 = time.perf_counter()
        items: list[tuple[str, str]] = []
        for g, tid in enumerate(bt):
            row = packed[g, : int(rs.length[tid - 1])]
            out_idx = 0
            for _pos, seq in decode_pieces(row):
                if len(seq) < min_piece:
                    continue
                items.append((f"{rs.name(int(tid))}_corr{out_idx}", bitpack.codes_to_seq(seq)))
                out_idx += 1
        _lap("decode", t0)
        yield bi, items


def _dag_correct_blocks(rs: ReadSet, jobs: VoteJobs, template_ids: np.ndarray, band: int,
                        min_cov: int, min_piece: int, done_blocks, device
                        ) -> Iterator[tuple[int, list[tuple[str, str]]]]:
    """Tag-chain correction (corConsensus=dag) on ``device``: the template
    blocks and segment geometry of the vote path, each template's
    consensus the heaviest consistent tag chain of ops.dagcon instead of
    the per-column plurality, pieces split where the chain's evidence
    coverage drops below min_cov."""
    from .dagcon import paths_for_jobs, segment_consensus

    S, slack = VOTE_SEG, VOTE_SEG_SLACK
    G = max(8, min(256, votepile.BLOCK_POS_BUDGET // S))
    words_d, len_d = device_words(rs, device)
    tl, nseg, row0 = _segment_table(rs.length, template_ids, S)
    tpos = np.zeros(rs.n_reads + 1, np.int64)
    tpos[template_ids] = np.arange(len(template_ids))
    t_words, t_len_d, seg_len, _pad_row = _segment_plane(rs, template_ids, nseg, row0, S,
                                                         device)
    sjobs = _segment_jobs(jobs, row0, tpos, S, slack)
    blocks = _pack_template_blocks(template_ids, tl, nseg, G)
    order = np.argsort(sjobs.t_idx, kind="stable")
    bounds = np.searchsorted(sjobs.t_idx[order], np.arange(int(row0[-1]) + 1))

    for bi, tsel in enumerate(blocks):
        if bi in done_blocks:
            continue
        # one batch of paths for the whole block's evidence jobs
        parts: list[np.ndarray] = []
        seg_slice: dict[int, tuple[int, int]] = {}
        off = 0
        for i in tsel:
            for k in range(int(nseg[i])):
                srow = int(row0[i]) + k
                t = order[bounds[srow] : bounds[srow + 1]]
                seg_slice[srow] = (off, off + len(t))
                parts.append(t)
                off += len(t)
        btake = np.concatenate(parts) if parts else np.zeros(0, np.int64)
        bjobs = VoteJobs(
            t_idx=sjobs.t_idx[btake], e_idx=sjobs.e_idx[btake],
            t_bgn=sjobs.t_bgn[btake], t_span=sjobs.t_span[btake],
            e_lo=sjobs.e_lo[btake], e_span=sjobs.e_span[btake],
            flipped=sjobs.flipped[btake], slot=np.zeros(len(btake), np.int32),
        )
        js, e_sub = paths_for_jobs(t_words, t_len_d, words_d, len_d, bjobs, S, band)
        items: list[tuple[str, str]] = []
        for i in tsel:
            tid = int(template_ids[i])
            pieces_codes: list[np.ndarray] = []
            pieces_cov: list[np.ndarray] = []
            for k in range(int(nseg[i])):
                srow = int(row0[i]) + k
                take = np.arange(*seg_slice[srow])
                tmpl = rs.get_codes(tid)[k * S : k * S + int(seg_len[srow])]
                if len(take) == 0:
                    pieces_codes.append(tmpl)
                    pieces_cov.append(np.zeros(len(tmpl), np.int64))
                    continue
                seg, cov, _ed = segment_consensus(tmpl, bjobs, take, js, e_sub, min_cov)
                pieces_codes.append(seg)
                pieces_cov.append(cov)
            full = np.concatenate(pieces_codes) if pieces_codes else np.zeros(0, np.uint8)
            cov = np.concatenate(pieces_cov) if pieces_cov else np.zeros(0, np.int64)
            # split at unsupported columns (the falcon path's decode_pieces
            # low-coverage splitting)
            sup = (cov >= min_cov).astype(np.int8)
            padded = np.concatenate([[0], sup, [0]])
            starts = np.flatnonzero((padded[:-1] == 0) & (padded[1:] == 1))
            ends = np.flatnonzero((padded[:-1] == 1) & (padded[1:] == 0))
            out_idx = 0
            for b, e in zip(starts, ends):
                if e - b < min_piece:
                    continue
                items.append((f"{rs.name(tid)}_corr{out_idx}", bitpack.codes_to_seq(full[b:e])))
                out_idx += 1
        yield bi, items
