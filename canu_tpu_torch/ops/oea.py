"""Overlap error adjustment: RED + OEA (counterpart of canu_tpu.ops.oea,
the reference's findErrors / correctOverlaps).

  * detect_read_errors ("RED", Canu src/overlapErrorAdjustment/
    findErrors.C:374-510): every read is re-examined against its overlap
    pile on the vote engine (ops.votepile, PyTorch ops on ``device``);
    positions where the evidence contradicts the read's own base with
    enough support (Vote_Qualify) become substitutions;
  * apply_corrections: the substitutions as bit surgery on the packed
    words (lengths unchanged, so every overlap coordinate stays valid);
  * adjust_overlap_erates ("OEA", correctOverlaps.C:156-215): every
    overlap (or, with only_changed, every overlap touching a corrected
    read) is verified again between the corrected reads and the new
    erates become the store's adjusted erate column.  At band 128 the
    verify runs the Myers engine: kernel K1 on CUDA tensors.

Same arguments and results as canu_tpu's, plus ``device=``.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from ..stores.overlaps import OverlapStore
from ..stores.readset import ReadSet
from .falcon import evidence_vote_jobs, run_vote_blocks, select_evidence_rows
from .votepile import _finalize_red


def detect_read_errors(
    rs: ReadSet,
    st: OverlapStore,
    max_evidence_coverage: int = 40,
    min_alt_votes: int = 4,
    max_own_votes: int = 1,
    band: int = 256,
    device=None,
) -> dict[int, np.ndarray]:
    """RED: per-read substitution corrections from overlap-pile votes.

    Returns {read_id: int32[M, 2] of (position, corrected_base_code)}.
    A position is corrected when an alternative base gets >=
    min_alt_votes while the read's own base keeps <= max_own_votes.
    """
    dev = resolve_device(device)
    per = st.n_overlaps_per_read()
    ids = (np.flatnonzero(per > 0) + 1).astype(np.int32)
    if len(ids) == 0:
        return {}
    rows = select_evidence_rows(st, ids, rs.length, max_evidence_coverage, 0)
    jobs = evidence_vote_jobs(st, rows, rs.length)
    has_ev = np.zeros(rs.n_reads + 1, bool)
    has_ev[jobs.t_idx + 1] = True
    ids = ids[has_ev[ids]]
    if len(ids) == 0:
        return {}

    def finalize(words_d, len_d, t_idx, votes, Lt):
        return _finalize_red(words_d, len_d, t_idx, votes, float(min_alt_votes),
                             float(max_own_votes), Lt)

    out: dict[int, np.ndarray] = {}
    for _bi, bt, packed in run_vote_blocks(rs, jobs, ids, band, finalize, device=dev):
        live = packed[: len(bt)]
        gg, pp = np.nonzero((live >> 2) & 1)  # fix positions (masked on the device)
        if len(gg) == 0:
            continue
        alt = (live[gg, pp] & 3).astype(np.int32)
        cut = np.searchsorted(gg, np.arange(len(bt) + 1))
        for g in np.unique(gg):
            s, e = cut[g], cut[g + 1]
            out[int(bt[g])] = np.stack([pp[s:e].astype(np.int32), alt[s:e]], axis=1)
    return out


def apply_corrections(rs: ReadSet, corrections: dict[int, np.ndarray]) -> ReadSet:
    """Corrected copy of the read set: substitutions in place on the packed
    words, grouped by lane within the word so no two writes collide."""
    words = rs.words.copy()
    if corrections:
        rid = np.concatenate([np.full(len(v), k, np.int64) for k, v in corrections.items()])
        pos = np.concatenate([v[:, 0] for v in corrections.values()]).astype(np.int64)
        base = np.concatenate([v[:, 1] for v in corrections.values()]).astype(np.uint32)
        w = rs.word_off[rid - 1] + pos // 16
        lane = (pos % 16).astype(np.int64)
        for sh in range(16):
            m = lane == sh
            if not m.any():
                continue
            wi = w[m]
            mask = np.uint32(~(np.uint32(3) << np.uint32(2 * sh)) & 0xFFFFFFFF)
            words[wi] = (words[wi] & mask) | (base[m] << np.uint32(2 * sh))
    names = list(rs.names) if rs.names else None
    return ReadSet(words, rs.word_off, rs.length, names, rs.source_id, rs.source_bgn)


def adjust_overlap_erates(
    rs: ReadSet,
    st: OverlapStore,
    corrections: dict[int, np.ndarray],
    band: int = 128,
    chunk: int = 512,
    only_changed: bool = False,
    device=None,
) -> np.ndarray:
    """OEA: verify overlaps again between the corrected reads.

    Returns the new uint16 erate_q column aligned with the store's rows
    (both mirror copies), for st.update_erates.  Erates are recomputed
    (they can rise, as in correctOverlaps.C); a row keeps its old value
    only where the new verify's span fell below half the stored span (a
    banding failure, not a measurement).  only_changed=True verifies only
    the overlaps with a corrected read at either end
    (correctOverlaps.C:156-178 Correct_Frags -> Redo_Olaps).
    """
    from .align import verify_overlaps
    from .minhash import OverlapCandidates
    from .minimizers import corrected_read_index, get_read_index

    dev = resolve_device(device)
    if not len(st.a_id):
        return st.erate_q.copy()
    rs_fixed = apply_corrections(rs, corrections)
    # substitutions keep lengths and syncmer geometry: the original read
    # set's cached seed index with the corrected word plane
    idx = corrected_read_index(get_read_index(rs, k=16, device=dev), rs_fixed)
    half = st.a_id < st.b_id  # one direction; mirror rows share the erate
    if only_changed:
        changed = np.zeros(st.n_reads + 1, bool)
        for rid in corrections:
            changed[rid] = True
        half = half & (changed[st.a_id] | changed[st.b_id])
        if not half.any():
            return st.erate_q.copy()
    z = np.zeros(int(half.sum()), np.int32)
    cand = OverlapCandidates(
        a_id=st.a_id[half].astype(np.int32), b_id=st.b_id[half].astype(np.int32),
        flipped=st.flipped[half], diag=z, n_shared=z, a_lo=z, a_hi=z, b_lo=z, b_hi=z,
    )
    ov = verify_overlaps(rs_fixed, cand, band=band, max_erate=1.0, min_overlap=0,
                         chunk=chunk, index=idx, device=dev)
    out = st.erate_q.copy()
    if len(ov) == 0:
        return out
    M = np.int64(st.n_reads + 1)
    a64 = ov.a_id.astype(np.int64)
    b64 = ov.b_id.astype(np.int64)
    ov_key = np.minimum(a64, b64) * M + np.maximum(a64, b64)
    ov_span = np.minimum(ov.a_end - ov.a_bgn, ov.b_end - ov.b_bgn).astype(np.int64)
    sk = np.argsort(ov_key, kind="stable")
    ov_key_s = ov_key[sk]
    sa64 = st.a_id.astype(np.int64)
    sb64 = st.b_id.astype(np.int64)
    st_key = np.minimum(sa64, sb64) * M + np.maximum(sa64, sb64)
    pos = np.searchsorted(ov_key_s, st_key)
    posc = np.minimum(pos, len(sk) - 1)
    found = ov_key_s[posc] == st_key
    match = sk[posc]
    old_span = (st.a_end - st.a_bgn).astype(np.int64)
    ok = found & (ov_span[match] * 2 >= old_span)
    out[ok] = ov.erate_q[match[ok]]
    return out
