"""Repeat detection and tig splitting (markRepeatReads equivalent).

The port's own copy of canu_tpu.graph.repeats (no torch, no jax), with the same
results.

Re-implements the repeat phase of the reference bogart
(Canu src/bogart/AS_BAT_MarkRepeatReads.C, driven at
bogart.C:498-529: build the full AssemblyGraph of alternate read
placements, annotate tig intervals covered by external evidence, then
break tigs at repeat boundaries whose boundary reads are "confused" —
an external edge scores nearly as well as the chosen internal edge,
thresholds -ca/-cp) plus the follow-up cleanup splitDiscontinuous
(bogart.C:540-560, AS_BAT_SplitDiscontinuous.C).

Redesign notes (host-side numpy over the device-verified store):

  * the reference's AssemblyGraph stores every read's alternate
    placements; here the placements are PROJECTED from the symmetric
    OverlapStore in ONE columnar pass over the whole store — each
    overlap row (a in tig T, b elsewhere) projects b's aligned span
    into T's coordinates, which is exactly the annotation interval
    markRepeatReads builds;
  * repeat regions = union of external-evidence projections supported
    by >= min_evidence distinct external reads (vectorized interval
    merge + distinct count);
  * per-read best internal/external edge scores are precomputed with
    segmented maxima over the store's row index (the store is sorted by
    a_id), so the confused test (-ca/-cp) is a pure array expression;
  * breaks happen between reads: every read keeps one piece (midpoint
    rule), then splitDiscontinuous re-partitions any piece whose reads
    no longer tile contiguously.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stores.overlaps import OverlapStore
from ..stores.tigs import CLASS_CONTIG, CLASS_UNASSEMBLED, Tig, TigStore


@dataclass
class RepeatRegion:
    tig_id: int
    bgn: int
    end: int
    n_evidence: int
    broke: bool


def tig_read_index(tigs: TigStore, n_reads: int):
    """Per-read tig id + placement arrays (0 = unplaced)."""
    tig_of = np.zeros(n_reads + 1, np.int32)
    lo = np.zeros(n_reads + 1, np.int32)
    hi = np.zeros(n_reads + 1, np.int32)
    rev = np.zeros(n_reads + 1, bool)
    for t in tigs:
        tig_of[t.read_id] = t.tig_id
        lo[t.read_id] = t.bgn
        hi[t.read_id] = t.end
        rev[t.read_id] = t.rev
    return tig_of, lo, hi, rev


def _seg_max(v: np.ndarray, index: np.ndarray, n_reads: int) -> np.ndarray:
    """out[r] = max(v[index[r]:index[r+1]]) or 0 for empty — reduceat."""
    out = np.zeros(n_reads + 1, np.float64)
    if len(v) == 0:
        return out
    starts = np.minimum(index[: n_reads + 1], len(v) - 1)
    red = np.maximum.reduceat(v, starts)
    nonempty = index[: n_reads + 1] < index[1 : n_reads + 2]
    out[nonempty] = red[nonempty]
    return out


def read_best_scores(
    store: OverlapStore, tig_of: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Per-read (best internal, best external) edge scores, one pass.

    Score = span * (1 - erate), the BestOverlapGraph edge score; an edge
    is internal when both reads sit in the same tig.
    """
    sc = (store.a_end - store.a_bgn).astype(np.float64) * (1.0 - store.erate)
    a_t = tig_of[store.a_id]
    internal = (tig_of[store.b_id] == a_t) & (a_t > 0)
    best_int = _seg_max(np.where(internal, sc, 0.0), store.index, store.n_reads)
    best_ext = _seg_max(np.where(internal, 0.0, sc), store.index, store.n_reads)
    return best_int, best_ext


def _external_projections(
    store: OverlapStore,
    tig_of: np.ndarray,
    p_lo: np.ndarray,
    p_hi: np.ndarray,
    p_rev: np.ndarray,
    max_erate: float | None = None,
):
    """All external-evidence rows projected into their a-read's tig.

    Returns (tig_id, t_lo, t_hi, ext_read_id) arrays sorted by tig_id —
    one columnar pass over the whole symmetric store.
    """
    a_t = tig_of[store.a_id]
    ext = (a_t > 0) & (tig_of[store.b_id] != a_t)
    if max_erate is not None:
        ext &= store.erate <= max_erate
    rows = np.flatnonzero(ext)
    a = store.a_id[rows]
    rev = p_rev[a]
    a_bgn = store.a_bgn[rows].astype(np.int64)
    a_end = store.a_end[rows].astype(np.int64)
    t_lo = np.where(rev, p_hi[a] - a_end, p_lo[a] + a_bgn)
    t_hi = np.where(rev, p_hi[a] - a_bgn, p_lo[a] + a_end)
    tid = a_t[rows]
    order = np.argsort(tid, kind="stable")
    return tid[order], t_lo[order], t_hi[order], store.b_id[rows][order]


def _merged_regions(lo: np.ndarray, hi: np.ndarray, ids: np.ndarray):
    """Vectorized interval union + distinct-id count per merged run.

    Each input interval lies in exactly one merged run, so the distinct
    count per run is a unique-pair count.  Returns (lo, hi, n_distinct).
    """
    if len(lo) == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    order = np.argsort(lo, kind="stable")
    lo, hi, ids = lo[order], hi[order], ids[order]
    cmax = np.maximum.accumulate(hi)
    new = np.zeros(len(lo), bool)
    new[0] = True
    new[1:] = lo[1:] > cmax[:-1]
    reg = np.cumsum(new) - 1
    reg_lo = lo[new]
    reg_hi = np.maximum.reduceat(hi, np.flatnonzero(new))
    key = reg.astype(np.int64) * (int(ids.max()) + 1) + ids.astype(np.int64)
    ureg = np.unique(key) // (int(ids.max()) + 1)
    n_distinct = np.bincount(ureg, minlength=len(reg_lo))
    return reg_lo.astype(np.int64), reg_hi.astype(np.int64), n_distinct


def find_repeat_regions(
    tig: Tig,
    store: OverlapStore,
    tig_of: np.ndarray,
    min_evidence: int = 2,
    min_region: int = 100,
    max_erate: float | None = None,
) -> list[RepeatRegion]:
    """External-evidence repeat annotation for one tig (columnar)."""
    n_reads = store.n_reads
    p_lo = np.zeros(n_reads + 1, np.int64)
    p_hi = np.zeros(n_reads + 1, np.int64)
    p_rev = np.zeros(n_reads + 1, bool)
    p_lo[tig.read_id] = tig.bgn
    p_hi[tig.read_id] = tig.end
    p_rev[tig.read_id] = tig.rev
    tid, t_lo, t_hi, ext_ids = _external_projections(
        store, tig_of, p_lo, p_hi, p_rev, max_erate
    )
    sel = tid == tig.tig_id
    mlo, mhi, n_ev = _merged_regions(t_lo[sel], t_hi[sel], ext_ids[sel])
    keep = (n_ev >= min_evidence) & (mhi - mlo >= min_region)
    return [
        RepeatRegion(tig.tig_id, int(a), int(b), int(n), False)
        for a, b, n in zip(mlo[keep], mhi[keep], n_ev[keep])
    ]


def mark_repeats(
    tigs: TigStore,
    store: OverlapStore,
    read_lengths: np.ndarray,
    min_evidence: int = 2,
    min_region: int = 100,
    end_slop: int = 200,
    confused_absolute: float = 2100.0,
    confused_percent: float = 200.0,
    min_reads_per_contig: int = 2,
) -> tuple[TigStore, list[RepeatRegion]]:
    """Break contigs at confused repeat boundaries; returns (new store, regions).

    confused_absolute / confused_percent mirror bogart -ca / -cp
    (reference defaults 2100 / 200, bogart.C command line;
    AS_BAT_MarkRepeatReads.C:confused test: an external edge within
    `ca` score units AND `cp` percent of the internal edge makes the
    boundary read confused, so the tig cannot be trusted across it).

    All store-wide work (projections, best scores) runs in single
    columnar passes; the remaining per-tig loop touches only that tig's
    pre-sliced rows.
    """
    n_reads = len(read_lengths)
    tig_of, p_lo, p_hi, p_rev = tig_read_index(tigs, n_reads)
    tid, t_lo, t_hi, ext_ids = _external_projections(
        store, tig_of, p_lo.astype(np.int64), p_hi.astype(np.int64), p_rev
    )
    best_int, best_ext = read_best_scores(store, tig_of)
    confused_read = (best_int > 0.0) & (
        best_ext >= best_int - confused_absolute
    ) & (best_ext >= best_int * (1.0 - confused_percent / 100.0))

    all_regions: list[RepeatRegion] = []
    out = TigStore()
    next_id = 1

    for tig in tigs:
        if tig.tig_class != CLASS_CONTIG or tig.n_reads < 2:
            out.add(Tig(next_id, tig.read_id, tig.bgn, tig.end, tig.rev,
                        tig.tig_class, tig.consensus))
            next_id += 1
            continue
        s, e = np.searchsorted(tid, [tig.tig_id, tig.tig_id + 1])
        mlo, mhi, n_ev = _merged_regions(t_lo[s:e], t_hi[s:e], ext_ids[s:e])
        keep = (n_ev >= min_evidence) & (mhi - mlo >= min_region)
        regions = [
            RepeatRegion(tig.tig_id, int(a), int(b), int(n), False)
            for a, b, n in zip(mlo[keep], mhi[keep], n_ev[keep])
        ]
        tig_len = tig.length
        breaks: list[int] = []
        for reg in regions:
            # only strictly-internal regions can break a tig; regions
            # touching a tig end just mean the tig ends in repeat
            internal_l = reg.bgn > end_slop
            internal_r = reg.end < tig_len - end_slop
            if not (internal_l or internal_r):
                all_regions.append(reg)
                continue
            for edge, is_internal in ((reg.bgn, internal_l), (reg.end, internal_r)):
                if not is_internal:
                    continue
                crossing = (tig.bgn < edge) & (tig.end > edge)
                if confused_read[tig.read_id[crossing]].any():
                    breaks.append(int(edge))
                    reg.broke = True
            all_regions.append(reg)

        if not breaks:
            out.add(Tig(next_id, tig.read_id, tig.bgn, tig.end, tig.rev,
                        tig.tig_class, tig.consensus))
            next_id += 1
            continue

        # partition reads by midpoint against sorted break coordinates
        breaks = sorted(set(breaks))
        mid = (tig.bgn.astype(np.int64) + tig.end) // 2
        piece = np.searchsorted(np.array(breaks), mid, side="right")
        for p in np.unique(piece):
            sel = piece == p
            bgn = tig.bgn[sel]
            shift = bgn.min()
            order = np.argsort(bgn, kind="stable")
            out.add(Tig(
                next_id,
                tig.read_id[sel][order],
                (bgn - shift)[order],
                (tig.end[sel] - shift)[order],
                tig.rev[sel][order],
                CLASS_CONTIG,
            ))
            next_id += 1

    out = split_discontinuous(out, min_reads_per_contig)
    return out, all_regions


def split_discontinuous(tigs: TigStore, min_reads_per_contig: int = 2) -> TigStore:
    """Split tigs whose reads no longer tile contiguously
    (splitDiscontinuous, bogart.C:540-560): a gap in read coverage means
    the layout is two independent pieces."""
    out = TigStore()
    next_id = 1
    for tig in tigs:
        if tig.n_reads <= 1:
            out.add(Tig(next_id, tig.read_id, tig.bgn, tig.end, tig.rev,
                        tig.tig_class, tig.consensus))
            next_id += 1
            continue
        order = np.argsort(tig.bgn, kind="stable")
        bgn, end = tig.bgn[order], tig.end[order]
        rid, rev = tig.read_id[order], tig.rev[order]
        reach = np.maximum.accumulate(end)
        # piece starts where a read begins past everything seen so far
        new_piece = np.zeros(len(bgn), bool)
        new_piece[1:] = bgn[1:] > reach[:-1]
        piece = np.cumsum(new_piece)
        for p in np.unique(piece):
            sel = piece == p
            shift = bgn[sel].min()
            cls = tig.tig_class
            if cls == CLASS_CONTIG and sel.sum() < min_reads_per_contig:
                cls = CLASS_UNASSEMBLED
            out.add(Tig(
                next_id, rid[sel], bgn[sel] - shift, end[sel] - shift,
                rev[sel], cls,
                tig.consensus if piece.max() == 0 else None,
            ))
            next_id += 1
    return out
