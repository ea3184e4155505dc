"""Orphan merging and bubble classification (mergeOrphans equivalent).

The port's own copy of canu_tpu.graph.orphans (no torch, no jax), with the same
results.

Re-implements the reference bogart's mergeOrphans/popBubbles phase
(Canu src/bogart/AS_BAT_MergeOrphans.C, driven at
bogart.C:469-478): a small tig whose reads can ALL be placed (via
overlaps) into one larger tig is an *orphan* — its reads are moved into
the larger tig and the small tig disappears; a tig whose ends anchor
into a larger tig but whose middle differs is a *bubble* — it is kept
but classified out of the primary contig set.

Placement is by overlap projection: each overlap (r in small tig, b in
target tig) maps r's full extent into target-tig coordinates through
b's placement, the same arithmetic the reference does with
PlaceReadUsingOverlaps (AS_BAT_PlaceReadUsingOverlaps.C).  The best
scoring overlap wins.

All store-wide work — target voting and best-overlap placement — runs
in single columnar passes; only the final commit loop (which must
respect merge ordering) iterates over candidate tigs.
"""

from __future__ import annotations

import numpy as np

from ..stores.overlaps import OverlapStore
from ..stores.tigs import CLASS_BUBBLE, CLASS_CONTIG, Tig, TigStore
from .repeats import tig_read_index


def _vote_targets(
    store: OverlapStore, tig_of: np.ndarray, candidate: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Distinct (read, target-tig) votes grouped by (source tig, target).

    candidate[t] marks small source tigs.  Returns (src_tig, dst_tig,
    votes) for every cross-tig pair with at least one voting read —
    one columnar pass (the per-read np.unique of the old implementation
    collapsed into a store-wide unique of (read, target) keys)."""
    a_t = tig_of[store.a_id]
    b_t = tig_of[store.b_id]
    sel = candidate[a_t] & (b_t > 0) & (b_t != a_t)
    if not sel.any():
        z = np.zeros(0, np.int64)
        return z, z, z
    a = store.a_id[sel].astype(np.int64)
    t = b_t[sel].astype(np.int64)
    T = int(tig_of.max()) + 1
    rt = np.unique(a * T + t)  # distinct (read, target) pairs
    reads = rt // T
    targets = rt % T
    src = tig_of[reads].astype(np.int64)
    st_key = np.unique(src * T + targets, return_counts=True)
    return st_key[0] // T, st_key[0] % T, st_key[1]


def _place_reads_in_targets(
    store: OverlapStore,
    read_ids: np.ndarray,
    target_of_read: np.ndarray,
    tig_of: np.ndarray,
    p_lo: np.ndarray,
    p_hi: np.ndarray,
    p_rev: np.ndarray,
    read_lengths: np.ndarray,
):
    """Best-overlap projection of each read into its assigned target tig.

    Columnar over the whole store: pick, per read, the highest-scoring
    overlap row whose b-read sits in target_of_read[read], then project
    the read's full extent through b's placement.  Returns
    (placed mask, t_lo, t_hi, rev) aligned with read_ids."""
    want = np.zeros(store.n_reads + 1, np.int64)
    want[read_ids] = target_of_read
    rows = np.flatnonzero(
        (want[store.a_id] > 0) & (tig_of[store.b_id] == want[store.a_id])
    )
    out_placed = np.zeros(store.n_reads + 1, bool)
    out_lo = np.zeros(store.n_reads + 1, np.int64)
    out_hi = np.zeros(store.n_reads + 1, np.int64)
    out_rev = np.zeros(store.n_reads + 1, bool)
    if len(rows):
        a = store.a_id[rows]
        span = (store.a_end[rows] - store.a_bgn[rows]).astype(np.float64)
        score = span * (1.0 - store.erate[rows])
        # best row per read: stable sort by (a, score), last of each group
        order = np.lexsort((score, a))
        rows_s, a_s = rows[order], a[order]
        last = np.zeros(len(rows_s), bool)
        last[:-1] = a_s[1:] != a_s[:-1]
        last[-1] = True
        best = rows_s[last]
        ab = a_s[last].astype(np.int64)
        bb = store.b_id[best].astype(np.int64)
        a_bgn = store.a_bgn[best].astype(np.int64)
        a_end = store.a_end[best].astype(np.int64)
        b_bgn = store.b_bgn[best].astype(np.int64)
        b_end = store.b_end[best].astype(np.int64)
        flip = store.flipped[best].astype(bool)
        rl = read_lengths[ab - 1].astype(np.int64)
        # r extent in b-forward coords
        y_lo = np.where(flip, b_end + a_bgn - rl, b_bgn - a_bgn)
        y_hi = y_lo + rl
        # b-forward -> tig coords through b's placement
        lo_b, hi_b, rev_b = p_lo[bb], p_hi[bb], p_rev[bb]
        t_lo = np.where(rev_b, hi_b - y_hi, lo_b + y_lo)
        t_hi = np.where(rev_b, hi_b - y_lo, lo_b + y_hi)
        out_placed[ab] = True
        out_lo[ab] = t_lo
        out_hi[ab] = t_hi
        out_rev[ab] = rev_b ^ flip
    return (out_placed[read_ids], out_lo[read_ids], out_hi[read_ids],
            out_rev[read_ids])


def merge_orphans(
    tigs: TigStore,
    store: OverlapStore,
    read_lengths: np.ndarray,
    max_orphan_reads: int = 50,
    place_fraction_bubble: float = 0.8,
) -> tuple[TigStore, int, int]:
    """Merge orphan tigs into their targets; classify bubbles.

    Returns (new store, n_orphans_merged, n_bubbles_marked).  Tig sizes
    above max_orphan_reads are never considered (reference caps bubble
    candidates similarly).
    """
    n_reads = len(read_lengths)
    tig_of, p_lo, p_hi, p_rev = tig_read_index(tigs, n_reads)
    sizes = {t.tig_id: t.length for t in tigs}
    nreads_of = {t.tig_id: t.n_reads for t in tigs}
    by_id = {t.tig_id: t for t in tigs}

    candidate = np.zeros(int(tig_of.max()) + 1, bool)
    for t in tigs:
        if t.tig_class == CLASS_CONTIG and t.n_reads <= max_orphan_reads:
            candidate[t.tig_id] = True

    src, dst, votes = _vote_targets(store, tig_of, candidate)

    # chosen target per candidate tig: most-voted larger tig with enough
    # voting reads (ties: larger vote, then smaller dst for determinism)
    chosen: dict[int, int] = {}
    order = np.lexsort((dst, -votes, src))
    for i in order:
        s, d, v = int(src[i]), int(dst[i]), int(votes[i])
        if s in chosen:
            continue
        if sizes.get(d, 0) <= sizes[s]:
            continue
        if v < place_fraction_bubble * nreads_of[s]:
            continue
        chosen[s] = d

    # placements for every read of every candidate, one columnar pass
    if chosen:
        cand_reads = np.concatenate(
            [by_id[s].read_id for s in sorted(chosen)]
        ).astype(np.int64)
        tgt_per_read = np.concatenate(
            [np.full(by_id[s].n_reads, chosen[s], np.int64)
             for s in sorted(chosen)]
        )
        placed, t_lo, t_hi, t_rev = _place_reads_in_targets(
            store, cand_reads, tgt_per_read, tig_of,
            p_lo.astype(np.int64), p_hi.astype(np.int64), p_rev,
            np.asarray(read_lengths),
        )
        off = {}
        o = 0
        for s in sorted(chosen):
            off[s] = o
            o += by_id[s].n_reads

    # commit in decreasing-size order so a tig never merges into an
    # already-dropped target (chains merge largest-first, as bogart's
    # iteration effectively does)
    extras: dict[int, list[tuple[int, int, int, bool]]] = {}
    dropped: set[int] = set()
    n_orphan = n_bubble = 0
    for s in sorted(chosen, key=lambda x: -sizes[x]):
        tig = by_id[s]
        if chosen[s] in dropped:
            continue
        o = off[s]
        n = tig.n_reads
        pl = placed[o : o + n]
        if pl.all():
            ex = extras.setdefault(chosen[s], [])
            for k in range(n):
                ex.append((int(tig.read_id[k]), int(t_lo[o + k]),
                           int(t_hi[o + k]), bool(t_rev[o + k])))
            dropped.add(s)
            n_orphan += 1
        elif pl.sum() >= place_fraction_bubble * n:
            tig.tig_class = CLASS_BUBBLE
            n_bubble += 1

    out = TigStore()
    next_id = 1
    for tig in tigs:
        if tig.tig_id in dropped:
            continue
        if tig.tig_id in extras:
            ex = extras[tig.tig_id]
            rid = np.concatenate([tig.read_id, np.array([e[0] for e in ex], np.int32)])
            bgn = np.concatenate([tig.bgn, np.array([e[1] for e in ex], np.int32)])
            end = np.concatenate([tig.end, np.array([e[2] for e in ex], np.int32)])
            rev = np.concatenate([tig.rev, np.array([e[3] for e in ex], bool)])
            shift = int(bgn.min())
            order = np.argsort(bgn, kind="stable")
            out.add(Tig(next_id, rid[order], (bgn - shift)[order],
                        (end - shift)[order], rev[order], tig.tig_class))
        else:
            out.add(Tig(next_id, tig.read_id, tig.bgn, tig.end, tig.rev,
                        tig.tig_class, tig.consensus))
        next_id += 1
    return out, n_orphan, n_bubble
