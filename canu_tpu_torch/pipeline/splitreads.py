"""Subread-loop / chimeric junction detection (splitReads equivalent).

The port's own copy of canu_tpu.pipeline.splitreads (no torch, no jax), with the same
results.

Re-implements the evidence logic of the reference's splitReads
(Canu src/overlapBasedTrimming/splitReads-subReads.C:60-306):
a read pair (a, b) that overlaps TWICE in OPPOSITE orientations is the
signature of a missed-adapter PacBio subread loop (the template is
sequenced forward then backward, so b aligns to a both ways around the
hairpin).  The junction lies between the two overlap extents on a; a
small gap (<= SUBREAD_LOOP_MAX_SIZE) is strong evidence, a larger one
(<= SUBREAD_LOOP_EXT_SIZE) weak.  Junctions with enough combined
evidence and too few spanning overlaps are confirmed bad regions; the
trimming stage splits reads there (our behavior: emit every good piece,
where the reference keeps the largest).

The opposite-orientation duplicate overlaps come from
verify_overlaps(palindromic_min=...) — our MinHash orientation vote
normally keeps only the majority orientation, so palindromic pairs are
explicitly re-verified in the minority orientation.

Everything here is host-side numpy over store columns (the graph-side
layer of the design; no per-read Python loops over overlaps).
"""

from __future__ import annotations

import numpy as np

# same-orient overlap pairs closer than this are strong subread evidence
SUBREAD_LOOP_MAX_SIZE = 500
# ... and anything closer than this counts as weak supporting evidence
SUBREAD_LOOP_EXT_SIZE = 2000
# spanning reads must clear the bad region by this margin on both sides
SPAN_MARGIN = 100
# >9 spanning reads -> the junction is refuted (splitReads-subReads.C:295)
MAX_SPANNERS = 9
# combined evidence (strong + weak/4 + palindrome) must reach this
MIN_EVIDENCE = 3


def detect_bad_regions(store) -> dict[int, list[tuple[int, int]]]:
    """Confirmed subread-junction regions per read id.

    store: OverlapStore (symmetric rows sorted by (a_id, b_id)).
    Returns {read_id: [(bgn, end), ...]} in read coordinates.
    """
    a = np.asarray(store.a_id)
    b = np.asarray(store.b_id)
    fl = np.asarray(store.flipped)
    abgn = np.asarray(store.a_bgn).astype(np.int64)
    aend = np.asarray(store.a_end).astype(np.int64)
    if len(a) == 0:
        return {}

    # adjacent rows with the same (a_id, b_id) and differing orientation
    # (rows are sorted by (a_id, b_id); at most 2 overlaps per pair)
    same = (a[1:] == a[:-1]) & (b[1:] == b[:-1]) & (fl[1:] != fl[:-1])
    ii = np.nonzero(same)[0]  # row index of the first of each duo
    if len(ii) == 0:
        return {}
    jj = ii + 1

    # junction interval between the two extents on a (reference: between
    # the end of the earlier overlap and the start of the later one,
    # swapped if they interpenetrate — splitReads-subReads.C:221-236)
    first_lo = abgn[ii] < abgn[jj]
    lo_end = np.where(first_lo, aend[ii], aend[jj])
    hi_bgn = np.where(first_lo, abgn[jj], abgn[ii])
    bad_b = np.minimum(lo_end, hi_bgn)
    bad_e = np.maximum(lo_end, hi_bgn)
    gap = bad_e - bad_b

    strong = gap <= SUBREAD_LOOP_MAX_SIZE
    weak = gap <= SUBREAD_LOOP_EXT_SIZE
    # large-palindrome flag: both extents overlap each other substantially
    # on a (splitReads-subReads.C:160-175's Aoverlap/Boverlap > 1000)
    inter = np.minimum(aend[ii], aend[jj]) - np.maximum(abgn[ii], abgn[jj])
    palin_read = np.unique(a[ii][inter > 1000])

    out: dict[int, list[tuple[int, int]]] = {}
    for rid in np.unique(a[ii][weak]):
        rid = int(rid)
        mine = (a[ii] == rid) & weak
        st = bad_b[mine]
        en = np.maximum(bad_e[mine], st + 1)
        w_strong = strong[mine]  # strong implies weak, so this aligns

        # merge weak intervals (BADall) and strong intervals (BAD)
        def merged(b0, e0):
            order = np.argsort(b0)
            b0, e0 = b0[order], e0[order]
            mb, me, mc = [], [], []
            for x, y in zip(b0, e0):
                if mb and x <= me[-1]:
                    me[-1] = max(me[-1], int(y))
                    mc[-1] += 1
                else:
                    mb.append(int(x))
                    me.append(int(y))
                    mc.append(1)
            return list(zip(mb, me, mc))

        all_iv = merged(st, en)
        strong_iv = merged(st[w_strong], en[w_strong]) if w_strong.any() else []
        if not strong_iv:
            continue

        s0, e0 = store.row_range(rid)
        ab, ae = abgn[s0:e0], aend[s0:e0]
        large_palin = 1 if rid in palin_read else 0
        confirmed: list[tuple[int, int]] = []
        for lo, hi, n_strong in strong_iv:
            all_hits = sum(c for (l2, h2, c) in all_iv if l2 <= lo and hi <= h2)
            n_span = int(np.sum((ab + SPAN_MARGIN < lo) & (hi + SPAN_MARGIN < ae)))
            if n_span > MAX_SPANNERS:
                continue
            if n_strong + all_hits // 4 + large_palin < MIN_EVIDENCE:
                continue
            confirmed.append((lo, hi))
        if confirmed:
            out[rid] = confirmed
    return out


def subtract_regions(
    intervals: list[tuple[int, int]], bad: list[tuple[int, int]]
) -> list[tuple[int, int]]:
    """Cut bad regions out of covered intervals (piece splitting)."""
    out = []
    for bgn, end in intervals:
        cur = int(bgn)
        for lo, hi in sorted(bad):
            if hi <= cur or lo >= end:
                continue
            if lo > cur:
                out.append((cur, int(lo)))
            cur = max(cur, int(hi))
        if cur < end:
            out.append((cur, int(end)))
    return out
