"""Best-overlap-graph unitig construction (bogart equivalent, host side).

The port's own copy of canu_tpu.graph.best_overlap (no torch, no jax), with the same
results.

Re-implements the core of the reference bogart phase sequence
(Canu src/bogart/bogart.C:386-630) as columnar numpy over the
device-verified OverlapStore:

  * overlap classification into containment / 5'-dovetail / 3'-dovetail
    per read end (BestOverlapGraph semantics,
    Canu src/bogart/AS_BAT_BestOverlapGraph.H:139-258);
  * the reference's read-hygiene filter cascade
    (AS_BAT_BestOverlapGraph.C constructor order): suspicious marking
    (good overlaps must merge to ONE interval on the read), the global
    error-profile deviation limit (median + deviation * 1.4826 * MAD of
    best-edge erates, utgGraphDeviation), spur/singleton marking (edges
    out of spurs allowed, never into them), and lopsided-edge marking
    (non-mutual best edges whose partner overlap lengths differ > 5%);
    best edges are re-picked after each filter, exactly like the
    reference re-runs findEdges();
  * greedy mutual-best walks build unitigs (populateUnitig,
    bogart.C:406-414) — requiring mutuality folds the reference's
    ChunkGraph mutual-best-chain seeding into the walk itself;
  * contained reads placed into their container's tig (placeContains,
    bogart.C:442-459) — resolved level-by-level over the containment
    forest, no per-read fixpoint loop;
  * spur reads surviving at contig tips are dropped back to singletons
    (dropDeadEnds role, bogart.C:540-560);
  * leftover reads become singleton unassembled tigs (promoteToSingleton
    + classification per contigFilter, bogart.C:562-598).

Positions are hang-arithmetic estimates (consensus refines them), like
the reference's initial tgPositions before optimizePositions.
Deliberately host-side: the graph walk is sequential pointer chasing —
the TPU's job was scoring the edges (SURVEY.md §7 step 10).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..stores.overlaps import OverlapStore
from ..stores.tigs import CLASS_CONTIG, CLASS_UNASSEMBLED, Tig, TigStore
from ..utils.intervals import covered_intervals_all

END5, END3 = 0, 1


def _last_per_key(keys: np.ndarray, order_val: np.ndarray):
    """Indices selecting, for every distinct key, the entry with the
    LARGEST order_val (ties -> later input index), via one lexsort."""
    order = np.lexsort((order_val, keys))
    ks = keys[order]
    last = np.flatnonzero(np.concatenate([ks[1:] != ks[:-1], [True]]))
    return order[last]


@dataclass
class BestEdges:
    """Per (read, end) best dovetail edge; 0 b_id = none."""

    b_id: np.ndarray  # int32 [n+1, 2]
    row: np.ndarray  # int64 [n+1, 2] row in the store for hang lookup
    contained_in: np.ndarray  # int32 [n+1], 0 = not contained
    contain_row: np.ndarray  # int64 [n+1]


class BestOverlapGraph:
    def __init__(
        self,
        store: OverlapStore,
        read_lengths: np.ndarray,  # int32 [n] (index read_id-1)
        max_erate: float = 0.30,
        end_slop: int = 100,
        min_span: int = 500,
        deviation: float = 6.0,
        filter_suspicious: bool = True,
        filter_high_error: bool = True,
        filter_spur: bool = True,
        filter_lopsided: bool = True,
    ):
        self.store = store
        self.n = store.n_reads
        self.read_len = read_lengths
        self.max_erate = max_erate
        self.end_slop = end_slop
        self.min_span = min_span
        self.deviation = deviation
        self.error_limit = max_erate
        self.suspicious = np.zeros(self.n + 1, bool)
        self.spur = np.zeros(self.n + 1, bool)
        self.singleton = np.zeros(self.n + 1, bool)
        self._classify()
        # the reference's constructor sequence: findEdges, then each
        # enabled filter followed by a findEdges re-pick
        # (AS_BAT_BestOverlapGraph.C BestOverlapGraph::BestOverlapGraph)
        self._find_edges()
        if filter_suspicious:
            self._mark_suspicious()
            self._find_edges()
        if filter_high_error:
            self._compute_error_limit()
            self._find_edges()
        if filter_spur:
            self._mark_spurs()
            self._find_edges()
        if filter_lopsided:
            self._mark_lopsided()
            self._find_edges()
            self._mark_spurs()  # refresh tip info for dropDeadEnds

    def _classify(self) -> None:
        st = self.store
        len_a = self.read_len[st.a_id - 1].astype(np.int64)
        len_b = self.read_len[st.b_id - 1].astype(np.int64)
        # oriented-B span (B' = rc(B) when flipped): left/right ends of the
        # alignment on B in A-forward direction
        bp_bgn = np.where(st.flipped, len_b - st.b_end, st.b_bgn).astype(np.int64)
        bp_end = np.where(st.flipped, len_b - st.b_bgn, st.b_end).astype(np.int64)
        slop = self.end_slop
        a_l0 = st.a_bgn <= slop  # alignment reaches A's left end
        a_r0 = st.a_end >= len_a - slop
        b_l0 = bp_bgn <= slop
        b_r0 = bp_end >= len_b - slop
        span_a = (st.a_end - st.a_bgn).astype(np.int64)
        self.base_ok = (st.erate <= self.max_erate) & (span_a >= self.min_span)

        # containment must be asymmetric: near-identical reads (same span,
        # both ends flush) would otherwise mark EACH OTHER contained and
        # both drop out of the graph — the container must be strictly
        # longer, ties broken by id (the reference resolves duplicate
        # reads similarly in gatekeeper dedup + bogart contain handling)
        a_longer = (len_a > len_b) | ((len_a == len_b) & (st.a_id < st.b_id))
        self.geo_b_contained = b_l0 & b_r0 & ~(a_l0 & a_r0 & ~a_longer) & a_longer
        self.geo_a_contained = a_l0 & a_r0 & ~a_longer  # A inside B
        # dovetail off A's 5' end: B' sticks out left
        self.geo_dove5 = a_l0 & b_r0 & ~b_l0 & ~a_r0
        # dovetail off A's 3' end: B' sticks out right
        self.geo_dove3 = a_r0 & b_l0 & ~b_r0 & ~a_l0
        self.span_a = span_a
        self.raw_score = span_a * (1.0 - st.erate.astype(np.float64))
        self.bp_bgn, self.bp_end = bp_bgn, bp_end

    # ---- edge picking (findEdges equivalent, fully columnar) ----

    def _gate(self) -> np.ndarray:
        # suspicious reads KEEP their edges (the reference only bars them
        # from seeding tigs, AS_BAT_PopulateUnitig.C:166 / ChunkGraph.C:73)
        st = self.store
        return self.base_ok & (st.erate <= self.error_limit)

    def _find_edges(self) -> None:
        st = self.store
        n = self.n
        gate = self._gate()

        # containment: best container by score
        contained_in = np.zeros(n + 1, np.int32)
        contain_row = np.full(n + 1, -1, np.int64)
        rows_c = np.flatnonzero(self.geo_a_contained & gate)
        if len(rows_c):
            pick = _last_per_key(st.a_id[rows_c], self.raw_score[rows_c])
            rr = rows_c[pick]
            contained_in[st.a_id[rr]] = st.b_id[rr]
            contain_row[st.a_id[rr]] = rr
        self.is_contained = contained_in > 0

        # dovetails: a contained read never offers dovetail edges; edges
        # must not point INTO contained reads, spurs, or singletons
        # (scoreEdge skips them, AS_BAT_BestOverlapGraph.C:388-395)
        bad_tgt = (
            self.is_contained[st.b_id]
            | self.spur[st.b_id]
            | self.singleton[st.b_id]
        )
        best_b = np.zeros((n + 1, 2), np.int32)
        best_row = np.full((n + 1, 2), -1, np.int64)
        dove_gate = gate & ~self.is_contained[st.a_id] & ~bad_tgt
        for end, geo in ((END5, self.geo_dove5), (END3, self.geo_dove3)):
            rows = np.flatnonzero(geo & dove_gate)
            if len(rows) == 0:
                continue
            pick = _last_per_key(st.a_id[rows], self.raw_score[rows])
            rr = rows[pick]
            best_b[st.a_id[rr], end] = st.b_id[rr]
            best_row[st.a_id[rr], end] = rr
        self.best = BestEdges(best_b, best_row, contained_in, contain_row)

    # ---- filter cascade ----

    def _mark_suspicious(self) -> None:
        """A read whose good overlaps do not merge into ONE interval on
        the read is suspicious (chimera signature), unless it is
        contained (markSuspiciousReads, AS_BAT_BestOverlapGraph.C:60-109)."""
        st = self.store
        rows = np.flatnonzero(self._gate())
        own, _, _ = covered_intervals_all(
            st.a_id[rows], st.a_bgn[rows], st.a_end[rows], 1
        )
        n_iv = np.bincount(own.astype(np.int64), minlength=self.n + 1)
        has = np.bincount(st.a_id[rows].astype(np.int64), minlength=self.n + 1) > 0
        self.suspicious |= has & (n_iv != 1) & ~self.is_contained

    def _compute_error_limit(self) -> None:
        """errorLimit = median + deviation * 1.4826 * MAD over best-edge
        erates (mean + deviation * stddev when the median is ~0), clamped
        at the graph erate (removeHighErrorBestEdges,
        AS_BAT_BestOverlapGraph.C:115-193)."""
        rows = self.best.row[self.best.b_id > 0]
        if len(rows) == 0:
            return
        er = self.store.erate[rows].astype(np.float64)
        med = float(np.median(er))
        if med > 1e-10:
            mad = float(np.median(np.abs(er - med)))
            limit = med + self.deviation * 1.4826 * mad
        else:
            limit = float(er.mean()) + self.deviation * float(er.std())
        self.error_limit = min(limit, self.max_erate)

    def _mark_spurs(self) -> None:
        """Spur = uncontained read with a best edge off exactly one end;
        singleton = off neither (AS_BAT_BestOverlapGraph.C:306-358)."""
        has5 = self.best.b_id[:, END5] != 0
        has3 = self.best.b_id[:, END3] != 0
        per = self.store.n_overlaps_per_read()
        has_ovl = np.concatenate([[False], per > 0])
        live = has_ovl & ~self.is_contained & ~self.suspicious
        self.spur = live & (has5 != has3)
        self.singleton = live & ~has5 & ~has3

    def entry_end_rows(self, rows: np.ndarray, a_end: int) -> np.ndarray:
        """Vectorized entry_end: which end of B the edge enters."""
        ep = END5 if a_end == END3 else END3
        fl = self.store.flipped[rows]
        return np.where(fl, 1 - ep, ep).astype(np.int64)

    def _mark_lopsided(self) -> None:
        """Non-mutual best edges whose partner's best-overlap length
        differs > 5% mark the read suspicious (removeLopsidedEdges,
        AS_BAT_BestOverlapGraph.C:196-305)."""
        b5 = self.best.b_id[:, END5]
        b3 = self.best.b_id[:, END3]
        fi = np.flatnonzero(
            ~self.suspicious & ~self.is_contained & (b5 != 0) & (b3 != 0)
        )
        if len(fi) == 0:
            return
        sus = np.zeros(len(fi), bool)
        mutual = np.ones(len(fi), bool)
        diffs = []
        for end in (END5, END3):
            row = self.best.row[fi, end]
            partner = self.best.b_id[fi, end]
            entry = self.entry_end_rows(row, end)
            back_id = self.best.b_id[partner, entry]
            back_row = self.best.row[partner, entry]
            mutual &= back_id == fi
            partner_dead = back_id == 0
            sus |= partner_dead  # edge to something with no edge out
            this_len = self.span_a[row].astype(np.float64)
            that_len = np.where(
                partner_dead, this_len, self.span_a[np.maximum(back_row, 0)]
            ).astype(np.float64)
            diffs.append(
                200.0 * np.abs(this_len - that_len)
                / np.maximum(this_len + that_len, 1.0)
            )
        lop = ~mutual & ((diffs[0] > 5.0) | (diffs[1] > 5.0))
        self.suspicious[fi[sus | lop]] = True

    # which end of B does an edge (store row) enter?  Off A's `end`, the
    # alignment touches B' at the opposite side; in forward-B terms the
    # entry end flips again when the overlap is flipped.
    def entry_end(self, row: int, a_end: int) -> int:
        flipped = bool(self.store.flipped[row])
        # off A3' -> enter B'5'; off A5' -> enter B'3'
        ep = END5 if a_end == END3 else END3
        if flipped:
            ep = END5 if ep == END3 else END3
        return ep


def _mutual(bog: BestOverlapGraph, a: int, a_end: int) -> Optional[tuple[int, int, int]]:
    """Follow a's best edge; require the target's best edge back.

    Returns (b_id, b_entry_end, row) or None.
    """
    b = int(bog.best.b_id[a, a_end])
    if b == 0:
        return None
    row = int(bog.best.row[a, a_end])
    b_entry = bog.entry_end(row, a_end)
    if int(bog.best.b_id[b, b_entry]) != a:
        return None
    return b, b_entry, row


def _place_rows(
    store: OverlapStore,
    r: np.ndarray,  # read ids to place (a side of row)
    row: np.ndarray,  # store rows placing r against a placed b
    read_lengths: np.ndarray,
    tig_of_read: np.ndarray,
    lo_of: np.ndarray,
    hi_of: np.ndarray,
    rev_of: np.ndarray,
) -> None:
    """Write placements of reads r via overlap rows to already-placed
    partners (hang extrapolation; handles containment and dovetail)."""
    st = store
    c = st.b_id[row]
    a_bgn = st.a_bgn[row].astype(np.int64)
    b_bgn = st.b_bgn[row].astype(np.int64)
    b_end = st.b_end[row].astype(np.int64)
    fl = st.flipped[row]
    len_a = read_lengths[r - 1].astype(np.int64)
    # B-forward coordinate of A base 0, stepping -1 per A base if flipped
    y0 = np.where(fl, b_end + a_bgn, b_bgn - a_bgn)
    y1 = np.where(fl, y0 - len_a, y0 + len_a)
    c_lo, c_hi, c_rev = lo_of[c], hi_of[c], rev_of[c]

    def T(y):
        return np.where(c_rev, c_hi - y, c_lo + y)

    p0, p1 = T(y0), T(y1)
    tig_of_read[r] = tig_of_read[c]
    lo_of[r] = np.minimum(p0, p1)
    hi_of[r] = np.maximum(p0, p1)
    rev_of[r] = c_rev ^ fl


def place_contained(
    bog: BestOverlapGraph,
    store: OverlapStore,
    read_lengths: np.ndarray,
    tig_of_read: np.ndarray,  # int32 [n+1], mutated
    lo_of: np.ndarray,
    hi_of: np.ndarray,
    rev_of: np.ndarray,
) -> np.ndarray:
    """Resolve the containment forest level-by-level (placeContains).

    Containers may themselves be contained; each pass places every read
    whose container is already placed, so the loop count is the maximum
    containment DEPTH (log-ish), not the read count.  Returns the ids
    placed (their placement is written into the arrays)."""
    placed_ids = []
    cand = np.flatnonzero(bog.is_contained) if bog.n else np.zeros(0, np.int64)
    cand = cand[tig_of_read[cand] == 0]
    while len(cand):
        container = bog.best.contained_in[cand]
        ready = tig_of_read[container] > 0
        if not ready.any():
            break
        r = cand[ready]
        _place_rows(store, r, bog.best.contain_row[r], read_lengths,
                    tig_of_read, lo_of, hi_of, rev_of)
        placed_ids.append(r)
        cand = cand[~ready]
    return np.concatenate(placed_ids) if placed_ids else np.zeros(0, np.int64)


def place_unplaced(
    bog: BestOverlapGraph,
    store: OverlapStore,
    read_lengths: np.ndarray,
    tig_of_read: np.ndarray,
    lo_of: np.ndarray,
    hi_of: np.ndarray,
    rev_of: np.ndarray,
    max_levels: int = 8,
) -> np.ndarray:
    """placeUnplaced (bogart placeContains companion): put every read
    that still has no tig into the tig of its best-scoring gate-passing
    overlap partner.  This is how spur/suspicious reads — barred from
    DRIVING walks — still end up as placed members, preserving genome
    fraction at tig ends (reference bogart.C:442-459)."""
    st = store
    gate = bog.base_ok
    placed_ids = []
    for _ in range(max_levels):
        rows = np.flatnonzero(
            gate
            & (tig_of_read[st.a_id] == 0)
            & (tig_of_read[st.b_id] > 0)
        )
        if len(rows) == 0:
            break
        pick = _last_per_key(st.a_id[rows], bog.raw_score[rows])
        rr = rows[pick]
        r = st.a_id[rr].astype(np.int64)
        _place_rows(store, r, rr, read_lengths,
                    tig_of_read, lo_of, hi_of, rev_of)
        placed_ids.append(r)
    return np.concatenate(placed_ids) if placed_ids else np.zeros(0, np.int64)


def cap_store_rows(
    store: OverlapStore, max_rows: int, log=None,
) -> OverlapStore:
    """Memory-budgeted per-read overlap cap (reference OverlapCache
    computeOverlapLimit, Canu src/bogart/
    AS_BAT_OverlapCache.H:249-281): keep the best-scoring <= per_read
    rows per a_id, then restore the "every overlap stored twice"
    invariant by union over canonical pair keys — a kept a->b row keeps
    its b->a mirror too (the mirror is an exact column swap, same
    flipped/erate_q), so n_overlaps (len//2) and mutual-best edges stay
    consistent."""
    per_read = max(16, max_rows // max(1, store.n_reads))
    score = (store.a_end - store.a_bgn).astype(np.int64) * (
        10000 - store.erate_q.astype(np.int64)
    )
    order = np.lexsort((-score, store.a_id))
    a_sorted = store.a_id[order]
    iota = np.arange(len(order), dtype=np.int64)
    seg0 = np.maximum.accumulate(
        np.where(np.concatenate([[True], a_sorted[1:] != a_sorted[:-1]]),
                 iota, 0)
    )
    keep_rows = order[(iota - seg0) < per_read]
    mask = np.zeros(len(store), bool)
    mask[keep_rows] = True
    lo_is_a = store.a_id <= store.b_id
    key = np.empty(
        len(store),
        dtype=[("lo", "<i8"), ("hi", "<i8"), ("lb", "<i4"), ("le", "<i4"),
               ("hb", "<i4"), ("he", "<i4"), ("f", "u1"), ("e", "<u2")],
    )
    key["lo"] = np.where(lo_is_a, store.a_id, store.b_id)
    key["hi"] = np.where(lo_is_a, store.b_id, store.a_id)
    key["lb"] = np.where(lo_is_a, store.a_bgn, store.b_bgn)
    key["le"] = np.where(lo_is_a, store.a_end, store.b_end)
    key["hb"] = np.where(lo_is_a, store.b_bgn, store.a_bgn)
    key["he"] = np.where(lo_is_a, store.b_end, store.a_end)
    key["f"] = store.flipped
    key["e"] = store.erate_q
    kept_keys = np.unique(key[mask])
    mask |= np.isin(key, kept_keys)
    cols = {
        c: getattr(store, c)[mask]
        for c in ("a_id", "b_id", "flipped", "a_bgn", "a_end",
                  "b_bgn", "b_end", "erate_q")
    }
    if log is not None:
        log.info(
            "OverlapCache limit (batMemory): kept %d/%d overlaps "
            "(<= %d per read)", int(mask.sum()), len(store), per_read,
        )
    return OverlapStore(store.n_reads, **cols)


def build_unitigs(
    store: OverlapStore,
    read_lengths: np.ndarray,
    max_erate: float = 0.30,
    end_slop: int = 100,
    min_span: int = 500,
    min_reads_per_contig: int = 2,
    deviation: float = 6.0,
    drop_dead_ends: bool = True,
    max_rows: int = 0,
    log_dir: str | None = None,
    log_flags: frozenset = frozenset(),
) -> TigStore:
    """Greedy mutual-best unitigs + contained placement + singletons.

    max_rows > 0 caps the overlaps held for the graph phase: per read,
    best-scoring first — the reference OverlapCache's memory-budgeted
    load (computeOverlapLimit, Canu src/bogart/
    AS_BAT_OverlapCache.H:249-281), driven by the batMemory parameter.

    log_dir + log_flags write the reference bogart's flag-gated
    per-phase log files (AS_BAT_Logging.H:57-82): 'bestedges' dumps the
    per-read best 5'/3' edge table, 'tigs' the greedy-walk tig list."""
    import logging

    log = logging.getLogger("canu_tpu_torch.bogart")
    if max_rows and len(store) > max_rows:
        store = cap_store_rows(store, max_rows, log)
    bog = BestOverlapGraph(store, read_lengths, max_erate, end_slop, min_span,
                           deviation=deviation)
    n = store.n_reads
    # per-phase instrumentation (the reference's bogart Instrumentation/
    # Logging role, AS_BAT_Logging.H flag-gated logs)
    log.info(
        "bestEdges: %d reads, %d suspicious, %d spur, %d singleton, "
        "%d contained; error limit %.4f (deviation %.1f)",
        n, int(bog.suspicious.sum()), int(bog.spur.sum()),
        int(bog.singleton.sum()), int(bog.is_contained.sum()),
        float(bog.error_limit), deviation,
    )
    if log_dir and "bestedges" in log_flags:
        # reference best.edges log (AS_BAT_BestOverlapGraph.C writeLog)
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "best.edges.log"), "w") as fh:
            fh.write("#read\tbest5\tbest3\tcontainedIn\tsuspicious\tspur\n")
            for r in range(1, n + 1):
                fh.write(
                    f"{r}\t{int(bog.best.b_id[r, 0])}\t"
                    f"{int(bog.best.b_id[r, 1])}\t"
                    f"{int(bog.best.contained_in[r])}\t"
                    f"{int(bog.suspicious[r])}\t{int(bog.spur[r])}\n"
                )
    visited = np.zeros(n + 1, bool)
    tigs = TigStore()
    tig_of_read = np.zeros(n + 1, np.int32)  # 1-based tig ids, 0 = none
    lo_of = np.zeros(n + 1, np.int64)
    hi_of = np.zeros(n + 1, np.int64)
    rev_of = np.zeros(n + 1, bool)

    # seed longest reads first (proxy for the reference ChunkGraph's
    # mutual-best chain-length ordering); suspicious reads neither seed
    # nor extend walks
    seed_order = np.argsort(-read_lengths, kind="stable") + 1

    def step(cur: int, cur_rev: bool, lo: int, hi: int, direction: int):
        """One walk step rightwards (direction=+1) or leftwards (-1).

        Returns (b, b_rev, lo_b, hi_b, row) or None.
        """
        # tig-right end of cur read: 3' if forward else 5' (mirror for left)
        if direction > 0:
            out = END3 if not cur_rev else END5
        else:
            out = END5 if not cur_rev else END3
        nxt = _mutual(bog, cur, out)
        if nxt is None:
            return None
        b, b_entry, row = nxt
        st = store
        len_b = int(read_lengths[b - 1])
        flipped = bool(st.flipped[row])
        a_bgn = int(st.a_bgn[row])
        bp_bgn = int(bog.bp_bgn[row])
        b_rev = cur_rev ^ flipped
        if not cur_rev:
            pos0 = lo + a_bgn - bp_bgn  # tig pos of B' base 0
            lo_b, hi_b = pos0, pos0 + len_b
        else:
            # A-forward coordinate x sits at tig pos hi - x
            pos_end = hi - a_bgn + bp_bgn  # tig pos of B' base 0 (right side)
            lo_b, hi_b = pos_end - len_b, pos_end
        return b, b_rev, lo_b, hi_b, row

    next_tig_id = 1
    walk_tigs: list[list[tuple[int, int, int, bool]]] = []
    for seed in seed_order:
        seed = int(seed)
        if (visited[seed] or bog.is_contained[seed] or bog.suspicious[seed]
                or bog.spur[seed] or bog.singleton[seed]):
            # spurs/singletons never drive walks (no edges point into
            # them); placeUnplaced attaches them to finished tigs below
            continue
        placements: list[tuple[int, int, int, bool]] = []
        lo, hi = 0, int(read_lengths[seed - 1])
        placements.append((seed, lo, hi, False))
        visited[seed] = True
        for direction in (+1, -1):
            cur, cur_rev, clo, chi = seed, False, lo, hi
            while True:
                nxt = step(cur, cur_rev, clo, chi, direction)
                if nxt is None:
                    break
                b, b_rev, lo_b, hi_b, _ = nxt
                if visited[b]:
                    break
                placements.append((b, lo_b, hi_b, b_rev))
                visited[b] = True
                cur, cur_rev, clo, chi = b, b_rev, lo_b, hi_b
        walk_tigs.append(placements)

    # dropDeadEnds (bogart.C:540-560 role): spur reads can only sit at a
    # tig tip (no edges point into a spur); strip them back to singletons
    for placements in walk_tigs:
        if drop_dead_ends and len(placements) > 2:
            placements.sort(key=lambda p: p[1])
            while len(placements) > 2 and bog.spur[placements[0][0]]:
                visited[placements[0][0]] = False
                placements.pop(0)
            while len(placements) > 2 and bog.spur[placements[-1][0]]:
                visited[placements[-1][0]] = False
                placements.pop()
        rid = np.array([p[0] for p in placements], np.int32)
        bgn = np.array([p[1] for p in placements], np.int64)
        end = np.array([p[2] for p in placements], np.int64)
        rev = np.array([p[3] for p in placements], bool)
        shift = bgn.min()
        bgn -= shift
        end -= shift
        order = np.argsort(bgn, kind="stable")
        tig = Tig(next_tig_id, rid[order], bgn[order].astype(np.int32),
                  end[order].astype(np.int32), rev[order])
        tigs.add(tig)
        tig_of_read[rid] = next_tig_id
        lo_of[rid] = bgn
        hi_of[rid] = end
        rev_of[rid] = rev
        next_tig_id += 1

    # place contained reads (placeContains, level-parallel over the
    # containment forest), then remaining reads by their best overlap to
    # a placed read (placeUnplaced); alternate until settled
    placed_all = []
    for _ in range(4):
        p1 = place_contained(bog, store, read_lengths,
                             tig_of_read, lo_of, hi_of, rev_of)
        p2 = place_unplaced(bog, store, read_lengths,
                            tig_of_read, lo_of, hi_of, rev_of)
        placed_all += [p1, p2]
        if len(p1) == 0 and len(p2) == 0:
            break
    placed = np.concatenate(placed_all) if placed_all else np.zeros(0, np.int64)
    if len(placed):
        visited[placed] = True
        by_tig: dict[int, list[int]] = {}
        for r in placed:
            by_tig.setdefault(int(tig_of_read[r]), []).append(int(r))
        for t, extras in by_tig.items():
            tig = tigs[t - 1]
            er = np.array(extras, np.int32)
            rid = np.concatenate([tig.read_id, er])
            bgn = np.concatenate([tig.bgn.astype(np.int64), lo_of[er]])
            end = np.concatenate([tig.end.astype(np.int64), hi_of[er]])
            rev = np.concatenate([tig.rev, rev_of[er]])
            shift = bgn.min()
            order = np.argsort(bgn, kind="stable")
            tigs.tigs[t - 1] = Tig(
                tig.tig_id, rid[order],
                (bgn - shift)[order].astype(np.int32),
                (end - shift)[order].astype(np.int32), rev[order],
            )

    # leftovers -> singleton unassembled tigs (promoteToSingleton)
    for r in np.flatnonzero(~visited[1:]) + 1:
        tigs.add(Tig(
            next_tig_id,
            np.array([r], np.int32),
            np.array([0], np.int32),
            np.array([read_lengths[r - 1]], np.int32),
            np.array([False]),
            tig_class=CLASS_UNASSEMBLED,
        ))
        next_tig_id += 1

    # classify: contigs need min_reads_per_contig
    for tig in tigs:
        if tig.tig_class == CLASS_CONTIG and tig.n_reads < min_reads_per_contig:
            tig.tig_class = CLASS_UNASSEMBLED

    # refine positions from overlap hangs (optimizePositions role) so
    # consensus sees placements, not walk-accumulated estimates
    tigs = optimize_positions(tigs, store, read_lengths)

    # orphan merge + bubble classification (bogart mergeOrphans,
    # bogart.C:469-478) — moves fully-placeable small tigs into their
    # targets, marks partially-placeable ones CLASS_BUBBLE
    from .orphans import merge_orphans

    tigs, _, _ = merge_orphans(tigs, store, read_lengths)
    if log_dir and "tigs" in log_flags:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "tigs.log"), "w") as fh:
            fh.write("#tig\tclass\treads\tspan\n")
            for t in tigs:
                fh.write(f"{t.tig_id}\t{t.tig_class}\t{t.n_reads}\t"
                         f"{t.length}\n")
    return tigs


def optimize_positions(
    tigs: TigStore,
    store: OverlapStore,
    read_lengths: np.ndarray,
    rounds: int = 8,
) -> TigStore:
    """Refine tig coordinates by least-squares over overlap hangs
    (the reference's optimizePositions pass,
    Canu src/bogart/AS_BAT_OptimizePositions.C, called from
    bogart.C:406-456 after placeContains).

    Initial positions are hang-arithmetic estimates accumulated along
    the greedy walk, so placement error grows with tig length and the
    consensus stage pays for it in slack and extra polish rounds.  Each
    in-tig overlap (a, b) pins the tig coordinate of its aligned span
    from both sides; with read spans held fixed, that is a linear
    constraint x[a] - x[b] = d, solved by damped weighted-Jacobi
    iterations — entirely columnar over the store (segmented means via
    the store's row index), no per-read loops.
    """
    from .repeats import tig_read_index

    n_reads = len(read_lengths)
    tig_of, lo, hi, rev = tig_read_index(tigs, n_reads)
    x = lo.astype(np.float64)
    span_t = (hi - lo).astype(np.int64)  # read span in tig coords (fixed)

    a_t = tig_of[store.a_id]
    sel = (a_t > 0) & (tig_of[store.b_id] == a_t)
    rows = np.flatnonzero(sel)
    if len(rows) == 0:
        return tigs
    a = store.a_id[rows]
    b = store.b_id[rows]
    a_bgn = store.a_bgn[rows].astype(np.int64)
    a_end = store.a_end[rows].astype(np.int64)
    # b window in B-forward coords, oriented into b's tig frame below
    b_bgn = store.b_bgn[rows].astype(np.int64)
    b_end = store.b_end[rows].astype(np.int64)
    w = (a_end - a_bgn).astype(np.float64)
    da = np.where(rev[a], span_t[a] - a_end, a_bgn)
    db = np.where(rev[b], span_t[b] - b_end, b_bgn)
    # rows are grouped by a (store order); per-read weighted means via
    # reduceat over the store's row index restricted to kept rows
    order = np.argsort(a, kind="stable")
    a_s, b_s = a[order], b[order]
    da_s, db_s, w_s = da[order], db[order], w[order]
    starts = np.searchsorted(a_s, np.arange(1, n_reads + 2))
    has = starts[:-1] < starts[1:]
    red_start = np.minimum(starts[:-1], max(0, len(a_s) - 1))
    wsum = np.zeros(n_reads + 1)
    wsum[1:][has] = np.add.reduceat(w_s, red_start)[has] if len(a_s) else 0

    for _ in range(max(1, rounds)):
        target = (x[b_s] + db_s - da_s) * w_s
        tsum = np.zeros(n_reads + 1)
        if len(a_s):
            tsum[1:][has] = np.add.reduceat(target, red_start)[has]
        mean = np.where(wsum > 0, tsum / np.maximum(wsum, 1e-9), x)
        # damped update; reads with no in-tig overlaps stay put
        x = np.where(wsum > 0, 0.5 * (x + mean), x)

    out = TigStore()
    for tig in tigs:
        rid = tig.read_id
        nb = np.round(x[rid]).astype(np.int64)
        ne = nb + span_t[rid]
        shift = nb.min() if len(nb) else 0
        order2 = np.argsort(nb, kind="stable")
        out.add(Tig(tig.tig_id, rid[order2],
                    (nb - shift)[order2].astype(np.int32),
                    (ne - shift)[order2].astype(np.int32),
                    tig.rev[order2], tig.tig_class, tig.consensus))
    return out
