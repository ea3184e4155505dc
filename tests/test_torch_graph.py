"""The port's numpy copies for trimming and assembly give what canu_tpu's
give: subread-junction detection and region subtraction, the tig store
and its versioned files, the best-overlap graph (unitigs, contained and
unplaced reads, the row cap, position optimisation, the bogart logs), the
repeat and orphan passes, the object store and the HTML report.  Exact,
on the inputs of tests/test_splitreads.py, test_repeats.py,
test_bubbles.py and test_assembly_slice.py's tig round trip, and on
stores made from simulated reads' true placements."""

from __future__ import annotations

import os

import numpy as np
import pytest

import canu_tpu.graph as JG
import canu_tpu.graph.best_overlap as JBO
import canu_tpu.graph.repeats as JRP
import canu_tpu.ops.align as JAL
import canu_tpu.pipeline.html as JH
import canu_tpu.pipeline.objectstore as JOS
import canu_tpu.pipeline.splitreads as JSR
import canu_tpu.stores.overlaps as JOV
import canu_tpu.stores.tigs as JT
import canu_tpu_torch.graph as TG
import canu_tpu_torch.graph.best_overlap as TBO
import canu_tpu_torch.graph.repeats as TRP
import canu_tpu_torch.ops.align as TAL
import canu_tpu_torch.pipeline.html as TH
import canu_tpu_torch.pipeline.objectstore as TOS
import canu_tpu_torch.pipeline.splitreads as TSR
import canu_tpu_torch.stores.overlaps as TOV
import canu_tpu_torch.stores.tigs as TT
from canu_tpu_torch.pipeline.report import Report
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from torch_cases import one_torch_thread  # noqa: F401

COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")
PKG = {"jax": (JAL, JOV, JT), "torch": (TAL, TOV, TT)}


def _store(pkg: str, rows, n_reads: int):
    AL, OV, _ = PKG[pkg]
    cols = list(zip(*rows)) if rows else [[]] * 8
    dt = (np.int32, np.int32, bool, np.int32, np.int32, np.int32, np.int32, np.uint16)
    table = AL.OverlapTable(**{c: np.array(v, d) for c, v, d in zip(COLS, cols, dt)})
    return OV.OverlapStore.build(table, n_reads)


def _tig(pkg: str, tid, reads, bgn, end, rev, cls=1):
    return PKG[pkg][2].Tig(tid, np.asarray(reads, np.int32), np.asarray(bgn, np.int32),
                           np.asarray(end, np.int32), np.asarray(rev, bool), cls)


def _same_tigs(jt, tt):
    assert len(jt) == len(tt)
    for a, b in zip(jt, tt):
        assert (a.tig_id, a.tig_class) == (b.tig_id, b.tig_class)
        for f in ("read_id", "bgn", "end", "rev"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        assert (a.consensus is None) == (b.consensus is None)
        if a.consensus is not None:
            np.testing.assert_array_equal(a.consensus, b.consensus)


def truth_rows(seed: int, n_false: int = 0, genome: int = 20_000):
    """Store rows of every true overlap of two zero-error simulated read
    sets of two genomes (coordinates from the reads' genome placements),
    and of n_false 1,500-base alignments between reads of the two (repeat
    evidence), erates drawn from the seed; and the read lengths."""
    rng = np.random.default_rng(seed)
    rows, lens = [], []
    for part in range(2):
        g = random_genome(genome, seed=seed + 10 * part)
        rs, tr = simulate_reads(g, coverage=10, mean_len=3000, min_len=1200, max_len=6000,
                                error_rate=0.0, seed=seed + 10 * part + 1, circular=False)
        off = sum(len(x) for x in lens)
        L = rs.length.astype(np.int64)
        for a in range(rs.n_reads):
            for b in range(a + 1, rs.n_reads):
                lo, hi = max(tr.start[a], tr.start[b]), min(tr.end[a], tr.end[b])
                if hi - lo < 500:
                    continue
                span = []
                for r in (a, b):
                    x0, x1 = lo - tr.start[r], hi - tr.start[r]
                    span += [L[r] - x1, L[r] - x0] if tr.strand[r] else [x0, x1]
                rows.append((off + a + 1, off + b + 1, bool(tr.strand[a] != tr.strand[b]),
                             *span, int(rng.integers(0, 400))))
        lens.append(rs.length.copy())
    n1, lens = len(lens[0]), np.concatenate(lens)
    for _ in range(n_false):
        a, b = int(rng.integers(1, n1 + 1)), int(rng.integers(n1 + 1, len(lens) + 1))
        if min(lens[a - 1], lens[b - 1]) < 1600:
            continue
        xa, xb = (int(rng.integers(0, lens[r - 1] - 1500)) for r in (a, b))
        rows.append((a, b, bool(rng.random() < 0.5), xa, xa + 1500, xb, xb + 1500,
                     int(rng.integers(0, 400))))
    # one row per read pair
    rows = list({(r[0], r[1]): r for r in rows}.values())
    return rows, lens, len(lens)


@pytest.fixture(scope="module")
def truth_stores():
    rows, lens, n = truth_rows(3, n_false=30)
    return {p: _store(p, rows, n) for p in PKG}, lens


# ---- splitreads -------------------------------------------------------------


def _palindrome_rows(seed: int):
    """Reads with opposite-orientation duplicate overlaps near their middle
    (the subread-loop signature), spanning reads and plain dovetails."""
    rng = np.random.default_rng(seed)
    rows = []
    for a in range(1, 9):
        for b in range(a + 1, 13):
            if rng.random() < 0.35:
                bg = int(rng.integers(0, 1200))
                rows.append((a, b, False, bg, bg + 1400, 0, 1400, 300))
            if a <= 4 and rng.random() < 0.5:
                gap = int(rng.choice([120, 400, 900, 1800]))
                rows.append((a, b, False, 0, 1400, 100, 1500, 200))
                rows.append((a, b, True, 1400 + gap, 2900, 0, 1500 - gap, 250))
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_bad_regions_equal(seed):
    rows = _palindrome_rows(seed)
    j = JSR.detect_bad_regions(_store("jax", rows, 12))
    t = TSR.detect_bad_regions(_store("torch", rows, 12))
    assert t == j
    assert TSR.detect_bad_regions(_store("torch", [], 3)) == {}
    for iv, bad in (([(0, 100)], [(40, 60)]), ([(0, 100)], [(0, 10), (90, 100)]),
                    ([(0, 100)], []), ([(10, 20), (30, 40)], [(15, 35)])):
        assert TSR.subtract_regions(iv, bad) == JSR.subtract_regions(iv, bad)


def test_detect_bad_regions_on_subread_artifacts():
    """tests/test_splitreads.py's read set (20 reads tiling a genome, 4
    subread-loop artifacts) and canu_tpu's store of it (the palindromic
    verify): the same confirmed junctions."""
    from test_splitreads import _make_reads, _overlap_store

    rs, junctions = _make_reads()
    st = _overlap_store(rs)
    tst = TOV.OverlapStore(st.n_reads, **{c: np.asarray(getattr(st, c)) for c in COLS})
    want = JSR.detect_bad_regions(st)
    assert TSR.detect_bad_regions(tst) == want
    assert set(want) & set(junctions)


# ---- the tig store ----------------------------------------------------------


def test_tig_store_round_trip_both_ways(tmp_path):
    tigs = {}
    for p in PKG:
        t = _tig(p, 1, [3, 1], [0, 500], [2000, 2500], [False, True])
        t.consensus = np.array([0, 1, 2, 3], np.uint8)
        u = _tig(p, 7, [2], [0], [900], [False], cls=0)
        tigs[p] = PKG[p][2].TigStore([t, u])
        assert tigs[p].n50() == 4 and tigs[p][0].length == 4 and tigs[p][1].length == 900
    # each package loads the other's files
    tigs["torch"].save(tmp_path / "t", version=2)
    tigs["jax"].save(tmp_path / "j", version=2)
    assert TT.TigStore.latest_version(tmp_path / "j") == JT.TigStore.latest_version(
        tmp_path / "t") == 2
    _same_tigs(JT.TigStore.load(tmp_path / "t", version=2),
               TT.TigStore.load(tmp_path / "j", version=2))
    _same_tigs(tigs["jax"], TT.TigStore.load(tmp_path / "t", version=2))
    assert TT.TigStore.latest_version(tmp_path / "none") == 0
    assert (TT.CLASS_UNASSEMBLED, TT.CLASS_CONTIG, TT.CLASS_BUBBLE) == (
        JT.CLASS_UNASSEMBLED, JT.CLASS_CONTIG, JT.CLASS_BUBBLE)


# ---- the best-overlap graph -------------------------------------------------


@pytest.mark.parametrize("kw", [
    {},
    {"max_erate": 0.02, "deviation": 2.0},
    {"min_reads_per_contig": 3, "drop_dead_ends": False},
    {"max_rows": 400, "min_span": 800},
])
def test_build_unitigs_equal(truth_stores, tmp_path, kw):
    stores, lens = truth_stores
    flags = frozenset({"bestedges", "tigs"})
    out = {}
    for p, BO in (("jax", JBO), ("torch", TBO)):
        out[p] = BO.build_unitigs(stores[p], lens, log_dir=str(tmp_path / p), log_flags=flags,
                                  **kw)
    _same_tigs(out["jax"], out["torch"])
    assert len(out["torch"]) >= 1
    for f in sorted(os.listdir(tmp_path / "jax")):
        with open(tmp_path / "jax" / f) as a, open(tmp_path / "torch" / f) as b:
            assert a.read() == b.read(), f


def test_graph_passes_equal(truth_stores):
    stores, lens = truth_stores
    tigs = {p: BO.build_unitigs(stores[p], lens) for p, BO in (("jax", JBO), ("torch", TBO))}
    for kw in ({}, {"confused_absolute": 50.0, "confused_percent": 5.0}):
        j, jr = JG.mark_repeats(tigs["jax"], stores["jax"], lens, min_evidence=2, **kw)
        t, tr = TG.mark_repeats(tigs["torch"], stores["torch"], lens, min_evidence=2, **kw)
        _same_tigs(j, t)
        assert [vars(r) for r in jr] == [vars(r) for r in tr]
    _same_tigs(JG.split_discontinuous(tigs["jax"], 3), TG.split_discontinuous(tigs["torch"], 3))
    jm, tm = JG.merge_orphans(tigs["jax"], stores["jax"], lens), \
        TG.merge_orphans(tigs["torch"], stores["torch"], lens)
    _same_tigs(jm[0], tm[0])
    assert jm[1:] == tm[1:]
    _same_tigs(JBO.optimize_positions(tigs["jax"], stores["jax"], lens.astype(np.int64)),
               TBO.optimize_positions(tigs["torch"], stores["torch"], lens.astype(np.int64)))
    for a, b in zip(JRP.tig_read_index(tigs["jax"], len(lens)),
                    TRP.tig_read_index(tigs["torch"], len(lens))):
        np.testing.assert_array_equal(a, b)
    jc, tc = (BO.cap_store_rows(stores[p], 600) for p, BO in (("jax", JBO), ("torch", TBO)))
    for c in COLS:
        np.testing.assert_array_equal(getattr(jc, c), getattr(tc, c))


def _two_tig_rows():
    """tests/test_repeats.py's _two_tig_setup: tig 1 (reads 1..10), tig 2
    (reads 11..16), reads 4..7 of tig 1 aligned to tig 2."""
    rows = [(a, a + 1, False, 500, 1000, 0, 500, 200) for a in range(1, 10)]
    rows += [(a, a + 1, False, 500, 1000, 0, 500, 200) for a in range(11, 16)]
    rows += [(5, 12, False, 0, 1000, 0, 1000, 200), (6, 13, False, 0, 1000, 0, 1000, 200),
             (4, 11, False, 0, 1000, 0, 1000, 200), (7, 14, False, 0, 1000, 0, 1000, 200)]
    return rows


def _tiling(p, tid, first, n):
    bgn = np.arange(n) * 500
    return _tig(p, tid, np.arange(first, first + n), bgn, bgn + 1000, np.zeros(n, bool))


def test_repeat_cases_equal():
    lens = np.full(16, 1000, np.int32)
    res = {}
    for p, G, RP in (("jax", JG, JRP), ("torch", TG, TRP)):
        TS = PKG[p][2].TigStore
        tigs, st = TS([_tiling(p, 1, 1, 10), _tiling(p, 2, 11, 6)]), _store(p, _two_tig_rows(), 16)
        tig_of, *_ = RP.tig_read_index(tigs, 16)
        regions = RP.find_repeat_regions(tigs[0], st, tig_of, min_evidence=2)
        out, marked = G.mark_repeats(tigs, st, lens, min_evidence=2)
        gap = _tig(p, 1, [1, 2, 3, 4, 5], [0, 500, 1000, 3000, 3500],
                   [1000, 1500, 2000, 4000, 4500], np.zeros(5, bool))
        pair = _tig(p, 1, [1, 2], [0, 2000], [1000, 3000], np.zeros(2, bool))
        res[p] = (regions, out, marked, G.split_discontinuous(TS([gap])),
                  G.split_discontinuous(TS([pair]), min_reads_per_contig=2))
    j, t = res["jax"], res["torch"]
    assert [vars(r) for r in j[0]] == [vars(r) for r in t[0]] and len(t[0]) > 0
    _same_tigs(j[1], t[1])
    assert [vars(r) for r in j[2]] == [vars(r) for r in t[2]]
    _same_tigs(j[3], t[3])
    _same_tigs(j[4], t[4])


def test_orphan_cases_equal():
    """tests/test_bubbles.py's three cases."""
    def lin(p, tid, reads, length):
        n = len(reads)
        b = np.linspace(0, length - 1000, n).astype(np.int32)
        return _tig(p, tid, reads, b, b + 1000, np.zeros(n, bool))

    cases = [
        (lambda p: [lin(p, 1, [1, 2, 3, 4, 5, 6], 6000), lin(p, 2, [7, 8], 1800)],
         [(7, 2, False, 0, 900, 50, 950, 100), (8, 3, False, 0, 900, 100, 1000, 100)],
         [1000] * 6 + [900, 900], {}),
        (lambda p: [lin(p, 1, [1, 2, 3, 4, 5, 6], 6000), lin(p, 2, [7, 8], 1800)],
         [(7, 2, False, 0, 900, 50, 950, 100)], [1000] * 6 + [900, 900],
         {"place_fraction_bubble": 0.5}),
        (lambda p: [_tig(p, 1, [1, 2, 3], [0, 1000, 2000], [1000, 2000, 3000],
                         [False, True, False]), _tig(p, 2, [4], [0], [900], [False])],
         [(4, 2, True, 0, 900, 100, 1000, 100)], [1000, 1000, 1000, 900],
         {"place_fraction_bubble": 0.5}),
    ]
    for make, rows, lens, kw in cases:
        lens = np.array(lens, np.int32)
        j = JG.merge_orphans(JT.TigStore(make("jax")), _store("jax", rows, len(lens)), lens, **kw)
        t = TG.merge_orphans(TT.TigStore(make("torch")), _store("torch", rows, len(lens)), lens,
                             **kw)
        _same_tigs(j[0], t[0])
        assert j[1:] == t[1:]


# ---- object store and HTML --------------------------------------------------


def test_object_store_and_html_equal(tmp_path):
    for p, OS in (("jax", JOS), ("torch", TOS)):
        d = tmp_path / p
        d.mkdir()
        (d / "a.txt").write_text("payload\n")
        (d / "store").mkdir()
        (d / "store" / "x.npy").write_bytes(b"\x00\x01")
        ob = OS.make_object_store(f"TEST:{d / 'bucket'}")
        assert isinstance(ob, OS.LocalObjectStore) and OS.make_object_store("") is None
        ob.stash_file(str(d / "a.txt"), "k/a.txt")
        assert ob.exists("k/a.txt") and not ob.exists("k/none")
        assert ob.fetch_file("k/a.txt", str(d / "b.txt")) and not ob.fetch_file("none",
                                                                                 str(d / "c"))
        ob.stash_store(str(d / "store"), "k/store.tar")
        assert ob.fetch_store("k/store.tar", str(d / "back"))
        assert (d / "back" / "store" / "x.npy").read_bytes() == b"\x00\x01"
        with pytest.raises(ValueError):
            OS.make_object_store("s3://nope")
    assert isinstance(TOS.make_object_store("gs://b"), TOS.GCSObjectStore)

    rep = Report(str(tmp_path / "asm.report"))
    rep.add("obt.trim", "kept 3 reads")
    rep.add("utg.unitig", "2 tigs <contigs>")
    rep.add("misc", "x & y")
    with open(tmp_path / "asm.stage-times.jsonl", "w") as fh:
        fh.write('{"stage": "obt-overlap", "wall_s": 3.5, "attempt": 1}\n'
                 '{"stage": "oea.sub", "sub_walls_s": {"red": 1.0, "adjust": 2.0}}\n')
    pages = []
    for H in (JH, TH):
        with open(H.build_html(str(tmp_path), "asm")) as fh:
            pages.append([ln for ln in fh.read().splitlines() if "generated" not in ln])
    assert pages[0] == pages[1]
    assert TH.ascii_histogram([1, 5, 2], label="x") == JH.ascii_histogram([1, 5, 2], label="x")
