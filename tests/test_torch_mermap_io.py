"""The port's k-mer DB algebra, persistence and count_reads, its overlap
text I/O (io/overlaps_io.py) and its ancillary k-mer tools (ops/mermap.py)
against canu_tpu's on the CPU.  Exact.

One deliberate difference: the port's KmerCounts.load keeps the saved
k-mer dtype, where canu_tpu's casts a k > 16 DB's exact uint64 k-mers to
uint32.  So the k=22 tests hold the port's save/load round trip to
itself and its results on a loaded DB to canu_tpu's on the DB in
memory."""

from __future__ import annotations

import numpy as np
import pytest

import canu_tpu.io.overlaps_io as JIO
import canu_tpu.ops.kmer as JK
import canu_tpu.ops.mermap as JM
import canu_tpu.stores.readset as JRS
import canu_tpu_torch.io.overlaps_io as TIO
import canu_tpu_torch.ops.kmer as TK
import canu_tpu_torch.ops.mermap as TM
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

OPS = ("union_sum", "union_min", "union_max", "intersect_min", "intersect_max",
       "intersect_sum", "subtract", "difference")


@pytest.fixture(scope="module")
def reads():
    """A small read set (the port's) and its copy as canu_tpu's ReadSet."""
    g = random_genome(15_000, seed=31, repeat_spec=[(600, 3)])
    rs, _ = simulate_reads(g, coverage=6, mean_len=1500, min_len=600, max_len=2500,
                           error_rate=0.05, seed=32, circular=False)
    jrs = JRS.ReadSet(rs.words, rs.word_off, rs.length, rs.names, rs.source_id,
                      rs.source_bgn)
    return rs, jrs


def _same(a, b):
    assert a.k == b.k
    assert a.unique.dtype == b.unique.dtype
    np.testing.assert_array_equal(a.unique, b.unique)
    np.testing.assert_array_equal(a.counts, b.counts)


def _dbs(k, seed):
    """Two random DBs with shared keys, as both packages' KmerCounts."""
    rng = np.random.default_rng(seed)
    dt = np.uint32 if k <= 16 else np.uint64
    top = (1 << (2 * k)) - 1
    keys = np.unique(rng.integers(0, top, size=3000, dtype=np.uint64)).astype(dt)
    a = np.sort(rng.choice(keys, size=1800, replace=False))
    b = np.sort(rng.choice(keys, size=1700, replace=False))
    ca = rng.integers(1, 9, size=len(a)).astype(np.int64)
    cb = rng.integers(1, 9, size=len(b)).astype(np.int64)
    return ((JK.KmerCounts(k, a, ca), JK.KmerCounts(k, b, cb)),
            (TK.KmerCounts(k, a.copy(), ca.copy()), TK.KmerCounts(k, b.copy(), cb.copy())))


@pytest.mark.parametrize("k", [16, 22])
@pytest.mark.parametrize("op", OPS)
def test_binary_ops_equal(k, op):
    (ja, jb), (ta, tb) = _dbs(k, 7)
    _same(getattr(ta, op)(tb), getattr(ja, op)(jb))


@pytest.mark.parametrize("k", [16, 22])
def test_filters_histogram_merge_equal(k):
    (ja, jb), (ta, tb) = _dbs(k, 8)
    for n in (1, 3, 8):
        _same(ta.at_least(n), ja.at_least(n))
        _same(ta.at_most(n), ja.at_most(n))
    _same(ta.merge(tb), ja.merge(jb))
    np.testing.assert_array_equal(ta.histogram(5), ja.histogram(5))
    assert (ta.n_distinct, ta.n_total) == (ja.n_distinct, ja.n_total)


def test_save_load_k16_equal(tmp_path):
    (ja, _), (ta, _) = _dbs(16, 9)
    ta.save(str(tmp_path / "t"))
    ja.save(str(tmp_path / "j.npz"))
    _same(TK.KmerCounts.load(str(tmp_path / "t")), JK.KmerCounts.load(str(tmp_path / "j")))
    _same(TK.KmerCounts.load(str(tmp_path / "t.npz")), ta)


@pytest.mark.parametrize("k", [16, 22])
def test_count_reads_equal(reads, k):
    rs, jrs = reads
    _same(TK.count_reads(rs, k, block_size=64, device="cpu"),
          JK.count_reads(jrs, k, block_size=64))


def test_k22_save_load_round_trip_exact(reads, tmp_path):
    """A k=22 DB saved and loaded by the port is the DB it counted."""
    rs, _ = reads
    db = TK.count_reads(rs, 22, block_size=64, device="cpu")
    assert db.unique.dtype == np.uint64 and int(db.unique.max()) > 1 << 32
    db.save(str(tmp_path / "db22"))
    _same(TK.KmerCounts.load(str(tmp_path / "db22")), db)


def test_map_mers_on_loaded_k22_db_equals_in_memory(reads, tmp_path):
    """map_mers_stats on the port's loaded k=22 DB equals canu_tpu's on its
    DB in memory, hits on every read."""
    rs, jrs = reads
    TK.count_reads(rs, 22, block_size=64, device="cpu").save(str(tmp_path / "db22"))
    got = TM.map_mers_stats(rs, TK.KmerCounts.load(str(tmp_path / "db22")), lo=1)
    want = JM.map_mers_stats(jrs, JK.count_reads(jrs, 22, block_size=64), lo=1)
    assert [vars(s) for s in got] == [vars(s) for s in want]
    assert all(s.n_hits == s.n_mers > 0 for s in got)


@pytest.mark.parametrize("k", [16, 22])
def test_mermap_equal(reads, k):
    rs, jrs = reads
    tdb = TK.count_reads(rs, k, block_size=64, device="cpu")
    jdb = JK.count_reads(jrs, k, block_size=64)
    (tc, tv), (jc, jv) = TM.positional_kmers(rs, k), JM.positional_kmers(jrs, k)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    cnt = TM.db_counts_at(tc, tdb)
    np.testing.assert_array_equal(cnt, JM.db_counts_at(jc, jdb))
    for lo, hi in ((1, 2**62), (2, 4), (3, 2**62)):
        assert ([vars(s) for s in TM.map_mers_stats(rs, tdb, lo=lo, hi=hi)]
                == [vars(s) for s in JM.map_mers_stats(jrs, jdb, lo=lo, hi=hi)])
        hit = tv & (cnt >= lo) & (cnt <= hi)
        for a, b in zip(TM.covered_intervals(rs, hit, k), JM.covered_intervals(jrs, hit, k)):
            np.testing.assert_array_equal(a, b)
    for thr, ml in ((2, 64), (3, 200)):
        np.testing.assert_array_equal(TM.mer_trim(rs, tdb, thr, ml),
                                      JM.mer_trim(jrs, jdb, thr, ml))
    asm_t = TK.count_readset_host(rs.sliced(np.zeros(rs.n_reads, np.int64),
                                            rs.length.astype(np.int64) // 2), k)
    asm_j = JK.KmerCounts(k, asm_t.unique.copy(), asm_t.counts.copy())
    for low in (2, 3):
        rt, rj = TM.mercy(tdb, asm_t, low), JM.mercy(jdb, asm_j, low)
        assert (rt.summary(), rt.classes, rt.missing_normal) == \
            (rj.summary(), rj.classes, rj.missing_normal)


def _tables_equal(a, b):
    for c in ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q"):
        x, y = getattr(a, c), getattr(b, c)
        assert x.dtype == y.dtype, c
        np.testing.assert_array_equal(x, y, err_msg=c)


def test_overlaps_io_equal(reads, tmp_path):
    rs, jrs = reads
    assert TIO.name_index(rs) == JIO.name_index(jrs)
    names = TIO.name_index(rs)
    rng = np.random.default_rng(4)
    nm = list(names)
    lines = ["# comment\n", "too\tfew\tcolumns\n"]
    for _ in range(300):
        q, t = rng.choice(len(nm), size=2, replace=False)
        s0, s1 = sorted(rng.integers(0, 2000, size=2))
        aln = int(rng.integers(0, 600))
        lines.append(f"{nm[q]}\t2000\t{s0}\t{s1 + 1}\t{'+-'[rng.integers(2)]}\t{nm[t]}\t2000\t"
                     f"{s0}\t{s1 + 1}\t{rng.integers(0, aln + 1)}\t{aln}\t60\n")
    lines.append(f"{nm[0]}\t9\t0\t5\t+\t{nm[0]}\t9\t0\t5\t5\t5\t60\n")  # self: skipped
    lines.append(f"missing\t9\t0\t5\t+\t{nm[1]}\t9\t0\t5\t5\t5\t60\n")  # unknown: skipped
    for mo in (0, 300):
        _tables_equal(TIO.paf_to_table(lines, names, mo), JIO.paf_to_table(lines, names, mo))
    paf = tmp_path / "x.paf.gz"
    import gzip

    with gzip.open(paf, "wt") as fh:
        fh.writelines(lines)
    t = TIO.paf_to_table(str(paf), names)
    _tables_equal(t, JIO.paf_to_table(str(paf), names))
    for ext in ("tsv", "tsv.gz"):
        TIO.write_table_text(str(tmp_path / f"t.{ext}"), t)
        JIO.write_table_text(str(tmp_path / f"j.{ext}"), t)
        if ext == "tsv":
            assert (tmp_path / "t.tsv").read_bytes() == (tmp_path / "j.tsv").read_bytes()
        _tables_equal(TIO.read_table_text(str(tmp_path / f"t.{ext}")),
                      JIO.read_table_text(str(tmp_path / f"j.{ext}")))
    for n, nr, ln, seed in ((1000, 50, 10000, 0), (10, 3, 600, 5)):
        _tables_equal(TIO.random_overlaps(n, nr, ln, seed), JIO.random_overlaps(n, nr, ln, seed))
    empty = tmp_path / "empty.tsv"
    empty.write_text("#a_id\n")
    _tables_equal(TIO.read_table_text(str(empty)), JIO.read_table_text(str(empty)))
