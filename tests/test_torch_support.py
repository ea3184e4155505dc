"""The port's own copies of canu_tpu's numpy-only pieces give what canu_tpu's
give: the simulator (same seeds, same reads), bit packing, ReadSet (packed
words, blocks, slices, FASTA/FASTQ loading, the on-disk store), the
config registry, error estimation, the report, the resource solver, and
the quality and interval math.  Exact."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

import canu_tpu.config as JC
from canu_tpu.io.fastx import write_fasta, write_fastq
import canu_tpu.ops.errorest as JE
import canu_tpu.pipeline.configure as JCF
import canu_tpu.pipeline.report as JR
import canu_tpu.sim.simulate as JSIM
import canu_tpu.stores.readset as JRS
import canu_tpu.utils.bitpack as JB
import canu_tpu.utils.intervals as JI
import canu_tpu.utils.quality as JQ
import canu_tpu_torch.config as TC
import canu_tpu_torch.ops.errorest as TE
import canu_tpu_torch.pipeline.configure as TCF
import canu_tpu_torch.pipeline.report as TR
import canu_tpu_torch.sim.simulate as TSIM
import canu_tpu_torch.stores.readset as TRS
import canu_tpu_torch.utils.bitpack as TB
import canu_tpu_torch.utils.intervals as TI
import canu_tpu_torch.utils.quality as TQ

READ_ARRAYS = ("words", "word_off", "length", "source_id", "source_bgn")


def _same_reads(a, b):
    for name in READ_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.names == b.names
    assert (a.quals is None) == (b.quals is None)
    if a.quals is not None:
        np.testing.assert_array_equal(a.quals, b.quals)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_simulator_same_seeds_same_reads(seed):
    kw = dict(length=9_000, seed=seed, repeat_spec=[(300, 4)] if seed else None)
    g_j, g_t = JSIM.random_genome(**kw), TSIM.random_genome(**kw)
    np.testing.assert_array_equal(g_t, g_j)
    sim = dict(coverage=5, mean_len=900, min_len=400, max_len=1600,
               error_rate=0.1, seed=seed + 1, circular=seed != 3)
    rs_j, tr_j = JSIM.simulate_reads(g_j, **sim)
    rs_t, tr_t = TSIM.simulate_reads(g_t, **sim)
    assert isinstance(rs_t, TRS.ReadSet)
    _same_reads(rs_j, rs_t)
    for f in dataclasses.fields(tr_j):
        np.testing.assert_array_equal(getattr(tr_t, f.name), getattr(tr_j, f.name))
    np.testing.assert_array_equal(TSIM.true_overlaps(tr_t, 300), JSIM.true_overlaps(tr_j, 300))
    ids = np.arange(1, rs_j.n_reads + 1)[::-1]
    for x, y in zip(rs_t.block_words(ids), rs_j.block_words(ids)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(rs_t.block_words(ids[:5], 200), rs_j.block_words(ids[:5], 200)):
        np.testing.assert_array_equal(x, y)
    rng = np.random.default_rng(seed)
    bgn = rng.integers(-5, 300, rs_j.n_reads)
    end = bgn + rng.integers(-10, 700, rs_j.n_reads)
    _same_reads(rs_j.sliced(bgn, end), rs_t.sliced(bgn, end))
    for r in (1, rs_j.n_reads):
        assert rs_t.get_seq(r) == rs_j.get_seq(r)
    # mutate_read draws in the same order: the same generator state gives
    # the same read and leaves the generator in the same state
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    for er in (0.0, 0.05, 0.3):
        np.testing.assert_array_equal(TSIM.mutate_read(g_t[:500], er, rt),
                                      JSIM.mutate_read(g_j[:500], er, rj))
    assert rt.random() == rj.random()


def test_bitpack_equal():
    rng = np.random.default_rng(2)
    for n in (0, 1, 15, 16, 17, 100):
        codes = rng.integers(0, 4, n).astype(np.uint8)
        w = TB.pack_codes(codes)
        np.testing.assert_array_equal(w, JB.pack_codes(codes))
        np.testing.assert_array_equal(TB.unpack_words(w, n), codes)
        np.testing.assert_array_equal(TB.revcomp_codes(codes), JB.revcomp_codes(codes))
        assert TB.n_words(n) == JB.n_words(n)
    seq = "ACGTNacgtRA"
    np.testing.assert_array_equal(TB.seq_to_codes(seq), JB.seq_to_codes(seq))
    assert TB.codes_to_seq(TB.seq_to_codes("ACGTTGCA")) == "ACGTTGCA"


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "fasta.gz"])
def test_readset_fastx_and_store_round_trip(tmp_path, fmt):
    rng = np.random.default_rng(9)
    recs = []
    for i in range(6):
        s = "".join("ACGT"[c] for c in rng.integers(0, 4, int(rng.integers(200, 900))))
        if i % 3 == 1:  # split at N, one fragment below the length cut
            s = s[:150] + "N" + s[150:]
        recs.append((f"r{i} desc", s))
    path = str(tmp_path / f"reads.{fmt}")
    if fmt == "fastq":
        write_fastq(path, [(n, s, "".join(chr(33 + (j % 40)) for j in range(len(s))))
                           for n, s in recs])
    else:
        write_fasta(path, recs, width=60)
    rs_j, st_j = JRS.ReadSet.from_fastx(path, min_read_length=180)
    rs_t, st_t = TRS.ReadSet.from_fastx(path, min_read_length=180)
    assert dataclasses.asdict(st_t) == dataclasses.asdict(st_j)
    _same_reads(rs_j, rs_t)
    np.testing.assert_array_equal(rs_t.length_histogram(100), rs_j.length_histogram(100))
    if rs_t.has_quals:
        np.testing.assert_array_equal(rs_t.mean_quals(), rs_j.mean_quals())
    # either package reads the store the other writes
    rs_t.save(tmp_path / "t.store")
    rs_j.save(tmp_path / "j.store")
    _same_reads(JRS.ReadSet.load(tmp_path / "t.store"), rs_t)
    _same_reads(TRS.ReadSet.load(tmp_path / "j.store", mmap=False), rs_j)


def _configs(keys):
    cj, ct = JC.Config(), TC.Config()
    for k, v in keys:
        cj.set(k, v)
        ct.set(k, v)
    return cj, ct


@pytest.mark.parametrize("keys", [
    [],
    [("genomeSize", "4.6m"), ("readType", "nanopore")],
    [("rawErrorRate", 0.4), ("corOvlErrorRate", 0.2), ("correctedErrorRate", 0.1),
     ("merSize", 20), ("contigFilter", "3 100 0.9 0.4 4")],
], ids=["defaults", "profile", "meta"])
def test_config_registry_equal(keys):
    cj, ct = _configs(keys)
    assert set(ct.registry) == set(cj.registry)
    for lk, p in cj.registry.items():
        q = ct.registry[lk]
        assert (q.key, q.synopsis, q.tag_base) == (p.key, p.synopsis, p.tag_base), lk
        assert q.default == p.default and type(q.default) is type(p.default), lk
    for c in (cj, ct):
        c.apply_read_type_profile()
    assert ct.to_dict() == cj.to_dict()
    assert (ct.explicit, ct.fanned) == (cj.explicit, cj.fanned)
    assert ct.print_options() == cj.print_options()
    for tag in ("cor", "obt", "utg"):
        for cov in (10, 40):
            assert ct.sketch_preset(tag, cov) == cj.sketch_preset(tag, cov)
    if cj.get("genomeSize") is not None:
        cj.validate()
        ct.validate()
    with pytest.raises(TC.ConfigError):
        ct.set("noSuchKey", 1)


def test_config_rejects_what_canu_tpu_rejects():
    for key, value in (("utgOvlBandWidth", 200), ("corMerSize", 40), ("gridEngine", "SGE")):
        cj, ct = _configs([("genomeSize", "1m"), (key, value)])
        with pytest.raises(JC.ConfigError) as ej:
            cj.validate()
        with pytest.raises(TC.ConfigError) as et:
            ct.validate()
        assert str(et.value) == str(ej.value)
    with pytest.raises(TC.ConfigError):
        TC.Config().validate()  # genomeSize unset


@pytest.mark.parametrize("n", [0, 1, 500])
def test_estimate_error_rates_equal(n):
    erates = np.random.default_rng(n).gamma(2.0, 0.04, n).astype(np.float32)
    for margin in (1.25, 1.5):
        got = TE.estimate_error_rates(erates, margin)
        ref = JE.estimate_error_rates(erates, margin)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_report_and_resources_equal(tmp_path):
    for R in (JR.Report, TR.Report):
        rep = R(str(tmp_path / f"{R.__module__}.report"))
        rep.add("cor.meryl", "k=16")
        rep.add("cor.overlap", "rows")
    a = JR.Report(str(tmp_path / f"{JR.Report.__module__}.report"))
    b = TR.Report(str(tmp_path / f"{TR.Report.__module__}.report"))
    assert b.data == a.data and b.render() == a.render() and b.get("cor.meryl") == "k=16"
    assert TCF._BYTES_PER_PAIR == JCF._BYTES_PER_PAIR
    for keys in ([], [("maxMemory", 2), ("maxThreads", 4)], [("maxMemory", 512)]):
        cj, ct = _configs(keys)
        got = TCF.configure_resources(ct)
        assert isinstance(got, TCF.Resources)
        # canu_tpu's solver also sizes its vote engine from the device: only
        # the decisions the overlap stage reads are compared
        ref = JCF.configure_resources(cj)
        assert (got.spill_pairs, got.sort_mem_bytes, got.sort_threads) == \
            (ref.spill_pairs, ref.sort_mem_bytes, ref.sort_threads)
    assert os.path.exists(tmp_path / f"{TR.Report.__module__}.report")


@pytest.mark.parametrize("seed", [0, 1])
def test_quality_math_equal(seed):
    rng = np.random.default_rng(seed)
    length = rng.integers(0, 900, 40).astype(np.int32)
    quals = rng.integers(0, 41, int(length.sum())).astype(np.uint8)
    qual_off = np.concatenate([[0], np.cumsum(length)]).astype(np.int64)
    # low-quality stretches, and a read of unknown (0) quality throughout
    for r in range(0, 40, 4):
        lo = qual_off[r] + length[r] // 3
        quals[lo : lo + 120] = rng.integers(0, 6, len(quals[lo : lo + 120]))
    quals[qual_off[5] : qual_off[6]] = 0
    np.testing.assert_array_equal(TQ.phred_to_error(quals), JQ.phred_to_error(quals))
    for min_qv, window, chunk in ((7.0, 100, 4096), (12.0, 30, 7)):
        got = TQ.quality_clear_ranges(length, quals, qual_off, min_qv, window, chunk)
        ref = JQ.quality_clear_ranges(length, quals, qual_off, min_qv, window, chunk)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    mean = rng.uniform(0, 40, 50).astype(np.float32)
    for bin_size in (1, 2, 5):
        np.testing.assert_array_equal(TQ.read_quality_histogram(mean, bin_size),
                                      JQ.read_quality_histogram(mean, bin_size))
    np.testing.assert_array_equal(TQ.read_quality_histogram(mean[:0]),
                                  JQ.read_quality_histogram(mean[:0]))


@pytest.mark.parametrize("seed", [0, 1])
def test_interval_math_equal(seed):
    rng = np.random.default_rng(seed)
    bgn = rng.integers(0, 5000, 300)
    spans = np.stack([bgn, bgn + rng.integers(1, 800, 300)], axis=1)
    spans[:20, 1] = spans[20:40, 0]  # touching spans
    owner = rng.integers(1, 12, 300)
    for min_cov in (1, 2, 4):
        for a, b in zip(TI.coverage_depth_events(spans), JI.coverage_depth_events(spans)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(TI.covered_intervals(spans, min_cov),
                                      JI.covered_intervals(spans, min_cov))
        for a, b in zip(TI.covered_intervals_all(owner, spans[:, 0], spans[:, 1], min_cov),
                        JI.covered_intervals_all(owner, spans[:, 0], spans[:, 1], min_cov)):
            np.testing.assert_array_equal(a, b)
        assert TI.largest_covered(spans, min_cov) == JI.largest_covered(spans, min_cov)
    empty = np.zeros((0, 2), np.int64)
    assert TI.largest_covered(empty) == JI.largest_covered(empty) == (0, 0)
    for a, b in zip(TI.covered_intervals_all(empty[:, 0], empty[:, 0], empty[:, 1]),
                    JI.covered_intervals_all(empty[:, 0], empty[:, 0], empty[:, 1])):
        np.testing.assert_array_equal(a, b)


def test_vote_budget_equal(monkeypatch):
    """The vote engine's DP cells a chunk, from the card's memory: the
    port's (torch.cuda.mem_get_info) and canu_tpu's (jax memory_stats)
    make the same decision."""
    import jax

    import canu_tpu.ops.votepile as JV
    import canu_tpu_torch.ops.votepile as TV
    import torch

    for card in (16 << 30, 80 << 30, 1 << 30):
        for mod in (JV, TV):
            monkeypatch.setattr(mod, "CHUNK_CELL_BUDGET", 1 << 21)
        dev = type("Dev", (), {"memory_stats": lambda self: {"bytes_limit": card}})()
        monkeypatch.setattr(jax, "local_devices", lambda: [dev])
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (card // 2, card))
        cj, ct = _configs([])
        ref, got = JCF.configure_resources(cj), TCF.configure_resources(ct)
        assert got.decisions == ref.decisions and TV.CHUNK_CELL_BUDGET == JV.CHUNK_CELL_BUDGET
        assert "chunkCellBudget" in got.decisions
