"""The read samples that stand in for a whole trimming and assembly
(chip_smoke.py's ecoliasm phase, scripts/torch_ecoli_assembly_reference.py)
are sound, on the CPU, on a small corrected read set at 15x, and canu_tpu
and the port agree on them:

  (a) trimming_phase on the full obt store gives the sampled reads the same
      trimmed records as on the store of their a_id rows, in both packages
      (the rows verified from the candidates with a sampled read on either
      side equal the full store's);
  (b) detect_read_errors (RED) on the full utg store gives the sampled
      templates the same corrections as on the store of their a_id rows;
      canu_tpu's run on that store gives the port's;
  (c) adjust_overlap_erates (OEA) of the rows with a sampled read on either
      side, given every read's corrections, gives those rows the full
      adjust's erates, in both packages; with the a_id rows alone the rows
      whose mirror is missing keep their old erate: the trap the rule
      avoids;
  (d) the unitig stage on a given adjusted store (unitig_layouts) gives the
      same layouts in both packages; the stage-boundary files round-trip.

Both packages' vote engines run at VOTE_SEG 512 with 16 segments a block
and 64 jobs a chunk, and RED at 8x evidence and band 64 (set by the
test), to keep the CPU run short; the rules hold at any geometry.  Most
of the file's time is canu_tpu's compiles of its vote engine and its
verify."""

from __future__ import annotations

import numpy as np
import pytest

import canu_tpu.ops.falcon as JF
import canu_tpu.ops.oea as JOEA
import canu_tpu.ops.votepile as JV
import canu_tpu.pipeline.driver as JD
import canu_tpu.pipeline.stages as JS
import canu_tpu.stores.overlaps as JO
import canu_tpu.stores.readset as JRS
import canu_tpu_torch.ops.align as TA
import canu_tpu_torch.ops.falcon as TF
import canu_tpu_torch.ops.kmer as TK
import canu_tpu_torch.ops.minhash as TM
import canu_tpu_torch.ops.oea as TOEA
import canu_tpu_torch.ops.votepile as TV
import canu_tpu_torch.pipeline.driver as TD
import canu_tpu_torch.pipeline.stages as TS
import canu_tpu_torch.stores.overlaps as TO
from canu_tpu.config import Config as JConfig
from canu_tpu_torch.config import Config
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from torch_cases import (  # noqa: F401  (one_torch_thread: autouse fixture)
    STORE_COLS,
    _sha_of,
    adjust_kwargs,
    corrections_arrays,
    corrections_from_arrays,
    corrections_records,
    one_torch_thread,
    pack_records,
    pairs_of_reads,
    red_kwargs,
    rows_of_reads,
    store_from_halves,
    store_halves,
    store_of_templates,
    template_sample,
    trim_with_store,
    trimmed_from_names,
    trimmed_of,
    unitig_layouts,
    unpack_records,
    verify_kwargs,
)

SEG = 512
GENOME = 5_000
SAMPLE = 8
EVIDENCE = 8
RED_BAND = 64


def _cfg(cls=Config):
    cfg = cls()
    cfg.set("genomeSize", GENOME)
    cfg.apply_read_type_profile()
    cfg.validate()
    return cfg


def _red_kwargs() -> dict:
    """The oea stage's RED arguments at EVIDENCE x evidence and RED_BAND."""
    return dict(red_kwargs(_cfg()), max_evidence_coverage=EVIDENCE, band=RED_BAND)


def _cols(st, cls):
    return cls(st.n_reads, **{c: np.asarray(getattr(st, c)) for c in STORE_COLS})


@pytest.fixture(scope="module")
def reads():
    """A corrected read set at 15x and 1% error, as both packages' ReadSets."""
    g = random_genome(GENOME, seed=91)
    trs, _ = simulate_reads(g, coverage=15, mean_len=1400, min_len=1100, max_len=1700,
                            error_rate=0.01, seed=92)
    jrs = JRS.ReadSet(trs.words, trs.word_off, trs.length, trs.names, trs.source_id,
                      trs.source_bgn)
    return trs, jrs


def _stores(trs, tag: str):
    """The port's full store of tag's candidates, the sample, and the store
    of the sample's a_id rows verified from its candidates alone."""
    cfg = _cfg()
    kw = verify_kwargs(cfg, tag)
    fk = TK.frequent_kmers(TK.count_readset_device(trs, k=kw["k"], block_size=64, device="cpu"))
    sk = TM.build_sketches(trs, k=kw["k"], n_hashes=256, frequent=fk, block_size=64,
                           device="cpu")
    pairs = TM.find_candidates_join(sk, min_matches=2, device="cpu")
    st = TO.OverlapStore.build(TA.verify_overlaps(trs, pairs, device="cpu", **kw), trs.n_reads)
    sample = template_sample(np.arange(1, trs.n_reads + 1), SAMPLE)
    sp = pairs_of_reads(pairs, sample)
    assert 0 < len(sp) < len(pairs) // 2
    sub = TO.OverlapStore.build(TA.verify_overlaps(trs, sp, device="cpu", **kw), trs.n_reads)
    rst = store_of_templates(sub, sample, TO.OverlapStore)
    # the rows verified from the sample's candidates are the full store's
    assert TO.store_digest(rst) == TO.store_digest(store_of_templates(st, sample))
    assert TO.store_digest(rows_of_reads(sub, sample)) == TO.store_digest(
        rows_of_reads(st, sample))
    return st, sample, rst


@pytest.fixture(scope="module")
def obt(reads):
    return _stores(reads[0], "obt")


@pytest.fixture(scope="module")
def utg(reads):
    return _stores(reads[0], "utg")


@pytest.fixture
def small_geometry(monkeypatch):
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "VOTE_SEG", SEG)
    for mod in (JV, TV):
        monkeypatch.setattr(mod, "BLOCK_POS_BUDGET", SEG * 16)  # G = 16 segments a block
        monkeypatch.setattr(mod, "CHUNK_CELL_BUDGET", SEG * 64)  # 64 jobs a chunk


@pytest.fixture(scope="module")
def red_full(reads, utg):
    """The port's RED on the full utg store at the small geometry."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (TF,):
            mp.setattr(mod, "VOTE_SEG", SEG)
        mp.setattr(TV, "BLOCK_POS_BUDGET", SEG * 16)
        mp.setattr(TV, "CHUNK_CELL_BUDGET", SEG * 64)
        return TOEA.detect_read_errors(reads[0], utg[0], device="cpu", **_red_kwargs())


def test_trimming_sample_equals_full(reads, obt, tmp_path):
    trs, jrs = reads
    st, sample, rst = obt
    names = {trs.name(int(i)) for i in sample}
    got = {}
    for pkg, stages, make_ctx, cfg_cls, store_cls, rs, kw in (
            ("port", TS, TD.make_ctx, Config, TO.OverlapStore, trs, {"device": "cpu"}),
            ("canu_tpu", JS, JD.make_ctx, JConfig, JO.OverlapStore, jrs, {})):
        for which, store in (("full", st), ("sample", rst)):
            ctx = make_ctx(str(tmp_path / f"{pkg}_{which}"), "t", _cfg(cfg_cls))
            got[pkg, which] = trim_with_store(stages, ctx, rs, _cols(store, store_cls), **kw)
    mine = trimmed_of(got["port", "full"], names)
    assert len(mine) >= SAMPLE // 2 and len(got["port", "full"]) > 4 * len(mine)
    assert got["port", "sample"] == mine
    assert got["canu_tpu", "full"] == got["port", "full"]
    assert got["canu_tpu", "sample"] == mine
    # the names carry the cut: the records rebuild from the untrimmed reads
    untrimmed = [(trs.name(i), trs.get_seq(i)) for i in range(1, trs.n_reads + 1)]
    assert trimmed_from_names(untrimmed, [n for n, _ in mine]) == mine


def test_red_sample_equals_full(reads, utg, red_full, small_geometry):
    trs, jrs = reads
    st, sample, rst = utg
    kw = _red_kwargs()
    mine = {int(i): red_full[int(i)] for i in sample if int(i) in red_full}
    assert mine and len(red_full) > 4 * len(mine)
    got = TOEA.detect_read_errors(trs, rst, device="cpu", **kw)
    assert sorted(got) == sorted(mine)
    assert _sha_of(corrections_records(got)) == _sha_of(corrections_records(mine))
    j = JOEA.detect_read_errors(jrs, _cols(rst, JO.OverlapStore), **kw)
    assert _sha_of(corrections_records(j)) == _sha_of(corrections_records(got))


def test_adjust_sample_equals_full(reads, utg, red_full):
    trs, jrs = reads
    st, sample, _ = utg
    kw = adjust_kwargs(_cfg())
    full = _cols(st, TO.OverlapStore)
    full.update_erates(TOEA.adjust_overlap_erates(trs, full, red_full, device="cpu", **kw))
    want = rows_of_reads(full, sample)
    assert (want.erate_q != rows_of_reads(st, sample).erate_q).any()
    touch = rows_of_reads(st, sample, TO.OverlapStore)
    touch.update_erates(TOEA.adjust_overlap_erates(trs, touch, red_full, device="cpu", **kw))
    assert TO.store_digest(touch) == TO.store_digest(want)
    jt = rows_of_reads(st, sample, JO.OverlapStore)
    jt.update_erates(JOEA.adjust_overlap_erates(jrs, jt, red_full, **kw))
    assert TO.store_digest(jt) == TO.store_digest(want)
    # the a_id rows alone: a pair's a_id > b_id row has no a_id < b_id mirror
    # there, so it is not verified again and keeps its old erate
    alone = store_of_templates(st, sample, TO.OverlapStore)
    alone.update_erates(TOEA.adjust_overlap_erates(trs, alone, red_full, device="cpu", **kw))
    assert TO.store_digest(alone) != TO.store_digest(store_of_templates(full, sample))


def test_unitig_layouts_equal(reads, utg, tmp_path):
    trs, jrs = reads
    st = utg[0]
    port = unitig_layouts(TS, TD.StopPipeline, TD.make_ctx(str(tmp_path / "port"), "t", _cfg()),
                          trs, _cols(st, TO.OverlapStore), device="cpu")
    ref = unitig_layouts(JS, JD.StopPipeline,
                         JD.make_ctx(str(tmp_path / "jax"), "t", _cfg(JConfig)),
                         jrs, _cols(st, JO.OverlapStore))
    assert port == ref and port["ctg_layouts"]["n"] > 0


def test_boundary_files_round_trip(reads, utg, red_full, tmp_path):
    trs, _ = reads
    recs = [(trs.name(i), trs.get_seq(i)) for i in range(1, trs.n_reads + 1)]
    recs[3] = (recs[3][0], recs[3][1][:50] + "N" + recs[3][1][51:])
    np.savez_compressed(tmp_path / "r.npz", **pack_records(recs))
    with np.load(tmp_path / "r.npz") as z:
        assert unpack_records(z) == recs
    st = utg[0]
    np.savez_compressed(tmp_path / "s.npz", **store_halves(st))
    with np.load(tmp_path / "s.npz") as z:
        back = store_from_halves(TO.OverlapStore, z)
    assert TO.store_digest(back) == TO.store_digest(st)
    np.savez_compressed(tmp_path / "c.npz", **corrections_arrays(red_full))
    with np.load(tmp_path / "c.npz") as z:
        back = corrections_from_arrays(z)
    assert sorted(corrections_records(back)) == sorted(corrections_records(red_full))
