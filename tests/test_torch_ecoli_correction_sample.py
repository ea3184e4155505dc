"""The template sample that stands in for a whole correction (chip_smoke.py's
ecolicor phase, scripts/torch_ecoli_correction_reference.py) is sound, on
the CPU and on a small raw read set at 10% error and 25x:

  (a) the port's full correct_reads_blocks gives the sampled templates
      the same records as a run on the sample-restricted store (the
      candidates with a sampled read on either side, verified and built
      into a store, of which the rows whose a_id is sampled are kept);
  (b) canu_tpu's run on its own restricted store, verified from the same
      candidates, gives the same records as the port's;
  (c) with the mirror rows left in (a_id the partner of a sampled read),
      the partners become templates with part of their evidence, and
      their records differ from the full run's (most of them are dropped
      under corMinCoverage): the trap the rule avoids.

The reads come as from a FASTA (no QVs: every vote weighs 1.0).  Both
packages run their vote engine at VOTE_SEG 512 with 16 segments a block
and 64 jobs a chunk (set by the test) to keep the CPU run short."""

from __future__ import annotations

import numpy as np
import pytest

import canu_tpu.ops.align as JA
import canu_tpu.ops.falcon as JF
import canu_tpu.ops.votepile as JV
import canu_tpu.stores.overlaps as JO
import canu_tpu.stores.readset as JRS
import canu_tpu_torch.ops.align as TA
import canu_tpu_torch.ops.falcon as TF
import canu_tpu_torch.ops.kmer as TK
import canu_tpu_torch.ops.minhash as TM
import canu_tpu_torch.ops.votepile as TV
import canu_tpu_torch.stores.overlaps as TO
from canu_tpu_torch.config import Config
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from torch_cases import (  # noqa: F401  (one_torch_thread: autouse fixture)
    one_torch_thread,
    pairs_of_reads,
    store_of_templates,
    template_sample,
)

SEG = 512
GENOME = 6_000
SAMPLE = 8
EVIDENCE = 8
VERIFY = dict(k=16, band=128, chunk=512, partial=True)


def _cor_verify_kwargs() -> dict:
    cfg = Config()
    return dict(VERIFY, max_erate=float(cfg.get("corOvlErrorRate")),
                min_overlap=int(cfg.get("minOverlapLength")),
                min_shared=int(cfg.get("corMinShared")))


@pytest.fixture(scope="module")
def reads_and_candidates():
    """A raw read set at 25x and 10% error (the port's reads and
    canu_tpu's, from the same arrays), its cor candidates from the port's
    hash-join, and the port's full store of them."""
    g = random_genome(GENOME, seed=61)
    trs, _ = simulate_reads(g, coverage=25, mean_len=1500, min_len=1000, max_len=2000,
                            error_rate=0.10, seed=62)
    jrs = JRS.ReadSet(trs.words, trs.word_off, trs.length, trs.names, trs.source_id,
                      trs.source_bgn)
    fk = TK.frequent_kmers(TK.count_readset_device(trs, k=16, block_size=64, device="cpu"))
    sk = TM.build_sketches(trs, k=16, n_hashes=512, frequent=fk, block_size=64, device="cpu")
    pairs = TM.find_candidates_join(sk, min_matches=2, device="cpu")
    ov = TA.verify_overlaps(trs, pairs, device="cpu", **_cor_verify_kwargs())
    st = TO.OverlapStore.build(ov, trs.n_reads)
    assert trs.n_reads > 80 and len(pairs) > 10 * trs.n_reads and len(st) > 0
    return trs, jrs, pairs, st


@pytest.fixture
def small_geometry(monkeypatch):
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "VOTE_SEG", SEG)
    for mod in (JV, TV):
        monkeypatch.setattr(mod, "BLOCK_POS_BUDGET", SEG * 16)  # G = 16 segments a block
        monkeypatch.setattr(mod, "CHUNK_CELL_BUDGET", SEG * 64)  # 64 jobs a chunk


def _correct(module, rs, st, **kw) -> dict[str, str]:
    """Every record of correct_reads_blocks with correction_phase's default
    arguments (every read a template, no QVs), but EVIDENCE times a
    template's length of evidence at most, not 40: a fifth of the jobs."""
    cfg = Config()
    recs = {}
    for _bi, items in module.correct_reads_blocks(
            rs, st, genome_size=GENOME, out_coverage=int(cfg.get("corOutCoverage")),
            max_evidence_coverage=EVIDENCE, band=int(cfg.get("corBandWidth")),
            min_cov=int(cfg.get("corMinCoverage")), **kw):
        recs.update(items)
    return recs


def _of(recs: dict[str, str], names: set) -> dict[str, str]:
    return {n: s for n, s in recs.items() if n.rsplit("_corr", 1)[0] in names}


def test_template_sample_rule():
    ids = np.arange(1, 1001, dtype=np.int32)[::-1]
    got = template_sample(ids, 256)
    np.testing.assert_array_equal(got, np.arange(1, 1001, 3)[:256])
    np.testing.assert_array_equal(template_sample(ids[-100:], 256), np.arange(1, 101))
    pairs = np.array([[1, 2, 5], [2, 3, 4], [3, 4, 2], [4, 7, 3]])
    np.testing.assert_array_equal(pairs_of_reads(pairs, np.array([2, 7])), pairs[[0, 1, 3]])


def test_sample_equals_full_correction(reads_and_candidates, small_geometry):
    trs, jrs, pairs, st = reads_and_candidates
    cfg = Config()
    tids = TF.select_templates(trs, GENOME, int(cfg.get("corOutCoverage")))
    assert len(tids) == trs.n_reads  # 25x under corOutCoverage 40: every read
    sample = template_sample(tids, SAMPLE)
    names = {trs.name(int(i)) for i in sample}
    sp = pairs_of_reads(pairs, sample)
    assert 0 < len(sp) < len(pairs) // 2
    kw = _cor_verify_kwargs()
    t_sub = TO.OverlapStore.build(TA.verify_overlaps(trs, sp, device="cpu", **kw), trs.n_reads)
    t_rst = store_of_templates(t_sub, sample, TO.OverlapStore)
    # the restricted store holds the full store's rows of the sample
    assert TO.store_digest(t_rst) == TO.store_digest(store_of_templates(st, sample))

    full = _correct(TF, trs, st, device="cpu")
    restricted = _correct(TF, trs, t_rst, device="cpu")
    # (a) the sampled templates' records, and no others
    assert len(restricted) >= SAMPLE // 2
    assert restricted == _of(full, names)

    # (b) canu_tpu's restricted run, on its own verify of the same pairs
    j_sub = JO.OverlapStore.build(JA.verify_overlaps(jrs, sp, **kw), jrs.n_reads)
    j_rst = store_of_templates(j_sub, sample, JO.OverlapStore)
    assert TO.store_digest(j_rst) == TO.store_digest(t_rst)
    assert _correct(JF, jrs, j_rst) == restricted

    # (c) the mirror rows left in: the partners become templates with the
    # sampled reads' evidence only, and lose the records the full run gives
    mirrored = _correct(TF, trs, t_sub, device="cpu")
    partners = {trs.name(int(i)) for i in np.setdiff1d(t_sub.a_id, sample)}
    assert partners and _of(full, partners)
    assert _of(mirrored, names) == restricted
    assert _of(mirrored, partners) != _of(full, partners)
