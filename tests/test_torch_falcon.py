"""canu_tpu_torch.ops.falcon against canu_tpu.ops.falcon on the CPU: template
and evidence selection, the vote jobs, and correct_reads_blocks on one
overlap store (canu_tpu's, built from 108 simulated reads at 10% error)
give the same blocks and the same corrected reads.  Exact.

The vote engine runs at VOTE_SEG 512 here (both packages, set by the
test) to keep the CPU run short; BLOCK_POS_BUDGET is cut so the reads
fall into several blocks."""

from __future__ import annotations

import numpy as np
import pytest

import canu_tpu.ops.falcon as JF
import canu_tpu.ops.votepile as JV
import canu_tpu_torch.ops.falcon as TF
import canu_tpu_torch.ops.votepile as TV
from canu_tpu_torch.stores.overlaps import OverlapStore as TStore
from canu_tpu_torch.stores.readset import ReadSet as TRS
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

SEG = 512
GENOME = 12_000
KW = dict(genome_size=GENOME, out_coverage=4, max_evidence_coverage=10, band=256,
          min_piece=800)


@pytest.fixture(scope="module")
def reads_and_store():
    """The 108-read set of tests/test_trace_falcon.py and canu_tpu's
    overlap store of it (the Myers verify at band 128, as the cor stage
    runs it); the port gets the same reads and store columns."""
    from canu_tpu.ops import align as AL, kmer as K, minhash as MH
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from canu_tpu.stores.overlaps import OverlapStore

    g = random_genome(GENOME, seed=50)
    rs, _ = simulate_reads(g, coverage=12, mean_len=1500, min_len=1000, max_len=2000,
                           error_rate=0.10, seed=51, circular=False)
    kc = K.count_readset_device(rs, k=16, block_size=64)
    fk = K.frequent_kmers(kc, distinct_fraction=0.9995)
    sk = MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk, block_size=64)
    pairs = MH.find_candidates(sk, min_matches=2, block_size=64)
    ov = AL.verify_overlaps(rs, pairs, band=128, max_erate=0.35, min_overlap=500, chunk=512)
    st = OverlapStore.build(ov, rs.n_reads)
    # QVs give the evidence weights a spread (the FASTQ route)
    quals = np.random.default_rng(3).integers(5, 40, rs.total_bases).astype(np.uint8)
    rs.quals = quals
    trs = TRS(rs.words, rs.word_off, rs.length, rs.names, rs.source_id, rs.source_bgn, quals)
    tst = TStore(st.n_reads, **{c: getattr(st, c) for c in
                                ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end",
                                 "erate_q")})
    assert rs.n_reads == 108 and len(st) > 0
    return (rs, st), (trs, tst)


@pytest.fixture
def small_geometry(monkeypatch):
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "VOTE_SEG", SEG)
    for mod in (JV, TV):
        monkeypatch.setattr(mod, "BLOCK_POS_BUDGET", SEG * 16)  # G = 16 segments a block
        monkeypatch.setattr(mod, "CHUNK_CELL_BUDGET", SEG * 64)  # 64 jobs a chunk


@pytest.mark.parametrize("template_filter", ["quick", "expensive"])
def test_selection_and_jobs_equal(reads_and_store, template_filter):
    (rs, st), (trs, tst) = reads_and_store
    for cov in (2, 4, 40):
        if template_filter == "expensive":
            ref = JF.select_templates_expensive(rs, st, GENOME, cov)
            got = TF.select_templates_expensive(trs, tst, GENOME, cov)
        else:
            ref = JF.select_templates(rs, GENOME, cov)
            got = TF.select_templates(trs, GENOME, cov)
        np.testing.assert_array_equal(got, ref)
        for max_cov, min_len, erate in ((10, 0, 0.0), (3, 1200, 0.2)):
            rows_j = JF.select_evidence_rows(st, ref, rs.length, max_cov, min_len, erate)
            rows_t = TF.select_evidence_rows(tst, got, trs.length, max_cov, min_len, erate)
            np.testing.assert_array_equal(rows_t, rows_j)
            for qv in (None, rs.mean_quals()):
                jj = JF.evidence_vote_jobs(st, rows_j, rs.length, mean_qv=qv)
                tj = TF.evidence_vote_jobs(tst, rows_t, trs.length, mean_qv=qv)
                for f in ("t_idx", "e_idx", "t_bgn", "t_span", "e_lo", "e_span", "flipped",
                          "slot", "weight"):
                    a, b = getattr(tj, f), getattr(jj, f)
                    assert (a is None) == (b is None), f
                    if a is not None:
                        assert a.dtype == b.dtype, f
                        np.testing.assert_array_equal(a, b, err_msg=f)
    # the segment split and block packing of the vote geometry
    jobs = JF.evidence_vote_jobs(st, JF.select_evidence_rows(st, ref, rs.length, 10, 0), rs.length)
    tl, nseg, row0 = JF._segment_table(rs.length, ref, SEG)
    for a, b in zip(TF._segment_table(trs.length, got, SEG), (tl, nseg, row0)):
        np.testing.assert_array_equal(a, b)
    tpos = np.zeros(rs.n_reads + 1, np.int64)
    tpos[ref] = np.arange(len(ref))
    sj, st_ = JF._segment_jobs(jobs, row0, tpos, SEG, 96), TF._segment_jobs(jobs, row0, tpos,
                                                                           SEG, 96)
    for f in ("t_idx", "e_idx", "t_bgn", "t_span", "e_lo", "e_span", "flipped"):
        np.testing.assert_array_equal(getattr(st_, f), getattr(sj, f), err_msg=f)
    for G in (4, 16):
        for a, b in zip(TF._pack_template_blocks(ref, tl, nseg, G),
                        JF._pack_template_blocks(ref, tl, nseg, G)):
            np.testing.assert_array_equal(a, b)
    plane_j = JF._segment_plane(rs, ref, nseg, row0, SEG)
    plane_t = TF._segment_plane(trs, got, nseg, row0, SEG, "cpu")
    np.testing.assert_array_equal(plane_t[0].numpy(), np.asarray(plane_j[0]).astype(np.int64))
    np.testing.assert_array_equal(plane_t[1].numpy(), np.asarray(plane_j[1]))
    np.testing.assert_array_equal(plane_t[2], plane_j[2])
    assert plane_t[3] == plane_j[3]


def _blocks(mod, rs, st, **kw):
    return [(bi, items) for bi, items in mod.correct_reads_blocks(rs, st, **KW, **kw)]


def test_correct_reads_blocks_equal(reads_and_store, small_geometry, monkeypatch):
    (rs, st), (trs, tst) = reads_and_store
    ref = _blocks(JF, rs, st)
    got = _blocks(TF, trs, tst, device="cpu")
    assert len(ref) >= 3 and sum(len(i) for _, i in ref) >= 3
    assert [bi for bi, _ in got] == [bi for bi, _ in ref]
    for (_, a), (_, b) in zip(got, ref):
        assert a == b
    # skipping blocks leaves the others' output unchanged (a resumed run,
    # and the chip check's reference on a subset of the blocks, rest on
    # it), and so does the chunk size the card's vote budget sets: 256
    # jobs a chunk here against 64 above
    skip = {bi for bi, _ in ref[2:-1]}
    assert len(skip) >= 2
    monkeypatch.setattr(TV, "CHUNK_CELL_BUDGET", 1 << 21)
    part = _blocks(TF, trs, tst, device="cpu", done_blocks=skip)
    assert part == [b for b in ref if b[0] not in skip]

