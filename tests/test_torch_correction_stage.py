"""The port's gatekeeper stage and correction phase against canu_tpu's on the
CPU: the same saved ReadSet from FASTA and from FASTQ with qvTrim, the
same corrected reads from a FASTA, the resume contract (a re-run is a
no-op, a deleted block file re-runs only that block).  Exact.
corConsensus=dag is held in tests/test_torch_dagcon.py.

Both packages run their vote engine at VOTE_SEG 512 with 16 segments a
block and 64 jobs a chunk (set by the test) to keep the CPU run short."""

from __future__ import annotations

import gzip
import os

import numpy as np
import pytest
import torch

import canu_tpu.config as JC
import canu_tpu.ops.falcon as JF
import canu_tpu.ops.votepile as JV
import canu_tpu.pipeline.driver as JD
import canu_tpu.pipeline.stages as JS
import canu_tpu.stores.readset as JRS
import canu_tpu_torch.config as TC
import canu_tpu_torch.ops.falcon as TF
import canu_tpu_torch.ops.votepile as TV
import canu_tpu_torch.pipeline.driver as TD
import canu_tpu_torch.pipeline.stages as TS
import canu_tpu_torch.stores.readset as TRS
from canu_tpu_torch.io.fastx import write_fasta
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

SEG = 512
READ_ARRAYS = ("words", "word_off", "length", "source_id", "source_bgn")


def _ctxs(tmp_path, keys):
    cj, ct = JC.Config(), TC.Config()
    for k, v in keys:
        cj.set(k, v)
        ct.set(k, v)
    return (JD.make_ctx(str(tmp_path / "jax"), "t", cj),
            TD.make_ctx(str(tmp_path / "torch"), "t", ct))


def _same_store(a, b):
    for name in READ_ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.names == b.names
    assert (a.quals is None) == (b.quals is None)
    if a.quals is not None:
        np.testing.assert_array_equal(a.quals, b.quals)


def _reads(seed=5, genome=10_000, coverage=8):
    g = random_genome(genome, seed=seed)
    rs, _ = simulate_reads(g, coverage=coverage, mean_len=1300, min_len=1000, max_len=1600,
                           error_rate=0.10, seed=seed + 1)
    return rs


def _fastq(path, rs, rng):
    """The reads as FASTQ: QV 20-40, a low-quality end on every third read
    (qvTrim trims it), one read low-quality in its middle, one short read."""
    with open(path, "w") as fh:
        for i in range(1, rs.n_reads + 1):
            seq = rs.get_seq(i)
            q = rng.integers(20, 41, len(seq))
            if i % 3 == 0:
                q[-int(rng.integers(150, 400)):] = 2
            if i == 4:
                q[len(seq) // 2 - 300 : len(seq) // 2 + 300] = 3
            if i == 7:
                seq, q = seq[:600], q[:600]
            fh.write(f"@{rs.name(i)}\n{seq}\n+\n{''.join(chr(33 + int(x)) for x in q)}\n")


@pytest.mark.parametrize("fmt", ["fasta", "fastq"])
def test_gatekeeper_equal(tmp_path, fmt):
    rs = _reads(seed=3, coverage=4)
    path = str(tmp_path / f"reads.{fmt}")
    if fmt == "fasta":
        write_fasta(path, ((rs.name(i), rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    else:
        _fastq(path, rs, np.random.default_rng(0))
    jctx, tctx = _ctxs(tmp_path, [("qvTrim", True)])
    rj = JS.gatekeeper(jctx, "cor", [path])
    rt = TS.gatekeeper(tctx, "cor", [path])
    assert isinstance(rt, TRS.ReadSet)
    _same_store(rt, rj)
    store = os.path.join("correction", "t.gkpStore")
    _same_store(TRS.ReadSet.load(tmp_path / "torch" / store),
                JRS.ReadSet.load(tmp_path / "jax" / store))
    assert tctx.report.get("cor.gatekeeper") == jctx.report.get("cor.gatekeeper")
    if fmt == "fastq":
        assert "QV trim: " in tctx.report.get("cor.gatekeeper")
        assert rt.total_bases < rs.total_bases
    # stopOnReadQuality: most reads below minReadLength stops both
    jctx2, tctx2 = _ctxs(tmp_path / "short", [("minReadLength", 1500), ("canuIterationMax", 1)])
    for stage, ctx in ((JS.gatekeeper, jctx2), (TS.gatekeeper, tctx2)):
        with pytest.raises(Exception) as err:
            stage(ctx, "cor", [path])
        assert "stopOnReadQuality" in str(err.value.__cause__ or err.value)


@pytest.fixture
def small_geometry(monkeypatch):
    for mod in (JF, TF):
        monkeypatch.setattr(mod, "VOTE_SEG", SEG)
    for mod in (JV, TV):
        monkeypatch.setattr(mod, "BLOCK_POS_BUDGET", SEG * 16)
        monkeypatch.setattr(mod, "CHUNK_CELL_BUDGET", SEG * 64)


def _fasta_text(path):
    with gzip.open(path, "rt") as fh:
        return fh.read()


def test_correction_phase_equal_and_resumes(tmp_path, small_geometry, monkeypatch):
    rs = _reads(genome=8_000)
    fa = str(tmp_path / "reads.fasta")
    write_fasta(fa, ((rs.name(i), rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    keys = [("genomeSize", 8_000), ("corMhapSensitivity", "low"), ("corOutCoverage", 3),
            ("saveReadCorrections", True)]
    jctx, tctx = _ctxs(tmp_path, keys)
    JS.correction_phase(jctx, [fa])
    TS.correction_phase(tctx, [fa], device="cpu")
    out = os.path.join("correction", "t.correctedReads.fasta.gz")
    ref = _fasta_text(tmp_path / "jax" / out)
    text = _fasta_text(tmp_path / "torch" / out)
    assert text == ref and text.count(">") >= 4
    assert all("_corr" in ln for ln in text.splitlines() if ln.startswith(">"))
    assert tctx.report.get("cor.correct").split(" -> ")[0] == \
        jctx.report.get("cor.correct").split(" -> ")[0]

    # a re-run is a no-op: the phase never reaches the vote engine
    real, calls, seen = TF.correct_reads_blocks, [], []

    def recording(*a, **kw):
        calls.append(set(kw["done_blocks"]))
        for bi, items in real(*a, **kw):
            seen.append(bi)
            yield bi, items

    monkeypatch.setattr(TF, "correct_reads_blocks", recording)
    TS.correction_phase(tctx, [fa], device="cpu")
    assert calls == []
    # a deleted block file re-runs only that block
    blocks = tmp_path / "torch" / "correction" / "blocks"
    names = sorted(os.listdir(blocks))
    assert len(names) >= 3
    kept = {n: (blocks / n).read_bytes() for n in names if n != names[1]}
    os.remove(blocks / names[1])
    os.remove(tmp_path / "torch" / out)
    TS.correction_phase(tctx, [fa], device="cpu")
    assert calls == [{int(n[6:11]) for n in kept}] and seen == [int(names[1][6:11])]
    assert _fasta_text(tmp_path / "torch" / out) == ref
    assert {n: (blocks / n).read_bytes() for n in kept} == kept


def test_correction_runs_on_the_card_unless_asked(tmp_path, monkeypatch):
    """device=None means the card: without one the phase raises before any
    stage runs, naming the device; the CPU runs only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tctx = _ctxs(tmp_path, [])
    with pytest.raises(RuntimeError, match="device cuda requested but no CUDA device"):
        TS.correction_phase(tctx, [str(tmp_path / "reads.fasta")])
    assert not os.path.exists(tmp_path / "torch" / "correction" / "t.gkpStore")
