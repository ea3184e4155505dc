"""The port's trimming and assembly phases behind run_pipeline, and its
CLI, against canu_tpu's on the CPU.

From one FASTA of corrected reads (a 15 kb genome, 12x, 1.5% error),
both packages' run_pipeline with enableOEA=false, cnsConsensus=quick and
the low sketch preset (a cheaper configuration canu_tpu supports; RED,
OEA and the polish are held in tests/test_torch_oea_polish.py) must write
the same files byte for byte: the trimmed reads, the utg store, the
unitig and contig layouts, the contigs, unitigs and unassembled FASTA,
layout.tsv and the GFA.  Then: a second run resumes with every stage
skipped; useGrid=true raises before any stage runs;
no card means an error, not the CPU; a CUDA out-of-memory attempt drops
the read indexes cached on read sets; the CLI prints the registry and
exits 2 without genomeSize.  The same parity with OEA and the plurality
polish on, and a raw-reads parity, run in the slow lane."""

from __future__ import annotations

import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from canu_tpu_torch.io.fastx import write_fasta
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from torch_cases import assembly_digests, one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
GENOME = 15_000
QUICK = {"enableOEA": "false", "cnsConsensus": "quick", "obtMhapSensitivity": "low",
         "utgMhapSensitivity": "low"}
OUTPUTS = ("trimming/asm.trimmedReads.fasta.gz", "asm.contigs.fasta", "asm.unitigs.fasta",
           "asm.unassembled.fasta", "asm.layout.tsv", "asm.contigs.gfa")


def _fasta(path: Path, genome: int, seed: int, **sim) -> str:
    g = random_genome(genome, seed=seed)
    rs, _ = simulate_reads(g, seed=seed + 1, circular=False, **sim)
    write_fasta(path, ((rs.name(i), rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    return str(path)


def _config(pkg: str, genome: int, extra: dict):
    if pkg == "jax":
        from canu_tpu.config import Config
    else:
        from canu_tpu_torch.config import Config
    cfg = Config()
    cfg.set("genomeSize", genome)
    for k, v in extra.items():
        cfg.set(k, v)
    return cfg


def _run(pkg: str, work: Path, genome: int, extra: dict, **inputs) -> str:
    if pkg == "jax":
        from canu_tpu.pipeline.driver import run_pipeline

        run_pipeline(str(work), "asm", _config(pkg, genome, extra), **inputs)
    else:
        from canu_tpu_torch.pipeline.driver import run_pipeline

        run_pipeline(str(work), "asm", _config(pkg, genome, extra), device="cpu", **inputs)
    return str(work)


def _read(path: str) -> bytes:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        return fh.read()


def _same_outputs(jd: str, td: str) -> dict:
    for rel in OUTPUTS:
        assert _read(os.path.join(td, rel)) == _read(os.path.join(jd, rel)), rel
    dj, dt = assembly_digests(jd, "asm"), assembly_digests(td, "asm")
    assert dt == dj
    return dt


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("asm")
    fa = _fasta(d / "reads.fasta", GENOME, 5, coverage=12, mean_len=1500, min_len=1000,
                max_len=2500, error_rate=0.015)
    return {pkg: _run(pkg, d / pkg, GENOME, QUICK, corrected_reads=[fa])
            for pkg in ("jax", "torch")}, fa


def test_corrected_to_contigs_equal(runs):
    (dirs, _) = runs
    dig = assembly_digests(dirs["torch"], "asm")
    assert dig["contigs"]["n"] >= 1 and dig["trimmed"]["n"] > 50
    _same_outputs(dirs["jax"], dirs["torch"])


def test_resume_skips_every_stage(runs):
    (dirs, fa) = runs
    times = os.path.join(dirs["torch"], "asm.stage-times.jsonl")
    before = Path(times).read_text()
    _run("torch", Path(dirs["torch"]), GENOME, QUICK, corrected_reads=[fa])
    assert Path(times).read_text() == before
    # the trimmed reads as input: the assembly phase alone, also resumed
    _run("torch", Path(dirs["torch"]), GENOME, QUICK,
         trimmed_reads=[os.path.join(dirs["torch"], OUTPUTS[0])])
    assert Path(times).read_text() == before


@pytest.mark.parametrize("key,value,item", [("useGrid", "true", "item 13")])
def test_unported_configurations_raise_before_any_stage(runs, tmp_path, key, value, item):
    (_, fa) = runs
    with pytest.raises(NotImplementedError, match=item):
        _run("torch", tmp_path / "w", GENOME, {**QUICK, key: value}, corrected_reads=[fa])
    assert not (tmp_path / "w" / "asm.stage-times.jsonl").exists()


def test_entry_points_need_a_card_unless_given_the_cpu(runs, tmp_path):
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx, run_pipeline

    (_, fa) = runs
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pipeline(str(tmp_path / "a"), "asm", _config("torch", GENOME, QUICK),
                     corrected_reads=[fa])
    ctx = make_ctx(str(tmp_path / "b"), "asm", _config("torch", GENOME, QUICK))
    for phase in (stages.trimming_phase, stages.assembly_phase):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            phase(ctx, [fa])


def test_oom_attempt_drops_cached_read_indexes(tmp_path):
    from canu_tpu_torch.ops import votepile
    from canu_tpu_torch.ops.minimizers import get_read_index
    from canu_tpu_torch.pipeline.driver import make_ctx, run_stage
    from canu_tpu_torch.stores.readset import ReadSet

    g = random_genome(3_000, seed=8)
    rs, _ = simulate_reads(g, coverage=3, mean_len=800, min_len=600, max_len=1000,
                           error_rate=0.02, seed=9)
    ctx = make_ctx(str(tmp_path), "t", _config("torch", 3_000, {}))
    attempts = []
    out = tmp_path / "out"

    def cached(readset):
        return readset.__dict__.get("_device_caches", {}).get("read_index", {})

    def fn():
        attempts.append(len(cached(rs)))
        get_read_index(rs, k=16, device="cpu")
        votepile.device_words(rs, "cpu")
        if len(attempts) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (simulated)")
        out.write_text("ok")

    get_read_index(rs, k=16, device="cpu")
    other = ReadSet.from_codes_list([g[:900]], ["x"])
    get_read_index(other, k=16, device="cpu")
    run_stage(ctx, "oom", out.exists, fn)
    # the retry found no index cached: the failed attempt's were dropped,
    # the other read set's too
    assert attempts == [1, 0]
    assert "_device_caches" not in other.__dict__
    assert len(cached(rs)) == 1  # built again by the retry


def _cli(*args) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-m", "canu_tpu_torch", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cli_options():
    r = _cli("-options")
    assert r.returncode == 0
    assert "genomeSize" in r.stdout and "corOvlErrorRate" in r.stdout


def test_cli_requires_genome_size(runs, tmp_path):
    (_, fa) = runs
    r = _cli("-p", "t", "-d", str(tmp_path / "a"), "-trimmed", fa)
    assert r.returncode == 2
    assert "genomeSize" in r.stderr
    r = _cli("-p", "t", "-bogus")
    assert r.returncode == 2 and "unknown option" in r.stderr


@pytest.mark.slow
def test_corrected_to_contigs_with_oea_and_polish_equal(tmp_path):
    """The default configuration (RED + OEA, the plurality polish) on a
    30 kb genome at the bench's read shapes."""
    fa = _fasta(tmp_path / "reads.fasta", 30_000, 11, coverage=15, mean_len=3500,
                min_len=1500, max_len=6000, error_rate=0.015)
    jd = _run("jax", tmp_path / "jax", 30_000, {}, corrected_reads=[fa])
    td = _run("torch", tmp_path / "torch", 30_000, {}, corrected_reads=[fa])
    dig = _same_outputs(jd, td)
    assert dig["contigs"]["n"] >= 1 and dig["adjusted_store"] == assembly_digests(jd, "asm")[
        "adjusted_store"]


@pytest.mark.slow
def test_raw_to_contigs_equal(tmp_path):
    """tests/test_pipeline.py's raw read set and options, through correction,
    trimming and assembly."""
    fa = _fasta(tmp_path / "raw.fasta", 9_000, 60, coverage=12, mean_len=1200, min_len=900,
                max_len=1600, error_rate=0.08)
    opts = {"corOutCoverage": 5, "corMaxEvidenceCoverage": 12, "minReadLength": 800,
            "minOverlapLength": 400}
    jd = _run("jax", tmp_path / "jax", 9_000, opts, raw_reads=[fa])
    td = _run("torch", tmp_path / "torch", 9_000, opts, raw_reads=[fa])
    assert _read(os.path.join(td, "correction/asm.correctedReads.fasta.gz")) == _read(
        os.path.join(jd, "correction/asm.correctedReads.fasta.gz"))
    _same_outputs(jd, td)
    assert np.any([ln.startswith(">") for ln in _read(os.path.join(td, "asm.contigs.fasta"))
                   .decode().splitlines()])
