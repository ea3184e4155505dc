"""canu_tpu_torch's stages across several processes on the CPU.

Fast lane: a gloo world of 2 ranks (tests/torch_mp_worker.py, a
FileStore in tmp_path) runs the cor gatekeeper, meryl and overlap stages
with shardedCompute=auto, which the world turns on: sharded meryl, the
ring, each rank verifying a strided slice, and the store built by the
a_id-range exchange or from the allgathered table.  The store and the
frequent-mer table must equal the port's single-process stage and
canu_tpu's, exactly.  Slow lane: two ranks run the whole command line
with useGrid=true under torchrun's environment, from raw reads, and
their contigs must equal a single-process run's (the counterpart of
tests/test_multiprocess.py test_two_process_full_pipeline).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from torch_cases import one_torch_thread  # noqa: F401
from torch_mp_worker import EXCHANGES, GENOME, PIPELINE_GENOME, frequent_digest, stage_config

ROOT = Path(__file__).resolve().parents[1]
WORKER = str(ROOT / "tests" / "torch_mp_worker.py")


def _env(**extra) -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""), **extra)


def _write_reads(path, genome_len: int, coverage: float, mean_len: int, min_len: int,
                 max_len: int) -> str:
    from canu_tpu_torch.io.fastx import write_fasta
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(genome_len, seed=7)
    rs, _ = simulate_reads(g, coverage=coverage, mean_len=mean_len, min_len=min_len,
                           max_len=max_len, error_rate=0.05, seed=8, circular=False)
    write_fasta(str(path), ((f"read{i}", rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    return str(path)


def _start(argv: list[str], env: dict, log: Path) -> subprocess.Popen:
    """One rank, its output to ``log``: a rank blocked on a full pipe would
    stall the collectives of the others."""
    with open(log, "w") as fh:
        p = subprocess.Popen(argv, env=env, stdout=fh, stderr=subprocess.STDOUT)
    p.log = log
    return p


def _wait(procs, timeout: float) -> list[str]:
    deadline = time.time() + timeout
    for p in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.wait()
            pytest.fail("a rank timed out: " + " | ".join(
                q.log.read_text()[-2000:] for q in procs))
    outs = [p.log.read_text() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank run's results per exchange, and the same stages in this
    process meanwhile: the port's ("torch") and canu_tpu's ("jax"), each
    (store digest, rows, frequent digest)."""
    import canu_tpu.config as JC
    import canu_tpu.pipeline.driver as JD
    from canu_tpu.pipeline import stages as JS

    from canu_tpu_torch.pipeline import stages as TS
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import store_digest

    d = tmp_path_factory.mktemp("mp")
    fasta = _write_reads(d / "reads.fasta", GENOME, 8, 1500, 1100, 2000)
    procs = [_start([sys.executable, WORKER, "stages", str(r), "2", f"file://{d}/store",
                     str(d / "w"), fasta], _env(), d / f"rank{r}.log") for r in range(2)]
    try:
        single = {}
        cfg = stage_config()
        assert not TS.sharded_enabled(cfg)
        ctx = make_ctx(str(d / "torch1"), "t", cfg)
        rs = TS.gatekeeper(ctx, "cor", [fasta])
        st = TS.overlap(ctx, "cor", rs, TS.meryl(ctx, "cor", rs, device="cpu"), device="cpu")
        single["torch"] = (store_digest(st), len(st),
                           frequent_digest(ctx.path("correction", "t.ms16.frequent.npz")))
        jcfg = JC.Config()
        jcfg.set("genomeSize", GENOME)
        jctx = JD.make_ctx(str(d / "jax1"), "t", jcfg)
        jrs = JS.gatekeeper(jctx, "cor", [fasta])
        jst = JS.overlap(jctx, "cor", jrs, JS.meryl(jctx, "cor", jrs))
        single["jax"] = (store_digest(jst), len(jst),
                         frequent_digest(jctx.path("correction", "t.ms16.frequent.npz")))
    finally:
        _wait(procs, 600)
    res = {}
    for ex in EXCHANGES:
        with open(d / "w" / ex / "result.json") as fh:
            res[ex] = json.load(fh)
    return res, single


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_two_rank_stages_equal_single_process(runs, exchange):
    res, single = runs
    got = res[exchange]
    assert got["rows"] > 0
    assert (got["store"], got["rows"], got["frequent"]) == single["torch"] == single["jax"]
    assert got["shards_left"] == []  # rank 0 merged and removed the range shards
    # sharded meryl's all_to_all and the ring's step ran; the range
    # exchange is one more all_to_all
    stats = got["stats"]
    assert stats["all_to_all"] == (2 if exchange == "range" else 1)
    assert stats["ring_shift"] == 1 and stats["barrier"] > 0


@pytest.mark.slow
def test_two_process_full_pipeline(tmp_path):
    """The whole command line on 2 ranks (useGrid=true, torchrun's
    variables with a free port), raw reads to contigs in one shared
    directory, against one process."""
    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io import fastx
    from canu_tpu_torch.pipeline.driver import run_pipeline

    fasta = _write_reads(tmp_path / "raw.fasta", PIPELINE_GENOME, 8, 2500, 1500, 4000)
    port = str(_free_port())
    env = {k: v for k, v in _env().items() if not k.startswith("SLURM_")}
    procs = [_start([sys.executable, WORKER, "pipeline", str(tmp_path / "mp_asm"), fasta],
                    dict(env, WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=port),
                    tmp_path / f"rank{r}.log") for r in range(2)]
    outs = _wait(procs, 3000)
    assert "useGrid: process 0/2 joined" in outs[0], outs[0][-3000:]
    cfg = Config()
    cfg.set("genomeSize", PIPELINE_GENOME)
    run_pipeline(str(tmp_path / "sp_asm"), "asm", cfg, raw_reads=[fasta], device="cpu")

    def contigs(d):
        return sorted(r.seq for r in fastx.read_fastx(str(tmp_path / d / "asm.contigs.fasta")))

    assert contigs("mp_asm") == contigs("sp_asm")
    assert len(contigs("sp_asm")) > 0
