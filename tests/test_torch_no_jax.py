"""canu_tpu_torch stands alone: a machine with the port and neither jax nor
the JAX package must be able to run its stages (the cor route, alone and
sharded in a gloo world of one, the utg band-256 and obt join + spill +
host-count routes, the correction phase from a FASTA,
with the falcon and the dag consensus, trimming + assembly from corrected
reads through run_pipeline, and the tools' kmer-count and bogus), and
running them where jax is installed must not load it."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["canu_tpu"] = None  # and so does any import of the JAX package
import os, tempfile
import canu_tpu_torch
from canu_tpu_torch.config import Config
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.pipeline import stages
from canu_tpu_torch.pipeline.driver import make_ctx

g = random_genome(6_000, seed=1)
rs, _ = simulate_reads(g, coverage=8, mean_len=800, min_len=600, max_len=1000,
                       error_rate=0.08, seed=2)
cfg = Config()
cfg.set("genomeSize", 6_000)
cfg.set("corMhapSensitivity", "low")
ctx = make_ctx(tempfile.mkdtemp(), "t", cfg)
fk = stages.meryl(ctx, "cor", rs, device="cpu")
st = stages.overlap(ctx, "cor", rs, fk, device="cpu")
assert len(st) > 0, "empty store"
# the sharded path in a gloo world of one: the hash-range meryl, the ring
# and the store equal the single-process stages'
from canu_tpu_torch.parallel import launch
from canu_tpu_torch.stores.overlaps import store_digest
work_sh = tempfile.mkdtemp()
assert launch.init_distributed("file://" + os.path.join(work_sh, "store"), 1, 0,
                               device="cpu") == (0, 1)
cfg.set("shardedCompute", "true")
ctx_sh = make_ctx(work_sh, "t", cfg)
st_sh = stages.overlap(ctx_sh, "cor", rs, stages.meryl(ctx_sh, "cor", rs, device="cpu"),
                       device="cpu")
assert store_digest(st_sh) == store_digest(st), "sharded store differs"
assert launch.STATS["all_to_all"][0] == 1 and launch.backend() == "gloo", launch.STATS
launch.shutdown()
cfg.set("shardedCompute", "auto")
# the corrected-read path: two-lane k=22 meryl, the INF-walled engine at band 256
rs2, _ = simulate_reads(g, coverage=8, mean_len=800, min_len=600, max_len=1000,
                        error_rate=0.03, seed=3)
cfg2 = Config()
cfg2.set("genomeSize", 6_000)
cfg2.set("utgOvlBandWidth", 256)
ctx2 = make_ctx(tempfile.mkdtemp(), "t", cfg2)
fk2 = stages.meryl(ctx2, "utg", rs2, device="cpu")
st2 = stages.overlap(ctx2, "utg", rs2, fk2, device="cpu")
assert fk2.k == 22 and len(st2) > 0, "empty utg store"
# the E. coli-scale route: the host k-mer counter, the hash-join and the
# spill store with the native external sort
from canu_tpu_torch.ops import kmer, minhash
from canu_tpu_torch.stores import overlaps
kmer.MAX_INSTANCES2 = 1
cfg3 = Config()
cfg3.set("genomeSize", 6_000)
cfg3.set("mhapMatchEngine", "join")
cfg3.set("ovsMethod", "spill")
ctx3 = make_ctx(tempfile.mkdtemp(), "t", cfg3)
fk3 = stages.meryl(ctx3, "obt", rs2, device="cpu")
st3 = stages.overlap(ctx3, "obt", rs2, fk3, device="cpu")
assert (kmer.HOST_COUNTS, minhash.JOIN_CALLS, overlaps.SPILL_BUILDS) == (1, 1, 1)
assert len(st3) > 0, "empty obt store"
# the correction route: gatekeeper from a FASTA, the cor stages, the vote
# engine (at 256-base segments, to keep the CPU run short)
from canu_tpu_torch.io.fastx import write_fasta
from canu_tpu_torch.ops import falcon
falcon.VOTE_SEG = 256
work4 = tempfile.mkdtemp()
fa = os.path.join(work4, "reads.fasta")
rs4, _ = simulate_reads(g, coverage=6, mean_len=1100, min_len=1000, max_len=1200,
                        error_rate=0.08, seed=4)
write_fasta(fa, ((rs4.name(i), rs4.get_seq(i)) for i in range(1, rs4.n_reads + 1)))
cfg4 = Config()
cfg4.set("genomeSize", 6_000)
cfg4.set("corMhapSensitivity", "low")
cfg4.set("corOutCoverage", 1)
stages.correction_phase(make_ctx(work4, "t", cfg4), [fa], device="cpu")
assert os.path.getsize(os.path.join(work4, "correction", "t.correctedReads.fasta.gz")) > 0
# the dag consensus on the same stores: the phase resumes from its stages
import shutil
work4d = tempfile.mkdtemp()
shutil.copytree(os.path.join(work4, "correction"), os.path.join(work4d, "correction"))
os.remove(os.path.join(work4d, "correction", "t.correctedReads.fasta.gz"))
cfg4.set("corConsensus", "dag")
stages.correction_phase(make_ctx(work4d, "t", cfg4), [fa], device="cpu")
assert os.path.getsize(os.path.join(work4d, "correction", "t.correctedReads.fasta.gz")) > 0
# the tools: kmer-count and the judge ruler
from canu_tpu_torch.tools.__main__ import main as tools_main
from canu_tpu_torch.utils.bitpack import codes_to_seq
assert tools_main(["kmer-count", fa, "-k", "16"], device="cpu") == 0
write_fasta(os.path.join(work4, "genome.fasta"), [("g", codes_to_seq(g))])
write_fasta(os.path.join(work4, "contigs.fasta"), [("c", codes_to_seq(g[500:4500]))])
assert tools_main(["bogus", "-genome", os.path.join(work4, "genome.fasta"), "-assembly",
                   os.path.join(work4, "contigs.fasta")], device="cpu") == 0
# trimming and assembly from corrected reads: RED + OEA, the graph, the
# plurality polish (at 256-base segments) and the outputs
from canu_tpu_torch.ops import consensus
from canu_tpu_torch.pipeline.driver import run_pipeline
consensus._POLISH_SEG = 256
work5 = tempfile.mkdtemp()
fa5 = os.path.join(work5, "reads.fasta")
rs5, _ = simulate_reads(g, coverage=10, mean_len=1300, min_len=1100, max_len=1600,
                        error_rate=0.015, seed=5, circular=False)
write_fasta(fa5, ((rs5.name(i), rs5.get_seq(i)) for i in range(1, rs5.n_reads + 1)))
cfg5 = Config()
cfg5.set("genomeSize", 6_000)
cfg5.set("obtMhapSensitivity", "low")
cfg5.set("utgMhapSensitivity", "low")
run_pipeline(os.path.join(work5, "asm"), "t", cfg5, corrected_reads=[fa5], device="cpu")
assert os.path.getsize(os.path.join(work5, "asm", "t.contigs.fasta")) > 0
assert os.path.isdir(os.path.join(work5, "asm", "unitigging", "t.ovlStore.adjusted"))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "canu_tpu")
                if sys.modules[m] is not None)
assert not loaded, loaded
print("ROWS", len(st), len(st2), len(st3))
"""


# jax stays importable here: nothing but the port's own imports keeps it
# unloaded
IMPORT_SCRIPT = r"""
import sys
import canu_tpu_torch
from canu_tpu_torch.pipeline import stages
from canu_tpu_torch.ops import align, falcon, kmer, minhash, minimizers, myers, trace, votepile
from canu_tpu_torch.ops import consensus, dagcon, mermap, oea
from canu_tpu_torch.io import overlaps_io
from canu_tpu_torch.sim import bogus
from canu_tpu_torch.tools import __main__ as tools_main
from canu_tpu_torch import graph, __main__
from canu_tpu_torch.io import gfa
from canu_tpu_torch.pipeline import driver, html, objectstore, splitreads
from canu_tpu_torch.stores import tigs
from canu_tpu_torch.ops.kernels import _nvcc, extend_cuda, myers_cuda
from canu_tpu_torch.utils import intervals, quality
from canu_tpu_torch.stores import overlaps
from canu_tpu_torch.parallel import launch, mesh, shard_overlap, storesort
import canu_tpu_torch.convert, canu_tpu_torch.native
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
print("NO_JAX")
"""

# jax importable: the port's make_ctx writes the invocation audit (which
# canu_tpu's fills from jax.devices()) and a meryl stage runs
CTX_SCRIPT = r"""
import os, sys, tempfile
from canu_tpu_torch.config import Config
from canu_tpu_torch.pipeline import stages
from canu_tpu_torch.pipeline.driver import make_ctx
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

g = random_genome(3_000, seed=4)
rs, _ = simulate_reads(g, coverage=4, mean_len=800, min_len=600, max_len=1000,
                       error_rate=0.05, seed=5)
cfg = Config()
cfg.set("genomeSize", 3_000)
work = tempfile.mkdtemp()
ctx = make_ctx(work, "t", cfg)
fk = stages.meryl(ctx, "cor", rs, device="cpu")
audit = [n for n in os.listdir(os.path.join(work, "canu-logs")) if n.endswith("_canu_tpu")]
assert len(audit) == 1, os.listdir(os.path.join(work, "canu-logs"))
text = open(os.path.join(work, "canu-logs", audit[0])).read()
assert "torch: " in text and "devices: " in text and "jax" not in text, text
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "canu_tpu"))
assert not loaded, loaded
print("NO_JAX", fk.k)
"""


def _run(script: str, tmp_path) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    # canu_tpu/__init__.py honours CANU_TPU_NO_COMPILE_CACHE, and canu_tpu
    # reaches for jax's devices when JAX_PLATFORMS is unset: neither may be
    # what keeps the port off jax
    env.pop("CANU_TPU_NO_COMPILE_CACHE", None)
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"  # as one_torch_thread (torch_cases.py)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)


def test_port_runs_with_jax_blocked(tmp_path):
    r = _run(SCRIPT, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "ROWS" in r.stdout


def test_importing_the_port_leaves_jax_unloaded(tmp_path):
    r = _run(IMPORT_SCRIPT, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX" in r.stdout


def test_make_ctx_and_meryl_leave_jax_unloaded(tmp_path):
    r = _run(CTX_SCRIPT, tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "NO_JAX 16" in r.stdout


def _port_sources() -> list[Path]:
    files = sorted((ROOT / "canu_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"] + [
        ROOT / "tests" / f for f in ("torch_cases.py", "torch_parallel_worker.py",
                                     "torch_mp_worker.py")]


def test_package_source_has_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    files = _port_sources()
    assert len(files) > 10
    assert {"launch.py", "mesh.py", "shard_overlap.py", "storesort.py"} <= {
        p.name for p in files if p.parent.name == "parallel"}
    bad = [str(p) for p in files if pat.search(p.read_text())]
    assert not bad, bad


def test_package_source_has_no_canu_tpu_import():
    # `canu_tpu\b` does not match `canu_tpu_torch`: `_` is a word character
    pat = re.compile(r"^\s*(import\s+canu_tpu\b|from\s+canu_tpu\b)", re.M)
    assert pat.search("from canu_tpu.config import Config")
    assert pat.search("import canu_tpu")
    assert not pat.search("from canu_tpu_torch.config import Config")
    bad = [str(p) for p in _port_sources() if pat.search(p.read_text())]
    assert not bad, bad
