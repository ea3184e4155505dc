"""canu_tpu_torch runs without jax: a machine with the port and no jax
must be able to run its stages."""

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
import os, tempfile
import canu_tpu_torch
from canu_tpu.config import Config
from canu_tpu.sim.simulate import random_genome, simulate_reads
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
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                if sys.modules[m] is not None)
assert not loaded, loaded
print("ROWS", len(st))
"""


# jax stays importable here: only the package's own guard keeps
# canu_tpu/__init__.py from importing it
IMPORT_SCRIPT = r"""
import sys
import canu_tpu_torch
from canu_tpu_torch.pipeline import stages
from canu_tpu_torch.ops import align, kmer, minhash, minimizers, myers
from canu_tpu_torch.ops.kernels import myers_cuda
import canu_tpu_torch.convert
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert not loaded, loaded
print("NO_JAX")
"""


def _run(script: str, tmp_path) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    # the package must set CANU_TPU_NO_COMPILE_CACHE itself, and canu_tpu
    # reaches for jax only when JAX_PLATFORMS is unset
    env.pop("CANU_TPU_NO_COMPILE_CACHE", None)
    env.pop("JAX_PLATFORMS", None)
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


def test_package_source_has_no_jax_import():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
    files = sorted((ROOT / "canu_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    bad = [str(p) for p in files if pat.search(p.read_text())]
    assert not bad, bad
