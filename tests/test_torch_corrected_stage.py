"""Port parity for the corrected-read overlap stages: canu_tpu_torch's meryl
+ overlap for "obt" (k=22, default band 128: the Myers engine, with
partial and palindromic pairs) and "utg" at utgOvlBandWidth=256 (the
INF-walled engine) against canu_tpu's on one small simulated read set,
each in its own work directory.  Integer outputs, so every comparison is
exact.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from canu_tpu.config import Config
from canu_tpu.pipeline import stages as JS
from canu_tpu.pipeline.driver import make_ctx
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.pipeline import stages as TS
from canu_tpu_torch.stores.overlaps import _COLS, store_digest
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

GENOME = 10_000
DRIVES = {"obt": {}, "utg256": {"utgOvlBandWidth": 256}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # planted repeats give the k=22 frequent-mer table entries, so the
    # sketches drop folded two-lane keys; 3% error is the corrected regime
    g = random_genome(GENOME, seed=61, repeat_spec=[(400, 8)])
    rs, _ = simulate_reads(g, coverage=8, mean_len=1200, min_len=700, max_len=1600,
                           error_rate=0.03, seed=62)
    out = {}
    for drive, keys in DRIVES.items():
        tag = drive[:3]
        for name, S, kw in (("jax", JS, {}), ("torch", TS, {"device": "cpu"})):
            cfg = Config()
            cfg.set("genomeSize", GENOME)
            for key, v in keys.items():
                cfg.set(key, v)
            ctx = make_ctx(str(tmp_path_factory.mktemp(f"{drive}-{name}")), "t", cfg)
            fk = S.meryl(ctx, tag, rs, **kw)
            st = S.overlap(ctx, tag, rs, fk, **kw)
            out[drive, name] = (ctx, fk, st)
    return out


@pytest.mark.parametrize("drive", list(DRIVES))
def test_corrected_stage_equals_canu_tpu(runs, drive):
    tag = drive[:3]
    (ctx_j, fk_j, st_j), (ctx_t, fk_t, st_t) = runs[drive, "jax"], runs[drive, "torch"]
    assert fk_t.k == 22 and fk_t.n > 0
    sub = os.path.join(JS.TAG_DIR[tag], "t.ms22.frequent.npz")
    with np.load(os.path.join(ctx_j.work_dir, sub)) as a, \
            np.load(os.path.join(ctx_t.work_dir, sub)) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert len(st_t) > 0 and len(st_t) == len(st_j)
    for c in _COLS:
        a, b = np.asarray(getattr(st_j, c)), np.asarray(getattr(st_t, c))
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    assert store_digest(st_j) == store_digest(st_t)
    fwd = set(zip(st_t.a_id.tolist(), st_t.b_id.tolist()))
    assert fwd == {(b, a) for a, b in fwd}
