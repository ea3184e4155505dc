"""Port parity for the slice as a whole: canu_tpu_torch's meryl + overlap
("cor") stages against canu_tpu's on one small simulated read set, each in
its own work directory.  Integer outputs, so every comparison is exact.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from canu_tpu.config import Config
from canu_tpu.pipeline import stages as JS
from canu_tpu.pipeline.driver import make_ctx
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu.stores.overlaps import OverlapStore as JaxOverlapStore
from canu_tpu_torch.pipeline import stages as TS
from canu_tpu_torch.stores.overlaps import _COLS, store_digest
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

GENOME = 15_000


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    # planted repeats give the frequent-mer filter real work; 9x gives
    # 1,908 candidates: four chunks of 512, i.e. one fused Myers group
    g = random_genome(GENOME, seed=21, repeat_spec=[(400, 8)])
    rs, _ = simulate_reads(g, coverage=9, mean_len=1500, min_len=1000, max_len=2000,
                           error_rate=0.10, seed=22)
    out = {}
    for name, S, kw in (("jax", JS, {}), ("torch", TS, {"device": "cpu"})):
        cfg = Config()
        cfg.set("genomeSize", GENOME)
        # 512 hashes, 2 matches: the 'high' preset's min_matches at 2/3
        # of its sketch cost on the CPU
        cfg.set("corMhapSensitivity", "normal")
        ctx = make_ctx(str(tmp_path_factory.mktemp(name)), "t", cfg)
        fk = S.meryl(ctx, "cor", rs, **kw)
        st = S.overlap(ctx, "cor", rs, fk, **kw)
        out[name] = (ctx, fk, st)
    out["rs"] = rs
    return out


def test_frequent_tables_equal(both):
    paths = [os.path.join(both[n][0].work_dir, "correction", "t.ms16.frequent.npz")
             for n in ("jax", "torch")]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def test_stores_equal_row_for_row(both):
    st_j, st_t = both["jax"][2], both["torch"][2]
    assert len(st_t) > 0 and len(st_t) == len(st_j)
    for c in _COLS:
        a, b = np.asarray(getattr(st_j, c)), np.asarray(getattr(st_t, c))
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    assert store_digest(st_j) == store_digest(st_t)
    # symmetric: every (a, b) row has its (b, a) mirror
    fwd = set(zip(st_t.a_id.tolist(), st_t.b_id.tolist()))
    assert fwd == {(b, a) for a, b in fwd}


def test_port_store_loads_in_canu_tpu(both):
    ctx = both["torch"][0]
    st = JaxOverlapStore.load(os.path.join(ctx.work_dir, "correction", "t.ovlStore"))
    st_t = both["torch"][2]
    for c in _COLS:
        np.testing.assert_array_equal(np.asarray(getattr(st, c)), np.asarray(getattr(st_t, c)))
    np.testing.assert_array_equal(st.n_overlaps_per_read(), st_t.n_overlaps_per_read())
    np.testing.assert_array_equal(st.erate, st_t.erate)


def test_resume_is_a_noop(both):
    ctx, fk, st = both["torch"]
    times = ctx.path("t.stage-times.jsonl")
    lines = open(times).read().splitlines()
    assert sum('"cor-overlap"' in ln for ln in lines) == 1
    assert sum('"cor-overlap.sub"' in ln for ln in lines) == 1
    store = os.path.join(ctx.work_dir, "correction", "t.ovlStore")
    mtime = os.path.getmtime(os.path.join(store, "a_id.npy"))
    fk2 = TS.meryl(ctx, "cor", both["rs"], device="cpu")
    st2 = TS.overlap(ctx, "cor", both["rs"], fk2, device="cpu")
    assert open(times).read().splitlines() == lines
    assert os.path.getmtime(os.path.join(store, "a_id.npy")) == mtime
    np.testing.assert_array_equal(fk2.kmers, fk.kmers)
    assert store_digest(st2) == store_digest(st)
