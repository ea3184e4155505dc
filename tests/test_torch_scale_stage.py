"""Port parity for the E. coli-scale overlap path at small size: the port's
obt meryl + overlap through the host k-mer counter (MAX_INSTANCES2
patched down), an obtOvlFrequentMers FASTA, the hash-join
(mhapMatchEngine=join) and the spill store (ovsMethod=spill) against
canu_tpu's default-path stage (device count, block matcher, in-RAM store)
on the same reads, by digest; the sampled store that chip_smoke.py's
ecoli phase holds against canu_tpu; and the minimap candidate path with a
fake minimap2.
"""

from __future__ import annotations

import os
import stat
import sys

import numpy as np
import pytest

import canu_tpu.config as JC
import canu_tpu.pipeline.driver as JD
import canu_tpu.sim.simulate as JSIM
import canu_tpu_torch.config as TC
import canu_tpu_torch.pipeline.driver as TD
import canu_tpu_torch.sim.simulate as TSIM
from canu_tpu.ops import align as JA
from canu_tpu.pipeline import stages as JS
from canu_tpu.stores.overlaps import OverlapStore as JStore
from canu_tpu.stores.readset import ReadSet as JReadSet
from canu_tpu.utils.bitpack import codes_to_seq
from canu_tpu_torch.ops import kmer as TK
from canu_tpu_torch.ops import minhash as TM
from canu_tpu_torch.pipeline import stages as TS
from canu_tpu_torch.stores import overlaps as TO
from canu_tpu_torch.stores.readset import ReadSet as TReadSet
from torch_cases import candidate_sample, one_torch_thread, store_rows_of_pairs  # noqa: F401

GENOME = 8_000
SIM = dict(coverage=8, mean_len=1200, min_len=700, max_len=1600, error_rate=0.03, seed=72)
PORT_KEYS = {"mhapMatchEngine": "join", "ovsMethod": "spill", "saveMerCounts": True}


def _reads(SIM_MOD, ReadSet):
    """Each package's own read set, plus one chimeric read (the longest
    read's first half, then its second half reverse-complemented): its
    pair with that read is palindromic, verified both ways."""
    g = SIM_MOD.random_genome(GENOME, seed=71, repeat_spec=[(400, 8)])
    rs, _ = SIM_MOD.simulate_reads(g, **SIM)
    codes = [rs.get_codes(i) for i in range(1, rs.n_reads + 1)]
    c = max(codes, key=len)
    h = len(c) // 2
    codes.append(np.concatenate([c[:h], (3 - c[h:])[::-1]]).astype(np.uint8))
    return g, ReadSet.from_codes_list(codes, [f"r{i}" for i in range(len(codes))])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    g, jrs = _reads(JSIM, JReadSet)
    _, trs = _reads(TSIM, TReadSet)
    fa = tmp_path_factory.mktemp("mers") / "mers.fasta"
    # the mers of two genome windows never seed (one holds a planted repeat)
    fa.write_text(f">m1\n{codes_to_seq(g[2000:2300])}\n>m2\n{codes_to_seq(g[6000:6100])}\n")
    out = {}
    for name, S, C, D, rs in (("jax", JS, JC, JD, jrs), ("torch", TS, TC, TD, trs)):
        cfg = C.Config()
        cfg.set("genomeSize", GENOME)
        cfg.set("obtMhapSensitivity", "low")  # 256 hashes: half the sketch time
        cfg.set("saveMerCounts", True)
        cfg.set("obtOvlFrequentMers", str(fa))
        kw = {}
        if name == "torch":
            for key, v in PORT_KEYS.items():
                cfg.set(key, v)
            kw = {"device": "cpu"}
        ctx = D.make_ctx(str(tmp_path_factory.mktemp(name)), "t", cfg)
        counts = (TK.HOST_COUNTS, TM.JOIN_CALLS, TO.SPILL_BUILDS)
        pairs = []
        if name == "torch":
            mp = pytest.MonkeyPatch()
            # below the read set's instances: the host counter counts
            mp.setattr(TK, "MAX_INSTANCES2", int(rs.total_bases) // 2)
            join = TM.find_candidates_join
            mp.setattr(TM, "find_candidates_join",
                       lambda *a, **k: pairs.append(join(*a, **k)) or pairs[-1])
        try:
            fk = S.meryl(ctx, "obt", rs, **kw)
            st = S.overlap(ctx, "obt", rs, fk, **kw)
        finally:
            if name == "torch":
                mp.undo()
        out[name] = (ctx, fk, st, rs, pairs, tuple(
            n - c for n, c in zip((TK.HOST_COUNTS, TM.JOIN_CALLS, TO.SPILL_BUILDS), counts)))
    return out


def test_scale_path_equals_canu_tpu_default_path(runs):
    ctx_j, fk_j, st_j, _, _, _ = runs["jax"]
    ctx_t, fk_t, st_t, _, _, path = runs["torch"]
    # the port went through the host counter (for the reads and for the
    # FASTA's mers), the join and the spill store
    assert path == (2, 1, 1)
    assert not os.path.exists(os.path.join(ctx_t.work_dir, "trimming", "t.ovl.spill"))
    assert fk_t.k == 22 and fk_t.n > 0 and fk_t.n == fk_j.n
    for f in ("t.ms22.frequent.npz", "t.ms22.counts.npz"):
        with np.load(os.path.join(ctx_j.work_dir, "trimming", f)) as a, \
                np.load(os.path.join(ctx_t.work_dir, "trimming", f)) as b:
            assert sorted(a.files) == sorted(b.files)
            for n in a.files:
                assert a[n].dtype == b[n].dtype, (f, n)
                np.testing.assert_array_equal(a[n], b[n], err_msg=f"{f} {n}")
    assert len(st_t) > 0 and len(st_t) == len(st_j)
    assert TO.store_digest(st_t) == TO.store_digest(st_j)
    np.testing.assert_array_equal(st_t.index, st_j.index)
    fwd = set(zip(st_t.a_id.tolist(), st_t.b_id.tolist()))
    assert fwd == {(b, a) for a, b in fwd}
    # obt's palindromic pairs give repeated (a_id, b_id) rows: the reason
    # stores are compared by digest
    assert len(fwd) < len(st_t)


def test_sampled_store_equals_the_full_stores_rows(runs):
    """A sample's verify gives the full store's rows for its pairs (the
    gate chip_smoke.py's ecoli phase relies on)."""
    ctx, _fk, st, rs, _, _ = runs["jax"]
    cfg = ctx.cfg
    (pairs,) = runs["torch"][4]
    sample = candidate_sample(pairs, 24)
    assert 0 < len(sample) < len(pairs) // 4
    ms = int(cfg.get("obtMinShared"))
    ov = JA.verify_overlaps(rs, sample, k=22, band=128,
                            max_erate=float(cfg.get("obtOvlErrorRate")),
                            min_overlap=int(cfg.get("minOverlapLength")), chunk=512,
                            min_shared=ms, partial=True, palindromic_min=ms)
    sub = JStore.build(ov, rs.n_reads)
    rows = store_rows_of_pairs(st, sample)
    assert len(rows.a_id) == len(sub) > 0
    assert TO.store_digest(rows) == TO.store_digest(sub)
    assert TO.store_digest(store_rows_of_pairs(runs["torch"][2], sample)) == TO.store_digest(sub)


FAKE_MINIMAP2 = """#!{python}
import sys
# minimap2 -x <preset> -k <k> reads.fasta reads.fasta: PAF rows for each
# read and the three after it, plus rows the parser must skip
args = sys.argv[1:]
assert args[0] == "-x" and args[2] == "-k" and args[4] == args[5], args
names = [ln[1:].strip() for ln in open(args[4]) if ln.startswith(">")]
n = min(len(names), 12)
for i in range(1, n + 1):
    for j in range(i + 1, min(i + 3, n) + 1):
        a, b = (i, j) if (i + j) % 2 else (j, i)
        print(f"{{a}}\\t1000\\t0\\t900\\t+\\t{{b}}\\t1000\\t0\\t900\\t900\\t900\\t60")
print("3\\t1000\\t0\\t900\\t+\\t3\\t1000\\t0\\t900\\t900\\t900\\t60")  # a read with itself
print("1\\t1000\\t0\\t900\\t+\\t99999\\t1000\\t0\\t900\\t900\\t900\\t60")  # no such read
print("x\\t1000\\t0\\t900\\t+\\t2\\t1000")  # not a read id
print("short line")
print(f"preset {{args[1]}} k {{args[3]}}", file=sys.stderr)
"""


def _fake_minimap2(path):
    path.write_text(FAKE_MINIMAP2.format(python=sys.executable))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_minimap_candidates_equal_canu_tpu(runs, tmp_path):
    mm2 = _fake_minimap2(tmp_path / "minimap2")
    got = {}
    for name, S, C, D, rs in (("jax", JS, JC, JD, runs["jax"][3]),
                              ("torch", TS, TC, TD, runs["torch"][3])):
        cfg = C.Config()
        cfg.set("minimap2Path", mm2)
        cfg.set("readType", "nanopore")
        d = tmp_path / name
        ctx = D.make_ctx(str(d), "t", cfg)
        got[name] = (S._minimap_candidates(ctx, "obt", rs, str(d)), d)
    (ref, dj), (pairs, dt) = got["jax"], got["torch"]
    assert pairs.dtype == np.int64 and pairs.shape == (30, 2)
    np.testing.assert_array_equal(pairs, ref)
    for f in ("t.mmap-reads.fasta", "t.mmap.paf"):
        assert (dt / f).read_bytes() == (dj / f).read_bytes(), f


def test_minimap_overlap_stage(runs, tmp_path):
    rs, fk = runs["torch"][3], runs["torch"][1]
    cfg = TC.Config()
    cfg.set("genomeSize", GENOME)
    cfg.set("obtOverlapper", "minimap")
    ctx = TD.make_ctx(str(tmp_path / "wd"), "t", cfg)
    cfg.set("minimap2Path", str(tmp_path / "no-such-minimap2"))
    with pytest.raises(TD.PipelineError):
        TS.overlap(ctx, "obt", rs, fk, device="cpu")
    cfg.set("minimap2Path", _fake_minimap2(tmp_path / "minimap2"))
    joins = TM.JOIN_CALLS
    st = TS.overlap(ctx, "obt", rs, fk, device="cpu")
    assert TM.JOIN_CALLS == joins and len(st) > 0
    pairs = {(min(a, b), max(a, b)) for a, b in zip(st.a_id.tolist(), st.b_id.tolist())}
    assert pairs <= {(i, j) for i in range(1, 13) for j in range(i + 1, i + 4)}
    assert os.path.exists(tmp_path / "wd" / "trimming" / "t.mmap.paf")
