"""Port parity for the spill store: canu_tpu_torch's OverlapSpill and
OverlapStore.build_spilled (native/ovsort.cc, built by canu_tpu_torch.native)
against canu_tpu's on the same tables, and verify_overlaps(sink=...), which
hands each chunk to the spill instead of accumulating it.

std::sort is not stable, so rows with one (a_id, b_id) may come out in
either order: stores are compared by store_digest (every column sorted).
"""

from __future__ import annotations

import numpy as np
import pytest

from canu_tpu.ops import align as JA
from canu_tpu.ops import minhash as JM
from canu_tpu.ops.minimizers import get_read_index as jax_index
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu.stores import overlaps as JO
from canu_tpu.stores.readset import ReadSet
from canu_tpu_torch import native
from canu_tpu_torch.convert import read_index_from_numpy
from canu_tpu_torch.ops import align as TA
from canu_tpu_torch.stores import overlaps as TO
from canu_tpu_torch.stores.readset import ReadSet as TorchReadSet
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")


def _tables(seed: int, n_reads: int = 60, m: int = 400):
    """The same random chunks as canu_tpu's and the port's OverlapTable,
    with repeated (a_id, b_id) pairs (as obt's palindromic pairs give)."""
    rng = np.random.default_rng(seed)
    cols = {"a_id": rng.integers(1, n_reads + 1, m), "b_id": rng.integers(1, n_reads + 1, m),
            "flipped": rng.integers(0, 2, m).astype(bool),
            "a_bgn": rng.integers(0, 900, m), "a_end": rng.integers(1000, 5000, m),
            "b_bgn": rng.integers(0, 900, m), "b_end": rng.integers(1000, 5000, m),
            "erate_q": rng.integers(0, 3000, m)}
    cols["b_id"][::7] = cols["a_id"][::7] % n_reads + 1  # a != b
    cols["a_id"][1::9], cols["b_id"][1::9] = cols["a_id"][::9][: len(cols["a_id"][1::9])], \
        cols["b_id"][::9][: len(cols["b_id"][1::9])]
    dt = {"flipped": bool, "erate_q": np.uint16}
    cols = {c: v.astype(dt.get(c, np.int32)) for c, v in cols.items()}
    cuts = [0, 0, 150, 151, 300, m]  # an empty chunk among them
    out = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        out.append((JA.OverlapTable(**{c: cols[c][lo:hi] for c in COLS}),
                    TA.OverlapTable(**{c: cols[c][lo:hi] for c in COLS})))
    return out, n_reads


def test_record_layout():
    assert TO.REC_DTYPE.itemsize == 28
    assert TO.REC_DTYPE == JO.REC_DTYPE
    # native/ovsort.cc's Rec: two uint32 ids, four int32 ends, uint16
    # erate_q, uint8 flipped, one pad byte, packed
    offsets = {n: TO.REC_DTYPE.fields[n][1] for n in TO.REC_DTYPE.names}
    assert offsets == {"a_id": 0, "b_id": 4, "a_bgn": 8, "a_end": 12, "b_bgn": 16,
                       "b_end": 20, "erate_q": 24, "flipped": 26, "pad": 27}


def test_spill_file_equals_canu_tpu(tmp_path):
    chunks, _ = _tables(1)
    js, ts = JO.OverlapSpill(str(tmp_path / "j.spill")), TO.OverlapSpill(str(tmp_path / "t.spill"))
    for jt, tt in chunks:
        js.append(jt)
        ts.append(tt)
    js.close()
    ts.close()
    assert ts.n_rows == js.n_rows == 2 * sum(len(t) for _, t in chunks)
    assert (tmp_path / "t.spill").read_bytes() == (tmp_path / "j.spill").read_bytes()


@pytest.mark.parametrize("threads", [1, 4])
def test_build_spilled_equals_canu_tpu_and_in_ram(tmp_path, threads):
    chunks, n_reads = _tables(2 + threads)
    js, ts = JO.OverlapSpill(str(tmp_path / "j.spill")), TO.OverlapSpill(str(tmp_path / "t.spill"))
    for jt, tt in chunks:
        js.append(jt)
        ts.append(tt)
    before = TO.SPILL_BUILDS
    got = TO.OverlapStore.build_spilled(ts, n_reads, n_threads=threads)
    ref = JO.OverlapStore.build_spilled(js, n_reads, n_threads=threads)
    assert TO.SPILL_BUILDS == before + 1
    assert sorted(p.name for p in tmp_path.iterdir()) == []  # spill and sorted files gone
    assert len(got) == len(ref) > 0
    for c in COLS:
        assert np.asarray(getattr(got, c)).dtype == np.asarray(getattr(ref, c)).dtype, c
    key = np.asarray(got.a_id).astype(np.int64) << 32 | np.asarray(got.b_id)
    assert (np.diff(key) >= 0).all()
    np.testing.assert_array_equal(got.index, ref.index)
    assert TO.store_digest(got) == TO.store_digest(ref)
    # the spilled store is the in-RAM build of the concatenated chunks
    cat = TA.OverlapTable(**{c: np.concatenate([getattr(t, c) for _, t in chunks]) for c in COLS})
    assert TO.store_digest(got) == TO.store_digest(TO.OverlapStore.build(cat, n_reads))
    got.save(tmp_path / "st")
    assert TO.store_digest(TO.OverlapStore.load(tmp_path / "st")) == TO.store_digest(got)


def test_empty_spill(tmp_path):
    sp = TO.OverlapSpill(str(tmp_path / "e.spill"))
    sp.append(TA.OverlapTable(**{c: np.zeros(0, np.int32) for c in COLS}))
    st = TO.OverlapStore.build_spilled(sp, 5)
    assert len(st) == 0 and st.n_overlaps_per_read().sum() == 0
    assert list(tmp_path.iterdir()) == []


def test_native_build_raises_and_never_falls_back(tmp_path, monkeypatch):
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR and lib.parent.parent.name == "canu_tpu_torch"
    assert native.SOURCE.parts[-2:] == ("native", "ovsort.cc")
    # a record file whose size is not a multiple of 28 bytes: the sort fails
    bad = tmp_path / "bad.spill"
    bad.write_bytes(b"\0" * 30)
    with pytest.raises(OSError, match="ovsort_file failed"):
        native.ovsort_file(str(bad), str(tmp_path / "out"), str(tmp_path))
    # a source that does not compile: the build raises
    src = tmp_path / "ovsort.cc"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()


@pytest.fixture(scope="module")
def palindromic():
    # reads plus one chimeric read (a read's first half, then its second
    # half reverse-complemented), whose pair with that read has k-mer
    # support in both orientations (tests/test_torch_align.py's set)
    g = random_genome(10_000, seed=40)
    rs, _ = simulate_reads(g, coverage=8, mean_len=800, min_len=500, max_len=1000,
                           error_rate=0.10, seed=41)
    codes = [rs.get_codes(i) for i in range(1, rs.n_reads + 1)]
    c = max(codes, key=len)
    h = len(c) // 2
    codes.append(np.concatenate([c[:h], (3 - c[h:])[::-1]]).astype(np.uint8))
    names = [f"r{i}" for i in range(len(codes))]
    rs = ReadSet.from_codes_list(codes, names)
    trs = TorchReadSet.from_codes_list(codes, names)
    pairs = JM.find_candidates(JM.build_sketches(rs, k=16, n_hashes=128, block_size=64),
                               min_matches=2)
    # the chimeric read's pairs and a few others: three chunks of 32
    pairs = np.concatenate([pairs[pairs[:, 1] == rs.n_reads], pairs[:80]])
    pairs = pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))]
    ji = jax_index(rs, k=16)
    ti = read_index_from_numpy(
        *(np.asarray(getattr(ji, n)) for n in ("words", "length", "mker", "mpos", "mstr")),
        ji.n_reads, ji.k, ji.pm, device="cpu")
    return trs, pairs, ti


def test_verify_sink_with_palindromic_pairs(palindromic):
    trs, pairs, ti = palindromic
    kw = dict(k=16, band=128, max_erate=0.3, min_overlap=300, chunk=32, min_shared=4,
              partial=True, palindromic_min=4)
    whole = TA.verify_overlaps(trs, pairs, index=ti, device="cpu", **kw)
    n_chunks = -(-len(pairs) // kw["chunk"])
    assert TA.LAST_PROFILE["n_chunks"] > n_chunks  # the palindromic pass ran
    # (the port's table equals canu_tpu's: tests/test_torch_align.py)
    got = []
    out = TA.verify_overlaps(trs, pairs, index=ti, device="cpu", sink=got.append, **kw)
    assert len(out) == 0 and len(got) == TA.LAST_PROFILE["n_chunks"]
    for c in COLS:
        a = np.concatenate([getattr(t, c) for t in got])
        np.testing.assert_array_equal(a, getattr(whole, c), err_msg=c)
    # the second pass's rows repeat (a_id, b_id) pairs of the first
    ab = set(zip(whole.a_id.tolist(), whole.b_id.tolist()))
    assert len(ab) < len(whole)
