"""Port parity for anchored verification: canu_tpu_torch.ops.align against
canu_tpu.ops.align (Myers engine, XLA on the CPU), fed the same ReadIndex
through convert.read_index_from_numpy, exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import align as JA
from canu_tpu.ops import minhash as JM
from canu_tpu.ops.minimizers import get_read_index as jax_index
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu.stores.readset import ReadSet
from canu_tpu_torch.convert import read_index_from_numpy
from canu_tpu_torch.ops import align as TA
from canu_tpu_torch.ops.minhash import OverlapCandidates
from canu_tpu_torch.stores.readset import ReadSet as TorchReadSet
from torch_cases import (LONG_READ_W, VERIFY_PRE_CHUNK, VERIFY_PRE_EDGE_CASES,  # noqa: F401
                         VERIFY_PRE_ODD_CASES, VERIFY_PRE_SIZE_PAIRS, one_torch_thread,
                         verify_pre_edge_case, verify_pre_long_case, verify_pre_size_case)

TABLE_COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")


@pytest.fixture(scope="module")
def sim():
    g = random_genome(10_000, seed=40)
    rs, _ = simulate_reads(g, coverage=8, mean_len=800, min_len=500, max_len=1000,
                           error_rate=0.10, seed=41)
    # plus one chimeric read (a read's first half, then its second half
    # reverse-complemented) whose pair with that read has k-mer support in
    # both orientations
    codes = [rs.get_codes(i) for i in range(1, rs.n_reads + 1)]
    c = max(codes, key=len)
    h = len(c) // 2
    codes.append(np.concatenate([c[:h], (3 - c[h:])[::-1]]).astype(np.uint8))
    names = [f"r{i}" for i in range(len(codes))]
    rs = ReadSet.from_codes_list(codes, names)
    trs = TorchReadSet.from_codes_list(codes, names)  # the port's own read set
    sk = JM.build_sketches(rs, k=16, n_hashes=128, block_size=64)
    pairs = JM.find_candidates(sk, min_matches=2)
    ji = jax_index(rs, k=16)
    ti = read_index_from_numpy(
        *(np.asarray(getattr(ji, n)) for n in ("words", "length", "mker", "mpos", "mstr")),
        ji.n_reads, ji.k, ji.pm, device="cpu")
    return rs, trs, pairs, ji, ti


def _eq(ref, got, name=""):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(ref), err_msg=name)


def test_shift_rows():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (9, 64)).astype(np.uint8)
    t = np.array([0, 1, 5, 31, 32, 63, 64, 70, 200], np.int32)  # incl. t >= L
    for out_len in (16, 64, 100):
        _eq(JA._shift_rows(jnp.asarray(x), jnp.asarray(t), out_len),
            TA._shift_rows(torch.from_numpy(x), torch.from_numpy(t), out_len), out_len)


@pytest.mark.parametrize("hi", [262_144, 1 << 21])
def test_interp_centers_at_long_coordinates(hi):
    """Centres of anchor chains up to `hi` rows, where a separate product
    and sum round differently from canu_tpu's fused multiply-add."""
    rng = np.random.default_rng(hi)
    B, M = 64, 64
    xa = np.sort(rng.integers(0, hi, (B, M)), axis=1).astype(np.int32)
    xb = np.maximum.accumulate(xa + rng.integers(-3000, 3000, (B, M)), axis=1).astype(np.int32)
    xa[:, 0] = xb[:, 0] = 0
    xa[:, 50:] = xb[:, 50:] = (1 << 24) + np.arange(14)  # the slope-1 padding
    _eq(JA._interp_centers(jnp.asarray(xa), jnp.asarray(xb), None, hi),
        TA._interp_centers(torch.from_numpy(xa), torch.from_numpy(xb), hi))


def test_interp_centers():
    rng = np.random.default_rng(1)
    B, M, n_rows = 40, 64, 700
    xa = np.full((B, M), 0, np.int32)
    xb = np.full((B, M), 0, np.int32)
    m = np.arange(M, dtype=np.int32)
    for i in range(B):
        n = int(rng.integers(0, M))
        steps_a = rng.integers(0 if i % 3 == 0 else 1, 40, n)  # %3: repeated xa
        pa = np.concatenate([[0], np.cumsum(steps_a)])[:n]
        pb = np.concatenate([[0], np.cumsum(rng.integers(0, 45, n))])[:n]
        xa[i] = np.where(m < n, np.pad(pa, (0, M - n)), (1 << 24) + m)
        xb[i] = np.where(m < n, np.pad(pb, (0, M - n)), (1 << 24) + m)
    _eq(JA._interp_centers(jnp.asarray(xa), jnp.asarray(xb), None, n_rows),
        TA._interp_centers(torch.from_numpy(xa), torch.from_numpy(xb), n_rows))


@pytest.mark.parametrize("orient", [True, False], ids=["orient", "given"])
def test_anchor_compact_and_verify_pre(sim, orient):
    _rs, _trs, pairs, ji, ti = sim
    a_idx = (pairs[:96, 0] - 1).astype(np.int32)
    b_idx = (pairs[:96, 1] - 1).astype(np.int32)
    fl = (np.arange(96) % 3 == 0)
    g = lambda a, i: jnp.asarray(a)[jnp.asarray(i)]  # noqa: E731
    ref = JA._anchor_compact(
        g(ji.mker, a_idx), g(ji.mpos, a_idx), g(ji.mstr, a_idx),
        g(ji.mker, b_idx), g(ji.mpos, b_idx), g(ji.mstr, b_idx),
        g(ji.length, a_idx), g(ji.length, b_idx), jnp.asarray(fl), 16, orient)
    ta, tb = torch.from_numpy(a_idx.astype(np.int64)), torch.from_numpy(b_idx.astype(np.int64))
    got = TA._anchor_compact(
        ti.mker[ta], ti.mpos[ta], ti.mstr[ta], ti.mker[tb], ti.mpos[tb], ti.mstr[tb],
        ti.length[ta], ti.length[tb], torch.from_numpy(fl), 16, orient)
    for name, r, t in zip(("aA", "aB", "n_anchor", "flipped", "n_minor"), ref, got):
        _eq(r, t, name)
    n_rows = ti.words.shape[1] * 16
    ref = JA._verify_pre(ji.words, ji.length, ji.mker, ji.mpos, ji.mstr,
                         jnp.asarray(a_idx), jnp.asarray(b_idx), jnp.asarray(fl),
                         16, 128, n_rows, orient)
    got = TA._verify_pre(ti, ta, tb, torch.from_numpy(fl), 16, 128, n_rows, orient)
    for name, r, t in zip(("a", "a_len", "b", "b_len", "centers"), ref[0], got[0]):
        _eq(r, t, name)
    for name, r, t in zip(("n_anchor", "flipped", "seedA", "seedB", "n_minor"), ref[1:], got[1:]):
        _eq(r, t, name)


def _tables_equal(ref, got):
    assert len(got) == len(ref)
    for c in TABLE_COLS:
        a, b = getattr(ref, c), getattr(got, c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(b, a, err_msg=c)


@pytest.mark.parametrize("mode", ["raw", "partial", "palindromic", "candidates"])
def test_verify_overlaps(sim, mode):
    rs, trs, pairs, ji, ti = sim
    kw = dict(k=16, band=128, max_erate=0.3, min_overlap=300, chunk=64, min_shared=4,
              partial=mode in ("partial", "palindromic"),
              palindromic_min=4 if mode == "palindromic" else 0)
    cand = pairs
    if mode == "candidates":
        # orientation given: the vote of the raw pass, every third inverted
        fl = np.zeros(len(pairs), bool)
        fl[::3] = True
        z = np.zeros(len(pairs), np.int32)
        cand = OverlapCandidates(a_id=pairs[:, 0].astype(np.int32),
                                 b_id=pairs[:, 1].astype(np.int32), flipped=fl, diag=z,
                                 n_shared=z, a_lo=z, a_hi=z, b_lo=z, b_hi=z)
    ref = JA.verify_overlaps(rs, cand, engine="myers", index=ji, **kw)
    got = TA.verify_overlaps(trs, cand, index=ti, device="cpu", **kw)
    assert len(got) > 0
    _tables_equal(ref, got)
    n_chunks = -(-len(pairs) // kw["chunk"])
    if mode == "palindromic":  # the second, minority-orientation pass ran
        assert TA.LAST_PROFILE["n_chunks"] > n_chunks
    else:
        assert TA.LAST_PROFILE["n_chunks"] == n_chunks
    assert TA.LAST_PROFILE["n_candidates"] == len(pairs)


def test_tight_budget_shrinks_the_myers_group(sim, monkeypatch):
    cpu = torch.device("cpu")
    chunk, n_rows = 64, 1024
    staging = TA._chunk_staging_bytes(chunk, n_rows, 128)
    # the schedule's temporaries are counted with the A/B planes and centres
    assert staging >= 2 * chunk * (4 + TA.SCHEDULE_BYTES_PER_ROW) * n_rows
    monkeypatch.setattr(TA, "CPU_INFLIGHT_BYTES", 1000 * staging)
    assert TA._verify_window(chunk, n_rows, 128, cpu) == (TA.MYERS_GROUP, 128)
    # never more in flight than the budget holds; a group takes half of it
    monkeypatch.setattr(TA, "CPU_INFLIGHT_BYTES", 6 * staging)
    assert TA._verify_window(chunk, n_rows, 128, cpu) == (3, 6)
    monkeypatch.setattr(TA, "_INFLIGHT_BACKOFF", 0.5)  # the driver's OOM retry
    assert TA._verify_window(chunk, n_rows, 128, cpu) == (1, 3)
    monkeypatch.setattr(TA, "CPU_INFLIGHT_BYTES", staging / 10)
    assert TA._verify_window(chunk, n_rows, 128, cpu) == (1, 1)

    # verify runs one extension per (smaller) group, with the same result
    from canu_tpu_torch.ops import myers as TM

    _rs, trs, pairs, _ji, ti = sim
    kw = dict(k=16, band=128, max_erate=0.3, min_overlap=300, chunk=chunk, min_shared=4,
              index=ti, device="cpu")
    real, calls = TM.banded_extend_myers, []

    def counted(*args, **kwargs):
        calls.append(args[0].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(TM, "banded_extend_myers", counted)
    tight = TA.verify_overlaps(trs, pairs, **kw)
    n_chunks = -(-len(pairs) // chunk)
    assert calls == [2 * chunk] * n_chunks  # group 1: one chunk a launch
    monkeypatch.setattr(TA, "CPU_INFLIGHT_BYTES", 1000 * staging)
    monkeypatch.setattr(TA, "_INFLIGHT_BACKOFF", 1.0)
    calls.clear()
    roomy = TA.verify_overlaps(trs, pairs, **kw)
    assert len(calls) == -(-n_chunks // TA.MYERS_GROUP) < n_chunks
    _tables_equal(roomy, tight)


def _edge_index(case):
    k = case[0]
    pl, a, b, fl, n_rows = verify_pre_edge_case(*case)
    ti = read_index_from_numpy(pl["words"], pl["length"], pl["mker"], pl["mpos"], pl["mstr"],
                               pl["n_reads"], k, pl["pm"], device="cpu")
    return pl, ti, a, b, fl, n_rows


@pytest.mark.parametrize("case", VERIFY_PRE_EDGE_CASES, ids=str)
def test_verify_pre_edge_cases_equal_canu_tpu(case):
    """The plain _verify_pre against canu_tpu's on torch_cases.py's edge
    cases (the ones kernel K7 is held to on the card), as one chunk."""
    k, _W, band, orient = case
    pl, ti, a, b, fl, n_rows = _edge_index(case)
    ref = JA._verify_pre(*(jnp.asarray(pl[n]) for n in ("words", "length", "mker", "mpos", "mstr")),
                         jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
                         jnp.asarray(fl), k, band, n_rows, orient)
    got = TA._verify_pre(ti, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(fl), k,
                         band, n_rows, orient)
    for name, r, t in zip(("a", "a_len", "b", "b_len", "centers"), ref[0], got[0]):
        _eq(r, t, name)
    for name, r, t in zip(("n_anchor", "flipped", "seedA", "seedB", "n_minor"), ref[1:], got[1:]):
        _eq(r, t, name)
    n_anchor = got[1].numpy()
    # the planted pairs: one anchor, a tied strand vote, repeated positions;
    # the padding row none; a read against itself more than MAX_ANCHORS
    assert n_anchor[6] == 0 and n_anchor[7] == 0 and n_anchor[8] == 0
    if orient:
        assert list(n_anchor[:6]) == [1, 1, 2, 2, 3, 2] and got[5].numpy()[2] == 2
        assert n_anchor[9] == TA.MAX_ANCHORS
    assert n_anchor[11] == 5 and got[0][4][11, 16] == 15  # 14.5000005, not 14.5


@pytest.mark.parametrize("case", VERIFY_PRE_ODD_CASES, ids=str)
def test_verify_pre_rows_off_16_bytes_equal_canu_tpu(case):
    """The plain _verify_pre against canu_tpu's where n_rows and the band
    are no multiple of 16 (rows K7 stores with unaligned heads and
    tails)."""
    k, W, band, orient, n_rows = case
    pl, ti, a, b, fl, _ = _edge_index((k, W, band, orient))
    ref = JA._verify_pre(*(jnp.asarray(pl[n]) for n in ("words", "length", "mker", "mpos", "mstr")),
                         jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
                         jnp.asarray(fl), k, band, n_rows, orient)
    got = TA._verify_pre(ti, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(fl), k,
                         band, n_rows, orient)
    assert got[0][0].shape[1] == n_rows and got[0][2].shape[1] == n_rows + band
    for name, r, t in zip(("a", "a_len", "b", "b_len", "centers"), ref[0], got[0]):
        _eq(r, t, name)
    for name, r, t in zip(("n_anchor", "flipped", "seedA", "seedB", "n_minor"), ref[1:], got[1:]):
        _eq(r, t, name)


def test_verify_pre_long_reads_equal_canu_tpu():
    """The plain _verify_pre against canu_tpu's on reads above 131,072
    bases (index W = LONG_READ_W, n_rows 262,144), both orientations'
    ways: the strand vote and the given flips."""
    pl, a, b, fl, n_rows = verify_pre_long_case()
    assert pl["words"].shape[1] == LONG_READ_W and n_rows == 16 * LONG_READ_W
    ti = read_index_from_numpy(pl["words"], pl["length"], pl["mker"], pl["mpos"], pl["mstr"],
                               pl["n_reads"], 16, pl["pm"], device="cpu")
    planes = [jnp.asarray(pl[n]) for n in ("words", "length", "mker", "mpos", "mstr")]
    for orient, band in ((True, 128), (False, 1024)):
        ref = JA._verify_pre(*planes, jnp.asarray(a.astype(np.int32)),
                             jnp.asarray(b.astype(np.int32)), jnp.asarray(fl), 16, band, n_rows,
                             orient)
        got = TA._verify_pre(ti, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(fl),
                             16, band, n_rows, orient)
        for name, r, t in zip(("a", "a_len", "b", "b_len", "centers"), ref[0], got[0]):
            _eq(r, t, f"{name} orient={orient}")
        for name, r, t in zip(("n_anchor", "flipped", "seedA", "seedB", "n_minor"), ref[1:],
                              got[1:]):
            _eq(r, t, f"{name} orient={orient}")
        n_anchor = got[1].numpy()
        assert n_anchor[7] == 0 and (got[3].numpy() > 65_536).any()  # seeds past 2^16 bases
        if orient:
            assert (n_anchor[:6] == TA.MAX_ANCHORS).all()


@pytest.fixture(scope="module")
def size_case():
    return verify_pre_size_case()


@pytest.mark.parametrize("orient,band", [(True, 128), (False, 256)])
def test_verify_pre_size_cases_equal_canu_tpu(size_case, orient, band):
    """The plain _verify_pre, as one chunk, against canu_tpu's on pairs
    whose join holds 1, 2, 2,048 and 4,096 valid entries (the edge sizes of
    a sort of K7's), 4,096 entries of one key, a read with itself, a chain
    whose first inlier lies before B's start and a tol set by the shorter
    read, at Pm 2,048 (tests/torch_cases.py verify_pre_size_case)."""
    pl, a, b, fl, n_rows = size_case
    ti = read_index_from_numpy(pl["words"], pl["length"], pl["mker"], pl["mpos"], pl["mstr"],
                               pl["n_reads"], 16, pl["pm"], device="cpu")
    ref = JA._verify_pre(*(jnp.asarray(pl[n]) for n in ("words", "length", "mker", "mpos", "mstr")),
                         jnp.asarray(a.astype(np.int32)), jnp.asarray(b.astype(np.int32)),
                         jnp.asarray(fl), 16, band, n_rows, orient)
    got = TA._verify_pre_plain(ti, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(fl),
                               16, band, n_rows, orient)
    for name, r, t in zip(("a", "a_len", "b", "b_len", "centers"), ref[0], got[0]):
        _eq(r, t, name)
    for name, r, t in zip(("n_anchor", "flipped", "seedA", "seedB", "n_minor"), ref[1:], got[1:]):
        _eq(r, t, name)
    valid = (pl["mker"] != 0xFFFFFFFF).sum(axis=1)
    sizes = [int(valid[ra] + valid[rb]) for _name, ra, rb in VERIFY_PRE_SIZE_PAIRS]
    assert sizes[:5] == [1, 2, 2048, 4096, 4096] and sizes[5] > 200
    n_anchor, n_minor = got[1].numpy(), got[5].numpy()
    assert n_anchor[0] == n_anchor[1] == 0 and n_minor[8] == 0  # one key: one hit
    if orient:
        assert list(n_anchor[2:4]) == list(n_anchor[8:10]) == [1, 1]
        assert (n_anchor[4:8] == TA.MAX_ANCHORS).all() and n_anchor[10] == TA.MAX_ANCHORS
        assert n_minor[6] == 200
        assert got[2].numpy()[12] and n_anchor[12] == 4  # the hit at posB -5 starts no chain
        assert n_anchor[14] == 4  # the hit 800 off the diagonal is outside tol 180
        assert n_anchor[16] == n_anchor[18] == 2  # row 18's second x joins nothing


@pytest.mark.parametrize("case", VERIFY_PRE_EDGE_CASES[:3], ids=str)
def test_group_pre_and_post_equal_the_chunks_one_by_one(case):
    """_verify_pre and _verify_post over a group of 3 chunks: the
    concatenation of the per-chunk plain calls in the group's layout
    (chunk 0's forward rows, its backward rows, chunk 1's ...)."""
    k, _W, band, orient = case
    _pl, ti, a, b, fl, n_rows = _edge_index(case)
    C = VERIFY_PRE_CHUNK
    ta, tb, tf = torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(fl)
    group = TA._verify_pre(ti, ta, tb, tf, k, band, n_rows, orient, C)
    parts = [TA._verify_pre_plain(ti, ta[s:s + C], tb[s:s + C], tf[s:s + C], k, band, n_rows,
                                  orient) for s in range(0, len(a), C)]
    for i, name in enumerate(("a", "a_len", "b", "b_len", "centers")):
        _eq(torch.cat([p[0][i] for p in parts]).numpy(), group[0][i], name)
    for i, name in enumerate(("n_anchor", "flipped", "seedA", "seedB", "n_minor"), start=1):
        _eq(torch.cat([p[i] for p in parts]).numpy(), group[i], name)
    rng = np.random.default_rng(3)
    res = [torch.from_numpy(rng.integers(0, 900, 2 * len(a)).astype(np.int32)) for _ in range(6)]
    tile = TA._verify_post(*group[1:], *res, chunk=C)
    for g, p in enumerate(parts):
        rows = slice(2 * g * C, 2 * (g + 1) * C)
        _eq(TA._verify_post(*p[1:], *(x[rows] for x in res)).numpy(),
            tile[g * C:(g + 1) * C], f"post chunk {g}")
