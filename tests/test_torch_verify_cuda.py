"""Kernels K7 (verify's anchor-and-inputs step), K8 (the syncmer read
index) and K12 (stage C's pair statistics) against their plain PyTorch
versions, and the wrappers' device contract.  This file imports no jax, so it runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_verify_cuda.py

(``--noconftest``: tests/conftest.py imports jax).  The ``cuda``-marked
tests need a card and skip elsewhere; the others run anywhere.  The edge
cases come from torch_cases.py, shared with test_torch_align.py and
test_torch_minimizers.py (which hold the plain versions to canu_tpu on the
CPU) and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.convert import read_index_from_numpy
from canu_tpu_torch.ops import align as AL
from canu_tpu_torch.ops import minimizers as MZ
from canu_tpu_torch.ops.hashing import u32_tensor
from canu_tpu_torch.ops.kernels import verify_cuda as VC
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.ops.kmer import bucket_widths
from canu_tpu_torch.sim import simulate as SIM
from canu_tpu_torch.stores.readset import ReadSet
from canu_tpu_torch.ops import minhash as MH
from torch_cases import (LONG_READ_W, PAIR_STATS_CASES, SYNCMER_EDGE_CASES,  # noqa: F401
                         VERIFY_PRE_CHUNK, VERIFY_PRE_EDGE_CASES, VERIFY_PRE_ODD_CASES,
                         VERIFY_PRE_SIZE_CHUNK, bucket_reads, pair_stats_case, placed_digest,
                         one_torch_thread, syncmer_cut_case, syncmer_edge_case,
                         verify_pre_edge_case, verify_pre_long_case, verify_pre_size_case)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels K7 and K8 are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _counts():
    return VC.PRE_LAUNCHES, VC.SYNCMER_LAUNCHES, AL.PLAIN_CUDA_PRE, MZ.PLAIN_CUDA_SYNCMER


def _pre_args(case, dev="cpu"):
    k, _W, band, orient, *odd = case
    pl, a, b, fl, n_rows = verify_pre_edge_case(k, _W, band, orient) if _W != LONG_READ_W else \
        verify_pre_long_case()
    n_rows = odd[0] if odd else n_rows
    index = read_index_from_numpy(pl["words"], pl["length"], pl["mker"], pl["mpos"], pl["mstr"],
                                  pl["n_reads"], k, pl["pm"], device=dev)
    return (index, torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev),
            torch.from_numpy(fl).to(dev), k, band, n_rows, orient)


def _sync_args(case, dev="cpu"):
    k, _W, pm = case
    words, lengths = syncmer_edge_case(*case)
    return u32_tensor(words, dev), torch.from_numpy(lengths).to(dev), k, pm


def _equal(ref, got, names):
    for name, r, g in zip(names, ref, got):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy(), err_msg=name)


PRE_NAMES = ("a", "a_len", "b", "b_len", "centers")
PER_PAIR = ("n_anchor", "flipped", "seedA", "seedB", "n_minor")


def test_cpu_tensors_take_the_plain_versions_and_never_the_kernels():
    args = _pre_args(VERIFY_PRE_EDGE_CASES[1])
    before = _counts()
    got = AL._verify_pre(*args, chunk=VERIFY_PRE_CHUNK)
    ref = AL._verify_pre_plain(*args)  # one chunk of all 96 pairs: the same per-pair outputs
    _equal(ref[1:], got[1:], PER_PAIR)
    w, lengths, k, pm = _sync_args(SYNCMER_EDGE_CASES[2])
    _equal(MZ._syncmer_kernel_plain(w, lengths, k, pm), MZ._syncmer_kernel(w, lengths, k, pm),
           ("mker", "mpos", "mstr", "n_sel"))
    assert _counts() == before


def _pre_kwargs(dev):
    index, a, b, fl, k, band, n_rows, orient = _pre_args(VERIFY_PRE_EDGE_CASES[0], dev)
    return {"index": index, "a_idx": a, "b_idx": b, "flipped": fl, "k": k, "band": band,
            "n_rows": n_rows, "orient": orient, "chunk": VERIFY_PRE_CHUNK}


def _index_with(name, fn):
    def change(kw):
        ix = kw["index"]
        return MZ.ReadIndex(**{**{f: getattr(ix, f) for f in ("words", "length", "mker", "mpos",
                                                             "mstr", "n_reads", "k", "pm")},
                              name: fn(getattr(ix, name))})
    return {"index": change}


# what K7's wrapper must refuse (a change to its keyword arguments, the
# exception and the message it names), whatever the device
PRE_REFUSALS = {
    "chunk not dividing": ({"chunk": 40}, ValueError, "whole chunks"),
    "a_idx 2-D": ({"a_idx": lambda a: a["a_idx"][None]}, ValueError, "1-D"),
    "a_idx int32": ({"a_idx": lambda a: a["a_idx"].to(torch.int32)}, TypeError, "dtype"),
    "b_idx short": ({"b_idx": lambda a: a["b_idx"][:5]}, ValueError, "shape"),
    "flipped uint8": ({"flipped": lambda a: a["flipped"].to(torch.uint8)}, TypeError, "dtype"),
    "n_rows 0": ({"n_rows": 0}, ValueError, "n_rows"),
    "mker int32": (_index_with("mker", lambda x: x.to(torch.int32)), TypeError, "dtype"),
    "mpos not contiguous": (_index_with("mpos", lambda x: x.t().contiguous().t()), ValueError,
                            "contiguous"),
    "Pm above 2048": (_index_with("mker", lambda x: x.repeat(1, 17)), ValueError, "1..2048"),
    "center_stride 8": ({"center_stride": 8}, ValueError, "stride 1 or 16"),
}

SYNC_REFUSALS = {
    "k 33": ({"k": 33}, ValueError, "k in 2..32"),
    "pm 0": ({"pm": 0}, ValueError, "pm >= 1"),
    "words 1-D": ({"words": lambda a: a["words"][0]}, ValueError, "2-D"),
    "words int32": ({"words": lambda a: a["words"].to(torch.int32)}, TypeError, "dtype"),
    "lengths int64": ({"lengths": lambda a: a["lengths"].to(torch.int64)}, TypeError, "dtype"),
    "too few words": ({"words": lambda a: a["words"][:, :1].contiguous(), "k": 22, "s": 16,
                       "t": 3}, ValueError, "no 22-mer"),
}


def _sync_kwargs(dev):
    words, lengths, k, pm = _sync_args(SYNCMER_EDGE_CASES[0], dev)
    s, t = MZ.syncmer_params(k)
    return {"words": words, "lengths": lengths, "k": k, "s": s, "t": t, "pm": pm}


def _refused(fn, kwargs, refusals, case):
    change, exc, msg = refusals[case]
    kwargs.update({k: v(kwargs) if callable(v) else v for k, v in change.items()})
    before = _counts()
    with pytest.raises(exc, match=msg):
        fn(**kwargs)
    assert _counts() == before


@pytest.mark.parametrize("case", sorted(PRE_REFUSALS))
def test_pre_wrapper_refuses_what_the_kernel_does_not_take(case):
    _refused(VC.verify_pre, _pre_kwargs(torch.device("cpu")), PRE_REFUSALS, case)


@pytest.mark.parametrize("case", sorted(SYNC_REFUSALS))
def test_syncmer_wrapper_refuses_what_the_kernel_does_not_take(case):
    _refused(VC.syncmer, _sync_kwargs(torch.device("cpu")), SYNC_REFUSALS, case)


def _bucket_set():
    codes = bucket_reads(SIM)
    return ReadSet.from_codes_list(codes, [f"r{i}" for i in range(len(codes))])


def _index_kwargs(dev, k=16):
    """syncmer_index's arguments for the bucket read set's one launch, into
    fresh planes shaped as its plain index's."""
    rs = _bucket_set()
    ref = MZ.build_read_index(rs, k=k, block_size=4, device="cpu")
    ids, wbs = bucket_widths(rs, 4)
    s, t = MZ.syncmer_params(k)
    kw = {"words": ref.words, "lengths": ref.length, "rows": torch.from_numpy(ids - 1),
          "wbs": torch.from_numpy(wbs), "min_wb": int(wbs.min()), "k": k, "s": s, "t": t,
          "mker": torch.full_like(ref.mker, 7), "mpos": torch.full_like(ref.mpos, 7),
          "mstr": torch.full_like(ref.mstr, 7)}
    return {n: v.to(dev) if isinstance(v, torch.Tensor) else v for n, v in kw.items()}, ref


def test_wrappers_refuse_host_tensors_instead_of_falling_back():
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        VC.verify_pre(**_pre_kwargs(torch.device("cpu")))
    with pytest.raises(ValueError, match="CUDA"):
        VC.syncmer(**_sync_kwargs(torch.device("cpu")))
    with pytest.raises(ValueError, match="CUDA"):
        VC.syncmer_index(**_index_kwargs(torch.device("cpu"))[0])
    assert _counts() == before


# what the whole-index launch must refuse, whatever the device
INDEX_REFUSALS = {
    "rows int64": ({"rows": lambda a: a["rows"].to(torch.int64)}, TypeError, "dtype"),
    "wbs short": ({"wbs": lambda a: a["wbs"][:3]}, ValueError, "shape"),
    "mpos narrower": ({"mpos": lambda a: a["mpos"][:, :5].contiguous()}, ValueError, "shape"),
    "pm 4096": ({n: (lambda a, n=n: a[n].repeat(1, 2)) for n in ("mker", "mpos", "mstr")},
                ValueError, "at most 2048"),
    "min_wb below a k-mer": ({"min_wb": 1, "k": 22, "s": 16, "t": 3}, ValueError, "no 22-mer"),
    "n_sel int64": ({"n_sel": lambda a: torch.zeros(a["words"].shape[0], dtype=torch.int64,
                                                     device=a["words"].device)},
                    TypeError, "dtype"),
}


@pytest.mark.parametrize("case", sorted(INDEX_REFUSALS))
def test_index_wrapper_refuses_what_the_kernel_does_not_take(case):
    _refused(VC.syncmer_index, _index_kwargs(torch.device("cpu"))[0], INDEX_REFUSALS, case)


# the edge groups (also with rows off 16-byte boundaries), and reads above
# 131,072 bases: W = LONG_READ_W, 4 pairs a chunk (K7's shared memory does
# not grow with the reads)
PRE_CASES = [(c, VERIFY_PRE_CHUNK) for c in VERIFY_PRE_EDGE_CASES + VERIFY_PRE_ODD_CASES] + [
    ((16, LONG_READ_W, 128, True), 4), ((16, LONG_READ_W, 1024, False), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case,chunk", PRE_CASES, ids=str)
def test_pre_kernel_matches_plain_on_card(cuda_device, case, chunk):
    args = _pre_args(case, cuda_device)
    before = _counts()
    got = AL._verify_pre(*args, chunk=chunk)
    assert _counts()[0] == before[0] + 1 and _counts()[2] == before[2]
    ref = AL._verify_pre_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    _equal(ref[0], got[0], PRE_NAMES)
    _equal(ref[1:], got[1:], PER_PAIR)


@pytest.mark.cuda
@pytest.mark.parametrize("case,chunk", [c for c in PRE_CASES if c[0][2] == 128], ids=str)
def test_pre_kernel_on_the_grid_matches_plain_on_card(cuda_device, case, chunk):
    # the centres stored on their 16-row grid (the Myers engine's input):
    # the plain step's grid, and the rows of the same call expanded from it
    args = _pre_args(case, cuda_device)
    got = AL._verify_pre(*args, chunk=chunk, center_stride=16)
    ref = AL._verify_pre_plain(*args, chunk=chunk, center_stride=16)
    rows = AL._verify_pre(*args, chunk=chunk)[0][4]
    torch.cuda.synchronize()
    _equal(ref[0], got[0], PRE_NAMES)
    _equal(ref[1:], got[1:], PER_PAIR)
    n_rows = rows.shape[1] - 1
    assert tuple(got[0][4].shape) == (rows.shape[0], n_rows // 16 + 1)
    assert torch.equal(AL.expand_centers(got[0][4], n_rows), rows)


def _long_sync_args(dev):
    pl = verify_pre_long_case()[0]
    return u32_tensor(pl["words"], dev), torch.from_numpy(pl["length"]).to(dev), 16, pl["pm"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*SYNCMER_EDGE_CASES, "long reads"], ids=str)
def test_syncmer_kernel_matches_plain_on_card(cuda_device, case):
    args = _long_sync_args(cuda_device) if case == "long reads" else _sync_args(case, cuda_device)
    before = _counts()
    got = MZ._syncmer_kernel(*args)
    assert _counts()[1] == before[1] + 1 and _counts()[3] == before[3]
    ref = MZ._syncmer_kernel_plain(*args)
    torch.cuda.synchronize()
    _equal(ref, got, ("mker", "mpos", "mstr", "n_sel"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PRE_REFUSALS))
def test_pre_wrapper_refuses_on_card(cuda_device, case):
    _refused(VC.verify_pre, _pre_kwargs(cuda_device), PRE_REFUSALS, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SYNC_REFUSALS))
def test_syncmer_wrapper_refuses_on_card(cuda_device, case):
    _refused(VC.syncmer, _sync_kwargs(cuda_device), SYNC_REFUSALS, case)


@pytest.mark.cuda
@pytest.mark.parametrize("k,band", [(16, 128), (22, 256)])
def test_index_and_verify_on_card_equal_the_cpu(cuda_device, k, band):
    from canu_tpu_torch.ops import minhash as MH

    g = random_genome(12_000, seed=14, repeat_spec=[(300, 4)])
    rs, _ = simulate_reads(g, coverage=6, mean_len=1500, min_len=800, max_len=2500,
                           error_rate=0.06, seed=15)
    idx = {dev: MZ.build_read_index(rs, k=k, block_size=32, device=dev)
           for dev in ("cpu", cuda_device)}
    for name in ("words", "length", "mker", "mpos", "mstr"):
        np.testing.assert_array_equal(getattr(idx[cuda_device], name).cpu().numpy(),
                                      getattr(idx["cpu"], name).numpy(), err_msg=name)
    sk = MH.build_sketches(rs, k=k, n_hashes=256, block_size=64, device="cpu")
    pairs = MH.find_candidates(sk, min_matches=2, device="cpu")
    out = {dev: AL.verify_overlaps(rs, pairs, k=k, band=band, chunk=64, partial=True,
                                   palindromic_min=2, index=idx[dev], device=dev)
           for dev in ("cpu", cuda_device)}
    assert len(out["cpu"]) > 0
    for c in ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q"):
        np.testing.assert_array_equal(getattr(out[cuda_device], c), getattr(out["cpu"], c),
                                      err_msg=c)


@pytest.mark.cuda
@pytest.mark.parametrize("orient,band", [(True, 128), (False, 256)])
def test_pre_kernel_matches_plain_at_the_sort_sizes_on_card(cuda_device, orient, band):
    """K7 on joins of 1, 2, 2,048 and 4,096 valid entries, 4,096 of one key
    and a read with itself (tests/torch_cases.py verify_pre_size_case, Pm
    2,048), one launch for its 3 chunks."""
    pl, a, b, fl, n_rows = verify_pre_size_case()
    index = read_index_from_numpy(pl["words"], pl["length"], pl["mker"], pl["mpos"], pl["mstr"],
                                  pl["n_reads"], 16, pl["pm"], device=cuda_device)
    args = (index, *(torch.from_numpy(x).to(cuda_device) for x in (a, b, fl)), 16, band, n_rows,
            orient)
    before = _counts()
    got = AL._verify_pre(*args, chunk=VERIFY_PRE_SIZE_CHUNK)
    assert _counts()[0] == before[0] + 1 and _counts()[2] == before[2]
    ref = AL._verify_pre_plain(*args, chunk=VERIFY_PRE_SIZE_CHUNK)
    torch.cuda.synchronize()
    _equal(ref[0], got[0], PRE_NAMES)
    _equal(ref[1:], got[1:], PER_PAIR)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 22])
def test_syncmer_kernel_matches_plain_at_the_cut_on_card(cuda_device, k):
    """K8 where reads select pm - 1, pm, pm + 1 and 2 pm keys and equal
    keys straddle the pm-th entry (its radix select's cut)."""
    words, lengths, pm = syncmer_cut_case(k)
    args = (u32_tensor(words, cuda_device), torch.from_numpy(lengths).to(cuda_device), k, pm)
    got = MZ._syncmer_kernel(*args)
    ref = MZ._syncmer_kernel_plain(*args)
    torch.cuda.synchronize()
    _equal(ref, got, ("mker", "mpos", "mstr", "n_sel"))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 22])
def test_index_is_one_launch_equal_to_the_plain_blocks_on_card(cuda_device, k):
    """build_read_index on the card: one K8 launch a build (SYNCMER_LAUNCHES
    up by 1, the plain selection never on the card), every plane equal to
    the plain index built block by block on the CPU, over buckets of 8 to
    1,024 words; and syncmer_index alone writes the same rows and n_sel."""
    rs = _bucket_set()
    before = _counts()
    got = MZ.build_read_index(rs, k=k, block_size=4, device=cuda_device)
    after = _counts()
    assert after[1] == before[1] + 1 and after[3] == before[3]
    kw, ref = _index_kwargs(cuda_device, k)
    for name in ("words", "length", "mker", "mpos", "mstr"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(ref, name).numpy(), err_msg=name)
    n_sel = torch.full((ref.n_rows,), -7, dtype=torch.int32, device=cuda_device)
    VC.syncmer_index(**kw, n_sel=n_sel)
    N = ref.n_reads
    for name in ("mker", "mpos", "mstr"):
        np.testing.assert_array_equal(kw[name][:N].cpu().numpy(), getattr(ref, name)[:N].numpy(),
                                      err_msg=name)
    assert int(n_sel[N]) == -7  # the padding row is no read's
    for ids, Wb in MZ.length_bucketed_blocks(rs, 4):
        words, lengths = MZ.block_tensors(rs, ids, Wb, "cpu")
        np.testing.assert_array_equal(n_sel[ids - 1].cpu().numpy(),
                                      MZ._syncmer_kernel_plain(words, lengths, k, ref.pm)[3].numpy())


# ---- K12: stage C's pair statistics ------------------------------------------

PAIR_NAMES = ("flipped", "diag", "n_inliers", "a_lo", "a_hi", "b_lo", "b_hi")


def _pair_kwargs(case="k16_fk", dev="cpu"):
    wa, la, wb, lb, fk, k = pair_stats_case(case)
    return {"wordsA": u32_tensor(wa, dev), "lenA": torch.from_numpy(la).to(dev),
            "wordsB": u32_tensor(wb, dev), "lenB": torch.from_numpy(lb).to(dev),
            "fk": u32_tensor(fk, dev), "k": k}


# what K12's wrapper refuses, whatever the device
PAIR_REFUSALS = {
    "words int32": ({"wordsA": lambda a: a["wordsA"].to(torch.int32)}, TypeError, "dtype"),
    "wordsB narrower": ({"wordsB": lambda a: a["wordsB"][:, :32].contiguous()}, ValueError,
                        "shape"),
    "lenB int64": ({"lenB": lambda a: a["lenB"].to(torch.int64)}, TypeError, "dtype"),
    "lenA short": ({"lenA": lambda a: a["lenA"][:5]}, ValueError, "shape"),
    "fk empty": ({"fk": lambda a: a["fk"][:0]}, ValueError, "at least one"),
    "k 33": ({"k": 33}, ValueError, "k in 2..32"),
    "host tensors": ({}, ValueError, "CUDA"),
}


def _pair_counts():
    return VC.PAIR_STATS_LAUNCHES, MH.PLAIN_CUDA_PAIR_STATS


@pytest.mark.parametrize("case", sorted(PAIR_REFUSALS))
def test_pair_stats_wrapper_refuses_what_the_kernel_does_not_take(case):
    change, exc, msg = PAIR_REFUSALS[case]
    kw = _pair_kwargs()
    kw.update({k: v(kw) if callable(v) else v for k, v in change.items()})
    before = _pair_counts()
    with pytest.raises(exc, match=msg):
        VC.pair_stats(**kw)
    assert _pair_counts() == before


@pytest.mark.parametrize("W,k,C", [(64, 16, 64), (1024, 22, 256), (16384, 16, 256)])
def test_pair_stats_scratch_holds_the_table_and_the_hits(W, k, C):
    blocks, S, H = VC.pair_stats_scratch(W, k, C)
    P = 16 * W - k + 1
    assert S >= 4 * P and S & (S - 1) == 0 and H == P
    assert 1 <= blocks <= C and (blocks == 1 or blocks * (12 * S + 8 * H) <= VC.PAIR_STATS_SCRATCH)


def test_place_candidates_on_the_cpu_launches_no_kernel():
    genome = random_genome(20_000, seed=3)
    rs, _ = simulate_reads(genome, coverage=4, mean_len=1500, min_len=800, max_len=2500,
                           error_rate=0.05, seed=4)
    pairs = np.stack([np.arange(1, rs.n_reads), np.arange(2, rs.n_reads + 1)], axis=1)
    before = _pair_counts()
    MH.place_candidates(rs, pairs, k=16, chunk=16, device="cpu")
    assert _pair_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAIR_STATS_CASES)
@pytest.mark.parametrize("budget", ["whole", "two blocks"])
def test_pair_stats_kernel_matches_plain_on_card(cuda_device, case, budget, monkeypatch):
    kw = _pair_kwargs(case, cuda_device)
    if budget == "two blocks":  # each block strides over the chunk's pairs
        _b, S, H = VC.pair_stats_scratch(kw["wordsA"].shape[1], kw["k"], 1)
        monkeypatch.setattr(VC, "PAIR_STATS_SCRATCH", 2 * (12 * S + 8 * H))
    ref = MH._pair_stats_kernel(*(kw[n] for n in ("wordsA", "lenA", "wordsB", "lenB", "fk")),
                                kw["k"])
    launches = VC.PAIR_STATS_LAUNCHES
    got = VC.pair_stats(**kw)
    torch.cuda.synchronize()
    assert VC.PAIR_STATS_LAUNCHES == launches + 1
    _equal(ref, got, PAIR_NAMES)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 22])
def test_place_candidates_on_card_equals_the_cpu(cuda_device, k):
    genome = random_genome(60_000, seed=5, repeat_spec=[(300, 8)])
    rs, _ = simulate_reads(genome, coverage=6, mean_len=3000, min_len=1500, max_len=6000,
                           error_rate=0.08, seed=6)
    rng = np.random.default_rng(k)
    pairs = np.sort(rng.choice(np.arange(1, rs.n_reads + 1), (700, 2)), axis=1)
    ref = MH.place_candidates(rs, pairs, k=k, device="cpu")
    before = _pair_counts()
    got = MH.place_candidates(rs, pairs, k=k, device=cuda_device)
    assert _pair_counts() == (before[0] + -(-len(pairs) // 256), before[1])
    assert len(got) > 0 and placed_digest(got) == placed_digest(ref)
