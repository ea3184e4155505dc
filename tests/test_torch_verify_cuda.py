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
from canu_tpu_torch.ops import kmer as KM
from canu_tpu_torch.ops.hashing import mix32, u32_tensor
from canu_tpu_torch.ops.kernels import verify_cuda as VC
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.ops.kmer import bucket_widths
from canu_tpu_torch.sim import simulate as SIM
from canu_tpu_torch.stores.readset import ReadSet
from canu_tpu_torch.ops import minhash as MH
from canu_tpu_torch.ops import votepile as VP
from torch_cases import (LONG_READ_W, PAIR_STATS_CASES, SYNCMER_EDGE_CASES,  # noqa: F401
                         VERIFY_PRE_CHUNK, VERIFY_PRE_EDGE_CASES, VERIFY_PRE_ODD_CASES,
                         VERIFY_PRE_SIZE_CHUNK, bucket_reads, pair_stats_case,
                         pair_stats_retry_case, placed_digest,
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


# K12's launch plan (the K12_* constants: 8,192 slots, 1,024 shared hits)
# at the bench shape (W 512, k 16), at W 1,024 with k 22 and at W 16,384:
# (lengths, expected slots, rounds and device-list room of pairs of two
# reads of that length)
PLAN_CASES = {
    "bench W512 k16": (512, 16, [0, 15, 16, 1000, 2064, 4112, 8192],
                       [64, 64, 64, 2048, 8192, 8192, 8192], [0, 0, 1, 1, 1, 2, 2],
                       [0, 0, 0, 0, 1025, 3073, 7153]),
    "W1024 k22": (1024, 22, [21, 22, 300, 1046, 1047, 16384],
                  [64, 64, 1024, 4096, 4096, 8192], [0, 1, 1, 1, 1, 4], [0, 0, 0, 1, 2, 15339]),
    "W16384 k16": (16384, 16, [4111, 4112, 100_000, 262_144], [8192] * 4, [1, 2, 25, 64],
                   [3072, 3073, 98_961, 261_105]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_pair_stats_plan_rounds_slots_and_hit_list_room(case):
    W, k, lens, slots, rounds, room = PLAN_CASES[case]
    lens = np.asarray(lens, np.int32)
    assert lens.max() <= 16 * W
    plan = VC.pair_stats_plan(lens, lens, k)
    np.testing.assert_array_equal(plan["slots"], slots)
    np.testing.assert_array_equal(plan["rounds"], rounds)
    np.testing.assert_array_equal(plan["room"], room)
    S, nA = plan["slots"], plan["nA"]
    assert ((S & (S - 1)) == 0).all() and (S <= VC.K12_SLOTS).all()
    # at most half a table a round, and no round more than needed
    assert (plan["rounds"] * (S // 2) >= nA).all()
    assert ((plan["rounds"] - 1) * (S // 2) < np.maximum(nA, 1)).all()
    # a read against an empty one takes no round and no room
    empty = VC.pair_stats_plan(lens, np.zeros_like(lens), k)
    assert not empty["rounds"].any() and not empty["room"].any()
    # the kernel's shared memory (its dynamic bytes, 1,104 static, 1 KB
    # reserved a block) holds 1,024 threads an SM of 228 KB
    per_block = 8 * VC.K12_HITS + 12 * VC.K12_SLOTS + 1104 + 1024
    assert (228 * 1024 // per_block) * VC.K12_THREADS >= 1024


def _rows_kwargs(dev="cpu"):
    wa, la, wb, lb, fk, k = pair_stats_case("k16_fk")
    C = wa.shape[0]
    rows = torch.arange(C, dtype=torch.int32)
    return {"words": u32_tensor(np.vstack([wa, wb]), dev),
            "lengths": torch.from_numpy(np.concatenate([la, lb])).to(dev),
            "a_idx": rows.to(dev), "b_idx": (rows + C).to(dev), "fk": u32_tensor(fk, dev), "k": k}


# what K12's call entry refuses, whatever the device
ROWS_REFUSALS = {
    "a row past the plane": ({"a_idx": lambda a: a["a_idx"] + 100}, ValueError, "outside"),
    "a negative b row": ({"b_idx": lambda a: a["b_idx"] - 100}, ValueError, "outside"),
    "ids int64": ({"a_idx": lambda a: a["a_idx"].to(torch.int64)}, TypeError, "dtype"),
    "b ids short": ({"b_idx": lambda a: a["b_idx"][:7]}, ValueError, "shape"),
    "lengths int64": ({"lengths": lambda a: a["lengths"].to(torch.int64)}, TypeError, "dtype"),
    "words 1-D": ({"words": lambda a: a["words"][0]}, ValueError, "2-D"),
    "host tensors": ({}, ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(ROWS_REFUSALS))
def test_pair_stats_rows_refuses_what_the_kernel_does_not_take(case):
    change, exc, msg = ROWS_REFUSALS[case]
    kw = _rows_kwargs()
    kw.update({k: v(kw) if callable(v) else v for k, v in change.items()})
    before = _pair_counts()
    with pytest.raises(exc, match=msg):
        VC.pair_stats_rows(**kw)
    assert _pair_counts() == before


# (each pair's room in the device hit list, budget): the ranges of
# consecutive pairs K12 launches on, each within the budget, a pair past
# it alone
GROUP_CASES = {
    "the call fits": ([0, 5, 7, 0, 3], 15, [(0, 5, 15)]),
    "split": ([4, 4, 4, 4, 4], 8, [(0, 2, 8), (2, 4, 8), (4, 5, 4)]),
    "a pair past the budget alone": ([1, 20, 1, 1], 4, [(0, 1, 1), (1, 2, 20), (2, 4, 2)]),
    "no room": ([0, 0, 0], 1, [(0, 3, 0)]),
    "no pair": ([], 8, []),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_hit_list_groups_stay_within_the_budget(case):
    need, budget, want = GROUP_CASES[case]
    got = VC.hit_list_groups(np.asarray(need, np.int64), budget)
    assert got == want
    assert all(room <= budget or q1 == q0 + 1 for q0, q1, room in got)


@pytest.mark.parametrize("budget", [1 << 27, 6000, 1])
def test_rows_hit_lists_split_a_call_past_the_budget(budget, monkeypatch):
    # 40 pairs of 1.5-6 kb reads, 6 of a read against itself: the call's
    # launches, each pair's offset in its launch's list and each list's size
    genome = random_genome(60_000, seed=5)
    rs, _ = simulate_reads(genome, coverage=6, mean_len=3000, min_len=1500, max_len=6000,
                           error_rate=0.08, seed=6)
    pairs = np.sort(np.random.default_rng(3).choice(np.arange(1, rs.n_reads + 1), (40, 2)), 1)
    pairs[:6, 1] = pairs[:6, 0]
    words, lengths = VP.device_words(rs, "cpu")
    a_idx, b_idx = (torch.from_numpy((pairs[:, j] - 1).astype(np.int32)) for j in (0, 1))
    monkeypatch.setattr(VC, "K12_HIT_LIST", budget)
    lists = VC.rows_hit_lists(lengths, a_idx, b_idx, 16)
    n = np.maximum(rs.length[pairs - 1] - 15, 0).min(1)
    need = np.maximum(n - VC.K12_HITS, 0)
    assert need.sum() > 6000
    assert [(q0, q1) for q0, q1, _, _ in lists] == [
        (q0, q1) for q0, q1, _ in VC.hit_list_groups(need, budget)]
    assert lists[0][0] == 0 and lists[-1][1] == 40
    assert (len(lists) == 1) == (budget == 1 << 27)
    for q0, q1, off, dh in lists:
        room = int(need[q0:q1].sum())
        assert room <= budget or q1 == q0 + 1
        assert budget > 1 or room == 0 or q1 == q0 + 1
        if room == 0:
            assert off is None and dh is None
            continue
        assert dh.shape == (room, 2)
        np.testing.assert_array_equal(off.numpy(), np.cumsum(need[q0:q1]) - need[q0:q1])


def test_place_candidates_on_the_cpu_launches_no_kernel():
    genome = random_genome(20_000, seed=3)
    rs, _ = simulate_reads(genome, coverage=4, mean_len=1500, min_len=800, max_len=2500,
                           error_rate=0.05, seed=4)
    pairs = np.stack([np.arange(1, rs.n_reads), np.arange(2, rs.n_reads + 1)], axis=1)
    before = _pair_counts()
    MH.place_candidates(rs, pairs, k=16, chunk=16, device="cpu")
    assert _pair_counts() == before


# (slots, hits): the K12_* constants, and a table of 512 slots (A's 1,009
# positions at W 64 in up to 4 rounds) with 32 shared hits, so most pairs
# spill hits to the device list
PAIR_PLANS = {"default": None, "small table": (512, 32)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", PAIR_STATS_CASES)
@pytest.mark.parametrize("plan", sorted(PAIR_PLANS))
def test_pair_stats_kernel_matches_plain_on_card(cuda_device, case, plan, monkeypatch):
    for name, v in zip(("K12_SLOTS", "K12_HITS"), PAIR_PLANS[plan] or ()):
        monkeypatch.setattr(VC, name, v)
    kw = _pair_kwargs(case, cuda_device)
    ref = MH._pair_stats_kernel(*(kw[n] for n in ("wordsA", "lenA", "wordsB", "lenB", "fk")),
                                kw["k"])
    C = kw["lenA"].shape[0]
    rounds = torch.full((C,), -1, dtype=torch.int32, device=cuda_device)
    launches = VC.PAIR_STATS_LAUNCHES
    got = VC.pair_stats(**kw, rounds=rounds)
    torch.cuda.synchronize()
    assert VC.PAIR_STATS_LAUNCHES == launches + 1
    _equal(ref, got, PAIR_NAMES)
    want = VC.pair_stats_plan(kw["lenA"].cpu().numpy(), kw["lenB"].cpu().numpy(),
                              kw["k"])["rounds"]
    np.testing.assert_array_equal(rounds.cpu().numpy(), want)
    if plan == "small table":
        assert want.max() >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 22])
def test_pair_stats_spills_hits_past_the_shared_list_on_card(cuda_device, k):
    # reads of 9-16 kb against themselves and their neighbours: thousands of
    # hits a pair, past the K12_HITS kept in shared memory, in up to 4 rounds
    genome = random_genome(40_000, seed=11)
    rs, _ = simulate_reads(genome, coverage=4, mean_len=12_000, min_len=9_000, max_len=16_000,
                           error_rate=0.03, seed=12)
    ids = np.arange(1, rs.n_reads + 1)
    pairs = np.concatenate([np.stack([ids, ids], 1), np.stack([ids[:-1], ids[1:]], 1)])
    wa, la = rs.block_words(pairs[:, 0], 1024)
    wb, lb = rs.block_words(pairs[:, 1], 1024)
    fk = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64, device=cuda_device)
    args = (u32_tensor(wa, cuda_device), torch.from_numpy(la).to(cuda_device),
            u32_tensor(wb, cuda_device), torch.from_numpy(lb).to(cuda_device), fk, k)
    ref = MH._pair_stats_kernel(*args)
    rounds = torch.full((len(pairs),), -1, dtype=torch.int32, device=cuda_device)
    got = VC.pair_stats(*args, rounds=rounds)
    _equal(ref, got, PAIR_NAMES)
    assert int(ref[2][: rs.n_reads].min()) > VC.K12_HITS
    np.testing.assert_array_equal(rounds.cpu().numpy(), VC.pair_stats_plan(la, lb, k)["rounds"])
    # the call entry over the read set's plane: the same rows
    words, lengths = VP.device_words(rs, cuda_device)
    rows = torch.from_numpy((pairs.T - 1).astype(np.int32)).to(cuda_device)
    out = VC.pair_stats_rows(words, lengths, rows[0].contiguous(), rows[1].contiguous(), fk, k)
    _equal(tuple(r.to(torch.int32) for r in ref), out.unbind(0), PAIR_NAMES)


# (slots, hits or None for the constants; A's k-mer positions, the bound
# below which each key's mix32 lies, W): A's keys crowd one of the plan's
# ranges past 3/4 of the table, so K12 retakes it over half the range; at
# 0.35 of the hash range the small table's first range holds ~750 keys in
# 512 slots, so an insert walks the whole table first
RETRY_CASES = {
    "small table, half the range": (512, 32, 450, 1 << 31, 64),
    "small table, a full table": (512, 32, 1000, int(0.35 * 2**32), 64),
    "the constants, half the range": (None, None, 7200, 1 << 31, 512),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_pair_stats_retry_case_crowds_one_range(case):
    slots, hits, n_pos, below, W = RETRY_CASES[case]
    wa, la, wb, lb, fk, k = pair_stats_retry_case(n_pos, below, W)
    canon, _ = KM.extract_kmers_any(torch.from_numpy(wa.astype(np.int64)), torch.from_numpy(la), k)
    plan = VC.pair_stats_plan(la, lb, k)
    S = min(slots or VC.K12_SLOTS, plan["slots"].max())
    rounds = -(-n_pos // (S // 2))
    for row in canon.numpy()[la > 0]:
        keys = row[row != KM.INVALID_KMER]
        h = mix32(torch.from_numpy(keys)).numpy()
        assert len(keys) == len(np.unique(keys)) == n_pos and h.max() < below
        # the first of the plan's equal ranges holds more than 3/4 of a table
        assert (h < -(-(1 << 32) // rounds)).sum() > 3 * S // 4


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_pair_stats_retakes_a_crowded_round_on_card(cuda_device, case, monkeypatch):
    slots, hits, n_pos, below, W = RETRY_CASES[case]
    if slots:
        monkeypatch.setattr(VC, "K12_SLOTS", slots)
        monkeypatch.setattr(VC, "K12_HITS", hits)
    wa, la, wb, lb, fk, k = pair_stats_retry_case(n_pos, below, W)
    args = (u32_tensor(wa, cuda_device), torch.from_numpy(la).to(cuda_device),
            u32_tensor(wb, cuda_device), torch.from_numpy(lb).to(cuda_device),
            u32_tensor(fk, cuda_device), k)
    ref = MH._pair_stats_kernel(*args)
    rounds = torch.full((len(la),), -1, dtype=torch.int32, device=cuda_device)
    got = VC.pair_stats(*args, rounds=rounds)
    _equal(ref, got, PAIR_NAMES)
    plan = VC.pair_stats_plan(la, lb, k)["rounds"]
    took = rounds.cpu().numpy()
    assert (plan[:-1] >= 2).all() and (took[:-1] > plan[:-1]).all() and took[-1] == plan[-1] == 0
    # each crowded round is halved until it fits, here at most twice: the
    # rest of the hash range in ranges of a quarter of the plan's width
    assert (took[:-1] <= 4 * plan[:-1] + 2).all()
    assert int(ref[2][0]) == n_pos  # A against itself: every position a hit


@pytest.mark.cuda
def test_pair_stats_rows_splits_a_call_past_the_hit_list_budget_on_card(cuda_device,
                                                                        monkeypatch):
    genome = random_genome(60_000, seed=5)
    rs, _ = simulate_reads(genome, coverage=6, mean_len=3000, min_len=1500, max_len=6000,
                           error_rate=0.08, seed=6)
    pairs = np.sort(np.random.default_rng(3).choice(np.arange(1, rs.n_reads + 1), (40, 2)), 1)
    pairs[:6, 1] = pairs[:6, 0]
    words, lengths = VP.device_words(rs, cuda_device)
    rows = torch.from_numpy((pairs.T - 1).astype(np.int32)).to(cuda_device)
    fk = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64, device=cuda_device)
    call = (words, lengths, rows[0].contiguous(), rows[1].contiguous(), fk, 16)
    whole = VC.pair_stats_rows(*call)
    monkeypatch.setattr(VC, "K12_HIT_LIST", 6000)
    n = len(VC.rows_hit_lists(lengths, call[2], call[3], 16))
    launches = VC.PAIR_STATS_LAUNCHES
    split = VC.pair_stats_rows(*call)
    assert n > 1 and VC.PAIR_STATS_LAUNCHES == launches + n
    assert torch.equal(whole, split)
    ref = MH.place_candidates(rs, pairs, k=16, min_shared=0, device="cpu")
    want = np.stack([ref.flipped.astype(np.int32), ref.diag, ref.n_shared, ref.a_lo, ref.a_hi,
                     ref.b_lo, ref.b_hi])
    np.testing.assert_array_equal(split.cpu().numpy(), want)


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
    assert _pair_counts() == (before[0] + 1, before[1])  # one launch a call
    assert len(got) > 0 and placed_digest(got) == placed_digest(ref)
