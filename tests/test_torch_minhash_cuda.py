"""Kernels K5 (the MinHash sketch) and K6 (the block matcher) against their
plain PyTorch versions, and the wrappers' device contract.  This file
imports no jax, so it runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_minhash_cuda.py

(``--noconftest``: tests/conftest.py imports jax).  The ``cuda``-marked
tests need a card and skip elsewhere; the others run anywhere.  The edge
cases come from torch_cases.py, shared with test_torch_minhash.py (which
holds the plain versions to canu_tpu on the CPU) and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.ops import minhash as MH
from canu_tpu_torch.ops.hashing import u32_tensor
from canu_tpu_torch.ops.kernels import minhash_cuda as MK
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from torch_cases import (MATCH_EDGE_CASES, MATCH_PAIR_CASES, SKETCH_EDGE_CASES,  # noqa: F401
                         match_edge_case, match_pair_case, one_torch_thread, sketch_edge_case)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels K5 and K6 are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _sketch_args(k, H, fk, dev="cpu"):
    words, lengths, seeds, table, k = sketch_edge_case(k, H, fk)
    return (u32_tensor(words, dev), torch.from_numpy(lengths).to(dev), u32_tensor(seeds, dev),
            u32_tensor(table, dev), k)


def _counts():
    return (MK.SKETCH_LAUNCHES, MK.MATCH_LAUNCHES, MK.COMPACT_LAUNCHES, MH.PLAIN_CUDA_SKETCHES,
            MH.PLAIN_CUDA_MATCHES)


def test_cpu_tensors_take_the_plain_versions_and_never_the_kernels():
    args = _sketch_args(22, 64, "frequent")
    SA, SB = (u32_tensor(x, "cpu") for x in match_edge_case(70, 130, 33))
    before = _counts()
    got = MH._sketch_kernel(*args)
    np.testing.assert_array_equal(got.numpy(), MH._sketch_kernel_plain(*args).numpy())
    for g, r in zip(MH._match_kernel(SA, SB, 3, False, 50),
                    MH._match_kernel_plain(SA, SB, 3, False, 50)):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    np.testing.assert_array_equal(MH.slot_counts(SA, SB).numpy(),
                                  MH._slot_counts_plain(SA, SB).numpy())
    assert _counts() == before


def test_the_sharded_ring_counts_through_slot_counts():
    from canu_tpu_torch.parallel import mesh

    SA, SB = (u32_tensor(x, "cpu") for x in match_edge_case(129, 129, 65))
    np.testing.assert_array_equal(mesh._count_matches(SA, SB, 2).numpy(),
                                  MH._slot_counts_plain(SA, SB).numpy())


@pytest.mark.parametrize("name", sorted(MATCH_PAIR_CASES))
def test_match_pair_cases_hold_what_they_name(name):
    """Each K6 block pair, through the plain match on the CPU, has the
    spot its name plants: set cells at all, n_found past max_out or
    max_out 0, every set cell of the one-tile-row self block in rows
    64-95, blocks past 1,024 or 2,048 rows or 32 column tiles of 32."""
    SA, SB, mm, self_block, max_out = match_pair_case(name)
    Na, Nb = len(SA), len(SB)
    ii, jj, c, n_found = MH._match_kernel_plain(u32_tensor(SA, "cpu"), u32_tensor(SB, "cpu"),
                                                mm, self_block, max_out)
    n, take = int(n_found), min(int(n_found), max_out)
    assert (n > 0) == (name != "1 x 1 self")
    assert (ii[take:] == Na).all() and (jj[take:] == Na).all() and (c[take:] == 0).all()
    assert (c[:take] >= mm).all() and (not self_block or (ii[:take] < jj[:take]).all())
    checks = {"n_found above max_out": n > max_out, "max_out 0": max_out == 0 and n > 0,
              "self, set cells in one tile row": n == 64 and set((ii[:n] // 32).tolist()) == {2},
              "Na above 1024": Na > 1024, "self, Na above 1024": Na > 1024 and self_block,
              "Na above 2,048, Nb 3": Na > 2048, "Nb above 32 column tiles": Nb > 32 * 32,
              "1 x 1024": (Na, Nb) == (1, 1024) and n > 512,
              "1024 x 1": (Na, Nb) == (1024, 1) and n > 512}
    assert checks.get(name, (Na, Nb) == (1, 1))


def _sketch_kwargs(dev):
    words, lengths, seeds, fk, k = _sketch_args(16, 64, "frequent", dev)
    return {"words": words, "lengths": lengths, "seeds": seeds, "fk": fk, "k": k}


# what K5's wrapper must refuse (a change to its keyword arguments, the
# exception and the message it names), whatever the device
SKETCH_REFUSALS = {
    "k 1": ({"k": 1}, ValueError, "k in 2..32"),
    "k 33": ({"k": 33}, ValueError, "k in 2..32"),
    "words 1-D": ({"words": lambda a: a["words"][0]}, ValueError, "2-D"),
    "words int32": ({"words": lambda a: a["words"].to(torch.int32)}, TypeError, "dtype"),
    "words not contiguous": ({"words": lambda a: a["words"][:, ::2]}, ValueError, "contiguous"),
    "lengths int64": ({"lengths": lambda a: a["lengths"].to(torch.int64)}, TypeError, "dtype"),
    "lengths short": ({"lengths": lambda a: a["lengths"][:3]}, ValueError, "shape"),
    "seeds 2-D": ({"seeds": lambda a: a["seeds"][None, :]}, ValueError, "shape"),
    "fk empty": ({"fk": lambda a: a["fk"][:0]}, ValueError, "at least one entry"),
    "fk int32": ({"fk": lambda a: a["fk"].to(torch.int32)}, TypeError, "dtype"),
}


def _match_kwargs(dev):
    SA, SB = (u32_tensor(x, dev) for x in match_edge_case(70, 130, 33))
    return {"SA": SA, "SB": SB, "min_matches": 3, "self_block": False, "max_out": 50}


MATCH_REFUSALS = {
    "SA int32": ({"SA": lambda a: a["SA"].to(torch.int32)}, TypeError, "dtype"),
    "SB other H": ({"SB": lambda a: a["SB"][:, :20].contiguous()}, ValueError, "shape"),
    "SB 1-D": ({"SB": lambda a: a["SB"][0]}, ValueError, "2-D"),
    "SA not contiguous": ({"SA": lambda a: a["SA"][:, ::2]}, ValueError, "contiguous"),
    "max_out -1": ({"max_out": -1}, ValueError, "max_out"),
}


def _refused(fn, kwargs, refusals, case):
    change, exc, msg = refusals[case]
    kwargs.update({k: v(kwargs) if callable(v) else v for k, v in change.items()})
    before = _counts()
    with pytest.raises(exc, match=msg):
        fn(**kwargs)
    assert _counts() == before


@pytest.mark.parametrize("case", sorted(SKETCH_REFUSALS))
def test_sketch_wrapper_refuses_what_the_kernel_does_not_take(case):
    _refused(MK.sketch, _sketch_kwargs(torch.device("cpu")), SKETCH_REFUSALS, case)


@pytest.mark.parametrize("case", sorted(MATCH_REFUSALS))
def test_match_wrapper_refuses_what_the_kernel_does_not_take(case):
    _refused(MK.match_block, _match_kwargs(torch.device("cpu")), MATCH_REFUSALS, case)


def test_wrappers_refuse_host_tensors_instead_of_falling_back():
    before = _counts()
    with pytest.raises(ValueError, match="CUDA"):
        MK.sketch(**_sketch_kwargs(torch.device("cpu")))
    with pytest.raises(ValueError, match="CUDA"):
        MK.match_block(**_match_kwargs(torch.device("cpu")))
    kw = _match_kwargs(torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        MK.slot_counts(kw["SA"], kw["SB"])
    assert _counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("k,H,fk", SKETCH_EDGE_CASES)
def test_sketch_kernel_matches_plain_on_card(cuda_device, k, H, fk):
    args = _sketch_args(k, H, fk, cuda_device)
    before = _counts()
    got = MH._sketch_kernel(*args)
    assert _counts()[0] == before[0] + 1 and _counts()[3] == before[3]
    ref = MH._sketch_kernel_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == ref.shape
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("Na,Nb,H,min_matches,self_block,max_out", MATCH_EDGE_CASES)
def test_match_kernel_matches_plain_on_card(cuda_device, Na, Nb, H, min_matches, self_block,
                                            max_out):
    SA, SB = (u32_tensor(x, cuda_device) for x in match_edge_case(Na, Nb, H))
    SB = SA if self_block else SB
    before = _counts()
    got = MH._match_kernel(SA, SB, min_matches, self_block, max_out)
    assert _counts()[1:3] == (before[1] + 1, before[2] + 1) and _counts()[4] == before[4]
    ref = MH._match_kernel_plain(SA, SB, min_matches, self_block, max_out)
    torch.cuda.synchronize()
    for name, r, g in zip(("ii", "jj", "c", "n_found"), ref, got):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy(), err_msg=name)
    np.testing.assert_array_equal(MH.slot_counts(SA, SB).cpu().numpy(),
                                  MH._slot_counts_plain(SA, SB).cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(MATCH_PAIR_CASES))
def test_match_kernel_matches_plain_on_block_pairs(cuda_device, name):
    """K6 on MATCH_PAIR_CASES: two launches a pair (the count and the
    compact), no plain match, outputs bit-equal to the plain version's,
    and a second call on the scratch the first one left gives the same."""
    SA, SB, mm, self_block, max_out = match_pair_case(name)
    SA, SB = u32_tensor(SA, cuda_device), u32_tensor(SB, cuda_device)
    SB = SA if self_block else SB
    ref = MH._match_kernel_plain(SA, SB, mm, self_block, max_out)
    for _ in range(2):
        before = _counts()
        got = MH._match_kernel(SA, SB, mm, self_block, max_out)
        after = _counts()
        assert (after[1] - before[1], after[2] - before[2], after[4] - before[4]) == (1, 1, 0)
        torch.cuda.synchronize()
        for field, r, g in zip(("ii", "jj", "c", "n_found"), ref, got):
            assert g.dtype == r.dtype and g.shape == r.shape, field
            np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy(), err_msg=field)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SKETCH_REFUSALS))
def test_sketch_wrapper_refuses_on_card(cuda_device, case):
    _refused(MK.sketch, _sketch_kwargs(cuda_device), SKETCH_REFUSALS, case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(MATCH_REFUSALS))
def test_match_wrapper_refuses_on_card(cuda_device, case):
    _refused(MK.match_block, _match_kwargs(cuda_device), MATCH_REFUSALS, case)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 22])
def test_sketch_and_candidates_on_card_equal_the_cpu(cuda_device, k):
    g = random_genome(30_000, seed=12, repeat_spec=[(300, 8)])
    rs, _ = simulate_reads(g, coverage=10, mean_len=2000, min_len=800, max_len=4000,
                           error_rate=0.08, seed=13)
    sk = {dev: MH.build_sketches(rs, k=k, n_hashes=256, block_size=64, device=dev)
          for dev in ("cpu", cuda_device)}
    np.testing.assert_array_equal(sk[cuda_device], sk["cpu"])
    for bs in (1024, 48):
        got = MH.find_candidates(sk["cpu"], min_matches=2, block_size=bs, device=cuda_device)
        ref = MH.find_candidates(sk["cpu"], min_matches=2, block_size=bs, device="cpu")
        assert len(ref) > 0
        np.testing.assert_array_equal(got, ref)
