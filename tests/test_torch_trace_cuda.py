"""Kernel K4 (the vote engine's DP) against the plain PyTorch version, and
the wrapper's device contract.  This file imports no jax, so it runs
where jax is absent:

    python -m pytest --noconftest tests/test_torch_trace_cuda.py

(``--noconftest``: tests/conftest.py imports jax).  The ``cuda``-marked
tests need a card and skip elsewhere; the others run anywhere.  The cases
come from torch_cases.py, shared with test_torch_trace.py (which holds the
plain version to canu_tpu on the CPU) and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.ops import trace as TT
from canu_tpu_torch.ops.kernels import trace_cuda as K4
from torch_cases import (DP_GROUP_CASES, dp_group_case, one_torch_thread,  # noqa: F401
                         trace_cases)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K4 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _args(band: int, n_rows: int, ends_free: bool, dev="cpu"):
    return [torch.from_numpy(x).to(dev)
            for x in trace_cases(n_rows + band + int(ends_free), n_rows, band)]


def _random_args(seed: int, B: int, n_rows: int, LE: int, dev="cpu"):
    """Random characters, t_len in [-2, n_rows + 4] and e_len in [-2, LE +
    9], with one template of n_rows, one empty and one empty evidence: the
    masks' edges (lengths past the rows or the evidence, negative ones)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, n_rows + 7)).astype(np.uint8)
    e = rng.integers(0, 4, (B, LE)).astype(np.uint8)
    tl = rng.integers(-2, n_rows + 5, B).astype(np.int32)
    el = rng.integers(-2, LE + 10, B).astype(np.int32)
    tl[0], tl[1], el[2] = n_rows, 0, 0
    return [torch.from_numpy(x).to(dev) for x in (t, tl, e, el)]


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    args = _args(128, 256, True)
    counts = (K4.LAUNCHES, TT.PLAIN_CUDA_CALLS)
    got = TT.align_positions_lean(*args, 128, 256, ends_free=True)
    ref = TT.align_positions_lean_plain(*args, 128, 256, ends_free=True)
    assert (K4.LAUNCHES, TT.PLAIN_CUDA_CALLS) == counts
    for name, r, g in zip(("j_star", "edits"), ref, got):
        np.testing.assert_array_equal(r.numpy(), g.numpy(), err_msg=name)


def _wrapper_args(dev, B=3, n_rows=64, LE=100):
    t, tl, e, el = _random_args(1, B, n_rows, LE, dev)
    return {"t": t, "t_len": tl, "e": e, "e_len": el,
            "anchors": TT._anchors(tl, el, 128, n_rows), "band": 128, "n_rows": n_rows,
            "ends_free": True}


# what the wrapper must refuse (a change to its keyword arguments, the
# exception and the message it names), whatever the device
REFUSALS = {
    "band 257": ({"band": 257}, ValueError, "bands 1..256"),
    "band 0": ({"band": 0}, ValueError, "bands 1..256"),
    "n_rows 100": ({"n_rows": 100}, ValueError, "multiple of 32"),
    "n_rows 0": ({"n_rows": 0}, ValueError, "multiple of 32"),
    "t shorter than n_rows": ({"n_rows": 96}, ValueError, "columns"),
    "t int32": ({"t": lambda a: a["t"].to(torch.int32)}, TypeError, "dtype"),
    "t_len int64": ({"t_len": lambda a: a["t_len"].to(torch.int64)}, TypeError, "dtype"),
    "e 1-D": ({"e": lambda a: a["e"][0]}, ValueError, "2-D"),
    "e_len short": ({"e_len": lambda a: a["e_len"][:2]}, ValueError, "shape"),
    "anchors short": ({"anchors": lambda a: a["anchors"][:, :1].contiguous()}, ValueError,
                      "shape"),
    "e not contiguous": ({"e": lambda a: a["e"][:, ::2]}, ValueError, "contiguous"),
}


def _refused(dev, case):
    args = _wrapper_args(dev)
    change, exc, msg = REFUSALS[case]
    args.update({k: v(args) if callable(v) else v for k, v in change.items()})
    launches = K4.LAUNCHES
    with pytest.raises(exc, match=msg):
        K4.vote_dp_keys(**args)
    assert K4.LAUNCHES == launches


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    _refused(torch.device("cpu"), case)


def test_wrapper_refuses_host_tensors_instead_of_falling_back():
    launches = K4.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        K4.vote_dp_keys(**_wrapper_args(torch.device("cpu")))
    assert K4.LAUNCHES == launches


def test_scratch_covers_the_padded_window():
    # the stored rows hold the window band + 128 in whole warps of 8 or
    # 12 cells a lane; each warp of a job stores at most half_rows rows
    # (whole super-rows of them staged) before the two meet at M = 32 *
    # round(t_len / 64), for every t_len; a job at 2,048 rows and band 256
    # takes 1.19 MB (pipeline/configure.py)
    for band in (1, 127, 128, 129, 200, 256):
        W = K4.row_lanes(band)
        assert W in (256, 384) and W >= band + 128 and W - (band + 128) < 128
    for n_rows in (32, 64, 96, 128, 2016, 2048):
        H = K4.half_rows(n_rows)
        assert H % 32 == 0 and H <= n_rows // 2 + 16
        for T in range(n_rows + 1):
            M = 32 * ((T + 32) // 64)
            assert M <= T and M <= H and T - M <= H and 32 * -(-(T - M) // 32) <= H
    assert K4.half_rows(2048) == 1024 and K4.half_rows(2016) == 1024
    assert K4.scratch_bytes(256, 256, 2048) == 256 * (1025 * 388 + 1024 * 768 + 2049 * 4) \
        == 305_235_968


@pytest.mark.parametrize("band,n_rows", [(1, 32), (129, 96), (256, 2048)])
def test_group_jobs_fits_its_budget_and_is_never_zero(band, n_rows):
    one = K4.scratch_bytes(1, band, n_rows)
    rng = np.random.default_rng(band + n_rows)
    for budget in [one, one + 1, 2 * one - 1, 7 * one, *rng.integers(one, 1 << 34, 20)]:
        n = K4.group_jobs(band, n_rows, int(budget))
        assert n >= 1 and K4.scratch_bytes(n, band, n_rows) <= budget
        assert K4.scratch_bytes(n + 1, band, n_rows) > budget
    for budget in (0, one - 1):
        with pytest.raises(ValueError, match="exceeds the budget"):
            K4.group_jobs(band, n_rows, budget)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [256, 2048])
@pytest.mark.parametrize("ends_free", [False, True])
@pytest.mark.parametrize("band", [128, 200, 256])
def test_kernel_matches_plain_on_card(cuda_device, band, ends_free, n_rows):
    args = _args(band, n_rows, ends_free, cuda_device)
    launches, plain = K4.LAUNCHES, TT.PLAIN_CUDA_CALLS
    got = TT.align_positions_lean(*args, band, n_rows, ends_free=ends_free)
    assert (K4.LAUNCHES, TT.PLAIN_CUDA_CALLS) == (launches + 1, plain)
    ref = TT.align_positions_lean_plain(*args, band, n_rows, ends_free=ends_free)
    assert TT.PLAIN_CUDA_CALLS == plain + 1
    torch.cuda.synchronize()
    for name, r, g in zip(("j_star", "edits"), ref, got):
        assert g.dtype == torch.int32 and g.shape == r.shape
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("band,n_rows,LE,ends_free", [(37, 64, 50, True), (128, 64, 200, False),
                                                      (160, 96, 400, True), (256, 96, 1, False)])
def test_kernel_matches_plain_on_random_lengths(cuda_device, band, n_rows, LE, ends_free):
    args = _random_args(band + n_rows, 40, n_rows, LE, cuda_device)
    got = TT.align_positions_lean(*args, band, n_rows, ends_free=ends_free)
    ref = TT.align_positions_lean_plain(*args, band, n_rows, ends_free=ends_free)
    torch.cuda.synchronize()
    for name, r, g in zip(("j_star", "edits"), ref, got):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_on_card(cuda_device, case):
    _refused(cuda_device, case)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n_rows,band,ends_free,mostly_short", DP_GROUP_CASES)
def test_kernel_matches_plain_on_groups(cuda_device, B, n_rows, band, ends_free, mostly_short):
    args = [torch.from_numpy(x).to(cuda_device)
            for x in dp_group_case(B + n_rows + band, B, n_rows, band, mostly_short)]
    launches, jobs = K4.LAUNCHES, K4.JOBS_LAUNCHED
    got = TT.align_positions_lean(*args, band, n_rows, ends_free=ends_free)
    assert (K4.LAUNCHES, K4.JOBS_LAUNCHED) == (launches + 1, jobs + B)
    ref = TT.align_positions_lean_plain(*args, band, n_rows, ends_free=ends_free)
    torch.cuda.synchronize()
    for name, r, g in zip(("j_star", "edits"), ref, got):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)
