"""Kernel K1 against its plain PyTorch loop, its inputs, and the wrapper's
device contract.  This file imports no jax, so it runs where jax is
absent:

    python -m pytest --noconftest tests/test_torch_myers_cuda.py

(``--noconftest``: tests/conftest.py imports jax).  The ``cuda``-marked
tests need a card and skip elsewhere; the others run anywhere.  The case
generators live in torch_cases.py, shared with test_torch_myers.py and
chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.device import resolve_device
from canu_tpu_torch.ops import myers as TM
from canu_tpu_torch.ops.kernels import myers_cuda as K1
from torch_cases import NAMES, myers_cases, myers_edge_cases

EDGE_CASES = tuple(myers_edge_cases())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_loop_and_never_the_kernel():
    args = [torch.from_numpy(x) for x in myers_cases(8, 6, 128, er=0.1)]
    launches, plain_cuda = K1.LAUNCHES, TM.PLAIN_CUDA_SEGMENTS
    got = TM.banded_extend_myers(*args, 128, 128, partial_cap_q=2400)
    ref = TM.banded_extend_myers_plain(*args, 128, 128, partial_cap_q=2400)
    assert (K1.LAUNCHES, TM.PLAIN_CUDA_SEGMENTS) == (launches, plain_cuda)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.numpy(), g.numpy(), err_msg=name)
    # the kernel's wrapper itself refuses host tensors instead of falling back
    planes = torch.zeros((TM.NC, 6), dtype=torch.int32)
    s_bits = torch.zeros((4, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        K1.myers_rows_cuda(planes, args[0], s_bits, args[2], args[1], args[3], 128, 2400)
    assert K1.LAUNCHES == launches


def _streams(args, n_rows, segment=TM.SEGMENT):
    """The plain loop's streams and K1's for the same extensions:
    (s_rows, ent_rows, o_all, n_run), n_run all rows of the schedule."""
    a, a_len, b, b_len, centers = (torch.from_numpy(np.ascontiguousarray(x)) for x in args)
    seg = min(segment, n_rows)
    n = max(1, -(-n_rows // seg)) * seg
    s_rows, ent_rows, _ = TM._myers_prep(b_len, centers, 128, n)
    return s_rows, ent_rows, TM._schedule(b_len, centers, 128, n), n


@pytest.mark.parametrize("case", EDGE_CASES + ("random",))
def test_shift_bits_unpack_to_the_plain_shift_stream(case):
    if case == "random":
        args, n_rows = myers_cases(9, 40, 333, er=0.2, drift=True), 333
    else:
        args, n_rows, _ = myers_edge_cases()[case]
    s_rows, _, o_all, n = _streams(args, n_rows)
    assert int(s_rows.max()) <= 1  # the schedule's slope: one bit a row
    for n_run in (1, 31, 32, 33, n):
        bits = TM._shift_bits(o_all, n_run)
        assert bits.dtype == torch.int32 and tuple(bits.shape) == (-(-n_run // 32), o_all.shape[0])
        w = bits.numpy().astype(np.int64) & 0xFFFFFFFF
        unpacked = (w[:, None, :] >> np.arange(32)[None, :, None]) & 1  # [word, bit, B]
        unpacked = unpacked.reshape(-1, o_all.shape[0])
        np.testing.assert_array_equal(unpacked[:n_run], s_rows[:n_run].numpy())
        assert not unpacked[n_run:].any()  # padding bits are 0


@pytest.mark.parametrize("case", EDGE_CASES)
def test_entering_index_follows_from_o(case):
    # K1 reads no index stream: o0 + the shifts so far + 127, clamped to
    # B's width, is the plain loop's entering index of every row
    args, n_rows, _ = myers_edge_cases()[case]
    s_rows, ent_rows, o_all, _ = _streams(args, n_rows)
    LB = args[2].shape[1]
    o = o_all[:, :1] + torch.cumsum(s_rows.T.to(torch.int64), dim=1)
    np.testing.assert_array_equal((o + 127).numpy(), ent_rows.T.numpy())
    np.testing.assert_array_equal(torch.clamp(o + 127, 0, LB - 1).numpy(),
                                  torch.clamp(ent_rows.T, 0, LB - 1).numpy())


def test_row_stride_padding_and_alignment():
    a = torch.arange(3 * 150, dtype=torch.int32).to(torch.uint8).reshape(3, 150)
    p = K1._row_aligned("a", a)
    assert tuple(p.shape) == (3, 160) and p.data_ptr() % K1.WINDOW == 0
    np.testing.assert_array_equal(p[:, :150].numpy(), a.numpy())
    assert not p[:, 150:].any()
    assert K1._row_aligned("a", p) is p  # already a multiple of 16: no copy
    base = torch.zeros(3 * 160 + 1, dtype=torch.uint8)
    off = base[1:].view(3, 160)  # contiguous, one byte off the boundary
    with pytest.raises(ValueError, match="boundary"):
        K1._row_aligned("a", off)


def test_resolve_device_never_moves_quietly():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
        assert resolve_device(None) == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.cuda
def test_myers_kernel_matches_plain_on_card(cuda_device):
    args = myers_cases(7, 300, 512, er=0.12, drift=True)
    t = [torch.from_numpy(x).to(cuda_device) for x in args]
    launches = K1.LAUNCHES
    got = TM.banded_extend_myers(*t, 128, 512, partial_cap_q=2400)
    assert K1.LAUNCHES == launches + 1
    ref = TM.banded_extend_myers_plain(*t, 128, 512, partial_cap_q=2400)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_myers_kernel_edge_cases_on_card(cuda_device, case):
    args, n_rows, kw = myers_edge_cases()[case]
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in args]
    ref = TM.banded_extend_myers_plain(*t, 128, n_rows, **kw)
    launches = K1.LAUNCHES
    got = TM.banded_extend_myers(*t, 128, n_rows, **kw)
    torch.cuda.synchronize()
    assert K1.LAUNCHES == launches + 1
    assert len(got) == len(ref)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
def test_myers_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    B, n_run = 4, 64
    planes = torch.zeros((TM.NC, B), dtype=torch.int32, device=cuda_device)
    s_bits = torch.zeros((2, B), dtype=torch.int32, device=cuda_device)
    b = torch.zeros((B, 100), dtype=torch.uint8, device=cuda_device)
    lens = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    a = torch.zeros((B, 64), dtype=torch.uint8, device=cuda_device)
    launches = K1.LAUNCHES
    with pytest.raises(ValueError, match="columns"):
        K1.myers_rows_cuda(planes, a[:, :48].contiguous(), s_bits, b, lens, lens, n_run, 0)
    with pytest.raises(ValueError, match="shape"):
        K1.myers_rows_cuda(planes, a, s_bits[:1].contiguous(), b, lens, lens, n_run, 0)
    off = torch.zeros(B * 64 + 1, dtype=torch.uint8, device=cuda_device)[1:].view(B, 64)
    with pytest.raises(ValueError, match="boundary"):
        K1.myers_rows_cuda(planes, off, s_bits, b, lens, lens, n_run, 0)
    assert K1.LAUNCHES == launches
