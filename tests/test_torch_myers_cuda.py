"""Kernel K1 against its plain PyTorch loop, and the wrapper's device
contract.  This file imports no jax, so it runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_myers_cuda.py

(``--noconftest``: tests/conftest.py imports jax).  The ``cuda``-marked
test needs a card and skips elsewhere; the others run anywhere.  The
case generator is shared with test_torch_myers.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.device import resolve_device
from canu_tpu_torch.ops import myers as TM
from canu_tpu_torch.ops.kernels import myers_cuda as K1

NAMES = ("edits", "a_used", "b_used", "p_edits", "p_a", "p_b")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K1 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _mutate(rng, seq, er):
    out = []
    for c in seq:
        r = rng.random()
        if r < er * 0.4:
            continue
        elif r < er * 0.7:
            out += [int(c), int(rng.integers(0, 4))]
        elif r < er:
            out.append(int((c + 1 + rng.integers(0, 3)) % 4))
        else:
            out.append(int(c))
    return np.array(out, np.uint8)


def _cases(seed, B, n_rows, er=0.1, drift=False, lens=None):
    """B extensions of random reads with ~er error, as numpy arrays."""
    rng = np.random.default_rng(seed)
    LB = n_rows + 128
    A = np.zeros((B, n_rows), np.uint8)
    Bb = np.zeros((B, LB), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    centers = np.zeros((B, n_rows + 1), np.int32)
    for i in range(B):
        la = int(rng.integers(n_rows // 2, n_rows + 1))
        base = rng.integers(0, 4, la).astype(np.uint8)
        mb = _mutate(rng, base, er)[:LB]
        A[i, :la] = base
        Bb[i, : len(mb)] = mb
        a_len[i] = la
        b_len[i] = len(mb)
        if drift:
            step = (rng.random(n_rows) < 0.6).astype(np.int32)
            centers[i] = np.concatenate([[0], np.cumsum(step)])
        else:
            centers[i] = np.arange(n_rows + 1)
    if lens is not None:
        a_len[: len(lens[0])] = lens[0]
        b_len[: len(lens[1])] = lens[1]
    return A, a_len, Bb, b_len, centers


def test_cpu_tensors_take_the_plain_loop_and_never_the_kernel():
    args = [torch.from_numpy(x) for x in _cases(8, 6, 128, er=0.1)]
    launches, plain_cuda = K1.LAUNCHES, TM.PLAIN_CUDA_SEGMENTS
    got = TM.banded_extend_myers(*args, 128, 128, partial_cap_q=2400)
    ref = TM.banded_extend_myers_plain(*args, 128, 128, partial_cap_q=2400)
    assert (K1.LAUNCHES, TM.PLAIN_CUDA_SEGMENTS) == (launches, plain_cuda)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.numpy(), g.numpy(), err_msg=name)
    # the kernel's wrapper itself refuses host tensors instead of falling back
    planes = torch.zeros((TM.NC, 6), dtype=torch.int32)
    rows = torch.zeros((128, 6), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        K1.myers_rows_cuda(planes, rows, rows, rows.to(torch.int32), args[2], args[1],
                           args[3], 2400)
    assert K1.LAUNCHES == launches


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
    args = _cases(7, 300, 512, er=0.12, drift=True)
    t = [torch.from_numpy(x).to(cuda_device) for x in args]
    launches = K1.LAUNCHES
    got = TM.banded_extend_myers(*t, 128, 512, partial_cap_q=2400)
    assert K1.LAUNCHES == launches + 1
    ref = TM.banded_extend_myers_plain(*t, 128, 512, partial_cap_q=2400)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)
