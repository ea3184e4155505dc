"""Kernels K2 and K3 against the plain INF-walled loop, and the wrappers'
device contract.  This file imports no jax, so it runs where jax is
absent:

    python -m pytest --noconftest tests/test_torch_extend_cuda.py

(``--noconftest``: tests/conftest.py imports jax).  The ``cuda``-marked
test needs a card and skips elsewhere; the others run anywhere.  The cases
come from torch_cases.py, as in test_torch_extend.py and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.ops import align as TA
from canu_tpu_torch.ops.kernels import extend_cuda as EX
from torch_cases import edge_cases, one_torch_thread  # noqa: F401

NAMES = ("edits", "a_used", "b_used")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernels K2 and K3 are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def test_cpu_tensors_take_the_plain_loop_and_never_a_kernel():
    args, n_rows = edge_cases(256)
    t = [torch.from_numpy(x) for x in args]
    counts = (EX.WARP_LAUNCHES, EX.BLOCK_LAUNCHES, TA.PLAIN_CUDA_ROWS)
    got = TA.banded_extend(*t, 256, n_rows)
    ref = TA.banded_extend_plain(*t, 256, n_rows)
    assert (EX.WARP_LAUNCHES, EX.BLOCK_LAUNCHES, TA.PLAIN_CUDA_ROWS) == counts
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.numpy(), g.numpy(), err_msg=name)
    # the two failure cases do fail, with edits at or above INF
    assert (ref[0].numpy()[-12:-10] >= TA.INF).all()
    # the kernels' wrappers refuse host tensors and bands they do not hold
    for fn, band in ((EX.banded_extend_warp, 256), (EX.banded_extend_block, 1024)):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*t, band, n_rows)
        with pytest.raises(ValueError, match="band"):
            fn(*t, 200, n_rows)
    with pytest.raises(ValueError, match="band"):
        EX.banded_extend_warp(*t, 640, n_rows)
    with pytest.raises(ValueError, match="band"):
        EX.banded_extend_block(*t, 512, n_rows)
    with pytest.raises(ValueError, match="band"):
        EX.banded_extend_block(*t, 1152, n_rows)
    with pytest.raises(ValueError, match="centers"):
        TA.banded_extend_plain(*t, 256, n_rows + 1)
    assert (EX.WARP_LAUNCHES, EX.BLOCK_LAUNCHES) == counts[:2]


@pytest.mark.cuda
@pytest.mark.parametrize("band", [128, 256, 512, 640, 768, 1024])
def test_extend_kernels_match_plain_on_card(cuda_device, band):
    args, n_rows = edge_cases(band)
    t = [torch.from_numpy(x).to(cuda_device) for x in args]
    # B as the cases give it (rows of any width: the kernel reads bytes)
    # and widened to a multiple of 16 bytes (the path's shape: words)
    wide = t[:2] + [torch.nn.functional.pad(t[2], (0, -t[2].shape[1] % 16 + 16))] + t[3:]
    for inputs in (t, wide):
        ref = TA.banded_extend_plain(*inputs, band, n_rows)
        warp, block = EX.WARP_LAUNCHES, EX.BLOCK_LAUNCHES
        got = TA.banded_extend(*inputs, band, n_rows)  # K2, or K3 above band 512
        k2 = band in EX.WARP_BANDS
        assert (EX.WARP_LAUNCHES, EX.BLOCK_LAUNCHES) == (warp + k2, block + (not k2))
        for name, r, g in zip(NAMES, ref, got):
            np.testing.assert_array_equal(g.cpu().numpy(), r.cpu().numpy(), err_msg=name)
