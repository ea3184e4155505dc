"""Port parity: canu_tpu_torch's plain Myers extension against canu_tpu's
XLA path and its Pallas kernel in interpret mode, all six outputs exact.

Every output is an integer, so every comparison is exact.  The CUDA
kernel (K1) is compared with the plain version on the card by
chip_smoke.py and by test_torch_myers_cuda.py, which also holds the case
generator (it imports no jax, so it runs on a machine without it).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops.myers import banded_extend_myers as jax_myers
from canu_tpu_torch.ops import myers as TM
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_myers_cuda import NAMES, _cases, _mutate


def _run_both(args, n_rows, impl="xla", **kw):
    ref = jax_myers(*map(jnp.asarray, args), 128, n_rows, impl=impl, **kw)
    got = TM.banded_extend_myers(*map(torch.from_numpy, args), 128, n_rows, **kw)
    assert len(ref) == len(got)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy(), err_msg=name)
    return got


@pytest.mark.parametrize("drift", [False, True], ids=["straight", "drift"])
def test_myers_plain_matches_xla(drift):
    args = _cases(1 + drift, 12, 256, er=0.12, drift=drift)
    _run_both(args, 256, partial_cap_q=1500)


def test_myers_plain_zero_lengths_and_word_boundaries():
    # empty A, empty B, and b_len on each word boundary of the band
    lens = ([0, 5, 0, 100, 256, 1, 200, 180, 150, 120],
            [0, 0, 7, 100, 256, 1, 32, 64, 96, 128])
    args = _cases(3, 12, 256, er=0.05, lens=lens)
    _run_both(args, 256, partial_cap_q=1500)
    _run_both(args, 256)  # classic 3-tuple


def test_myers_plain_max_rows_truncation():
    args = _cases(4, 8, 1024, er=0.1)
    _run_both(args, 1024, max_rows=700, segment=256, partial_cap_q=2400)


def test_myers_plain_matches_pallas_interpret():
    # the shape of tests/test_myers_pallas.py: B=5, 128 rows
    rng = np.random.default_rng(5)
    B, LA, LB, n_rows = 5, 150, 160, 128
    A = np.zeros((B, n_rows), np.uint8)
    Bb = np.zeros((B, LB + 128), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    for i in range(B):
        base = rng.integers(0, 4, LA).astype(np.uint8)
        mb = _mutate(rng, base, 0.2)[:LB]
        a_len[i] = min(LA, n_rows)
        b_len[i] = len(mb)
        A[i, : a_len[i]] = base[: a_len[i]]
        Bb[i, : len(mb)] = mb
    a_len[B - 1] = 0
    b_len[B - 2] = 0
    centers = np.arange(n_rows + 1, dtype=np.int32)[None, :].repeat(B, 0)
    _run_both((A, a_len, Bb, b_len, centers), n_rows, impl="pallas_interpret",
              partial_cap_q=1500)


def test_band_schedule_and_helpers():
    from canu_tpu.ops import myers as JM

    rng = np.random.default_rng(6)
    centers = np.cumsum(rng.integers(0, 3, (6, 300)), axis=1).astype(np.int32)
    b_len = rng.integers(0, 500, 6).astype(np.int32)
    ref = np.asarray(JM._band_schedule(jnp.asarray(centers), jnp.asarray(b_len), 128))
    got = TM._band_schedule(torch.from_numpy(centers), torch.from_numpy(b_len), 128)
    np.testing.assert_array_equal(ref, got.numpy())
    w = rng.integers(0, 129, 50).astype(np.int32)
    for k in range(4):
        np.testing.assert_array_equal(
            np.asarray(JM._word_mask(jnp.asarray(w), k)).astype(np.int64),
            TM._word_mask(torch.from_numpy(w))[k].numpy())
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.int64)
    np.testing.assert_array_equal(
        TM._popcount(torch.from_numpy(x)).numpy(),
        [bin(int(v)).count("1") for v in x])
    bits = rng.random((7, 128)) < 0.5
    words = TM._pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(TM._unpack_bits(words).numpy(), bits.astype(np.int32))

