"""canu_tpu_torch.ops.trace against canu_tpu.ops.trace on the CPU: the
vote engine's banded fwd+bwd DP (align_positions_lean) gives the same
per-row evidence positions j* and the same edit counts.  Exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canu_tpu.ops.trace as JT
import canu_tpu_torch.ops.trace as TT
from torch_cases import one_torch_thread, trace_cases  # noqa: F401  (autouse fixture)


@pytest.mark.parametrize("band,ends_free,n_rows", [
    pytest.param(128, False, 256, id="128-False"),
    pytest.param(128, True, 256, id="128-True"),
    pytest.param(256, True, 256, id="256-True"),
    pytest.param(200, False, 256, id="200-False"),  # a band not a multiple of 32
    pytest.param(256, True, 512, id="256-True-512rows"),
])
def test_align_positions_lean_equal(band, ends_free, n_rows):
    ta, tl, ea, el = trace_cases(n_rows + band + int(ends_free), n_rows, band)
    js_j, ed_j = JT.align_positions_lean(jnp.asarray(ta), jnp.asarray(tl), jnp.asarray(ea),
                                         jnp.asarray(el), band, n_rows, ends_free=ends_free)
    js_t, ed_t = TT.align_positions_lean(torch.from_numpy(ta), torch.from_numpy(tl),
                                         torch.from_numpy(ea), torch.from_numpy(el), band,
                                         n_rows, ends_free=ends_free)
    assert js_t.dtype == torch.int32 and ed_t.dtype == torch.int32
    np.testing.assert_array_equal(js_t.numpy(), np.asarray(js_j))
    np.testing.assert_array_equal(ed_t.numpy(), np.asarray(ed_j))
    # the pad row stays at 0 and the live rows are monotone
    assert (js_t[5] == 0).all()
    assert (np.diff(js_t.numpy(), axis=1) >= 0).all()


def test_band_starts_equal():
    rng = np.random.default_rng(4)
    centers = np.sort(rng.integers(-50, 700, (5, 65)), axis=1).astype(np.int32)
    centers[2] = rng.integers(0, 700, 65)  # not monotone
    b_len = np.array([600, 0, 700, 30, -3], np.int32)
    for band in (128, 256):
        ref = JT._band_starts(jnp.asarray(centers), jnp.asarray(b_len), band)
        got = TT._band_starts(torch.from_numpy(centers), torch.from_numpy(b_len), band)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (TT.SMAX, TT.SROW, TT.INF16) == (JT.SMAX, JT.SROW, JT.INF16)
