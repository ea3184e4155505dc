"""Port parity of the Myers extension's chain around the row loop: the
band schedule and its shift bits, the row-0 state and its planes, the
end pick (the plain versions that kernels K10 and K11 are held to on the
card) against canu_tpu's jitted programs on the same numpy inputs, exact.

    _schedule + _shift_bits       against _myers_prep's shift stream
    _myers_init + _carry_pack     against _myers_init + _carry_pack
    _carry_unpack + _myers_finish against _carry_unpack + _myers_finish

The cases are tests/torch_cases.py myers_schedule_cases (centres narrower
and wider than the rows, a rise after n_run, lengths 0 and negative, o0
at the end of B, int32 limits, one row, 40,000 rows) and
myers_finish_cases (ties, INF costs, columns cut off at b_len)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import myers as JM
from canu_tpu_torch.ops import myers as TM
from torch_cases import NAMES, myers_finish_cases, myers_schedule_cases, one_torch_thread  # noqa: F401

SCHEDULE_CASES = myers_schedule_cases()
LANES = 128  # canu_tpu's carry planes are [NC, B / 128, 128]


def _tensors(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_shift_bits_equal_myers_prep(case):
    centers, b, a_len, b_len, n_rows, n_run = SCHEDULE_CASES[case]
    s_seg, _ent, o0 = JM._myers_prep(jnp.asarray(b_len), jnp.asarray(centers), 128, 1, n_rows)
    ref = np.asarray(s_seg)[0][:n_run].astype(np.int64)  # [n_run, B] shifts of rows 1..n_run
    c, bl = _tensors(centers, b_len)
    o_all = TM._schedule(bl, c, 128, n_rows)
    bits = TM._shift_bits(o_all, n_run).numpy().astype(np.int64) & 0xFFFFFFFF
    got = ((bits[:, None, :] >> np.arange(32)[None, :, None]) & 1).reshape(-1, bits.shape[1])
    np.testing.assert_array_equal(got[:n_run], ref)
    assert not got[n_run:].any()  # the last word's rows past n_run
    np.testing.assert_array_equal(o_all[:, 0].numpy(), np.asarray(o0))


def _to_lanes(*xs):
    """Rows repeated to a whole number of 128-lane planes."""
    B = xs[0].shape[0]
    reps = -(-B // LANES) * LANES
    idx = np.arange(reps) % B
    return [x[idx] for x in xs]


@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_row0_planes_equal_myers_init(case):
    centers, b, a_len, b_len, n_rows, _n_run = SCHEDULE_CASES[case]
    centers, b, a_len, b_len = _to_lanes(centers, b, a_len, b_len)
    c, tb, ta, tbl = _tensors(centers, b, a_len, b_len)
    o0 = TM._schedule(tbl, c, 128, n_rows)[:, 0].contiguous()
    got = TM._carry_pack(TM._myers_init(tb, tbl, ta, o0, 128)).numpy()
    ref = np.asarray(JM._carry_pack(JM._myers_init(
        jnp.asarray(b), jnp.asarray(b_len), jnp.asarray(a_len), jnp.asarray(o0.numpy()), 128)))
    np.testing.assert_array_equal(got.view(np.uint32), ref.reshape(TM.NC, -1))


def test_end_pick_equals_myers_finish():
    planes, a_len, b_len = myers_finish_cases()
    got = TM._myers_finish(TM._carry_unpack(torch.from_numpy(planes)), *_tensors(a_len, b_len),
                           128)
    arr = jnp.asarray(planes.view(np.uint32).reshape(TM.NC, -1, LANES))
    ref = JM._myers_finish(JM._carry_unpack(arr), jnp.asarray(a_len), jnp.asarray(b_len), 128)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    # the cases hold the pick's ties: equal costs go to the A-exhausted end
    carry = TM._carry_unpack(torch.from_numpy(planes))
    assert int((got[0] == carry.best_bx).sum()) > 32 and int((carry.best_bx == TM.INF).sum()) > 0
