"""Port parity of the Myers extension's chain around the row loop: the
band schedule and its shift bits, the row-0 state and its planes, the
end pick (the plain versions that kernels K10 and K11 are held to on the
card) against canu_tpu's jitted programs on the same numpy inputs, exact.

    _schedule + _shift_bits       against _myers_prep's shift stream
    _myers_init + _carry_pack     against _myers_init + _carry_pack
    _carry_unpack + _myers_finish against _carry_unpack + _myers_finish

The cases are tests/torch_cases.py myers_schedule_cases (centres narrower
and wider than the rows, a rise after n_run, lengths 0 and negative, o0
at the end of B, int32 limits, one row, 40,000 rows), myers_split_case (3
extensions x 200,003 rows) and myers_finish_cases (ties, INF costs,
columns cut off at b_len).

Kernel K10 splits an extension's rows into segments and reads the centres
on their 16-row grid; ``split_bits`` below is a plain numpy model of that
split, held bit for bit to _myers_prep's shift stream at segment sizes
32, 96, 128 and 4,096, with the centres as rows and on the grid.  The
grid itself is held to canu_tpu's interpolated rows, and the plain chain
given the grid to the plain chain given its rows."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import align as JA
from canu_tpu.ops import myers as JM
from canu_tpu_torch.ops import align as TA
from canu_tpu_torch.ops import myers as TM
from torch_cases import (NAMES, myers_cases, myers_finish_cases, myers_schedule_cases,  # noqa: F401
                         myers_split_case, one_torch_thread)

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


# ---- the segment split of kernel K10 -----------------------------------------

IMAX, IMIN = np.iinfo(np.int32).max, np.iinfo(np.int32).min
SEGMENTS = (32, 96, 128, 4096)


def _excl(acc, x, init):
    """Exclusive running acc (np.maximum / np.minimum) of x with init first."""
    return acc.accumulate(np.concatenate([[init], x[:-1]]))


def _units(centers, b_len, stride, n_rows):
    """Each extension's clipped targets a unit of `stride` rows: unit u holds
    rows stride u .. stride u + stride - 1 and the centre column min(u,
    uLast) (stride 16: the grid; rows past the last take its centre)."""
    c = centers.astype(np.int64)
    wrapped = ((c - 64 + 2**31) % 2**32) - 2**31  # centre - 64 as int32 wraps
    bcl = np.maximum(b_len.astype(np.int64), 0)[:, None]
    t = np.minimum(np.maximum(wrapped, 0), bcl)
    nu = n_rows // stride + 1
    idx = np.minimum(np.arange(nu), centers.shape[1] - 1)
    return t[:, idx]


def split_bits(v, stride, n_rows, n_run, seg, back_carry=True):
    """The shifts of rows 1..n_run and o(0) of one extension whose unit
    targets are v (int64[n_rows // stride + 1]), its rows cut into segments
    of `seg` rows (a multiple of stride), each segment given only its
    carries: the running max R entering it (a prefix max of the segments'
    own maxima lt), the min M of t - i before it (a prefix min of the
    segments' minima under their R), and the max of t - i after it, a
    suffix max of max(R - s0, h), h the segment's max of lt(j) - j over its
    own running max lt(j), which needs no second pass.  Inside a segment a
    unit's rows share t = T, and o(i) = d + i with d = min((min(M_u, T - i)
    + max(H_u, T - i)) >> 1, t(0)), the kernel's row.  back_carry=False
    drops what later segments send back (the model must then fail)."""
    N, U = n_rows, seg // stride
    nu = len(v)
    ns = -(-nu // U)
    vv = np.zeros(ns * U, np.int64)
    vv[:nu] = v
    vv = vv.reshape(ns, U)
    r0 = (np.arange(ns * U, dtype=np.int64) * stride).reshape(ns, U)
    real = r0 <= N
    rl = np.minimum(r0 + stride - 1, N)
    # pass A: each segment's own running max, its maximum and h
    lt_run = np.maximum.accumulate(np.where(real, vv, 0), axis=1)
    h = np.where(real, lt_run - r0, IMIN).max(axis=1)
    R = _excl(np.maximum, lt_run[:, -1], 0)
    # pass B: t under R, each segment's min of t - i; the carries
    T = np.maximum(R[:, None], lt_run)
    low = np.where(real, T - rl, IMAX)
    M = _excl(np.minimum, low.min(axis=1), IMAX)
    Hseg = np.where(real[:, 0], np.maximum(R - r0[:, 0], h), IMIN)
    after = _excl(np.maximum, Hseg[::-1], IMIN)[::-1]
    if not back_carry:
        after = np.full_like(after, IMIN)
    # pass C: the units' min before and max after, then the rows
    mb = np.minimum(np.minimum.accumulate(np.concatenate(
        [np.full((ns, 1), IMAX), low[:, :-1]], axis=1), axis=1), M[:, None])
    high = np.where(real, T - r0, IMIN)
    ha = np.maximum.accumulate(np.concatenate(
        [high[:, 1:], np.full((ns, 1), IMIN)], axis=1)[:, ::-1], axis=1)[:, ::-1]
    ha = np.maximum(ha, after[:, None])
    i = r0[..., None] + np.arange(stride)
    x = T[..., None] - i
    a = np.minimum(mb[..., None], x) + np.maximum(ha[..., None], x)
    o = (np.minimum(a >> 1, v[0]) + i).reshape(-1)[: N + 1]
    return (o[1 : n_run + 1] != o[:n_run]).astype(np.int64), int(o[0])


def _prep_reference(centers, b_len, n_rows, n_run):
    s_seg, _ent, o0 = JM._myers_prep(jnp.asarray(b_len), jnp.asarray(centers), 128, 1, n_rows)
    return np.asarray(s_seg)[0][:n_run].astype(np.int64), np.asarray(o0)


def _grid_of(centers, n_rows):
    """The case's centres padded to rows 0..n_rows, every 16th: a grid."""
    pad = n_rows + 1 - centers.shape[1]
    if pad > 0:
        centers = np.concatenate([centers, np.repeat(centers[:, -1:], pad, axis=1)], axis=1)
    return np.ascontiguousarray(centers[:, : n_rows + 1 : 16])


def _hold_split(centers, b_len, n_rows, n_run, stride, segs):
    ref_rows = centers
    if stride == 16:
        ref_rows = TM.expand_centers(torch.from_numpy(centers), n_rows).numpy()
    ref, o0 = _prep_reference(ref_rows, b_len, n_rows, n_run)
    v = _units(centers, b_len, stride, n_rows)
    for seg in segs:
        for x in range(len(b_len)):
            bits, o = split_bits(v[x], stride, n_rows, n_run, seg)
            np.testing.assert_array_equal(bits, ref[:, x], err_msg=f"seg {seg}, extension {x}")
            assert o == o0[x]


@pytest.mark.parametrize("stride", [1, 16], ids=["rows", "grid"])
@pytest.mark.parametrize("case", sorted(SCHEDULE_CASES))
def test_segment_split_model_equals_myers_prep(case, stride):
    centers, _b, _a_len, b_len, n_rows, n_run = SCHEDULE_CASES[case]
    if stride == 16:
        centers = _grid_of(centers, n_rows)
    _hold_split(centers, b_len, n_rows, n_run, stride, SEGMENTS)


def test_segment_split_model_on_a_long_split_case():
    """3 extensions x 200,003 rows: hundreds of segments at every size,
    on the rows and on the grid."""
    centers, _b, _a_len, b_len, n_rows, n_run = myers_split_case()
    _hold_split(centers, b_len, n_rows, n_run, 1, SEGMENTS)
    _hold_split(_grid_of(centers, n_rows), b_len, n_rows, n_run, 16, SEGMENTS)


def test_split_model_catches_a_lost_carry():
    """The model is not vacuous: dropping the carry that a later segment
    sends back changes the shifts of the rise-after-n_run case."""
    centers, _b, _a_len, b_len, n_rows, n_run = SCHEDULE_CASES["rise_after_run"]
    ref, _o0 = _prep_reference(centers, b_len, n_rows, n_run)
    v = _units(centers, b_len, 1, n_rows)
    assert any((split_bits(v[x], 1, n_rows, n_run, 128, back_carry=False)[0] != ref[:, x]).any()
               for x in range(len(b_len)))


@pytest.mark.parametrize("n_rows", [700, 333, 1024, 16])
def test_interp_grid_expands_to_canu_tpu_rows(n_rows):
    rng = np.random.default_rng(n_rows)
    B, M = 24, 64
    xa = np.sort(rng.integers(0, 2 * n_rows, (B, M)), axis=1).astype(np.int32)
    xb = np.maximum.accumulate(xa + rng.integers(-200, 200, (B, M)), axis=1).astype(np.int32)
    xa[:, 0] = xb[:, 0] = 0
    xa[:, 40:] = xb[:, 40:] = (1 << 24) + np.arange(M - 40)  # the slope-1 padding
    grid = TA._interp_grid(torch.from_numpy(xa), torch.from_numpy(xb), n_rows)
    assert tuple(grid.shape) == (B, n_rows // 16 + 1) and grid.dtype == torch.int32
    ref = np.asarray(JA._interp_centers(jnp.asarray(xa), jnp.asarray(xb), None, n_rows))
    np.testing.assert_array_equal(TM.expand_centers(grid, n_rows).numpy(), ref)
    np.testing.assert_array_equal(
        TA._interp_centers(torch.from_numpy(xa), torch.from_numpy(xb), n_rows).numpy(), ref)
    with pytest.raises(ValueError, match="grid"):
        TM.expand_centers(grid[:, :-1], n_rows)


@pytest.mark.parametrize("n_rows,kw", [(288, {"partial_cap_q": 2400}),
                                       (300, {"segment": 128, "max_rows": 260})],
                         ids=["partial", "segments"])
def test_plain_chain_takes_the_grid_as_its_rows(n_rows, kw):
    a, a_len, b, b_len, centers = myers_cases(31, 12, n_rows, er=0.12, drift=True)
    grid = np.ascontiguousarray(centers[:, ::16])
    rows = TM.expand_centers(torch.from_numpy(grid), n_rows)
    t = _tensors(a, a_len, b, b_len)
    got = TM.banded_extend_myers(*t, torch.from_numpy(grid), 128, n_rows, center_stride=16, **kw)
    ref = TM.banded_extend_myers(*t, rows, 128, n_rows, **kw)  # held to canu_tpu elsewhere
    assert len(got) == len(ref)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(g.numpy(), r.numpy(), err_msg=name)
