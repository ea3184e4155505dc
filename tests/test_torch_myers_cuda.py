"""Kernels K1 (alone and with K11's end pick after its last row), K10
(the centres as rows and on the 16-row grid, one block or a cluster of
blocks an extension) and K11 against their plain PyTorch versions, their
inputs, and the wrappers' device contract.  This file imports no jax, so it runs where jax is
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
from torch_cases import (NAMES, k1_rows_plain, myers_cases, myers_edge_cases, myers_finish_cases,
                         myers_schedule_cases, myers_split_case)

EDGE_CASES = tuple(myers_edge_cases())
SCHEDULE_CASES = tuple(myers_schedule_cases())


def _k10_k11_counts():
    return K1.PROLOGUE_LAUNCHES, K1.EPILOGUE_LAUNCHES, TM.PLAIN_CUDA_SCHEDULES


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


@pytest.mark.parametrize("seg", [256, 320])
def test_segmented_plain_rows_equal_the_plain_loop(seg):
    """k1_rows_plain, from the plain loop's own carries at every seg-th
    row, gives the plain loop's carry at the next one and at the end (320:
    a last segment past n_run, where no lane is live); chip_smoke.py runs
    it from K1's carries to hold a long K1 launch to every plain row."""
    n_rows, band, cap_q = 1024, 128, 2400
    a, a_len, b, b_len, centers = (torch.from_numpy(x)
                                   for x in myers_cases(11, 5, n_rows, er=0.1, drift=True))
    o_all = TM._schedule(b_len, centers, band, n_rows)
    carry0 = TM._myers_init(b, b_len, a_len, o_all[:, 0].contiguous(), band)
    s_bits = TM._shift_bits(o_all, n_rows)
    s_rows, ent_rows, _o0 = TM._myers_prep(b_len, centers, band, n_rows)
    T = -(-n_rows // seg)
    ends = [TM._carry_pack(TM._rows_plain(carry0, a, b, s_rows, ent_rows, a_len, b_len, cap_q,
                                          band, seg, t)) for t in range(1, T)]
    ends.append(TM._carry_pack(TM._rows_plain(carry0, a, b, s_rows, ent_rows, a_len, b_len,
                                              cap_q, band, n_rows, 1)))
    got = k1_rows_plain([TM._carry_pack(carry0)] + ends[:-1], a, s_bits, b, a_len, b_len,
                        n_rows, cap_q, seg)
    for t in range(T):
        np.testing.assert_array_equal(got[:, t].numpy(), ends[t].numpy(), err_msg=str(t))
    fin = TM._myers_finish(TM._carry_unpack(got[:, -1]), a_len, b_len, band)
    ref = TM.banded_extend_myers_plain(a, a_len, b, b_len, centers, band, n_rows,
                                       partial_cap_q=cap_q)
    for name, r, g in zip(NAMES, ref, fin):
        np.testing.assert_array_equal(r.numpy(), g.numpy(), err_msg=name)


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
        # the default is the card too: without one it raises, naming it
        with pytest.raises(RuntimeError, match="device cuda requested but no CUDA device"):
            resolve_device(None)
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


def test_cpu_extension_launches_no_prologue_or_epilogue():
    args = [torch.from_numpy(x) for x in myers_cases(9, 5, 96, er=0.1, drift=True)]
    before = _k10_k11_counts()
    TM.banded_extend_myers(*args, 128, 96, partial_cap_q=2400)
    assert _k10_k11_counts() == before  # the plain chain on the CPU counts no CUDA call


def _k10_args(dev="cpu"):
    centers, b, a_len, b_len, n_rows, n_run = myers_schedule_cases()["narrow"]
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in (centers, b, a_len, b_len)]
    return {"centers": t[0], "b": t[1], "a_len": t[2], "b_len": t[3], "n_rows": n_rows,
            "n_run": n_run}


# what K10's and K11's wrappers refuse, whatever the device
PROLOGUE_REFUSALS = {
    "centers int64": ({"centers": lambda a: a["centers"].to(torch.int64)}, TypeError, "dtype"),
    "centers 1-D": ({"centers": lambda a: a["centers"][0]}, ValueError, "2-D"),
    "centers column-strided": ({"centers": lambda a: a["centers"].T.contiguous().T},
                               ValueError, "contiguous rows"),
    "b int32": ({"b": lambda a: a["b"].to(torch.int32)}, TypeError, "dtype"),
    "b fewer rows": ({"b": lambda a: a["b"][:3]}, ValueError, "shape"),
    "a_len int64": ({"a_len": lambda a: a["a_len"].to(torch.int64)}, TypeError, "dtype"),
    "b_len short": ({"b_len": lambda a: a["b_len"][:2]}, ValueError, "shape"),
    "n_run past n_rows": ({"n_run": lambda a: a["n_rows"] + 1}, ValueError, "n_run"),
    "center_stride 8": ({"center_stride": lambda a: 8}, ValueError, "center_stride"),
    "center_rows past the rows": ({"center_rows": lambda a: a["centers"].shape[1] + 1},
                                  ValueError, "centre columns"),
    "center_rows past the grid": ({"center_stride": lambda a: 16,
                                   "center_rows": lambda a: 16 * a["centers"].shape[1] + 1},
                                  ValueError, "centre columns"),
    "center_rows 0": ({"center_rows": lambda a: 0}, ValueError, "centre columns"),
    "split 0": ({"split": lambda a: 0}, ValueError, "split"),
    "split 9": ({"split": lambda a: K1.PROLOGUE_MAX_BLOCKS + 1}, ValueError, "split"),
    "host tensors": ({}, ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(PROLOGUE_REFUSALS))
def test_prologue_wrapper_refuses(case):
    change, exc, msg = PROLOGUE_REFUSALS[case]
    kw = _k10_args()
    kw.update({k: v(kw) for k, v in change.items()})
    before = (*_k10_k11_counts(), K1.LAUNCHES)
    with pytest.raises(exc, match=msg):
        K1.myers_prologue_cuda(**kw)
    assert (*_k10_k11_counts(), K1.LAUNCHES) == before


def test_rows_wrapper_with_the_pick_refuses_host_tensors():
    # the end pick inside K1 has no CPU route either: the plain chain's
    # _myers_finish is ops.myers._extend's, on CPU tensors
    args = [torch.from_numpy(x) for x in myers_cases(8, 6, 128, er=0.1)]
    planes = torch.zeros((TM.NC, 6), dtype=torch.int32)
    s_bits = torch.zeros((4, 6), dtype=torch.int32)
    before = (*_k10_k11_counts(), K1.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        K1.myers_rows_cuda(planes, args[0], s_bits, args[2], args[1], args[3], 128, 2400,
                           pick=True)
    assert (*_k10_k11_counts(), K1.LAUNCHES) == before


def test_prologue_blocks_split_only_few_extensions():
    sms = 132
    assert K1.prologue_blocks(16_384, 8_192, sms) == 1  # a verify group fills the card
    assert K1.prologue_blocks(3, 3_430_380, sms) == K1.PROLOGUE_MAX_BLOCKS  # the judge
    assert K1.prologue_blocks(3, 1_000, sms) == 1  # one 1,024-row step a block at least
    assert K1.prologue_blocks(3, 2_048, sms) == 2
    assert K1.prologue_blocks(200, 100_000, sms) == 2
    assert K1.prologue_blocks(264, 100_000, sms) == 1


@pytest.mark.parametrize("case", ["planes int64", "planes 42 rows", "a_len short", "host"])
def test_epilogue_wrapper_refuses(case):
    planes, a_len, b_len = (torch.from_numpy(x) for x in myers_finish_cases())
    exc, msg = ValueError, "shape"
    if case == "planes int64":
        planes, exc, msg = planes.to(torch.int64), TypeError, "dtype"
    elif case == "planes 42 rows":
        planes = planes[:42].contiguous()
    elif case == "a_len short":
        a_len = a_len[:3]
    else:
        msg = "CUDA"
    before = _k10_k11_counts()
    with pytest.raises(exc, match=msg):
        K1.myers_epilogue_cuda(planes, a_len, b_len)
    assert _k10_k11_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_prologue_matches_plain_on_card(cuda_device, case):
    kw = dict(zip(("centers", "b", "a_len", "b_len"),
                  (torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                   for x in myers_schedule_cases()[case][:4])))
    n_rows, n_run = myers_schedule_cases()[case][4:]
    before = _k10_k11_counts()
    planes, s_bits = K1.myers_prologue_cuda(**kw, n_rows=n_rows, n_run=n_run)
    torch.cuda.synchronize()
    assert K1.PROLOGUE_LAUNCHES == before[0] + 1
    o_all = TM._schedule(kw["b_len"], kw["centers"], 128, n_rows)
    np.testing.assert_array_equal(s_bits.cpu().numpy(), TM._shift_bits(o_all, n_run).cpu().numpy())
    ref = TM._carry_pack(TM._myers_init(kw["b"], kw["b_len"], kw["a_len"],
                                        o_all[:, 0].contiguous(), 128))
    np.testing.assert_array_equal(planes.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
def test_epilogue_matches_plain_on_card(cuda_device):
    planes, a_len, b_len = (torch.from_numpy(x).to(cuda_device) for x in myers_finish_cases())
    got = K1.myers_epilogue_cuda(planes, a_len, b_len)
    ref = TM._myers_finish(TM._carry_unpack(planes), a_len, b_len, 128)
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_extension_is_k10_k1_k11_on_card(cuda_device, case):
    # two launches: K10, then K1 with K11's end pick; no K11 launch of its own
    args, n_rows, kw = myers_edge_cases()[case]
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in args]
    ref = TM.banded_extend_myers_plain(*t, 128, n_rows, **kw)
    before = (*_k10_k11_counts(), K1.LAUNCHES)
    events: list = []
    got = TM.banded_extend_myers(*t, 128, n_rows, events=events, **kw)
    torch.cuda.synchronize()
    p, e, plain, k1 = before
    assert (*_k10_k11_counts(), K1.LAUNCHES) == (p + 1, e, plain, k1 + 1)
    assert len(events) == 1 and all(e0.elapsed_time(e1) >= 0 for e0, e1 in
                                    zip(events[0], events[0][1:]))
    for name, r, g in zip(NAMES, ref, got):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_extension_on_the_grid_on_card(cuda_device, case):
    # the centres handed over on their 16-row grid: K10 reads the grid, the
    # plain chain expands it; both equal the extension given those rows
    args, n_rows, kw = myers_edge_cases()[case]
    grid = torch.from_numpy(np.ascontiguousarray(args[4][:, ::16])).to(cuda_device)
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device) for x in args[:4]]
    rows = TM.expand_centers(grid, n_rows)
    ref = TM.banded_extend_myers_plain(*t, rows, 128, n_rows, **kw)
    plain = TM.banded_extend_myers_plain(*t, grid, 128, n_rows, center_stride=16, **kw)
    got = TM.banded_extend_myers(*t, grid, 128, n_rows, center_stride=16, **kw)
    for name, r, p_, g in zip(NAMES, ref, plain, got):
        np.testing.assert_array_equal(r.cpu().numpy(), p_.cpu().numpy(), err_msg=name)
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)


def _prologue_held(kw, n_rows, n_run, **opts):
    """K10 on kw's tensors with opts, against the plain chain on the
    centres as rows (expanded from the grid at stride 16)."""
    rows = kw["centers"]
    if opts.get("center_stride", 1) > 1:
        rows = TM.expand_centers(rows, opts["center_rows"] - 1)
    before = _k10_k11_counts()
    planes, s_bits = K1.myers_prologue_cuda(**kw, n_rows=n_rows, n_run=n_run, **opts)
    torch.cuda.synchronize()
    assert K1.PROLOGUE_LAUNCHES == before[0] + 1
    o_all = TM._schedule(kw["b_len"], rows, 128, n_rows)
    np.testing.assert_array_equal(s_bits.cpu().numpy(), TM._shift_bits(o_all, n_run).cpu().numpy())
    ref = TM._carry_pack(TM._myers_init(kw["b"], kw["b_len"], kw["a_len"],
                                        o_all[:, 0].contiguous(), 128))
    np.testing.assert_array_equal(planes.cpu().numpy(), ref.cpu().numpy())


def _schedule_kw(case, dev):
    return dict(zip(("centers", "b", "a_len", "b_len"),
                    (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in myers_schedule_cases()[case][:4])))


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_prologue_on_the_grid_matches_plain_on_card(cuda_device, case):
    kw = _schedule_kw(case, cuda_device)
    n_rows, n_run = myers_schedule_cases()[case][4:]
    c = kw["centers"]
    if c.shape[1] < n_rows + 1:  # the last centre repeats up to row n_rows
        c = torch.cat([c, c[:, -1:].expand(-1, n_rows + 1 - c.shape[1])], dim=1)
    kw["centers"] = c[:, : n_rows + 1 : 16].contiguous()
    for C in (n_rows + 1, 16 * kw["centers"].shape[1]):  # rows past C - 1 take its centre
        _prologue_held(kw, n_rows, n_run, center_stride=16, center_rows=C)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [2, 8])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_prologue_split_matches_plain_on_card(cuda_device, case, split):
    # an extension's rows over a cluster of blocks, even where some blocks
    # get no rows (few rows, many blocks)
    kw = _schedule_kw(case, cuda_device)
    n_rows, n_run = myers_schedule_cases()[case][4:]
    _prologue_held(kw, n_rows, n_run, split=split)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 16])
@pytest.mark.parametrize("split", [None, 1, 4, 8])
def test_prologue_long_split_case_on_card(cuda_device, split, stride):
    centers, b, a_len, b_len, n_rows, n_run = myers_split_case()
    if stride == 16:
        centers = centers[:, ::16]
    kw = dict(zip(("centers", "b", "a_len", "b_len"),
                  (torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                   for x in (centers, b, a_len, b_len))))
    opts = {"split": split}
    if stride == 16:
        opts.update(center_stride=16, center_rows=n_rows + 1)
    _prologue_held(kw, n_rows, n_run, **opts)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_rows_kernel_with_the_pick_matches_plain_on_card(cuda_device, case):
    # K1 with the pick equals K1's planes through K11 and through the plain
    # _myers_finish
    args, n_rows, kw = myers_edge_cases()[case]
    a, a_len, b, b_len, centers = (torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
                                   for x in args)
    n_run = -(-n_rows // 32) * 32
    a = torch.nn.functional.pad(a, (0, max(0, n_run - a.shape[1])))
    planes, s_bits = K1.myers_prologue_cuda(centers, b, a_len, b_len, n_run, n_run)
    before = (*_k10_k11_counts(), K1.LAUNCHES)
    fin = K1.myers_rows_cuda(planes, a, s_bits, b, a_len, b_len, n_run, 2400)
    got = K1.myers_rows_cuda(planes, a, s_bits, b, a_len, b_len, n_run, 2400, pick=True)
    torch.cuda.synchronize()
    assert (*_k10_k11_counts(), K1.LAUNCHES) == (*before[:3], before[3] + 2)
    ref = TM._myers_finish(TM._carry_unpack(fin), a_len, b_len, 128)
    alone = K1.myers_epilogue_cuda(fin, a_len, b_len)
    for name, r, g, e in zip(NAMES, ref, got, alone):
        np.testing.assert_array_equal(r.cpu().numpy(), g.cpu().numpy(), err_msg=name)
        np.testing.assert_array_equal(r.cpu().numpy(), e.cpu().numpy(), err_msg=name)


def test_card_staging_counts_k10_bytes_not_the_plain_schedule():
    # the verify window on the card holds the centres' grid and K10's
    # shift words and row-0 planes in place of the centre rows and the
    # plain chain's temporaries; the INF-walled engine neither
    from canu_tpu_torch.ops import align as AL

    chunk, n_rows = 512, 8192
    plain = AL._chunk_staging_bytes(chunk, n_rows, 128)
    card = AL._chunk_staging_bytes(chunk, n_rows, 128, on_card=True)
    rows = 4 * (n_rows + 1) + AL.SCHEDULE_BYTES_PER_ROW * (n_rows + 1)
    grid = 4 * (n_rows // 16 + 1) + 4 * (n_rows // 32 + 1) + 4 * TM.NC
    assert plain - card == 2 * chunk * (rows - grid)
    assert (AL._chunk_staging_bytes(chunk, n_rows, 256, on_card=True)
            == AL._chunk_staging_bytes(chunk, n_rows, 256))
