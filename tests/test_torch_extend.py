"""Port parity for the INF-walled extension engine: banded_extend_plain
against canu_tpu.ops.align.banded_extend and canu_tpu's two Pallas
extension kernels (interpret mode), and verify_overlaps at band 256
against canu_tpu's, fed the same ReadIndex; exact.  Also the early-exit
argument the kernels stop on (torch_cases.extend_exit_rows) and the
grouping of chunks into one extension call."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import align as JA
from canu_tpu.ops import minhash as JM
from canu_tpu.ops.minimizers import get_read_index as jax_index
from canu_tpu.ops.pallas.extend import banded_extend_pallas
from canu_tpu.ops.pallas.extend_x8 import banded_extend_pallas_x8
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu.stores.readset import ReadSet
from canu_tpu_torch.convert import read_index_from_numpy
from canu_tpu_torch.ops import align as TA
from canu_tpu_torch.stores.readset import ReadSet as TorchReadSet
from torch_cases import edge_cases, extend_exit_rows, one_torch_thread, x8_cases  # noqa: F401

TABLE_COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")
K = 22


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x) for x in xs]


# 128 and 256 run on K2 on the card, 1024 (utgOvlBandWidth=1024) on K3
@pytest.mark.parametrize("band", [128, 256, 1024])
def test_banded_extend_plain_matches_canu_tpu(band):
    args, n_rows = edge_cases(band)
    ref = _np(JA.banded_extend(*map(jnp.asarray, args), band, n_rows))
    got = _np(TA.banded_extend_plain(*map(torch.from_numpy, args), band, n_rows))
    for name, r, g in zip(("edits", "a_used", "b_used"), ref, got):
        np.testing.assert_array_equal(g, r, err_msg=name)
    # the Pallas kernels K2 and K3 on the cases of their own tests, which
    # stay inside their contract (o(0) = 0, 0 <= a_len <= n_rows)
    args, n_rows = x8_cases(band)
    j = list(map(jnp.asarray, args))
    got = _np(TA.banded_extend_plain(*map(torch.from_numpy, args), band, n_rows))
    for kernel in (banded_extend_pallas_x8, banded_extend_pallas):
        ref = _np(kernel(*j, band, n_rows, interpret=True))
        for name, r, g in zip(("edits", "a_used", "b_used"), ref, got):
            np.testing.assert_array_equal(g, r, err_msg=f"{kernel.__name__} {name}")


@pytest.fixture(scope="module")
def sim():
    g = random_genome(15_000, seed=50)
    rs, _ = simulate_reads(g, coverage=8, mean_len=1200, min_len=600, max_len=1600,
                           error_rate=0.03, seed=51)
    # plus one chimeric read (a read's first half, then its second half
    # reverse-complemented): its pair with that read has k-mer support in
    # both orientations, so the palindromic second pass runs
    codes = [rs.get_codes(i) for i in range(1, rs.n_reads + 1)]
    c = max(codes, key=len)
    h = len(c) // 2
    codes.append(np.concatenate([c[:h], (3 - c[h:])[::-1]]).astype(np.uint8))
    names = [f"r{i}" for i in range(len(codes))]
    rs = ReadSet.from_codes_list(codes, names)
    trs = TorchReadSet.from_codes_list(codes, names)  # the port's own read set
    sk = JM.build_sketches(rs, k=K, n_hashes=128, block_size=64)
    pairs = JM.find_candidates(sk, min_matches=2)
    ji = jax_index(rs, k=K)
    ti = read_index_from_numpy(
        *(np.asarray(getattr(ji, n)) for n in ("words", "length", "mker", "mpos", "mstr")),
        ji.n_reads, ji.k, ji.pm, device="cpu")
    return rs, trs, pairs, ji, ti


BAND256 = dict(k=K, band=256, max_erate=0.12, min_overlap=300, chunk=64, min_shared=3,
               partial=True, palindromic_min=3)


@pytest.fixture(scope="module")
def band256(sim):
    """The port's verify_overlaps at band 256 on the sim fixture, with every
    banded_extend call's arguments captured: (table, calls, profile)."""
    _rs, trs, pairs, _ji, ti = sim
    calls = []
    real = TA.banded_extend
    TA.banded_extend = lambda *a: calls.append(a) or real(*a)
    try:
        got = TA.verify_overlaps(trs, pairs, index=ti, device="cpu", **BAND256)
    finally:
        TA.banded_extend = real
    return got, calls, dict(TA.LAST_PROFILE)


def test_verify_overlaps_band256_partial_palindromic(sim, band256):
    rs, trs, pairs, ji, ti = sim
    kw = BAND256
    # canu_tpu picks its xla engine off the TPU, the port the INF-walled
    # engine (the plain loop on CPU tensors): the same function
    ref = JA.verify_overlaps(rs, pairs, index=ji, **kw)
    got, calls, prof = band256
    # the band alone picked the INF-walled engine, one call per group of
    # up to MYERS_GROUP chunks in each pass (the main and the palindromic)
    n1 = -(-len(pairs) // kw["chunk"])
    n2 = prof["n_chunks"] - n1
    G = TA.MYERS_GROUP
    assert len(calls) == -(-n1 // G) + -(-n2 // G) < prof["n_chunks"]
    assert sum(c[0].shape[0] for c in calls) == 2 * kw["chunk"] * prof["n_chunks"]
    assert len(got) > 0 and len(got) == len(ref)
    for c in TABLE_COLS:
        a, b = getattr(ref, c), getattr(got, c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(b, a, err_msg=c)
    # the second, minority-orientation pass ran
    assert n2 > 0
    assert prof["n_candidates"] == len(pairs)


def _exit_rows_hold(args, band, n_rows):
    """extend_exit_rows on one call: the row minimum never fell on a live
    row, the outputs at the exit row and at the end are
    banded_extend_plain's.  Returns (extensions with an exit row, live
    rows after it, live rows)."""
    exit_row, at_exit, final, fell = extend_exit_rows(*args, band, n_rows)
    ref = TA.banded_extend_plain(*args, band, n_rows)
    assert not fell.any()
    ex = exit_row >= 0
    for name, r, f, x in zip(("edits", "a_used", "b_used"), ref, final, at_exit):
        np.testing.assert_array_equal(f.numpy(), r.numpy(), err_msg=name)
        np.testing.assert_array_equal(x[ex].numpy(), r[ex].numpy(), err_msg=f"{name} at exit")
    live = torch.clamp(args[1].to(torch.int64), 0, n_rows)
    assert (exit_row[ex] >= 1).all() and (exit_row[ex] <= live[ex]).all()
    return int(ex.sum()), int((live - exit_row)[ex].sum()), int(live.sum())


@pytest.mark.parametrize("band", [128, 256, 1024])
def test_early_exit_outputs_are_fixed_on_edge_cases(band):
    args, n_rows = edge_cases(band)
    n_exit, after, live = _exit_rows_hold([torch.from_numpy(x) for x in args], band, n_rows)
    # some extensions stop early, and the rows they skip are real work
    assert n_exit > 0 and 0 < after < live


def test_early_exit_outputs_are_fixed_on_verify_extensions(band256):
    _got, calls, _prof = band256
    n_exit = after = 0
    for a, a_len, b, b_len, centers, band, n_rows in calls:
        pick = slice(None, None, 3)  # a third of each call keeps the lane short
        e, r, _live = _exit_rows_hold([a[pick], a_len[pick], b[pick], b_len[pick],
                                       centers[pick]], band, n_rows)
        n_exit, after = n_exit + e, after + r
    assert n_exit > 0 and after > 0


def test_tight_budget_shrinks_the_extend_group(sim, band256, monkeypatch):
    cpu = torch.device("cpu")
    chunk, n_rows = 64, 1024
    staging = TA._chunk_staging_bytes(chunk, n_rows, 256)
    # the INF-walled engine stages A, B, the centres and its outputs, and
    # no Myers band schedule
    assert 2 * chunk * 4 * n_rows < staging < TA._chunk_staging_bytes(chunk, n_rows, 128)
    monkeypatch.setattr(TA, "CPU_INFLIGHT_BYTES", 1000 * staging)
    assert TA._verify_window(chunk, n_rows, 256, cpu) == (TA.MYERS_GROUP, 128)
    monkeypatch.setattr(TA, "CPU_INFLIGHT_BYTES", 6 * staging)
    assert TA._verify_window(chunk, n_rows, 256, cpu) == (3, 6)
    monkeypatch.setattr(TA, "_INFLIGHT_BACKOFF", 0.5)  # the driver's OOM retry
    assert TA._verify_window(chunk, n_rows, 256, cpu) == (1, 3)

    # verify runs one extension per chunk at group 1, with the same result
    _rs, trs, pairs, _ji, ti = sim
    roomy, _calls, _prof = band256
    monkeypatch.setattr(TA, "CPU_INFLIGHT_BYTES", staging / 10)
    calls = []
    real = TA.banded_extend
    monkeypatch.setattr(TA, "banded_extend", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    tight = TA.verify_overlaps(trs, pairs, index=ti, device="cpu", **BAND256)
    assert calls == [2 * BAND256["chunk"]] * TA.LAST_PROFILE["n_chunks"]
    for c in TABLE_COLS:
        np.testing.assert_array_equal(getattr(tight, c), getattr(roomy, c), err_msg=c)
