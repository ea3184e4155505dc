"""Port parity for the syncmer read index: canu_tpu_torch.ops.minimizers
against canu_tpu's, and convert.read_index_from_numpy round-tripping
canu_tpu's index, exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import minimizers as JMZ
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.convert import read_index_from_numpy
from canu_tpu_torch.ops import hashing as TH
from canu_tpu_torch.ops import minimizers as TMZ
from canu_tpu_torch.sim import simulate as torch_sim
from torch_cases import (LONG_READ_W, SYNCMER_EDGE_CASES, bucket_reads,  # noqa: F401
                         one_torch_thread, syncmer_cut_case, syncmer_edge_case, umax_key_kmer,
                         verify_pre_long_case)

PLANES = ("words", "length", "mker", "mpos", "mstr")


def _reads(seed):
    """(canu_tpu's read set, the port's), each from its own simulator with
    the same seeds."""
    sim = dict(coverage=6, mean_len=1100, min_len=300, max_len=1900, error_rate=0.1,
               seed=seed + 1)
    rs, _ = simulate_reads(random_genome(12_000, seed=seed, repeat_spec=[(300, 5)]), **sim)
    trs, _ = torch_sim.simulate_reads(
        torch_sim.random_genome(12_000, seed=seed, repeat_spec=[(300, 5)]), **sim)
    return rs, trs


def _as_np(idx, name):
    x = getattr(idx, name)
    if isinstance(x, torch.Tensor):
        return TH.u32_numpy(x) if name in ("words", "mker") else x.numpy()
    return np.asarray(x)


def test_syncmer_params_and_kernel():
    for k in (8, 12, 16, 20, 22, 23):
        assert TMZ.syncmer_params(k) == JMZ.syncmer_params(k)
    rs, trs = _reads(30)
    ids = np.arange(1, rs.n_reads + 1)
    words, lengths = rs.block_words(ids, 128)
    for x, y in zip(trs.block_words(ids, 128), (words, lengths)):
        np.testing.assert_array_equal(x, y)
    for pm in (128, 512):
        ref = JMZ._syncmer_kernel(jnp.asarray(words), jnp.asarray(lengths), 16, pm)
        got = TMZ._syncmer_kernel(TH.u32_tensor(words, "cpu"), torch.from_numpy(lengths),
                                  16, pm)
        np.testing.assert_array_equal(TH.u32_numpy(got[0]), np.asarray(ref[0]))
        for r, g in zip(ref[1:], got[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_read_index_planes_equal():
    rs, trs = _reads(31)
    ref = JMZ.build_read_index(rs, k=16, block_size=16)
    got = TMZ.build_read_index(trs, k=16, block_size=16, device="cpu")
    assert (got.n_reads, got.k, got.pm, got.n_rows) == (ref.n_reads, ref.k, ref.pm, ref.n_rows)
    for name in PLANES:
        np.testing.assert_array_equal(_as_np(got, name), _as_np(ref, name), err_msg=name)


def test_read_index_from_numpy_round_trip():
    rs, trs = _reads(32)
    ref = JMZ.get_read_index(rs, k=16)
    conv = read_index_from_numpy(*(np.asarray(getattr(ref, n)) for n in PLANES),
                                 ref.n_reads, ref.k, ref.pm, device="cpu")
    own = TMZ.get_read_index(trs, k=16, device="cpu")
    assert TMZ.get_read_index(trs, k=16, device="cpu") is own  # cached
    for name in PLANES:
        a = getattr(conv, name)
        assert a.dtype == getattr(own, name).dtype, name
        np.testing.assert_array_equal(_as_np(conv, name), _as_np(ref, name), err_msg=name)
        np.testing.assert_array_equal(a.numpy(), getattr(own, name).numpy(), err_msg=name)


@pytest.mark.parametrize("case", [*SYNCMER_EDGE_CASES, "long reads"], ids=str)
def test_syncmer_edge_cases_equal_canu_tpu(case):
    """The port's _syncmer_kernel (the plain version on the CPU) against
    canu_tpu's on torch_cases.py's edge blocks (the ones kernel K8 is held
    to on the card), and on the block of verify_pre_long_case's reads
    (W = LONG_READ_W; Pm 2,048 of ~27,000 selected a read: the cut at
    pm)."""
    if case == "long reads":
        pl = verify_pre_long_case()[0]
        case, words, lengths = (16, LONG_READ_W, pl["pm"]), pl["words"], pl["length"]
    else:
        words, lengths = syncmer_edge_case(*case)
    k, _W, pm = case
    ref = JMZ._syncmer_kernel(jnp.asarray(words), jnp.asarray(lengths), k, pm)
    got = TMZ._syncmer_kernel(TH.u32_tensor(words, "cpu"), torch.from_numpy(lengths), k, pm)
    np.testing.assert_array_equal(TH.u32_numpy(got[0]), np.asarray(ref[0]))
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if pm < 10:  # a small pm: n_sel above it on the longer reads
        assert (got[3].numpy() == pm).sum() >= 3
    if _W == LONG_READ_W:  # the four long reads select more than pm
        assert (got[3].numpy()[:4] == pm).all()


def test_syncmer_tie_rule_on_a_planted_umax_key():
    """A selected k-mer whose mix32 key is UINT32_MAX ties with every
    unselected position: its live slots take the first positions of key
    UINT32_MAX in position order, which are unselected ones."""
    planted = umax_key_kmer(22)
    assert planted is not None and umax_key_kmer(16) is None
    words, lengths = syncmer_edge_case(22, 64, 256)
    mker, mpos, _mstr, n_sel = TMZ._syncmer_kernel(TH.u32_tensor(words, "cpu"),
                                                   torch.from_numpy(lengths), 22, 256)
    row = len(lengths) - 2  # the read with three planted copies at 30, 70 and 140
    n = int(n_sel[row])
    keys = TH.u32_numpy(TH.mix32(mker[row, :n]))
    tail = int((keys == 0xFFFFFFFF).sum()) + int((mpos[row, :n] < 30).sum())
    assert n > 3 and tail >= 3
    assert list(mpos[row, n - 3:n].numpy()) == [0, 1, 2]



@pytest.mark.parametrize("k", [16, 22])
def test_syncmer_cut_at_pm_equals_canu_tpu(k):
    """The plain selection against canu_tpu's where reads select pm - 1, pm,
    pm + 1 and 2 pm keys, and where equal keys straddle the pm-th entry
    (tests/torch_cases.py syncmer_cut_case): the rows kernel K8 cuts by its
    radix select on the card."""
    words, lengths, pm = syncmer_cut_case(k)
    ref = JMZ._syncmer_kernel(jnp.asarray(words), jnp.asarray(lengths), k, pm)
    got = TMZ._syncmer_kernel(TH.u32_tensor(words, "cpu"), torch.from_numpy(lengths), k, pm)
    np.testing.assert_array_equal(TH.u32_numpy(got[0]), np.asarray(ref[0]))
    for r, g in zip(ref[1:], got[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    full = TMZ._syncmer_kernel(TH.u32_tensor(words, "cpu"), torch.from_numpy(lengths), k, 16 * 256)
    assert list(full[3].numpy()[1:]) == [pm - 1, pm, pm + 1, 2 * pm]
    assert list(got[3].numpy()) == [pm, pm - 1, pm, pm, pm]
    keys = TH.mix32(full[0][0]).numpy()
    assert keys[pm - 1] == keys[pm]  # the cut falls inside a run of one key


def _bucket_sets():
    codes = bucket_reads(torch_sim)
    names = [f"r{i}" for i in range(len(codes))]
    from canu_tpu.stores.readset import ReadSet
    from canu_tpu_torch.stores.readset import ReadSet as TorchReadSet

    return ReadSet.from_codes_list(codes, names), TorchReadSet.from_codes_list(codes, names)


def test_read_index_of_buckets_of_different_widths_equals_canu_tpu():
    """A read set whose length buckets pad to 4-1,024 words (block_size
    4): each read's rows at its bucket's width, as the one launch of
    kernel K8 gives them on the card."""
    rs, trs = _bucket_sets()
    from canu_tpu_torch.ops.kmer import bucket_widths

    assert len(set(bucket_widths(trs, 4)[1].tolist())) >= 5
    for k in (16, 22):
        ref = JMZ.build_read_index(rs, k=k, block_size=4)
        got = TMZ.build_read_index(trs, k=k, block_size=4, device="cpu")
        assert (got.n_reads, got.k, got.pm, got.n_rows) == (ref.n_reads, ref.k, ref.pm,
                                                            ref.n_rows)
        for name in PLANES:
            np.testing.assert_array_equal(_as_np(got, name), _as_np(ref, name), err_msg=name)


def test_bucket_widths_follow_length_bucketed_blocks():
    """ops.kmer.bucket_widths: the reads in length_bucketed_blocks' order,
    each with its block's width, for the port's and canu_tpu's bucketing."""
    from canu_tpu.ops.kmer import length_bucketed_blocks as jax_blocks
    from canu_tpu_torch.ops.kmer import bucket_widths, length_bucketed_blocks

    rs, trs = _bucket_sets()
    for bs in (1, 3, 4, 64):
        ids, wbs = bucket_widths(trs, bs)
        assert ids.dtype == wbs.dtype == np.int32 and len(ids) == trs.n_reads
        for blocks in (list(length_bucketed_blocks(trs, bs)), list(jax_blocks(rs, bs))):
            np.testing.assert_array_equal(ids, np.concatenate([b for b, _ in blocks]))
            np.testing.assert_array_equal(wbs, np.concatenate([np.full(len(b), w)
                                                               for b, w in blocks]))
    ids, wbs = bucket_widths(trs.sliced(np.zeros(trs.n_reads), np.zeros(trs.n_reads)), 4)
    assert len(ids) == len(wbs) == 0
