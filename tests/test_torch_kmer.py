"""Port parity for k-mers: canu_tpu_torch.ops.{hashing,kmer} against
canu_tpu's on the same numpy inputs, exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import hashing as JH
from canu_tpu.ops import kmer as JK
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.ops import hashing as TH
from canu_tpu_torch.ops import kmer as TK
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = torch.device("cpu")


def _t(a):
    return TH.u32_tensor(a, CPU)


def test_mix32_edges_and_random():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF], np.uint32),
        rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32),
    ])
    ref = np.asarray(JH.mix32(jnp.asarray(x)))
    np.testing.assert_array_equal(TH.u32_numpy(TH.mix32(_t(x))), ref)
    np.testing.assert_array_equal(TH.hash_seeds(100, 7), JH.hash_seeds(100, 7))


def _block(seed, B=12, W=8):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, W * 16 + 1, B).astype(np.int32)
    lengths[:3] = [0, 15, W * 16]
    return words, lengths


@pytest.mark.parametrize("k", [12, 16])
def test_extract_kmers(k):
    words, lengths = _block(k)
    rc, rs = JK.extract_kmers(jnp.asarray(words), jnp.asarray(lengths), k)
    tc, ts = TK.extract_kmers(_t(words), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(TH.u32_numpy(tc), np.asarray(rc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    rc2, rs2 = JK.extract_kmers_any(jnp.asarray(words), jnp.asarray(lengths), k)
    tc2, ts2 = TK.extract_kmers_any(_t(words), torch.from_numpy(lengths), k)
    np.testing.assert_array_equal(TH.u32_numpy(tc2), np.asarray(rc2))
    np.testing.assert_array_equal(ts2.numpy(), np.asarray(rs2))
    np.testing.assert_array_equal(
        TK.unpack_bases(_t(words)).numpy(), np.asarray(JK.unpack_bases(jnp.asarray(words))))
    with pytest.raises(ValueError):  # k > 16 is two-lane (test_torch_kmer22.py) up to 32
        TK.extract_kmers_any(_t(words), torch.from_numpy(lengths), 33)


def test_sort_count_sentinel_sorts_last():
    rng = np.random.default_rng(3)
    flat = rng.integers(0, 50, 4096).astype(np.uint32)
    flat[rng.random(4096) < 0.2] = 0xFFFFFFFF
    flat[:3] = [0x80000000, 0xFFFFFFFE, 0x7FFFFFFF]  # int32-view order traps
    rs_, rc_ = JK.sort_count(jnp.asarray(flat))
    ts_, tc_ = TK.sort_count(_t(flat))
    np.testing.assert_array_equal(TH.u32_numpy(ts_), np.asarray(rs_))
    np.testing.assert_array_equal(tc_.numpy(), np.asarray(rc_))
    assert TH.u32_numpy(ts_)[-1] == 0xFFFFFFFF
    np.testing.assert_array_equal(
        TK.histogram_device(tc_, 100).numpy(), np.asarray(JK.histogram_device(rc_, 100)))
    km, ct, nf = TK.select_frequent_device(ts_, tc_, 60, 16)
    jkm, jct, jnf = JK.select_frequent_device(rs_, rc_, jnp.int32(60), 16)
    assert nf == int(jnf)
    np.testing.assert_array_equal(TH.u32_numpy(km), np.asarray(jkm))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(jct))


def test_count_readset_histogram_and_frequent():
    g = random_genome(20_000, seed=5, repeat_spec=[(300, 10)])
    rs, _ = simulate_reads(g, coverage=8, mean_len=1200, min_len=600, max_len=2000,
                           error_rate=0.08, seed=6)
    jk = JK.count_readset_device(rs, k=16, block_size=64)
    tk = TK.count_readset_device(rs, k=16, block_size=64, device="cpu")
    # hist[0] counts padding positions, which the port does not pad
    np.testing.assert_array_equal(tk.histogram(1000)[1:], jk.histogram(1000)[1:])
    assert tk.n_distinct() == jk.n_distinct() and tk.n_total() == jk.n_total()
    jh, th = jk.to_host(), tk.to_host()
    np.testing.assert_array_equal(th.unique, jh.unique)
    np.testing.assert_array_equal(th.counts, jh.counts)
    for kc_t, kc_j in ((tk, jk), (th, jh)):
        assert (TK.threshold_from_distinct_fraction(kc_t, 0.999)
                == JK.threshold_from_distinct_fraction(kc_j, 0.999))
        assert TK.estimate_coverage_threshold(kc_t) == JK.estimate_coverage_threshold(kc_j)
        for thr in (None, 3, 9):
            a = TK.frequent_kmers(kc_t, threshold=thr, distinct_fraction=0.999)
            b = JK.frequent_kmers(kc_j, threshold=thr, distinct_fraction=0.999)
            assert a.n > 0 and (a.threshold, a.total_kmers) == (b.threshold, b.total_kmers)
            np.testing.assert_array_equal(a.kmers, b.kmers)
            assert a.kmers.dtype == b.kmers.dtype
            np.testing.assert_array_equal(a.fraction, b.fraction)
    with pytest.raises(NotImplementedError):
        TK.count_readset_device(rs, k=16, max_instances=10, device="cpu")
    blocks_t = list(TK.length_bucketed_blocks(rs, 17))
    blocks_j = list(JK.length_bucketed_blocks(rs, 17))
    assert [w for _, w in blocks_t] == [w for _, w in blocks_j]
    for (a, _), (b, _) in zip(blocks_t, blocks_j):
        np.testing.assert_array_equal(a, b)
