"""Port parity for two-lane (k > 16) k-mers: canu_tpu_torch.ops.kmer against
canu_tpu.ops.kmer on the same numpy inputs, exact, at k = 17, 22, 31 and
32; plus the k=22 sketches and syncmer index that consume the folded keys.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import kmer as JK
from canu_tpu.ops import minhash as JM
from canu_tpu.ops.minimizers import build_read_index as jax_build_index
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.ops import hashing as TH
from canu_tpu_torch.ops import kmer as TK
from canu_tpu_torch.ops import minhash as TM
from canu_tpu_torch.ops.minimizers import build_read_index as torch_build_index
from canu_tpu_torch.sim import simulate as torch_sim
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

CPU = torch.device("cpu")
KS = [17, 22, 31, 32]


def _t(a):
    return TH.u32_tensor(a, CPU)


def _u32(t):
    return TH.u32_numpy(t)


@pytest.fixture(scope="module")
def reads():
    # each package's own read set, from its own simulator with the same seeds
    sim = dict(coverage=6, mean_len=900, min_len=400, max_len=1500, error_rate=0.03, seed=32)
    rs, _ = simulate_reads(random_genome(12_000, seed=31, repeat_spec=[(300, 10)]), **sim)
    trs, _ = torch_sim.simulate_reads(
        torch_sim.random_genome(12_000, seed=31, repeat_spec=[(300, 10)]), **sim)
    return rs, trs


def _block(seed, B=12, W=8):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    lengths = rng.integers(0, W * 16 + 1, B).astype(np.int32)
    lengths[:4] = [0, 15, 31, W * 16]
    # all-A and all-T reads: canonical 0 and the largest k-mers
    words[4] = 0
    words[5] = 0xFFFFFFFF
    lengths[4:6] = W * 16
    return words, lengths


@pytest.mark.parametrize("k", KS)
def test_two_lane_kmers(reads, k):
    words, lengths = _block(k)
    jw, jl, tw, tl = jnp.asarray(words), jnp.asarray(lengths), _t(words), torch.from_numpy(lengths)

    # extraction: both lanes, strand and validity
    ref = JK.extract_kmers2(jw, jl, k)
    got = TK.extract_kmers2(tw, tl, k)
    for name, r, g in zip(("hi", "lo"), ref[:2], got[:2]):
        np.testing.assert_array_equal(_u32(g), np.asarray(r), err_msg=name)
    for name, r, g in zip(("strand", "valid"), ref[2:], got[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    np.testing.assert_array_equal(_u32(TK.fold2(got[0], got[1])),
                                  np.asarray(JK.fold2(ref[0], ref[1])))
    rk, rs_ = JK.extract_kmers_any(jw, jl, k)
    tk, ts = TK.extract_kmers_any(tw, tl, k)
    np.testing.assert_array_equal(_u32(tk), np.asarray(rk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs_))

    # sort_count2: lanes with the top bit set and INVALID pairs sort in
    # unsigned lexicographic order, INVALID last
    rng = np.random.default_rng(k)
    hi = rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                             np.uint32), 3000)
    lo = rng.choice(np.array([0, 5, 0x80000001, 0xFFFFFFFF], np.uint32), 3000)
    inv = rng.random(3000) < 0.2
    hi[inv] = lo[inv] = 0xFFFFFFFF
    rh, rl, rc = JK.sort_count2(jnp.asarray(hi), jnp.asarray(lo))
    th_, tl_, tc = TK.sort_count2(_t(hi), _t(lo))
    np.testing.assert_array_equal(_u32(th_), np.asarray(rh))
    np.testing.assert_array_equal(_u32(tl_), np.asarray(rl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    assert _u32(th_)[-1] == _u32(tl_)[-1] == 0xFFFFFFFF

    # whole-readset counts, histogram, thresholds and frequent tables
    jk = JK.count_readset_device(reads[0], k=k, block_size=32)
    tk2 = TK.count_readset_device(reads[1], k=k, block_size=32, device="cpu")
    assert isinstance(tk2, TK.DeviceKmerCounts2)
    # hist[0] counts padding positions, which the port does not pad
    np.testing.assert_array_equal(tk2.histogram(1000)[1:], jk.histogram(1000)[1:])
    assert (tk2.n_distinct(), tk2.n_total()) == (jk.n_distinct(), jk.n_total())
    jh, th = jk.to_host(), tk2.to_host()
    assert th.unique.dtype == jh.unique.dtype == np.uint64
    np.testing.assert_array_equal(th.unique, jh.unique)
    np.testing.assert_array_equal(th.counts, jh.counts)
    for kc_t, kc_j in ((tk2, jk), (th, jh)):
        assert (TK.threshold_from_distinct_fraction(kc_t, 0.999)
                == JK.threshold_from_distinct_fraction(kc_j, 0.999))
        assert TK.estimate_coverage_threshold(kc_t) == JK.estimate_coverage_threshold(kc_j)
        for thr in (None, 1, 5):
            a = TK.frequent_kmers(kc_t, threshold=thr, distinct_fraction=0.999)
            b = JK.frequent_kmers(kc_j, threshold=thr, distinct_fraction=0.999)
            assert a.n > 0 and (a.threshold, a.total_kmers) == (b.threshold, b.total_kmers)
            for f in ("kmers", "fraction", "kmers_exact"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
    with pytest.raises(ValueError):
        TK.extract_kmers2(tw, tl, 33)


def test_k22_sketches_and_read_index(reads):
    k = 22
    reads, treads = reads
    kc = JK.count_readset_device(reads, k=k, block_size=32)
    fk_j = JK.frequent_kmers(kc, threshold=5)
    fk_t = TK.frequent_kmers(TK.count_readset_device(treads, k=k, block_size=32, device="cpu"),
                             threshold=5)
    assert fk_t.n > 0
    np.testing.assert_array_equal(fk_t.kmers, fk_j.kmers)
    sk_j = np.asarray(JM.build_sketches(reads, k=k, n_hashes=64, frequent=fk_j, block_size=32))
    sk_t = TM.build_sketches(treads, k=k, n_hashes=64, frequent=fk_t, block_size=32, device="cpu")
    np.testing.assert_array_equal(sk_t, sk_j)
    ji = jax_build_index(reads, k=k, block_size=32)
    ti = torch_build_index(treads, k=k, block_size=32, device="cpu")
    assert (ti.k, ti.pm) == (ji.k, ji.pm)
    for name in ("words", "mker"):
        np.testing.assert_array_equal(_u32(getattr(ti, name)), np.asarray(getattr(ji, name)))
    for name in ("length", "mpos", "mstr"):
        np.testing.assert_array_equal(getattr(ti, name).numpy(), np.asarray(getattr(ji, name)))
