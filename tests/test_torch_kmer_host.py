"""Port parity for the host k-mer counter: canu_tpu_torch.ops.kmer's
count_readset_host, the device counter's handover to it above
max_instances, and the OvlFrequentMers tables (frequent_from_fasta,
union_frequent) against canu_tpu.ops.kmer on the same reads, exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from canu_tpu.ops import kmer as JK
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu.stores.readset import ReadSet as JReadSet
from canu_tpu.utils.bitpack import codes_to_seq
from canu_tpu_torch.ops import kmer as TK
from canu_tpu_torch.sim import simulate as torch_sim
from canu_tpu_torch.stores.readset import ReadSet as TReadSet
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

SIM = dict(coverage=6, mean_len=900, min_len=400, max_len=1500, error_rate=0.03, seed=52)


@pytest.fixture(scope="module")
def reads():
    # each package's own read set, from its own simulator with the same seeds
    rs, _ = simulate_reads(random_genome(12_000, seed=51, repeat_spec=[(300, 10)]), **SIM)
    trs, _ = torch_sim.simulate_reads(
        torch_sim.random_genome(12_000, seed=51, repeat_spec=[(300, 10)]), **SIM)
    return rs, trs


def _same_counts(a, b) -> None:
    assert a.k == b.k
    assert a.unique.dtype == b.unique.dtype and a.counts.dtype == b.counts.dtype
    np.testing.assert_array_equal(a.unique, b.unique)
    np.testing.assert_array_equal(a.counts, b.counts)


def _same_table(a, b) -> None:
    for f in ("k", "threshold", "total_kmers"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("kmers", "fraction", "kmers_exact"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("k", [16, 22, 32])
def test_count_readset_host(reads, k):
    rs, trs = reads
    a, b = JK.count_readset_host(rs, k), TK.count_readset_host(trs, k)
    assert b.unique.dtype == (np.uint32 if k <= 16 else np.uint64)
    assert b.n_distinct > 0
    _same_counts(a, b)
    # the frequent table built on host counts (folded keys at k > 16)
    thr = JK.threshold_from_distinct_fraction(a, 0.99)
    assert thr == TK.threshold_from_distinct_fraction(b, 0.99)
    _same_table(JK.frequent_kmers(a, threshold=thr), TK.frequent_kmers(b, threshold=thr))


@pytest.mark.parametrize("k", [16, 22])
def test_device_hands_over_to_host(reads, k):
    rs, trs = reads
    small = int(trs.total_bases) - 1
    a = JK.count_readset_device(rs, k=k, max_instances=small)
    before = TK.HOST_COUNTS
    b = TK.count_readset_device(trs, k=k, max_instances=small, device="cpu")
    assert isinstance(b, TK.KmerCounts) and TK.HOST_COUNTS == before + 1
    _same_counts(a, b)
    np.testing.assert_array_equal(a.histogram(1000), b.histogram(1000))
    # at the budget the device counts, and its counts are the host's
    d = TK.count_readset_device(trs, k=k, max_instances=small + 1, device="cpu")
    assert TK.HOST_COUNTS == before + 1
    _same_counts(b, d.to_host())


def test_empty_read_set():
    rs = TReadSet.from_codes_list([], [])
    for k in (16, 22):
        kc = TK.count_readset_host(rs, k)
        assert kc.n_distinct == 0 and kc.unique.dtype == (np.uint32 if k <= 16 else np.uint64)


@pytest.mark.parametrize("k", [16, 22])
def test_frequent_from_fasta_and_union(tmp_path, k):
    g = random_genome(2000, seed=3)
    fa = tmp_path / "mers.fasta"
    # a record shorter than k is skipped; a repeated window dedups
    fa.write_text(">m1\n" + codes_to_seq(g[:50]) + "\n>m2\nACGT\n>m3\n"
                  + codes_to_seq(g[10:40]) + "\n")
    a, b = JK.frequent_from_fasta(str(fa), k), TK.frequent_from_fasta(str(fa), k)
    _same_table(a, b)
    assert b.n > 0 and (b.fraction == 1.0).all()
    assert (b.kmers_exact is not None) == (k > 16)
    ja = JK.frequent_kmers(JK.count_readset_host(JReadSet.from_codes_list([g], ["r1"]), k),
                           distinct_fraction=0.9)
    ta = TK.frequent_kmers(TK.count_readset_host(TReadSet.from_codes_list([g], ["r1"]), k),
                           distinct_fraction=0.9)
    _same_table(ja, ta)
    u = TK.union_frequent(ta, b)
    _same_table(JK.union_frequent(ja, a), u)
    assert max(ta.n, b.n) <= u.n <= ta.n + b.n
    assert (np.diff(u.kmers.astype(np.int64)) > 0).all()
    # a table loaded from a .frequent.npz has no exact k-mers; the union
    # gives its rows zeros there, as canu_tpu's does
    def loaded(M, t):
        return M.FrequentKmers(k=t.k, kmers=t.kmers, fraction=t.fraction,
                               threshold=t.threshold, total_kmers=t.total_kmers)

    _same_table(JK.union_frequent(loaded(JK, ja), a), TK.union_frequent(loaded(TK, ta), b))


def test_frequent_from_fasta_without_records(tmp_path):
    fa = tmp_path / "short.fasta"
    fa.write_text(">m1\nACGT\n")
    a, b = JK.frequent_from_fasta(str(fa), 16), TK.frequent_from_fasta(str(fa), 16)
    _same_table(a, b)
    assert b.n == 0
