"""Port parity for the hash-join candidate matcher: canu_tpu_torch's
find_candidates_join (on the CPU) against canu_tpu's on the same sketches,
exact, including the buckets dropped over bucket_cap and the count the
warning gives; below the cap it equals the port's block matcher.
"""

from __future__ import annotations

import logging
import re

import numpy as np
import pytest

from canu_tpu.ops import kmer as JK
from canu_tpu.ops import minhash as JM
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.ops import minhash as TM
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def sketches():
    # the sketch set of tests/test_minhash.py's join == block test
    g = random_genome(40_000, seed=21)
    rs, _ = simulate_reads(g, coverage=6, mean_len=2500, min_len=1500, max_len=4000,
                           error_rate=0.06, seed=22, circular=False)
    kc = JK.count_readset_device(rs, k=16, block_size=256)
    fk = JK.frequent_kmers(kc, distinct_fraction=0.9995)
    return np.asarray(JM.build_sketches(rs, k=16, n_hashes=128, frequent=fk, block_size=128))


def _dropped(caplog, logger: str):
    msgs = [r.getMessage() for r in caplog.records if r.name == logger]
    return [int(re.search(r"dropped (\d+) buckets", m).group(1)) for m in msgs]


@pytest.mark.parametrize("min_matches", [2, 3])
def test_join_equals_canu_tpu_and_block(sketches, min_matches):
    ref = JM.find_candidates_join(sketches, min_matches=min_matches)
    before = TM.JOIN_CALLS
    got = TM.find_candidates_join(sketches, min_matches=min_matches, device="cpu")
    assert TM.JOIN_CALLS == before + 1
    assert got.dtype == np.int64 and got.shape == ref.shape and len(got) > 0
    np.testing.assert_array_equal(got, ref)
    assert (got[:, 0] < got[:, 1]).all()
    # no bucket reaches the cap here, so the join is the block matcher
    block = TM.find_candidates(sketches, min_matches=min_matches, block_size=128, device="cpu")
    np.testing.assert_array_equal(got, block)


@pytest.mark.parametrize("slot_chunk", [48, 128])
def test_join_slot_groups(sketches, slot_chunk):
    # slot groups that do not divide H, and one group of every slot
    ref = JM.find_candidates_join(sketches, min_matches=2)
    got = TM.find_candidates_join(sketches, min_matches=2, slot_chunk=slot_chunk, device="cpu")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("cap", [2, 3])
def test_join_drops_buckets_over_the_cap(sketches, caplog, cap):
    with caplog.at_level(logging.WARNING):
        ref = JM.find_candidates_join(sketches, min_matches=2, bucket_cap=cap)
        got = TM.find_candidates_join(sketches, min_matches=2, bucket_cap=cap, device="cpu")
    np.testing.assert_array_equal(got, ref)
    (n_ref,), (n_got,) = _dropped(caplog, "canu_tpu.minhash"), _dropped(caplog, "canu_tpu_torch.minhash")
    assert n_got == n_ref > 0
    # dropping buckets loses slot matches: fewer candidates than uncapped
    assert len(got) < len(TM.find_candidates_join(sketches, min_matches=2, device="cpu"))


def test_join_small_inputs(sketches):
    for n in (0, 1):
        got = TM.find_candidates_join(sketches[:n], min_matches=2, device="cpu")
        assert got.shape == (0, 3) and got.dtype == np.int64
    # no slot value shared: no pairs
    distinct = np.arange(8 * 16, dtype=np.uint32).reshape(8, 16)
    assert TM.find_candidates_join(distinct, min_matches=1, device="cpu").shape == (0, 3)
    # empty reads (UINT32_MAX in every slot) never match
    empty = np.full((5, 16), 0xFFFFFFFF, np.uint32)
    assert TM.find_candidates_join(empty, min_matches=1, device="cpu").shape == (0, 3)
    # matches below min_matches: pairs expand but none is kept
    two = np.arange(2 * 16, dtype=np.uint32).reshape(2, 16)
    two[1, 0] = two[0, 0]
    assert JM.find_candidates_join(two, min_matches=2).shape == (0, 3)
    assert TM.find_candidates_join(two, min_matches=2, device="cpu").shape == (0, 3)
    np.testing.assert_array_equal(TM.find_candidates_join(two, min_matches=1, device="cpu"),
                                  JM.find_candidates_join(two, min_matches=1))
