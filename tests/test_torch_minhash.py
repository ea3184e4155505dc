"""Port parity for MinHash sketches and block candidate matching:
canu_tpu_torch.ops.minhash against canu_tpu's, exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from canu_tpu.ops import kmer as JK
from canu_tpu.ops import minhash as JM
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.ops import hashing as TH
from canu_tpu_torch.ops import minhash as TM
from canu_tpu_torch.sim import simulate as torch_sim
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def reads():
    sim = dict(coverage=8, mean_len=1000, min_len=500, max_len=1600, error_rate=0.08, seed=9)
    rs, _ = simulate_reads(random_genome(12_000, seed=8, repeat_spec=[(200, 6)]), **sim)
    # the port's own read set, from the port's simulator with the same seeds
    trs, _ = torch_sim.simulate_reads(
        torch_sim.random_genome(12_000, seed=8, repeat_spec=[(200, 6)]), **sim)
    fk = JK.frequent_kmers(JK.count_readset_device(rs, k=16), threshold=4)
    assert fk.n > 0
    return rs, trs, fk


@pytest.mark.parametrize("use_fk", [False, True], ids=["nofk", "fk"])
def test_build_sketches(reads, use_fk):
    rs, trs, fk = reads
    fk = fk if use_fk else None
    ref = JM.build_sketches(rs, k=16, n_hashes=64, frequent=fk, block_size=32)
    got = TM.build_sketches(trs, k=16, n_hashes=64, frequent=fk, block_size=32, device="cpu")
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("block", [1024, 16], ids=["self_block", "cross_block"])
def test_find_candidates(reads, block):
    rs, _trs, fk = reads
    sk = JM.build_sketches(rs, k=16, n_hashes=64, frequent=fk, block_size=32)
    sk[3] = 0xFFFFFFFF  # an empty read never matches
    ref = JM.find_candidates(sk, min_matches=2, block_size=block)
    got = TM.find_candidates(sk, min_matches=2, block_size=block, device="cpu")
    assert len(got) > 0
    np.testing.assert_array_equal(got, ref)


def test_match_kernel_padding_and_overflow(reads):
    rs, _trs, fk = reads
    sk = JM.build_sketches(rs, k=16, n_hashes=64, frequent=fk, block_size=32)
    for self_block in (True, False):
        SA, SB = sk[:40], sk[:40] if self_block else sk[40:70]
        ref = JM._match_kernel(jnp.asarray(SA), jnp.asarray(SB), 2, self_block, 64)
        got = TM._match_kernel(TH.u32_tensor(SA, "cpu"), TH.u32_tensor(SB, "cpu"), 2,
                               self_block, 64)
        assert got[3] == int(ref[3])
        for r, g in zip(ref[:3], got[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(RuntimeError, match="candidate overflow") as e_t:
        TM.find_candidates(sk, min_matches=1, block_size=64, max_out_per_blockpair=8,
                           device="cpu")
    with pytest.raises(RuntimeError, match="candidate overflow") as e_j:
        JM.find_candidates(sk, min_matches=1, block_size=64, max_out_per_blockpair=8)
    assert str(e_t.value) == str(e_j.value)
