"""Port parity for MinHash sketches, block candidate matching and stage C
placement: canu_tpu_torch.ops.minhash against canu_tpu's, exact (the
plain versions that kernels K5 and K6 are held to on the card)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import align as JA
from canu_tpu.ops import kmer as JK
from canu_tpu.ops import minhash as JM
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.ops import align as TA
from canu_tpu_torch.ops import hashing as TH
from canu_tpu_torch.ops import minhash as TM
from canu_tpu_torch.sim import simulate as torch_sim
from torch_cases import (MATCH_EDGE_CASES, PAIR_STATS_CASES, SKETCH_EDGE_CASES,  # noqa: F401
                         match_edge_case, one_torch_thread, pair_stats_case, sketch_edge_case)


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


@pytest.fixture(scope="module")
def fk22(reads):
    rs, _trs, _fk = reads
    fk = JK.frequent_kmers(JK.count_readset_device(rs, k=22), threshold=4)
    assert fk.n > 0
    return fk


def test_sketch_plain_at_the_path_shapes(reads, fk22):
    # the obt/utg stages' k = 22 (the two-lane fold) with a frequent table,
    # at the widest preset's 768 slots and mhapBlockSize's 256 reads a block
    rs, trs, _fk = reads
    ref = JM.build_sketches(rs, k=22, n_hashes=768, frequent=fk22, block_size=256)
    got = TM.build_sketches(trs, k=22, n_hashes=768, frequent=fk22, block_size=256,
                            device="cpu")
    assert (ref != 0xFFFFFFFF).any()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k,H,fk", SKETCH_EDGE_CASES)
def test_sketch_plain_on_edge_reads(k, H, fk):
    words, lengths, seeds, table, k = sketch_edge_case(k, H, fk)
    ref = np.asarray(JM._sketch_kernel(jnp.asarray(words), jnp.asarray(lengths),
                                       jnp.asarray(seeds), jnp.asarray(table), k))
    got = TM._sketch_kernel_plain(TH.u32_tensor(words, "cpu"), torch.from_numpy(lengths),
                                  TH.u32_tensor(seeds, "cpu"), TH.u32_tensor(table, "cpu"), k)
    np.testing.assert_array_equal(TH.u32_numpy(got), ref)
    # reads shorter than k keep no window; with the table, read 5 none
    assert (ref[[0, 1]] == 0xFFFFFFFF).all() and (ref[[2, 8]] != 0xFFFFFFFF).any()
    assert (ref[5] == 0xFFFFFFFF).all() == (fk == "frequent")


@pytest.mark.parametrize("Na,Nb,H,min_matches,self_block,max_out", MATCH_EDGE_CASES)
def test_match_plain_on_edge_blocks(Na, Nb, H, min_matches, self_block, max_out):
    SA, SB = match_edge_case(Na, Nb, H)
    SB = SA if self_block else SB
    ref = JM._match_kernel(jnp.asarray(SA), jnp.asarray(SB), min_matches, self_block, max_out)
    got = TM._match_kernel_plain(TH.u32_tensor(SA, "cpu"), TH.u32_tensor(SB, "cpu"),
                                 min_matches, self_block, max_out)
    assert int(got[3]) == int(ref[3]) > 0
    for name, r, g in zip(("ii", "jj", "c"), ref[:3], got[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)


def test_find_candidates_drains_every_group(reads):
    # 12 blocks of 8 reads: 78 block pairs, drained in groups of 8, with
    # empty pairs between full ones
    rs, _trs, fk = reads
    sk = JM.build_sketches(rs, k=16, n_hashes=64, frequent=fk, block_size=32)
    ref = JM.find_candidates(sk, min_matches=4, block_size=8)
    got = TM.find_candidates(sk, min_matches=4, block_size=8, device="cpu")
    assert len(sk) > 88 and len(got) > 0
    np.testing.assert_array_equal(got, ref)


PLACED = ("a_id", "b_id", "flipped", "diag", "n_shared", "a_lo", "a_hi", "b_lo", "b_hi")
STORE = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")


@pytest.mark.parametrize("k,use_fk,edges", [(16, False, False), (16, True, False),
                                             (22, False, False), (16, True, True)],
                         ids=["k16", "k16_fk", "k22", "k16_edges"])
def test_place_candidates(reads, k, use_fk, edges):
    rs, trs, fk = reads
    fk = fk if use_fk else None
    sk = JM.build_sketches(rs, k=16, n_hashes=128, frequent=fk, block_size=64)
    # plus random pairs, most unrelated, which the inlier filter drops
    rng = np.random.default_rng(k)
    extra = np.sort(rng.choice(np.arange(1, rs.n_reads + 1), (40, 2), replace=True), axis=1)
    pairs = np.concatenate([JM.find_candidates(sk, min_matches=2)[:, :2],
                            extra[extra[:, 0] < extra[:, 1]]])
    min_shared = 3
    if edges:
        # reads against themselves (a key repeated in a read: its last A
        # entry meets its first B entry off the main diagonal) and, with
        # min_shared 0, the unrelated pairs' empty inlier sets kept
        pairs = np.concatenate([pairs, np.repeat(np.arange(1, rs.n_reads + 1, 7), 2)
                                .reshape(-1, 2)])
        min_shared = 0
    ref = JM.place_candidates(rs, pairs, k=k, frequent=fk, min_shared=min_shared, chunk=64)
    got = TM.place_candidates(trs, pairs, k=k, frequent=fk, min_shared=min_shared, chunk=64,
                              device="cpu")
    if edges:
        empty = got.n_shared == 0
        assert len(got) == len(pairs) and empty.any() and (got.a_id == got.b_id).any()
        assert (got.a_lo[empty] == 2**30).all() and (got.b_hi[empty] == -1).all()
    else:
        assert 0 < len(got) < len(pairs)
    assert got.flipped.any() and (~got.flipped).any()
    for name in PLACED:
        r, g = getattr(ref, name), getattr(got, name)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    # the placed candidates verify as canu_tpu's do (orientation given)
    ov_ref = JA.verify_overlaps(rs, ref, band=128, min_overlap=500, chunk=64)
    ov_got = TA.verify_overlaps(trs, got, band=128, min_overlap=500, chunk=64, device="cpu")
    assert len(ov_got) > 0
    for name in STORE:
        np.testing.assert_array_equal(np.asarray(getattr(ov_got, name)),
                                      np.asarray(getattr(ov_ref, name)), err_msg=name)


@pytest.fixture(scope="module")
def chunked_ref(reads):
    # neighbours, every fifth read against itself and random pairs, all
    # kept (min_shared 0), placed by canu_tpu in chunks of 64
    rs, _trs, fk = reads
    ids = np.arange(1, rs.n_reads + 1)
    rng = np.random.default_rng(21)
    pairs = np.concatenate([np.stack([ids[:-1], ids[1:]], 1), np.stack([ids, ids], 1)[::5],
                            np.sort(rng.choice(ids, (60, 2)), axis=1)])
    return pairs, JM.place_candidates(rs, pairs, k=16, frequent=fk, min_shared=0, chunk=64)


@pytest.mark.parametrize("chunk", [16, 64, 256])
def test_place_candidates_does_not_depend_on_the_chunk(reads, chunked_ref, chunk):
    # the premise of one K12 launch a call on the card: a pair's statistics
    # do not depend on the chunk it is padded in (W only pads past its reads)
    _rs, trs, fk = reads
    pairs, ref = chunked_ref
    got = TM.place_candidates(trs, pairs, k=16, frequent=fk, min_shared=0, chunk=chunk,
                              device="cpu")
    assert len(got) == len(pairs) > 64 and (got.n_shared > 0).any()
    for name in PLACED:
        r, g = getattr(ref, name), getattr(got, name)
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)


@pytest.mark.parametrize("case", PAIR_STATS_CASES)
def test_pair_stats_on_edge_chunks(case):
    # stage C's statistics (kernel K12's plain version) on a chunk of tandem
    # repeats, self pairs, a tied vote, empty and short reads, two far
    # clusters of diagonals, a cluster at tol and random padding
    wa, la, wb, lb, fk, k = pair_stats_case(case)
    ref = JM._pair_stats_kernel(jnp.asarray(wa), jnp.asarray(la), jnp.asarray(wb), jnp.asarray(lb),
                                jnp.zeros(1, jnp.uint32), jnp.asarray(fk), k)
    got = TM._pair_stats_kernel(*(TH.u32_tensor(x, "cpu") if x.dtype == np.uint32
                                  else torch.from_numpy(x) for x in (wa, la, wb, lb, fk)), k)
    for name, r, g in zip(PLACED[2:], ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    n_inl = got[2].numpy()
    assert (n_inl == 0).any() and (n_inl > 0).any() and got[0].any()
