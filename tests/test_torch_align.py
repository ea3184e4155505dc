"""Port parity for anchored verification: canu_tpu_torch.ops.align against
canu_tpu.ops.align (Myers engine, XLA on the CPU), fed the same ReadIndex
through convert.read_index_from_numpy, exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from canu_tpu.ops import align as JA
from canu_tpu.ops import minhash as JM
from canu_tpu.ops.minimizers import get_read_index as jax_index
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu.stores.readset import ReadSet
from canu_tpu_torch.convert import read_index_from_numpy
from canu_tpu_torch.ops import align as TA
from canu_tpu_torch.ops.minhash import OverlapCandidates
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

TABLE_COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")


@pytest.fixture(scope="module")
def sim():
    g = random_genome(10_000, seed=40)
    rs, _ = simulate_reads(g, coverage=8, mean_len=800, min_len=500, max_len=1000,
                           error_rate=0.10, seed=41)
    # plus one chimeric read (a read's first half, then its second half
    # reverse-complemented) whose pair with that read has k-mer support in
    # both orientations
    codes = [rs.get_codes(i) for i in range(1, rs.n_reads + 1)]
    c = max(codes, key=len)
    h = len(c) // 2
    codes.append(np.concatenate([c[:h], (3 - c[h:])[::-1]]).astype(np.uint8))
    rs = ReadSet.from_codes_list(codes, [f"r{i}" for i in range(len(codes))])
    sk = JM.build_sketches(rs, k=16, n_hashes=128, block_size=64)
    pairs = JM.find_candidates(sk, min_matches=2)
    ji = jax_index(rs, k=16)
    ti = read_index_from_numpy(
        *(np.asarray(getattr(ji, n)) for n in ("words", "length", "mker", "mpos", "mstr")),
        ji.n_reads, ji.k, ji.pm, device="cpu")
    return rs, pairs, ji, ti


def _eq(ref, got, name=""):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(ref), err_msg=name)


def test_shift_rows():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (9, 64)).astype(np.uint8)
    t = np.array([0, 1, 5, 31, 32, 63, 64, 70, 200], np.int32)  # incl. t >= L
    for out_len in (16, 64, 100):
        _eq(JA._shift_rows(jnp.asarray(x), jnp.asarray(t), out_len),
            TA._shift_rows(torch.from_numpy(x), torch.from_numpy(t), out_len), out_len)


def test_interp_centers():
    rng = np.random.default_rng(1)
    B, M, n_rows = 40, 64, 700
    xa = np.full((B, M), 0, np.int32)
    xb = np.full((B, M), 0, np.int32)
    m = np.arange(M, dtype=np.int32)
    for i in range(B):
        n = int(rng.integers(0, M))
        steps_a = rng.integers(0 if i % 3 == 0 else 1, 40, n)  # %3: repeated xa
        pa = np.concatenate([[0], np.cumsum(steps_a)])[:n]
        pb = np.concatenate([[0], np.cumsum(rng.integers(0, 45, n))])[:n]
        xa[i] = np.where(m < n, np.pad(pa, (0, M - n)), (1 << 24) + m)
        xb[i] = np.where(m < n, np.pad(pb, (0, M - n)), (1 << 24) + m)
    _eq(JA._interp_centers(jnp.asarray(xa), jnp.asarray(xb), None, n_rows),
        TA._interp_centers(torch.from_numpy(xa), torch.from_numpy(xb), n_rows))


@pytest.mark.parametrize("orient", [True, False], ids=["orient", "given"])
def test_anchor_compact_and_verify_pre(sim, orient):
    rs, pairs, ji, ti = sim
    a_idx = (pairs[:96, 0] - 1).astype(np.int32)
    b_idx = (pairs[:96, 1] - 1).astype(np.int32)
    fl = (np.arange(96) % 3 == 0)
    g = lambda a, i: jnp.asarray(a)[jnp.asarray(i)]  # noqa: E731
    ref = JA._anchor_compact(
        g(ji.mker, a_idx), g(ji.mpos, a_idx), g(ji.mstr, a_idx),
        g(ji.mker, b_idx), g(ji.mpos, b_idx), g(ji.mstr, b_idx),
        g(ji.length, a_idx), g(ji.length, b_idx), jnp.asarray(fl), 16, orient)
    ta, tb = torch.from_numpy(a_idx.astype(np.int64)), torch.from_numpy(b_idx.astype(np.int64))
    got = TA._anchor_compact(
        ti.mker[ta], ti.mpos[ta], ti.mstr[ta], ti.mker[tb], ti.mpos[tb], ti.mstr[tb],
        ti.length[ta], ti.length[tb], torch.from_numpy(fl), 16, orient)
    for name, r, t in zip(("aA", "aB", "n_anchor", "flipped", "n_minor"), ref, got):
        _eq(r, t, name)
    n_rows = ti.words.shape[1] * 16
    ref = JA._verify_pre(ji.words, ji.length, ji.mker, ji.mpos, ji.mstr,
                         jnp.asarray(a_idx), jnp.asarray(b_idx), jnp.asarray(fl),
                         16, 128, n_rows, orient)
    got = TA._verify_pre(ti, ta, tb, torch.from_numpy(fl), 16, 128, n_rows, orient)
    for name, r, t in zip(("a", "a_len", "b", "b_len", "centers"), ref[0], got[0]):
        _eq(r, t, name)
    for name, r, t in zip(("n_anchor", "flipped", "seedA", "seedB", "n_minor"), ref[1:], got[1:]):
        _eq(r, t, name)


def _tables_equal(ref, got):
    assert len(got) == len(ref)
    for c in TABLE_COLS:
        a, b = getattr(ref, c), getattr(got, c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(b, a, err_msg=c)


@pytest.mark.parametrize("mode", ["raw", "partial", "palindromic", "candidates"])
def test_verify_overlaps(sim, mode):
    rs, pairs, ji, ti = sim
    kw = dict(k=16, band=128, max_erate=0.3, min_overlap=300, chunk=64, min_shared=4,
              partial=mode in ("partial", "palindromic"),
              palindromic_min=4 if mode == "palindromic" else 0)
    cand = pairs
    if mode == "candidates":
        # orientation given: the vote of the raw pass, every third inverted
        fl = np.zeros(len(pairs), bool)
        fl[::3] = True
        z = np.zeros(len(pairs), np.int32)
        cand = OverlapCandidates(a_id=pairs[:, 0].astype(np.int32),
                                 b_id=pairs[:, 1].astype(np.int32), flipped=fl, diag=z,
                                 n_shared=z, a_lo=z, a_hi=z, b_lo=z, b_hi=z)
    ref = JA.verify_overlaps(rs, cand, engine="myers", index=ji, **kw)
    got = TA.verify_overlaps(rs, cand, index=ti, device="cpu", **kw)
    assert len(got) > 0
    _tables_equal(ref, got)
    n_chunks = -(-len(pairs) // kw["chunk"])
    if mode == "palindromic":  # the second, minority-orientation pass ran
        assert TA.LAST_PROFILE["n_chunks"] > n_chunks
    else:
        assert TA.LAST_PROFILE["n_chunks"] == n_chunks
    assert TA.LAST_PROFILE["n_candidates"] == len(pairs)
