"""Port parity for the INF-walled extension engine: banded_extend_plain
against canu_tpu.ops.align.banded_extend and canu_tpu's two Pallas
extension kernels (interpret mode), and verify_overlaps at band 256
against canu_tpu's, fed the same ReadIndex; exact."""

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
from torch_cases import edge_cases, one_torch_thread, x8_cases  # noqa: F401

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
    rs = ReadSet.from_codes_list(codes, [f"r{i}" for i in range(len(codes))])
    sk = JM.build_sketches(rs, k=K, n_hashes=128, block_size=64)
    pairs = JM.find_candidates(sk, min_matches=2)
    ji = jax_index(rs, k=K)
    ti = read_index_from_numpy(
        *(np.asarray(getattr(ji, n)) for n in ("words", "length", "mker", "mpos", "mstr")),
        ji.n_reads, ji.k, ji.pm, device="cpu")
    return rs, pairs, ji, ti


def test_verify_overlaps_band256_partial_palindromic(sim, monkeypatch):
    rs, pairs, ji, ti = sim
    kw = dict(k=K, band=256, max_erate=0.12, min_overlap=300, chunk=64, min_shared=3,
              partial=True, palindromic_min=3)
    # canu_tpu picks its xla engine off the TPU, the port the INF-walled
    # engine (the plain loop on CPU tensors): the same function
    ref = JA.verify_overlaps(rs, pairs, index=ji, **kw)
    calls = []
    real = TA.banded_extend
    monkeypatch.setattr(TA, "banded_extend", lambda *a: calls.append(a[0].shape) or real(*a))
    got = TA.verify_overlaps(rs, pairs, index=ti, device="cpu", **kw)
    # the band alone picked the INF-walled engine, one call per chunk
    assert len(calls) == TA.LAST_PROFILE["n_chunks"]
    assert len(got) > 0 and len(got) == len(ref)
    for c in TABLE_COLS:
        a, b = getattr(ref, c), getattr(got, c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(b, a, err_msg=c)
    # the second, minority-orientation pass ran
    assert TA.LAST_PROFILE["n_chunks"] > -(-len(pairs) // kw["chunk"])
    assert TA.LAST_PROFILE["n_candidates"] == len(pairs)
