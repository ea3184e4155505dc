"""Port parity for the syncmer read index: canu_tpu_torch.ops.minimizers
against canu_tpu's, and convert.read_index_from_numpy round-tripping
canu_tpu's index, exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from canu_tpu.ops import minimizers as JMZ
from canu_tpu.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.convert import read_index_from_numpy
from canu_tpu_torch.ops import hashing as TH
from canu_tpu_torch.ops import minimizers as TMZ
from canu_tpu_torch.sim import simulate as torch_sim
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

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
