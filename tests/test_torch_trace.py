"""canu_tpu_torch.ops.trace against canu_tpu.ops.trace on the CPU: the
vote engine's banded fwd+bwd DP (align_positions_lean) gives the same
per-row evidence positions j* and the same edit counts.  Exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canu_tpu.ops.trace as JT
import canu_tpu_torch.ops.trace as TT
from canu_tpu_torch.sim.simulate import mutate_read
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


def _homopolymer_template(rng, n):
    """Runs of 2-7 equal bases: deletions and insertions in a run tie."""
    out = []
    while len(out) < n:
        out += [int(rng.integers(0, 4))] * int(rng.integers(2, 8))
    return np.array(out[:n], np.uint8)


def _cases(seed: int, n_rows: int, band: int):
    """(t, t_len, e, e_len) rows: mutated reads at 10-15% error, a
    zero-length pad row, templates shorter than n_rows and of n_rows,
    evidence with flanks beyond the template's ends, evidence as long as
    its window, homopolymer runs with one base deleted and one doubled,
    a template longer than its evidence."""
    rng = np.random.default_rng(seed)
    LE = n_rows + max(band, n_rows // 2)
    rows = []
    for er in (0.10, 0.12, 0.15, 0.15):
        t = rng.integers(0, 4, int(rng.integers(n_rows // 3, n_rows))).astype(np.uint8)
        rows.append((t, mutate_read(t, er, rng)))
    t = rng.integers(0, 4, n_rows).astype(np.uint8)  # t_len == n_rows
    rows.append((t, mutate_read(t, 0.12, rng)))
    rows.append((np.zeros(0, np.uint8), np.zeros(0, np.uint8)))  # pad row
    t = rng.integers(0, 4, n_rows // 2).astype(np.uint8)  # flanked evidence
    flank = rng.integers(0, 4, band // 2 + 40).astype(np.uint8)
    rows.append((t, np.concatenate([flank, mutate_read(t, 0.1, rng), flank])))
    t = rng.integers(0, 4, n_rows - 8).astype(np.uint8)  # evidence fills its window
    e = np.concatenate([mutate_read(t, 0.1, rng), rng.integers(0, 4, LE).astype(np.uint8)])
    rows.append((t, e[: LE - 1]))
    h = _homopolymer_template(rng, n_rows // 2)
    rows.append((h, np.delete(h, [5, 40])))
    rows.append((h, np.insert(h, [7, 33], h[[7, 33]])))
    t = rng.integers(0, 4, n_rows // 2).astype(np.uint8)  # template longer than evidence
    rows.append((t, t[: n_rows // 4]))
    B = len(rows)
    ta = np.zeros((B, n_rows), np.uint8)
    ea = np.zeros((B, LE), np.uint8)
    tl = np.zeros(B, np.int32)
    el = np.zeros(B, np.int32)
    for b, (t, e) in enumerate(rows):
        e = e[:LE]
        ta[b, : len(t)] = t
        ea[b, : len(e)] = e
        tl[b], el[b] = len(t), len(e)
    return ta, tl, ea, el


@pytest.mark.parametrize("band,ends_free", [(128, False), (128, True), (256, True)])
def test_align_positions_lean_equal(band, ends_free):
    n_rows = 256
    ta, tl, ea, el = _cases(n_rows + band + int(ends_free), n_rows, band)
    js_j, ed_j = JT.align_positions_lean(jnp.asarray(ta), jnp.asarray(tl), jnp.asarray(ea),
                                         jnp.asarray(el), band, n_rows, ends_free=ends_free)
    js_t, ed_t = TT.align_positions_lean(torch.from_numpy(ta), torch.from_numpy(tl),
                                         torch.from_numpy(ea), torch.from_numpy(el), band,
                                         n_rows, ends_free=ends_free)
    assert js_t.dtype == torch.int32 and ed_t.dtype == torch.int32
    np.testing.assert_array_equal(js_t.numpy(), np.asarray(js_j))
    np.testing.assert_array_equal(ed_t.numpy(), np.asarray(ed_j))
    # the pad row stays at 0 and the live rows are monotone
    assert (js_t[5] == 0).all()
    assert (np.diff(js_t.numpy(), axis=1) >= 0).all()


def test_band_starts_equal():
    rng = np.random.default_rng(4)
    centers = np.sort(rng.integers(-50, 700, (5, 65)), axis=1).astype(np.int32)
    centers[2] = rng.integers(0, 700, 65)  # not monotone
    b_len = np.array([600, 0, 700, 30, -3], np.int32)
    for band in (128, 256):
        ref = JT._band_starts(jnp.asarray(centers), jnp.asarray(b_len), band)
        got = TT._band_starts(torch.from_numpy(centers), torch.from_numpy(b_len), band)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (TT.SMAX, TT.SROW, TT.INF16) == (JT.SMAX, JT.SROW, JT.INF16)
