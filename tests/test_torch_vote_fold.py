"""The vote fold of canu_tpu_torch.ops.votepile (pile_votes's group fold
and _fold_chunk, the plain version kernel K9 is held to) against
canu_tpu.ops.votepile's (pile_votes, _vote_many) on the CPU, exactly.

Both packages get the same fold inputs, as the DP leaves them: each
package's window gathers and DP are replaced by the planted rows of
torch_cases.fold_case (every odd spot of the fold: t_bgn's high bits,
deleted runs over 15 rows and one reaching the last row, dj >= 3, paths
at 0 and past e_span and W_e, e_span past W_e, rows past t_span, pad
jobs, a slot off the block) and fold_exact_case (256 jobs voting one
column with count 15 at the largest weight).  canu_tpu runs with jit
disabled, so that its fold takes the planted rows.  A planted break of
the port's t_bgn mask or of its clamp at 15 must make a case differ.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canu_tpu.ops.votepile as JV
import canu_tpu_torch.ops.votepile as TV
from torch_cases import (FOLD_CASES, FOLD_WEIGHT_MAX, fold_case, fold_exact_case,  # noqa: F401
                         one_torch_thread)

CHUNK = 64  # jobs a chunk (several chunks and a padded last one a case)


def _case(name: str):
    if name == "exact":
        return fold_exact_case(256, 256, 128), 256, 128, 8
    n, n_rows, band, G = FOLD_CASES[name]
    return fold_case(sum(map(ord, name)), n, n_rows, band, G), n_rows, band, G


def _plant(mp, mod, case, to):
    """mod's window gathers return the case's t_sub and e_sub rows of the
    jobs gathered (t_idx = e_idx = the job), its DP the jobs' js."""
    js, t_sub, e_sub, _ = case
    last = {}

    def gather(words, lengths, idx, bgn, flipped, out_len):
        i = np.asarray(idx).astype(np.int64)
        if flipped is None:
            last["jobs"] = i
            return to(t_sub[i])
        return to(e_sub[i])

    def dp(t, t_len, e, e_len, band, n_rows, ends_free=False):
        return to(js[last["jobs"]]), None

    mp.setattr(mod, "_gather_window", gather)
    mp.setattr(mod, "align_positions_lean", dp)
    mp.setattr(mod, "CHUNK_CELL_BUDGET", CHUNK * t_sub.shape[1])


def _jobs(cls, cols):
    return cls(t_idx=cols[0], e_idx=cols[1], t_bgn=cols[2], t_span=cols[3], e_lo=cols[4],
               e_span=cols[5], flipped=cols[6] != 0, slot=cols[7],
               weight=cols[8].view(np.float32).copy())


def _piles(case, n_rows, band, G, port_group_budget=None):
    """(canu_tpu's pile_votes, the port's) of the case's jobs, planted."""
    cols = case[3]
    dummy_j, dummy_t = jnp.zeros(1, jnp.int32), torch.zeros(1, dtype=torch.int32)
    with pytest.MonkeyPatch.context() as mp:
        _plant(mp, JV, case, jnp.asarray)
        _plant(mp, TV, case, torch.from_numpy)
        if port_group_budget is not None:
            mp.setattr(TV, "GROUP_BYTE_BUDGET", port_group_budget)
        with jax.disable_jit():
            ref = np.asarray(JV.pile_votes(dummy_j, dummy_j, dummy_j, dummy_j,
                                           _jobs(JV.VoteJobs, cols), G, n_rows, band=band,
                                           ends_free=True))
        got = TV.pile_votes(dummy_t, dummy_t, dummy_t, dummy_t, _jobs(TV.VoteJobs, cols), G,
                            n_rows, band=band, ends_free=True).numpy()
    return ref, got


@pytest.mark.parametrize("name", [*FOLD_CASES, "exact"])
def test_pile_votes_fold_equals_canu_tpu(name):
    case, n_rows, band, G = _case(name)
    groups = TV.GROUPS
    ref, got = _piles(case, n_rows, band, G)
    assert TV.GROUPS - groups == -(-case[0].shape[0] // CHUNK)  # one chunk a group on the CPU
    assert got.dtype == np.float32 and got.shape == (G, TV.N_CH, n_rows)
    np.testing.assert_array_equal(got, ref)
    if name == "exact":  # 256 jobs x 15 deletions x the largest weight on one column
        assert ref[0, TV.CH_DEL, 0] == 256 * 15 * FOLD_WEIGHT_MAX == 7650.0
    else:
        assert (ref[:, TV.CH_INS2] > 0).any() and (ref[:, TV.CH_DEL] > 0).any()


def test_pile_votes_fold_grouped_equals_canu_tpu():
    """Three chunks a DP group on the CPU: the group folds its chunks in
    order, and the votes are canu_tpu's."""
    from canu_tpu_torch.ops.kernels import trace_cuda as K4

    case, n_rows, band, G = _case("odd 300 x 256")
    budget = (3 * CHUNK + 1) * K4.scratch_bytes(1, band, n_rows)
    groups, chunks = TV.GROUPS, TV.CHUNKS
    ref, got = _piles(case, n_rows, band, G, port_group_budget=budget)
    assert (TV.GROUPS - groups, TV.CHUNKS - chunks) == (2, 5)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["odd 300 x 256", "odd 40 x 8192"])
def test_fold_chunk_equals_vote_many(name):
    """_fold_chunk on one chunk into an accumulator already holding votes
    equals canu_tpu's _vote_many (its fold, planted) on the same chunk."""
    case, n_rows, band, G = _case(name)
    js, t_sub, e_sub = (np.ascontiguousarray(x[:CHUNK]) for x in case[:3])
    cols = np.ascontiguousarray(case[3][:, :CHUNK])
    votes = (np.random.default_rng(3).integers(0, 4, (G, TV.N_CH, n_rows)) * 0.25).astype(
        np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _plant(mp, JV, case, jnp.asarray)
        with jax.disable_jit():
            ref = np.asarray(JV._vote_many(jnp.asarray(votes), *(jnp.zeros(1, jnp.int32),) * 4,
                                           jnp.asarray(cols), band, n_rows, n_rows, G, True))
    got = TV._fold_chunk(torch.from_numpy(votes), *map(torch.from_numpy, (js, t_sub, e_sub)),
                         torch.from_numpy(cols), n_rows, n_rows, G).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got != votes).any()


def test_fold_cases_plant_every_odd_spot():
    """The cases hold what they say: live rows whose column moves with
    t_bgn's high bits, deleted runs over 15 live rows (one reaching the
    last row), active steps dj >= 3, paths idle at 0 and at or past
    e_span and W_e, e_span past W_e, rows past t_span, pad jobs and a slot
    off the block."""
    for name in FOLD_CASES:
        (js, t_sub, e_sub, cols), n_rows, band, G = _case(name)
        W_e = e_sub.shape[1]
        t_bgn, t_span, e_span = cols[2].astype(np.int64), cols[3], cols[5]
        mask = (1 << TV._log_rounds(n_rows)) - 1
        live_job = (t_span > 0) & (cols[8] != 0) & (cols[7] < G)
        assert (live_job & (t_bgn & ~mask != 0)).any() and (t_bgn < 0).any()
        dj = np.diff(js, axis=1)
        rows = np.arange(n_rows)[None, :]
        es = np.minimum(e_span, W_e - 1)[:, None]
        live = rows < t_span[:, None]
        active = live & (js[:, 1:] > 0) & (js[:, :-1] < es)
        deleting = active & (dj == 0)
        # a deleted run of the template over 15 rows, and one at the last row
        same = np.concatenate([np.zeros((len(js), 1), bool), t_sub[:, 1:] == t_sub[:, :-1]], 1)
        run = np.zeros(len(js), int)
        longest = np.zeros(len(js), int)
        for i in range(n_rows):
            run = np.where(deleting[:, i], np.where(same[:, i], run + 1, 1), 0)
            longest = np.maximum(longest, run)
        assert (longest > 15).any() and (run > 15).any()
        assert (active & (dj >= 3)).any()
        assert ((js[:, :-1] == 0) & live).any() and ((js[:, :-1] >= es) & live).any()
        assert (js.max(1) >= W_e).any() and (e_span >= W_e).any()
        assert (t_span < n_rows).any() and (t_span > n_rows).any()
        assert ((t_span == 0) & (cols[8] == 0)).any() and (cols[7] >= G).any()


def test_breaking_the_mask_or_the_clamp_shows():
    """A planted break of the port's fold makes a case differ from
    canu_tpu's: the template shift without its log-rounds mask (t_bgn's
    high bits kept), or the deletion count without its clamp at 15."""
    case, n_rows, band, G = _case("odd 300 x 256")
    ref, got = _piles(case, n_rows, band, G)
    np.testing.assert_array_equal(got, ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TV, "_log_rounds", lambda n: 31)
        _, broken = _piles(case, n_rows, band, G)
    assert (broken != ref).any()
    clamp = torch.clamp

    def unclamped(x, min=None, max=None):
        return clamp(x, min, 10 ** 6 if max == 15 else max)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TV.torch, "clamp", unclamped)
        _, broken = _piles(case, n_rows, band, G)
    assert (broken[:, TV.CH_DEL] != ref[:, TV.CH_DEL]).any()
