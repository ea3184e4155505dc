"""canu_tpu_torch.ops.votepile against canu_tpu.ops.votepile on the CPU: the
vote piles (float32 votes, with QV weights, flipped evidence and several
chunks, whatever the chunks a DP group), both finalizers' packed values,
decode_pieces, segment_codes_plane and device_words give the same
results.  Exact: votes are exact float32
sums."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import canu_tpu.ops.votepile as JV
import canu_tpu_torch.ops.votepile as TV
from canu_tpu_torch.ops.kernels import trace_cuda as K4
from canu_tpu_torch.sim.simulate import mutate_read
from canu_tpu_torch.utils import bitpack
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

LT = 256  # template rows of the pile (n_rows = Lt)
S_E = 512  # evidence plane row width
G = 8
CPU = torch.device("cpu")


def _pile_inputs(seed: int, n_jobs: int = 150):
    """Template segments (<= LT bases), evidence windows cut from mutated
    copies (10-15% error, flanked, a third stored reverse-complemented and
    voted flipped), a slot and a QV weight per job."""
    rng = np.random.default_rng(seed)
    n_t = 12
    tmpl = [rng.integers(0, 4, int(rng.integers(120, LT + 1))).astype(np.uint8)
            for _ in range(n_t)]
    # a homopolymer-rich template: deletion votes stack on run starts
    hp = np.repeat(rng.integers(0, 4, 60), rng.integers(1, 6, 60)).astype(np.uint8)[:LT]
    tmpl[3] = hp
    ev, cols = [], {k: [] for k in ("t_idx", "e_idx", "t_bgn", "t_span", "e_lo", "e_span",
                                    "flipped", "slot")}
    for j in range(n_jobs):
        ti = int(rng.integers(0, n_t))
        t = tmpl[ti]
        bgn = int(rng.integers(0, max(1, len(t) // 4)))
        span = int(rng.integers(len(t) // 2, len(t) - bgn + 1))
        lf, rf = rng.integers(0, 4, int(rng.integers(0, 60))), rng.integers(0, 4, 30)
        e = np.concatenate([lf, mutate_read(t[bgn : bgn + span], float(rng.choice([0.1, 0.15])),
                                            rng), rf]).astype(np.uint8)[:S_E]
        core = min(len(e) - len(lf), len(e))
        fl = bool(j % 3 == 0)
        ev.append(bitpack.revcomp_codes(e) if fl else e)
        cols["t_idx"].append(ti)
        cols["e_idx"].append(j)
        cols["t_bgn"].append(bgn)
        cols["t_span"].append(span)
        cols["e_lo"].append(int(max(0, len(lf) - int(rng.integers(0, 20)))))
        cols["e_span"].append(int(min(core + 20, len(e) - cols["e_lo"][-1])))
        cols["flipped"].append(fl)
        cols["slot"].append(ti % G)
    jobs = {k: np.array(v, bool if k == "flipped" else np.int32) for k, v in cols.items()}
    weight = (1.0 + rng.integers(5, 41, n_jobs) / 256.0).astype(np.float32)
    return tmpl, ev, jobs, weight


def _jobs(cls, cols, weight):
    return cls(**cols, weight=weight)


@pytest.fixture(scope="module")
def piles():
    """Both packages' piles of the same jobs, at 32 jobs a chunk: several
    chunks and a padded last one."""
    tmpl, ev, cols, weight = _pile_inputs(11)
    jt, jl, _ = JV.segment_codes_plane(tmpl, LT)
    je, jel, _ = JV.segment_codes_plane(ev, S_E)
    tt, tl, _ = TV.segment_codes_plane(tmpl, LT, "cpu")
    te, tel, _ = TV.segment_codes_plane(ev, S_E, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JV, TV):
            mp.setattr(mod, "CHUNK_CELL_BUDGET", 32 * LT)
        ref = JV.pile_votes(jt, jl, je, jel, _jobs(JV.VoteJobs, cols, weight), G, LT,
                            ends_free=True)
        chunks = TV.CHUNKS
        got = TV.pile_votes(tt, tl, te, tel, _jobs(TV.VoteJobs, cols, weight), G, LT,
                            ends_free=True)
        assert TV.CHUNKS - chunks == -(-len(weight) // 32)
    return (jt, jl, np.array(ref)), (tt, tl, got)


def test_pile_votes_equal(piles):
    (_, _, ref), (_, _, got) = piles
    assert got.dtype == torch.float32 and got.shape == (G, TV.N_CH, LT)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref[:, TV.CH_DEL].max() >= 2  # deletion counts were stacked
    assert ref.sum() > 0 and (ref != np.round(ref)).any()  # QV weights are non-uniform


@pytest.mark.parametrize("per_group", [1, 2, 3])
def test_pile_votes_grouped_equal(piles, per_group, monkeypatch):
    """pile_votes with a DP group budget of per_group chunks of 32 jobs: the
    5 chunks go to the DP in groups of per_group (the last one smaller)
    and are folded in order; the votes and both finalizers' packed values
    equal canu_tpu's exactly."""
    (jt, jl, ref), (tt, tl, _) = piles
    _, ev, cols, weight = _pile_inputs(11)
    te, tel, _ = TV.segment_codes_plane(ev, S_E, "cpu")
    one = K4.scratch_bytes(1, 256, LT)
    monkeypatch.setattr(TV, "CHUNK_CELL_BUDGET", 32 * LT)
    monkeypatch.setattr(TV, "GROUP_BYTE_BUDGET", (per_group * 32 + 31) * one)
    assert TV.group_chunks(256, LT, 32, CPU) == per_group
    chunks, groups = TV.CHUNKS, TV.GROUPS
    got = TV.pile_votes(tt, tl, te, tel, _jobs(TV.VoteJobs, cols, weight), G, LT, ends_free=True)
    assert (TV.CHUNKS - chunks, TV.GROUPS - groups) == (5, -(-5 // per_group))
    np.testing.assert_array_equal(got.numpy(), ref)
    t_idx = np.arange(G, dtype=np.int32)
    for keep in (False, True):
        rp, rc = JV._finalize_plurality(jt, jl, jnp.asarray(t_idx), jnp.asarray(ref), 2.0, LT, keep)
        gp, gc = TV._finalize_plurality(tt, tl, torch.from_numpy(t_idx), got, 2.0, LT, keep)
        np.testing.assert_array_equal(gp.numpy(), np.asarray(rp).astype(np.int64))
        np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    r = JV._finalize_red(jt, jl, jnp.asarray(t_idx), jnp.asarray(ref), 2.0, 1.0, LT)
    g = TV._finalize_red(tt, tl, torch.from_numpy(t_idx), got, 2.0, 1.0, LT)
    np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64))


def test_group_chunks_raises_when_a_chunk_does_not_fit(monkeypatch):
    monkeypatch.setattr(TV, "GROUP_BYTE_BUDGET", 32 * K4.scratch_bytes(1, 256, LT) - 1)
    with pytest.raises(ValueError, match="group budget"):
        TV.group_chunks(256, LT, 32, CPU)
    monkeypatch.setattr(TV, "GROUP_BYTE_BUDGET", 0)
    with pytest.raises(ValueError, match="exceeds the budget"):
        TV.group_chunks(256, LT, 32, CPU)


@pytest.mark.parametrize("card_gb", [0, 16, 80])
def test_group_chunks_default_fits_a_canonical_chunk(card_gb, monkeypatch):
    """With the budgets as a fresh process has them (nothing sized by
    configure_resources) a canonical chunk (2,048 rows, band 256, 256
    jobs) goes to the DP: one a call on the CPU, as many as K4's scratch
    fits in a sixth of the card on a CUDA device (card_gb 0: the CPU)."""
    assert TV.GROUP_BYTE_BUDGET is None
    B = TV.chunk_jobs(2048)
    assert B == 256
    if card_gb == 0:
        assert TV.group_chunks(256, 2048, B, CPU) == 1
        return
    card = card_gb << 30
    props = type("Props", (), {"total_memory": card})()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: props)
    k = TV.group_chunks(256, 2048, B, torch.device("cuda", 0))
    assert k >= 1 and K4.scratch_bytes(k * B, 256, 2048) <= card // 6
    assert K4.scratch_bytes((k + 1) * B, 256, 2048) > card // 6
    assert card_gb < 80 or k >= 16  # a pile_votes chapter of a correction block


def test_finalizers_equal(piles):
    (jt, jl, votes), (tt, tl, _) = piles
    rng = np.random.default_rng(5)
    # small integer votes as well: 2-vs-2 base ties, insertion ties, exact
    # majorities at the gate
    ties = rng.integers(0, 3, votes.shape).astype(np.float32)
    t_idx = np.array([0, 1, 2, 3, 4, 5, 6, 1023], np.int32)  # the last a pad row
    for v in (votes, ties):
        for min_cov in (1.0, 4.0):
            for keep in (False, True):
                rp, rc = JV._finalize_plurality(jt, jl, jnp.asarray(t_idx), jnp.asarray(v),
                                                min_cov, LT, keep)
                gp, gc = TV._finalize_plurality(tt, tl, torch.from_numpy(t_idx),
                                                torch.from_numpy(v), min_cov, LT, keep)
                np.testing.assert_array_equal(gp.numpy(), np.asarray(rp).astype(np.int64))
                np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
        for min_alt, max_own in ((2.0, 1.0), (1.0, 2.0)):
            r = JV._finalize_red(jt, jl, jnp.asarray(t_idx), jnp.asarray(v), min_alt, max_own, LT)
            g = TV._finalize_red(tt, tl, torch.from_numpy(t_idx), torch.from_numpy(v), min_alt,
                                 max_own, LT)
            np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64))


def test_decode_pieces_and_code_plane_equal():
    rng = np.random.default_rng(9)
    for _ in range(6):
        row = rng.integers(0, 1 << 10, 700).astype(np.uint16)
        row[rng.integers(0, 700, 40)] &= ~np.uint16(1 << TV.PB_SUPPORTED)
        ref = JV.decode_pieces(row)
        for r in (row, row.astype(np.int32)):  # the port's rows hold int32
            got = TV.decode_pieces(r)
            assert [p for p, _ in got] == [p for p, _ in ref]
            for (_, a), (_, b) in zip(got, ref):
                np.testing.assert_array_equal(a, b)
    segs = [rng.integers(0, 4, n).astype(np.uint8) for n in (0, 1, 255, 256, 17)]
    jp, jl, jpad = JV.segment_codes_plane(segs, 256)
    tp, tl, tpad = TV.segment_codes_plane(segs, 256, "cpu")
    assert tpad == jpad
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp).astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert (TV.BLOCK_POS_BUDGET, TV.block_geometry(3000), TV.block_geometry(100)) == \
        (JV.BLOCK_POS_BUDGET, JV.block_geometry(3000), JV.block_geometry(100))


def test_device_words_equal():
    from canu_tpu.stores.readset import ReadSet as JRS
    from canu_tpu_torch.stores.readset import ReadSet as TRS

    rng = np.random.default_rng(2)
    codes = [rng.integers(0, 4, int(n)).astype(np.uint8) for n in rng.integers(1, 900, 140)]
    jw, jl = JV.device_words(JRS.from_codes_list(codes))
    trs = TRS.from_codes_list(codes)
    tw, tl = TV.device_words(trs, "cpu")
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw).astype(np.int64))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert TV.device_words(trs, "cpu")[0] is tw  # cached per read set and device


def test_pile_votes_fresh_at_real_geometry(piles):
    """pile_votes at the correction's geometry (2,048 rows, band 256, a
    chunk of 256 jobs) with the budgets as a fresh process has them, as a
    resumed correction_phase runs it: one chunk, one DP call on the CPU,
    and the votes of templates up to LT bases equal canu_tpu's at LT
    rows, zero past them."""
    (_, _, ref), _ = piles
    tmpl, ev, cols, weight = _pile_inputs(11)
    assert TV.GROUP_BYTE_BUDGET is None and TV.chunk_jobs(2048) == 256
    tt, tl, _ = TV.segment_codes_plane(tmpl, 2048, "cpu")
    te, tel, _ = TV.segment_codes_plane(ev, S_E, "cpu")
    chunks, groups = TV.CHUNKS, TV.GROUPS
    got = TV.pile_votes(tt, tl, te, tel, _jobs(TV.VoteJobs, cols, weight), G, 2048,
                        ends_free=True).numpy()
    assert (TV.CHUNKS - chunks, TV.GROUPS - groups) == (1, 1)
    np.testing.assert_array_equal(got[:, :, :LT], ref)
    assert not got[:, :, LT:].any()
