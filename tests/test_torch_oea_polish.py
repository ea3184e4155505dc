"""RED, OEA and the plurality polish of the port give what canu_tpu's give,
exactly, on the CPU: detect_read_errors (and its finalize,
votepile._finalize_red), apply_corrections and adjust_overlap_erates with
and without only_changed on tests/test_oea.py's pile of reads with
planted errors; quick_mosaic and one round of polish_tig on a tig of
simulated reads placed at their true positions.  Both packages' vote
engines run at one small geometry (512-base segments, 64 jobs a chunk,
as tests/test_torch_falcon.py's), a few chunks each; chip_smoke.py's
assemble phase holds the real geometry against canu_tpu on a whole
assembly."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import canu_tpu.ops.consensus as JC
import canu_tpu.ops.falcon as JF
import canu_tpu.ops.oea as JO
import canu_tpu.ops.votepile as JV
import canu_tpu_torch.ops.consensus as TC
import canu_tpu_torch.ops.falcon as TF
import canu_tpu_torch.ops.oea as TO
import canu_tpu_torch.ops.votepile as TV
from canu_tpu.stores.readset import ReadSet as JRS
from canu_tpu.stores.tigs import Tig as JTig
from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
from canu_tpu_torch.stores.overlaps import OverlapStore as TStore
from canu_tpu_torch.stores.readset import ReadSet as TRS
from canu_tpu_torch.stores.tigs import Tig as TTig
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)

COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")
ERR_POS = [200, 700, 900, 1300, 1500, 1750]
SEG = 512


@pytest.fixture(scope="module", autouse=True)
def small_geometry():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JF, TF):
            mp.setattr(mod, "VOTE_SEG", SEG)
        for mod in (JC, TC):
            mp.setattr(mod, "_POLISH_SEG", SEG)
        for mod in (JV, TV):
            mp.setattr(mod, "BLOCK_POS_BUDGET", SEG * 16)  # G = 16 segments a block
            mp.setattr(mod, "CHUNK_CELL_BUDGET", SEG * 64)  # 64 jobs a chunk
        yield


def _pile_codes(seed: int = 0, n: int = 10, L: int = 2000, plant: bool = True):
    """tests/test_oea.py's pile: n reads of one genome window, exact but
    for planted substitutions in reads 1 and 4 (unless not plant)."""
    g = random_genome(4000, seed=seed)
    rng = np.random.default_rng(seed + 1)
    codes = []
    for _ in range(n):
        s = int(rng.integers(0, 500))
        codes.append(g[s : s + L].copy())
    for r in (0, 3) if plant else ():
        for p in ERR_POS[r % 2::2] if r else ERR_POS:
            codes[r][p] = (codes[r][p] + 1) % 4
    return codes


@pytest.fixture(scope="module")
def pile():
    """The pile as both packages' ReadSets and canu_tpu's overlap store of
    it (the Myers verify at band 128); the port gets the same columns."""
    from canu_tpu.ops.align import verify_overlaps
    from canu_tpu.stores.overlaps import OverlapStore

    codes = _pile_codes()
    names = [f"r{i + 1}" for i in range(len(codes))]
    jrs, trs = JRS.from_codes_list(codes, names), TRS.from_codes_list(codes, names)
    pairs = np.array([(a, b) for a in range(1, 10) for b in range(a + 1, 11)], np.int64)
    ov = verify_overlaps(jrs, pairs, band=128, max_erate=0.2, min_overlap=500, chunk=32)
    st = OverlapStore.build(ov, jrs.n_reads)
    tst = TStore(st.n_reads, **{c: np.asarray(getattr(st, c)) for c in COLS})
    assert len(st) > 0
    return (jrs, st), (trs, tst)


@pytest.fixture(scope="module")
def red(pile):
    (jrs, st), (trs, tst) = pile
    j = JO.detect_read_errors(jrs, st, band=256)
    t = TO.detect_read_errors(trs, tst, band=256, device="cpu")
    return j, t


def test_detect_read_errors_equal(red, pile):
    j, t = red
    assert sorted(t) == sorted(j) and 1 in t, (sorted(j), sorted(t))
    for rid in j:
        assert t[rid].dtype == np.asarray(j[rid]).dtype
        np.testing.assert_array_equal(t[rid], j[rid])
    # the finalize on this pile's own read plane, at the real geometry
    (jrs, _), (trs, _) = pile
    jw, jl = JV.device_words(jrs)
    tw, tl = TV.device_words(trs, "cpu")
    rng = np.random.default_rng(2)
    votes = rng.integers(0, 6, (8, TV.N_CH, 2048)).astype(np.float32)
    idx = np.array([0, 1, 2, 3, 9, 4, 5, tw.shape[0] - 1], np.int32)
    import jax.numpy as jnp

    for min_alt, max_own in ((4.0, 1.0), (2.0, 2.0)):
        r = JV._finalize_red(jw, jl, jnp.asarray(idx), jnp.asarray(votes), min_alt, max_own, 2048)
        g = TV._finalize_red(tw, tl, torch.from_numpy(idx), torch.from_numpy(votes), min_alt,
                             max_own, 2048)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int64))


def test_apply_corrections_equal(red, pile):
    j, t = red
    (jrs, _), (trs, _) = pile
    jf, tf = JO.apply_corrections(jrs, j), TO.apply_corrections(trs, t)
    for f in ("words", "word_off", "length", "source_id", "source_bgn"):
        np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f))
    assert tf.names == jf.names
    # every planted error of read 1 is restored
    clean = _pile_codes(plant=False)
    fixed = tf.get_codes(1)
    assert sum(int(fixed[p] != clean[0][p]) for p in ERR_POS) < len(ERR_POS)
    np.testing.assert_array_equal(TO.apply_corrections(trs, {}).words, trs.words)


@pytest.mark.parametrize("only_changed", [False, True])
def test_adjust_overlap_erates_equal(red, pile, only_changed):
    j, t = red
    (jrs, st), (trs, tst) = pile
    want = JO.adjust_overlap_erates(jrs, st, j, band=128, chunk=32, only_changed=only_changed)
    got = TO.adjust_overlap_erates(trs, tst, t, band=128, chunk=32, only_changed=only_changed,
                                   device="cpu")
    assert got.dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)
    assert (got != tst.erate_q).any()
    np.testing.assert_array_equal(
        TO.adjust_overlap_erates(trs, tst, {}, band=128, chunk=32, only_changed=True,
                                 device="cpu"), tst.erate_q)


def test_polish_tig_equal():
    """quick_mosaic and one polish round of a 5 kb tig: 12x of reads at 3%
    error, placed at their true genome positions (ten segments)."""
    g = random_genome(5000, seed=90)
    rs, tr = simulate_reads(g, coverage=12, mean_len=1500, min_len=900, max_len=2200,
                            error_rate=0.03, seed=91, circular=False)
    jrs = JRS(rs.words, rs.word_off, rs.length, rs.names, rs.source_id, rs.source_bgn)
    order = np.argsort(tr.start, kind="stable")
    ids = (order + 1).astype(np.int32)
    place = (tr.start[order].astype(np.int32), tr.end[order].astype(np.int32),
             tr.strand[order].astype(bool))
    jt, tt = JTig(1, ids, *place), TTig(1, ids, *place)
    jb, tb = JC.quick_mosaic(jrs, jt), TC.quick_mosaic(rs, tt)
    np.testing.assert_array_equal(tb, jb)
    want = JC.polish_tig(jrs, jt, jb, band=256, min_cov=2, rounds=1)
    got = TC.polish_tig(rs, tt, tb, band=256, min_cov=2, rounds=1, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))
    assert len(got) > 4000 and not np.array_equal(got, tb)
    with pytest.raises(NotImplementedError, match="8\\(e\\)"):
        TC.polish_tig(rs, tt, tb, mode="dag", device="cpu")
