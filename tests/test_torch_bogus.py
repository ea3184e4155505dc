"""The port's judge ruler (sim/bogus.py) against canu_tpu's on the CPU:
genome classification, ideal contigs, NG50 and evaluate_assembly on a
misjoin, a 700-base collapse, a reverse-complemented noisy piece and a
contig across a circular genome's origin give the same verdicts,
placements and identities.  Exact: the identity ruler's Myers pass runs
the port's plain loop (kernel K1 on the card), and its band centres come
from the anchors through float32 as canu_tpu's int32 -> float32 path
gives them, the BIG = 1 << 24 padding included."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import canu_tpu.ops.align as JAL
import canu_tpu.sim.bogus as JB
import canu_tpu.sim.simulate as JSIM
import canu_tpu_torch.ops.align as TAL
import canu_tpu_torch.sim.bogus as TB
from canu_tpu_torch.sim.simulate import mutate_read, random_genome, simulate_reads
from canu_tpu_torch.utils.bitpack import revcomp_codes
from torch_cases import one_torch_thread  # noqa: F401  (autouse fixture)


def _evals_equal(got, want):
    assert len(got.placements) == len(want.placements)
    for p, q in zip(got.placements, want.placements):
        a, b = dataclasses.asdict(p), dataclasses.asdict(q)
        for key in ("anchor_a", "anchor_b"):
            np.testing.assert_array_equal(a.pop(key), b.pop(key))
        assert a == b
    skip = ("placements",)
    assert ({f.name: getattr(got, f.name) for f in dataclasses.fields(got) if f.name not in skip}
            == {f.name: getattr(want, f.name) for f in dataclasses.fields(want)
                if f.name not in skip})
    assert got.summary() == want.summary()


@pytest.mark.parametrize("seed,spec", [(5, [(800, 3)]), (6, None), (7, [(300, 4), (1200, 2)])])
def test_classify_genome_equal(seed, spec):
    g = random_genome(20_000, seed=seed, repeat_spec=spec)
    for k in (15, 21):
        (tr, tu), (jr, ju) = TB.classify_genome(g, k=k), JB.classify_genome(g, k=k)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tu, ju)


@pytest.mark.parametrize("circular", [False, True])
def test_ideal_contigs_and_ng50_equal(circular):
    g = random_genome(30_000, seed=7)
    _, tr = simulate_reads(g, coverage=6, mean_len=2000, min_len=1200, error_rate=0.05,
                           seed=8, circular=circular)
    jtr = JSIM.ReadTruth(tr.genome_len, tr.circular, tr.start, tr.end, tr.strand)
    for mo in (200, 500, 1500):
        iv = TB.ideal_contigs(tr, min_overlap=mo)
        np.testing.assert_array_equal(iv, JB.ideal_contigs(jtr, min_overlap=mo))
        assert TB.ng50(iv[:, 1] - iv[:, 0], 30_000) == JB.ng50(iv[:, 1] - iv[:, 0], 30_000)
    assert TB.ng50(np.zeros(0, np.int64), 10) == JB.ng50(np.zeros(0, np.int64), 10) == 0


def _cases():
    g = random_genome(30_000, seed=10)
    rng = np.random.default_rng(11)
    chim = np.concatenate([g[2_000:5_000], g[12_000:15_000]])  # jump > 5 kb: a misjoin
    collapse = np.concatenate([g[3_000:7_000], g[7_700:11_000]])
    noisy = revcomp_codes(mutate_read(g[20_000:24_000], 0.03, rng))
    wrap = np.concatenate([g[28_000:], g[:2_000]])
    return g, {"misjoin": [chim], "collapse": [collapse],
               "noisy_rc_and_clean": [noisy, g[1_000:5_000]], "circular_wrap": [wrap]}


G, CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_evaluate_assembly_equal(name):
    contigs = CASES[name]
    circular = name == "circular_wrap"
    got = TB.evaluate_assembly(G, contigs, k=21, circular=circular, device="cpu")
    want = JB.evaluate_assembly(G, contigs, k=21, circular=circular)
    _evals_equal(got, want)
    assert got.n_placed == len(contigs)
    if name == "misjoin":
        assert got.n_misjoins == 1 and len(got.placements) == 2
    if name == "collapse":
        # merged into one placement whose ruler charges the 700 bases
        assert got.n_misjoins == 0 and len(got.placements) == 1
        assert got.identity < 1.0 - 600 / 7_300
    if name == "circular_wrap":
        assert got.n_misjoins == 0 and got.identity > 0.995


def test_evaluate_with_truth_and_strings_equal():
    _, tr = simulate_reads(G, coverage=5, mean_len=2000, min_len=1200, error_rate=0.05,
                           seed=12, circular=False)
    jtr = JSIM.ReadTruth(tr.genome_len, tr.circular, tr.start, tr.end, tr.strand)
    from canu_tpu_torch.utils.bitpack import codes_to_seq

    contigs = [codes_to_seq(G[:9_000]), "ACGT" * 10]
    got = TB.evaluate_assembly(G, contigs, truth=tr, circular=False, device="cpu",
                               measure_identity=False)
    _evals_equal(got, JB.evaluate_assembly(G, contigs, truth=jtr, circular=False,
                                           measure_identity=False))
    assert got.n_placed == 1 and got.ideal_ng50 > 0


def test_ruler_big_padding_through_float32(monkeypatch):
    """A piece without anchors pads its centre line with BIG + ramp points
    (BIG = 1 << 24): as float32 those round to even, as canu_tpu's int32 ->
    float32 cast rounds them, and the interpolated centres, then the
    identities, equal canu_tpu's."""
    import jax.numpy as jnp

    seen = []
    interp = TAL._interp_grid  # the ruler hands the extension the centres' grid

    def spy(xa, xb, n_rows):
        seen.append((xa.clone(), xb.clone(), n_rows))
        return interp(xa, xb, n_rows)

    monkeypatch.setattr(TAL, "_interp_grid", spy)
    ctg = [G[4_000:6_500], revcomp_codes(G[10_000:14_000])]
    segs = []
    for imp in (TB, JB):
        segs.append([imp.Placement(0, 0, 2_500, 4_000, 6_500, False, 0),
                     imp.Placement(1, 0, 4_000, 10_000, 14_000, True, 2,
                                   anchor_a=np.array([0, 3_000], np.int64),
                                   anchor_b=np.array([0, 3_000], np.int64))])
    TB._segment_identity(ctg, G, segs[0], 21, device="cpu")
    JB._segment_identity(ctg, G, segs[1], 21)
    assert [s.identity for s in segs[0]] == [s.identity for s in segs[1]]
    assert segs[0][0].identity == 1.0 and segs[0][1].identity > 0.99
    (xa, xb, n_rows), = seen
    big = xa[0, 1:].numpy()
    assert big.min() == (1 << 24) + 1 and big.max() == (1 << 24) + 2047
    f_t = xa.to(torch.float32).numpy()
    f_j = np.asarray(jnp.asarray(xa.numpy()).astype(jnp.float32))
    np.testing.assert_array_equal(f_t, f_j)
    assert len(np.unique(f_t[0, 1:])) < 2047  # BIG + odd ramps round to even
    np.testing.assert_array_equal(
        TAL.expand_centers(interp(xa, xb, n_rows), n_rows).numpy(),
        np.asarray(JAL._interp_centers(jnp.asarray(xa.numpy()), jnp.asarray(xb.numpy()), None,
                                       n_rows)))
