"""Kernel K9 (the vote engine's fold, one launch a DP group) against the
plain PyTorch fold, and the wrapper's contract.  This file imports no
jax, so it runs where jax is absent:

    python -m pytest --noconftest tests/test_torch_vote_fold_cuda.py

(``--noconftest``: tests/conftest.py imports jax).  The ``cuda``-marked
tests need a card and skip elsewhere; the others run anywhere.  The cases
come from torch_cases.py, shared with test_torch_vote_fold.py (which holds
the plain fold to canu_tpu on the CPU) and chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.ops import votepile as VP
from canu_tpu_torch.ops.kernels import votepile_cuda as K9
from canu_tpu_torch.sim.simulate import mutate_read
from torch_cases import (FOLD_CASES, FOLD_TILE_CASES, FOLD_WEIGHT_MAX, fold_case,  # noqa: F401
                         fold_exact_case, fold_tile_case, fold_tiles, one_torch_thread)

CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K9 is CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _fold_args(case, G: int, Lt: int, dev, seed: int = 3):
    """votes already holding votes (multiples of 1/4), the case's tensors
    on dev, its host columns and a fresh load."""
    js, t_sub, e_sub, cols = case
    votes = (np.random.default_rng(seed).integers(0, 4, (G, VP.N_CH, Lt)) * 0.25).astype(
        np.float32)
    return ([torch.from_numpy(x).to(dev) for x in (votes, js, t_sub, e_sub, cols)],
            np.ascontiguousarray(cols), np.zeros(G))


def _held(case, n_rows: int, G: int, Lt: int, dev, B: int = 256):
    """K9 on one launch of the case's jobs, and the plain fold chunk by
    chunk on the same tensors; both on dev."""
    (votes, js, t_sub, e_sub, cols), host, load = _fold_args(case, G, Lt, dev)
    ref = votes.clone()
    for lo in range(0, js.shape[0], B):
        ref = VP._fold_chunk(ref, js[lo : lo + B], t_sub[lo : lo + B], e_sub[lo : lo + B],
                             cols[:, lo : lo + B], n_rows, Lt, G)
    launches = K9.LAUNCHES
    got = VP._fold_group(votes, js, t_sub, e_sub, cols, host, n_rows, Lt, G, B, load)
    assert got is votes and K9.LAUNCHES == launches + 1  # one launch, in place
    torch.cuda.synchronize()
    return ref.cpu().numpy(), got.cpu().numpy()


# ---- the wrapper's contract (anywhere) --------------------------------------

def test_cpu_tensors_fold_chunk_by_chunk_and_never_launch():
    case = fold_case(1, 300, 256, 128, 8)
    (votes, js, t_sub, e_sub, cols), host, load = _fold_args(case, 8, 256, CPU)
    ref = votes.clone()
    for lo in range(0, 300, 64):
        ref = VP._fold_chunk(ref, js[lo : lo + 64], t_sub[lo : lo + 64], e_sub[lo : lo + 64],
                             cols[:, lo : lo + 64], 256, 256, 8)
    counts = (K9.LAUNCHES, VP.PLAIN_CUDA_FOLDS)
    got = VP._fold_group(votes, js, t_sub, e_sub, cols, host, 256, 256, 8, 64, load)
    assert (K9.LAUNCHES, VP.PLAIN_CUDA_FOLDS) == counts and not load.any()
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _wrapper_args(dev, n=40, n_rows=64, G=4):
    (votes, js, t_sub, e_sub, cols), host, load = _fold_args(
        fold_case(2, n, n_rows, 32, G), G, n_rows, dev)
    return {"votes": votes, "js": js, "t_sub": t_sub, "e_sub": e_sub, "cols": cols,
            "n_rows": n_rows, "t_mask": n_rows - 1, "host_cols": host, "load": load}


def _weights(args, w, slot=None):
    host = args["host_cols"].copy()
    host[8] = np.asarray(w, np.float32).view(np.int32)
    if slot is not None:
        host[7] = slot
    return host


# what the wrapper must refuse (a change to its keyword arguments, the
# exception and the message it names), whatever the device
REFUSALS = {
    "n_rows 0": ({"n_rows": 0}, ValueError, "rows"),
    "votes 2-D": ({"votes": lambda a: a["votes"][:, 0]}, ValueError, "votes must be"),
    "votes 14 channels": ({"votes": lambda a: a["votes"][:, :14]}, ValueError, "votes must be"),
    "votes float64": ({"votes": lambda a: a["votes"].double()}, TypeError, "dtype"),
    "votes not contiguous": ({"votes": lambda a: a["votes"][..., ::2]}, ValueError,
                             "contiguous"),
    "js int64": ({"js": lambda a: a["js"].long()}, TypeError, "dtype"),
    "js one row short": ({"js": lambda a: a["js"][:, :-1].contiguous()}, ValueError, "shape"),
    "t_sub int32": ({"t_sub": lambda a: a["t_sub"].int()}, TypeError, "dtype"),
    "e_sub 1-D": ({"e_sub": lambda a: a["e_sub"][0]}, ValueError, "2-D"),
    "cols 8 rows": ({"cols": lambda a: a["cols"][:8]}, ValueError, "shape"),
    "host_cols int64": ({"host_cols": lambda a: a["host_cols"].astype(np.int64)}, ValueError,
                        "host_cols"),
    "load of another block": ({"load": lambda a: np.zeros(5)}, ValueError, "slots"),
    "negative t_mask": ({"t_mask": -1}, ValueError, "t_mask"),
    "weight 0.3 (not a multiple of 2^-7)": ({"host_cols": lambda a: _weights(a, 0.3)},
                                            ValueError, "multiples of 2"),
    "weight -1": ({"host_cols": lambda a: _weights(a, -1.0)}, ValueError, "multiples of 2"),
    "weight nan": ({"host_cols": lambda a: _weights(a, np.nan)}, ValueError, "multiples of 2"),
    "weight inf": ({"host_cols": lambda a: _weights(a, np.inf)}, ValueError, "multiples of 2"),
    "a slot's sums reach 2^17": ({"host_cols": lambda a: _weights(a, 300.0, 1)}, ValueError,
                                 "below 2"),
    "the block's earlier sums reach 2^17": (
        {"load": lambda a: np.full(4, 2.0 ** 17 - 10)}, ValueError, "below 2"),
}


def _refused(dev, case):
    args = _wrapper_args(dev)
    change, exc, msg = REFUSALS[case]
    args.update({k: v(args) if callable(v) else v for k, v in change.items()})
    load = args["load"].copy()
    launches = K9.LAUNCHES
    with pytest.raises(exc, match=msg):
        K9.vote_fold(**args)
    assert K9.LAUNCHES == launches
    np.testing.assert_array_equal(args["load"], load)  # nothing counted


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    _refused(CPU, case)


def test_wrapper_refuses_host_tensors_instead_of_falling_back():
    args = _wrapper_args(CPU)
    launches = K9.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        K9.vote_fold(**args)
    assert K9.LAUNCHES == launches


def test_exact_weights_pass_and_count_their_bound():
    """Every weight the engine makes (0, 1 and 1 + q / 256 rounded to
    bfloat16) passes; each slot's bound grows by 15 x its rounded weights,
    and a slot off the block counts nothing."""
    q = np.arange(256)
    w = np.concatenate([[0.0, 1.0, FOLD_WEIGHT_MAX], 1.0 + q / 256.0]).astype(np.float32)
    slot = np.arange(len(w)) % 5  # slot 4 is off a block of 4
    host = np.zeros((9, len(w)), np.int32)
    host[7], host[8] = slot, w.view(np.int32)
    load = np.zeros(4)
    K9.add_load(host, load)
    r = K9.rounded_weights(host[8]).astype(np.float64)
    assert (r * 128 == np.round(r * 128)).all() and r.max() == 2.0
    np.testing.assert_array_equal(load, [15 * r[slot == s].sum() for s in range(4)])
    K9.add_load(host, load)  # a second group of the block adds to it
    np.testing.assert_array_equal(load, [30 * r[slot == s].sum() for s in range(4)])


def _case(name: str):
    """(js, t_sub, e_sub, cols, n_rows, Lt, G) of a FOLD_CASES or
    FOLD_TILE_CASES entry."""
    if name in FOLD_CASES:
        n, n_rows, band, G = FOLD_CASES[name]
        return (*fold_case(sum(map(ord, name)), n, n_rows, band, G), n_rows, n_rows, G)
    return fold_tile_case(name)


@pytest.mark.parametrize("name", [*FOLD_CASES, *FOLD_TILE_CASES])
def test_slot_order_lists_the_voting_jobs_by_slot(name):
    """slot_order: G + 1 offsets, then every job that votes (t_span above
    0, a bfloat16 weight other than 0, its slot on the block) and no
    other, by slot and, within a slot, in group order; a slot with no
    voting job keeps an empty range."""
    _, _, _, cols, _, _, G = _case(name)
    G2 = 2 * G  # the cases' slots lie in -1..G: slots G + 1 .. 2G - 1 hold no job
    order = K9.slot_order(cols, G2)
    assert order.dtype == np.int32
    offsets, jobs = order[: G2 + 1], order[G2 + 1 :]
    w = K9.rounded_weights(cols[8])
    votes = (cols[3] > 0) & (w != 0) & (cols[7] >= 0) & (cols[7] < G2)
    assert offsets[0] == 0 and offsets[-1] == len(jobs) == votes.sum()
    for s in range(G2):
        mine = jobs[offsets[s] : offsets[s + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(votes & (cols[7] == s)))
    assert (offsets[G + 1 :] == len(jobs)).all()
    if name == "pads and slots off the block":
        assert (~votes).sum() > 20  # pads, weights of 0 and -0, slots -1 and G left out


@pytest.mark.parametrize("tile", [128, 32])
@pytest.mark.parametrize("name", [*FOLD_CASES, *FOLD_TILE_CASES])
def test_tile_model_equals_the_plain_fold(name, tile):
    """fold_tiles, the numpy model of K9's tiling (a slot's tile of columns
    from its jobs' rows on the tile, the deletion counts inside it and the
    run open at its right end carried past it), equals _fold_chunk chunk
    by chunk, at the kernel's tile width and at one that cuts more runs."""
    js, t_sub, e_sub, cols, n_rows, Lt, G = _case(name)
    (votes, *t), _, _ = _fold_args((js, t_sub, e_sub, cols), G, Lt, CPU)
    ref = votes.clone()
    for lo in range(0, js.shape[0], 256):
        ref = VP._fold_chunk(ref, *(x[lo : lo + 256] for x in t[:3]), t[3][:, lo : lo + 256],
                             n_rows, Lt, G)
    got = fold_tiles(votes.numpy(), js, t_sub, e_sub, cols, n_rows, Lt, G, tile)
    np.testing.assert_array_equal(got, ref.numpy())
    assert (got != votes.numpy()).sum() > 1000


# ---- K9 on the card ----------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", [*FOLD_CASES, "exact"])
def test_kernel_matches_plain_on_cases(cuda_device, name):
    if name == "exact":
        case, n_rows, G = fold_exact_case(256, 256, 128), 256, 8
    else:
        n, n_rows, band, G = FOLD_CASES[name]
        case = fold_case(sum(map(ord, name)), n, n_rows, band, G)
    ref, got = _held(case, n_rows, G, n_rows, cuda_device, B=64)
    np.testing.assert_array_equal(got, ref)
    if name == "exact":
        assert got[0, VP.CH_DEL, 0] - ref[0, VP.CH_DEL, 0] == 0 and ref[0, VP.CH_DEL, 0] >= 7650


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FOLD_TILE_CASES))
def test_kernel_matches_plain_on_tile_edges(cuda_device, name):
    """Runs of deletions across a tile's edge and past 15, an undeleted
    run longer than a tile, a run past Lt, one slot for every job, slots
    interleaved, pads and off-block slots, Lt below the tile width, t_bgn
    bits above t_mask: one launch each."""
    js, t_sub, e_sub, cols, n_rows, Lt, G = fold_tile_case(name)
    ref, got = _held((js, t_sub, e_sub, cols), n_rows, G, Lt, cuda_device, B=32)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("Lt", [200, 300, 512])
def test_kernel_matches_plain_at_other_block_widths(cuda_device, Lt):
    """Lt other than n_rows: columns past a narrower block dropped, a
    shift mask wider than the rows."""
    ref, got = _held(fold_case(8, 300, 256, 128, 8), 256, 8, Lt, cuda_device, B=64)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 17])
def test_kernel_matches_plain_at_real_geometry(cuda_device, chunks):
    """The correction's geometry: G 256, Lt 2,048, chunks of 256 jobs, W_e
    3,072 (band 256), a group of 1 and of 17 chunks in one launch."""
    case = fold_case(100 + chunks, 256 * chunks, 2048, 256, 256)
    ref, got = _held(case, 2048, 256, 2048, cuda_device)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_wrapper_refuses_on_card(cuda_device, case):
    _refused(cuda_device, case)


@pytest.mark.cuda
def test_pile_votes_launches_k9_once_a_group(cuda_device, monkeypatch):
    """pile_votes on the card (K4, then K9 once a DP group, the plain fold
    never) gives the CPU's votes (the plain DP and fold) on mutated reads
    with QV weights, in groups of 3 chunks of 32 jobs."""
    from canu_tpu_torch.ops.kernels import trace_cuda as K4

    rng = np.random.default_rng(4)
    tmpl = [rng.integers(0, 4, int(rng.integers(150, 257))).astype(np.uint8) for _ in range(10)]
    ev, jobs = [], {k: [] for k in ("t_idx", "e_idx", "t_bgn", "t_span", "e_lo", "e_span",
                                    "flipped", "slot")}
    for j in range(200):
        ti = int(rng.integers(0, 10))
        bgn = int(rng.integers(0, 30))
        span = len(tmpl[ti]) - bgn
        e = np.concatenate([rng.integers(0, 4, 20), mutate_read(tmpl[ti][bgn:], 0.12, rng),
                            rng.integers(0, 4, 20)]).astype(np.uint8)[:512]
        ev.append(e)
        for k, v in zip(jobs, (ti, j, bgn, span, 15, len(e) - 15, False, ti % 8)):
            jobs[k].append(v)
    cols = {k: np.array(v, bool if k == "flipped" else np.int32) for k, v in jobs.items()}
    weight = (1.0 + rng.integers(5, 41, 200) / 256.0).astype(np.float32)
    monkeypatch.setattr(VP, "CHUNK_CELL_BUDGET", 32 * 256)
    monkeypatch.setattr(VP, "GROUP_BYTE_BUDGET", (3 * 32 + 1) * K4.scratch_bytes(1, 256, 256))
    out = {}
    for dev in (CPU, cuda_device):
        tt, tl, _ = VP.segment_codes_plane(tmpl, 256, dev)
        te, tel, _ = VP.segment_codes_plane(ev, 512, dev)
        counts = (K9.LAUNCHES, VP.GROUPS, VP.PLAIN_CUDA_FOLDS)
        out[dev.type] = VP.pile_votes(tt, tl, te, tel, VP.VoteJobs(**cols, weight=weight), 8,
                                      256, ends_free=True).cpu().numpy()
        launches, groups, plain = (a - b for a, b in zip(
            (K9.LAUNCHES, VP.GROUPS, VP.PLAIN_CUDA_FOLDS), counts))
        assert groups == 3 and plain == 0
        assert launches == (groups if dev.type == "cuda" else 0)
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    assert out["cpu"].sum() > 0
