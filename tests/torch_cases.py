"""Shared helpers of the port's tests and chip_smoke.py; imports nothing of
jax or canu_tpu.

``one_torch_thread``: an autouse fixture a test module imports to run its
torch CPU ops on one thread.  ``pack_pairs``, ``x8_cases`` and
``edge_cases``: the INF-walled extension's inputs as numpy arrays, held
against canu_tpu's banded extension on the CPU and against kernels K2
and K3 on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from canu_tpu_torch.sim.simulate import mutate_read


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run a module's torch CPU ops on one thread, then restore the count.

    The parity tests run thousands of tiny ops (row loops), in a lane of
    several pytest workers on a few cores.  There each worker's OpenMP
    pool oversubscribes the cores and waits on descheduled threads: the
    port's test files took 441 s together on 6 workers and 8 cores, and
    57 s with one thread each.  A module imports this fixture to use it.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pack_pairs(a_list, b_list, band):
    """Pairs as the extension's arrays (zero-padded, centres on the straight
    line to b's end, as canu_tpu's Pallas extension tests build them):
    (a, a_len, b, b_len, centers), n_rows."""
    B = len(a_list)
    n_rows = max(max(len(a) for a in a_list), 8)
    L = max(n_rows, max(len(b) for b in b_list)) + band
    a = np.zeros((B, L), np.uint8)
    b = np.zeros((B, L), np.uint8)
    al = np.zeros(B, np.int32)
    bl = np.zeros(B, np.int32)
    c = np.zeros((B, n_rows + 1), np.int32)
    for i, (aa, bb) in enumerate(zip(a_list, b_list)):
        a[i, : len(aa)] = aa
        b[i, : len(bb)] = bb
        al[i] = len(aa)
        bl[i] = len(bb)
        c[i, : len(aa) + 1] = np.round(np.linspace(0, len(bb), len(aa) + 1)).astype(np.int32)
        c[i, len(aa) + 1 :] = len(bb)
    return (a, al, b, bl, c), n_rows


def x8_cases(band):
    """The pairs of canu_tpu's tests/test_pallas_x8.py: one mixed group of 8
    (exact, prefix, B shorter, noisy, unrelated, longest, empty A, empty
    B) and 16 noisy pairs of 150-400 bases."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, 300).astype(np.uint8)
    y = rng.integers(0, 4, 250).astype(np.uint8)
    z = rng.integers(0, 4, 411).astype(np.uint8)
    a_list = [x, x[:150], x.copy(), y, rng.integers(0, 4, 64).astype(np.uint8), z,
              np.zeros(0, np.uint8), x[:40].copy()]
    b_list = [x.copy(), x.copy(), x[:150].copy(), mutate_read(y, 0.12, rng),
              rng.integers(0, 4, 80).astype(np.uint8), mutate_read(z, 0.05, rng),
              x[:40].copy(), np.zeros(0, np.uint8)]
    rng = np.random.default_rng(3)
    for _ in range(16):
        t = rng.integers(0, 4, int(rng.integers(150, 400))).astype(np.uint8)
        a_list.append(t)
        b_list.append(mutate_read(t, 0.10, rng))
    return pack_pairs(a_list, b_list, band)


def edge_cases(band, seed=5):
    """x8_cases plus extensions outside the Pallas kernels' contract that
    canu_tpu.ops.align.banded_extend still defines: INF-range failures
    (negative b_len, a_len past n_rows with B out of reach, a band that
    starts far off the diagonal), a_len < 0, b_len inside the row-0 band,
    b_len on the band edge, drifting centres and a row-0 start o(0) > 0."""
    (a, al, b, bl, c), n_rows = x8_cases(band)
    rng = np.random.default_rng(seed)
    k = 12
    ex = [np.repeat(v[:1], k, axis=0).copy() for v in (a, al, b, bl, c)]
    ea, eal, eb, ebl, ec = ex
    eal[:] = n_rows // 2
    ebl[:] = n_rows // 2
    ebl[0] = -3                         # B negative: every cell INF
    eal[1], ebl[1] = n_rows + 5, b.shape[1]  # A never exhausted, B out of reach
    ec[2] += 3 * band                   # band far right of the diagonal
    eal[3] = -1                         # negative A
    eal[4], ebl[4] = 7, band // 2       # B exhausted inside the row-0 band
    ebl[5] = band - 1
    ebl[6] = band
    for i in (7, 8):                    # drifting centres (slope clamp bites)
        ec[i] = np.concatenate([[0], np.cumsum(rng.integers(0, 7, n_rows))])
    ec[9] += band // 2 + 9              # o(0) > 0
    eal[10], ebl[10] = 0, n_rows        # empty A, long B
    eal[11], ebl[11] = n_rows, 0        # empty B, long A
    ea[:] = rng.integers(0, 4, ea.shape)
    return (np.concatenate([a, ea]), np.concatenate([al, eal]), np.concatenate([b, eb]),
            np.concatenate([bl, ebl]), np.concatenate([c, ec])), n_rows


# ---- the Myers engine (kernel K1) ------------------------------------------

NAMES = ("edits", "a_used", "b_used", "p_edits", "p_a", "p_b")


def mutate(rng, seq, er):
    """seq with ~er errors (40% deletions, 30% insertions, 30%
    substitutions), one base at a time."""
    out = []
    for c in seq:
        r = rng.random()
        if r < er * 0.4:
            continue
        elif r < er * 0.7:
            out += [int(c), int(rng.integers(0, 4))]
        elif r < er:
            out.append(int((c + 1 + rng.integers(0, 3)) % 4))
        else:
            out.append(int(c))
    return np.array(out, np.uint8)


def myers_cases(seed, B, n_rows, er=0.1, drift=False, lens=None):
    """B extensions of random reads with ~er error, as numpy arrays
    (a, a_len, b, b_len, centers): a uint8[B, n_rows], b uint8[B, n_rows +
    128]; lens = (a_lens, b_lens) overrides the first lengths."""
    rng = np.random.default_rng(seed)
    LB = n_rows + 128
    A = np.zeros((B, n_rows), np.uint8)
    Bb = np.zeros((B, LB), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    centers = np.zeros((B, n_rows + 1), np.int32)
    for i in range(B):
        la = int(rng.integers(n_rows // 2, n_rows + 1))
        base = rng.integers(0, 4, la).astype(np.uint8)
        mb = mutate(rng, base, er)[:LB]
        A[i, :la] = base
        Bb[i, : len(mb)] = mb
        a_len[i] = la
        b_len[i] = len(mb)
        if drift:
            step = (rng.random(n_rows) < 0.6).astype(np.int32)
            centers[i] = np.concatenate([[0], np.cumsum(step)])
        else:
            centers[i] = np.arange(n_rows + 1)
    if lens is not None:
        a_len[: len(lens[0])] = lens[0]
        b_len[: len(lens[1])] = lens[1]
    return A, a_len, Bb, b_len, centers


WINDOW_LENS = (1, 15, 16, 17, 31, 32, 33, 47, 48, 49)


def myers_edge_cases():
    """Kernel K1's edge cases: {name: ((a, a_len, b, b_len, centers),
    n_rows, keyword arguments of banded_extend_myers)}.

    K1 walks each A row and B read through 16-byte windows and the shifts
    through 32-bit words, so the cases put a_len, b_len and the widths of
    A and B on and beside every window edge, run the entering index past
    the end of B, and hold the shift at 1 (and at 0) for longer than a
    window."""
    rng = np.random.default_rng(11)
    cases = {}
    # empty A / B, b_len on each band word boundary, drifting centres
    B, n_rows = 64, 256
    A = rng.integers(0, 4, (B, n_rows)).astype(np.uint8)
    Bb = np.zeros((B, n_rows + 128), np.uint8)
    a_len = rng.integers(1, n_rows + 1, B).astype(np.int32)
    b_len = rng.integers(1, n_rows + 129, B).astype(np.int32)
    for i in range(B):  # B is A with ~10% substitutions, then random tail
        Bb[i, :n_rows] = np.where(rng.random(n_rows) < 0.1, rng.integers(0, 4, n_rows), A[i])
        Bb[i, n_rows:] = rng.integers(0, 4, 128)
    a_len[:4], b_len[:4] = [0, 0, 5, 0], [0, 9, 0, 300]
    b_len[4:12] = [32, 64, 96, 128, 127, 129, 255, 384]
    centers = np.broadcast_to(np.arange(n_rows + 1, dtype=np.int32), (B, n_rows + 1)).copy()
    for i in range(B // 2, B):
        centers[i] = np.concatenate([[0], np.cumsum(rng.random(n_rows) < 0.7)])
    cases["band_edges"] = ((A, a_len, Bb, b_len, centers), n_rows, {"partial_cap_q": 3000})
    # a_len and b_len on and beside the window edges, ragged rest; A and B
    # 150 and 251 wide (not multiples of 16)
    n = len(WINDOW_LENS)
    lens = (list(WINDOW_LENS) + list(WINDOW_LENS[::-1]), list(WINDOW_LENS[::-1]) + list(WINDOW_LENS))
    A, al, Bb, bl, c = myers_cases(21, 2 * n + 12, 150, er=0.1, drift=True, lens=lens)
    cases["window_lens"] = ((A, al, Bb[:, :251], np.minimum(bl, 251), c), 150,
                            {"partial_cap_q": 2000})
    # the entering index runs past LB - 1: B is 40 wide, the band moves on
    A, al, Bb, bl, c = myers_cases(22, 24, 160, er=0.1)
    c[:] = np.minimum(2 * np.arange(161), 400)[None, :]
    bl[: len(WINDOW_LENS)] = WINDOW_LENS
    cases["past_lb"] = ((A, al, Bb[:, :40].copy(), np.minimum(bl + 100, 400), c), 160,
                        {"partial_cap_q": 2000})
    # shift runs: slope 1 (a shift every row), slope 0 (none), and runs of
    # 40 rows of each, longer than an A or B window and than 32 rows
    A, al, Bb, bl, c = myers_cases(23, 30, 300, er=0.05)
    ramp = np.arange(301)
    c[10:20] = 0
    c[20:30] = (ramp // 80) * 40 + np.minimum(ramp % 80, 40)
    cases["shift_runs"] = ((A, al, Bb, bl, c), 300, {"partial_cap_q": 2400})
    # two row segments with max_rows truncation, and the 3-tuple result
    cases["segments"] = (myers_cases(24, 16, 700, er=0.12, drift=True), 700,
                         {"segment": 256, "max_rows": 600})
    return cases
