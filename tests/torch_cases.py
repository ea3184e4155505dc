"""Shared helpers of the port's tests and chip_smoke.py; imports no jax.

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

from canu_tpu.sim.simulate import mutate_read


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
