"""Shared helpers of the port's tests and chip_smoke.py; imports nothing of
jax or canu_tpu.

``one_torch_thread``: an autouse fixture a test module imports to run its
torch CPU ops on one thread.  ``pack_pairs``, ``x8_cases`` and
``edge_cases``: the INF-walled extension's inputs as numpy arrays, held
against canu_tpu's banded extension on the CPU and against kernels K2
and K3 on the card; ``extend_exit_rows``: the row after which each
extension's outputs are fixed, where K2 and K3 stop (the tests check the
argument; chip_smoke.py counts the kernels' bound up to it).
``myers_edge_cases``: kernel K1's; ``trace_cases``: the vote engine's
DP's (ops.trace.align_positions_lean), held against canu_tpu's on the CPU
and kernel K4 against the plain version on the card; ``dp_group_case``
and ``DP_GROUP_CASES``: K4 launches of thousands of jobs whose t_len
runs over every row (``mostly_short``: most of them short), held to the
plain version on the card; ``FOLD_CASES`` / ``fold_case`` and
``fold_exact_case``: the vote fold's inputs as the DP leaves them, with
every odd spot planted, held against canu_tpu's fold on the CPU and
kernel K9 against the plain fold on the card; ``FOLD_TILE_CASES`` /
``fold_tile_case``: K9's tile edges planted on them, and ``fold_tiles``:
a numpy model of K9's tiling, held to the plain fold on the CPU;
``k1_rows_plain``:
the plain rows of one K1 launch, cut into segments that run at once from
given carries (a long launch held to the plain loop at the cost of one
segment of it).
``candidate_sample`` and
``store_rows_of_pairs``: a sample of a candidate list and a store's rows
for it, which stand in for a full verify where the reference cannot run
one (chip_smoke.py's ecoli phase; scripts/torch_ecoli_reference.py).
``template_sample``, ``pairs_of_reads`` and ``store_of_templates``: the
template sample of an E. coli-scale correction, the candidates and store
rows it needs, which stand in for a full correction where the reference
cannot run one (chip_smoke.py's ecolicor phase;
scripts/torch_ecoli_correction_reference.py;
test_torch_ecoli_correction_sample.py shows the sample sound).
``corrected_digest``: the digest of a block of corrected reads that
chip_smoke.py's correct phase holds against
scripts/torch_correction_reference.py's.  ``assembly_digests``: the
gates of a trimming + assembly run (trimmed reads, utg and adjusted
stores, RED corrections, unitig and contig layouts, the output FASTA
files, layout.tsv and the GFA), which chip_smoke.py's assemble phase
holds against scripts/torch_assembly_reference.py's, and
``write_assembly_reads``: the read sets of ASSEMBLY_RUNS both of them
assemble; ``identity_vs_genome`` and ``largest_contig_identity``: a
contig's identity to the simulated genome, which both hold against the
same measure of the reference's contig.  ``gfa_cases``, ``gfa_tigs``,
``gfa_store``, ``GFA_STORE_ROWS``: test_gfa.py's links, which the GFA
parity tests and chip_smoke.py's card check of write_gfa share.
``SKETCH_EDGE_CASES`` / ``sketch_edge_case`` and ``MATCH_EDGE_CASES`` /
``match_edge_case``: the MinHash sketch's and block matcher's edge
blocks, held against canu_tpu on the CPU and kernels K5 and K6 against
the plain versions on the card (chip_smoke.py's phase 3e too);
``MATCH_PAIR_CASES`` / ``match_pair_case``: K6's block pairs at the
pipeline's edges (1 x 1 to 1,024 x 1, Na above 1,024 and 2,048, Nb past
32 column tiles, max_out 0 and below n_found);
``frequent_reads`` and ``candidates_digest``: the read sets of
chip_smoke.py's frequent-mer phase (4c) and
scripts/torch_frequent_reference.py, and the digest of their candidates.
``tools_session``, ``tools_setup`` and ``run_tools_session``: the tools
CLI's scripted session, whose step records (``tools_record``:
exit code, stdout, stderr, ``file_digest`` of each file made) chip_smoke.py's
tools phase holds against scripts/torch_tools_reference.py's and
test_torch_tools.py holds against canu_tpu's; ``db22_loaded_as_saved``:
the k=22 DB steps' load for canu_tpu's side.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
from types import SimpleNamespace

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


def extend_exit_rows(a, a_len, b, b_len, centers, band, n_rows):
    """The INF-walled extension's exit rows, read off banded_extend_plain's
    rows through its on_row hook (torch tensors, any device).

    Every cell of row i is at least min(smallest cell of row i-1, INF), so
    once a row's smallest cell exceeds the best "B exhausted" cost found so
    far (best_bx < INF), no later row can lower either capture, and the
    outputs are (best_bx, aend_bx, bend_bx).  Returns (exit, at_exit, final,
    fell): exit int64[B] the first row i >= 1 after which that holds (-1:
    none before min(a_len, n_rows)); at_exit the three captures at that row
    (those of row 0 where exit is -1); final banded_extend_plain's
    (edits, a_used, b_used); fell bool[B], set where a live row's smallest
    cell was below the row before's."""
    from canu_tpu_torch.ops import align as AL

    st = {}

    def on_row(i, D, live, best, aend, bend):
        row_min = D.min(dim=1).values
        if i == 0:
            st.update(prev=row_min, at=(best, aend, bend), fell=torch.zeros_like(live),
                      exit=torch.full(live.shape, -1, dtype=torch.int64, device=D.device))
            return
        st["fell"] = st["fell"] | (live & (row_min < st["prev"]))
        st["prev"] = torch.where(live, row_min, st["prev"])
        new = live & (st["exit"] < 0) & (row_min > best)
        st["exit"] = torch.where(new, i, st["exit"])
        st["at"] = tuple(torch.where(new, x, y) for x, y in zip((best, aend, bend), st["at"]))

    final = AL.banded_extend_plain(a, a_len, b, b_len, centers, band, n_rows, on_row=on_row)
    return st["exit"], st["at"], final, st["fell"]


# ---- the Myers engine (kernel K1) ------------------------------------------

def homopolymer_template(rng, n):
    """Runs of 2-7 equal bases: deletions and insertions in a run tie."""
    out = []
    while len(out) < n:
        out += [int(rng.integers(0, 4))] * int(rng.integers(2, 8))
    return np.array(out[:n], np.uint8)


def trace_cases(seed: int, n_rows: int, band: int):
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
    h = homopolymer_template(rng, n_rows // 2)
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


# kernel K4 against the plain DP on the card: (jobs, n_rows, band,
# ends_free, mostly_short); n_rows = 32, 64, 96 and 2,016 are 1, 2, 3 and 63
# super-rows, bands 1, 128, 129 (the switch from 8 to 12 cells a lane) and
# 256, launches of 1,000 and 4,096 jobs
DP_GROUP_CASES = ((1000, 256, 256, True, False), (4096, 128, 128, False, True),
                  (1000, 32, 129, True, True), (1000, 64, 1, False, False),
                  (1000, 96, 128, False, True), (4096, 256, 1, True, True),
                  (300, 2016, 256, True, True), (300, 2016, 129, False, False))


def dp_group_case(seed: int, B: int, n_rows: int, band: int, mostly_short: bool):
    """(t, t_len, e, e_len) of B vote-engine jobs: the first min(B, n_rows +
    7) jobs' t_len run evenly from -2 to n_rows + 4 (every row when B
    allows: meeting rows of both parities, lengths past either end), the
    rest t_len uniform in [0, n_rows] or, mostly_short, four in
    five of them at most n_rows // 8; the evidence a 12% mutated copy of
    the template's window between random flanks, and one job in eight an
    e_len drawn from [-2, LE + 9] (past the evidence, empty, negative)."""
    rng = np.random.default_rng(seed)
    LE = n_rows + max(band, n_rows // 2)
    t = rng.integers(0, 4, (B, n_rows)).astype(np.uint8)
    tl = rng.integers(0, n_rows + 1, B).astype(np.int32)
    if mostly_short:
        short = rng.random(B) < 0.8
        tl[short] = rng.integers(0, n_rows // 8 + 1, int(short.sum()))
    k = min(B, n_rows + 7)
    tl[:k] = -2 + np.arange(k) * (n_rows + 6) // max(k - 1, 1)
    e = np.zeros((B, LE), np.uint8)
    el = np.zeros(B, np.int32)
    for b in range(B):
        core = t[b, : max(0, min(int(tl[b]), n_rows))].copy()
        hit = rng.random(len(core)) < 0.12
        core[hit] = rng.integers(0, 4, int(hit.sum()))
        ev = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 12))), core,
                             rng.integers(0, 4, int(rng.integers(0, 12)))])[:LE]
        e[b, : len(ev)] = ev
        el[b] = len(ev)
    odd = rng.random(B) < 0.125
    el[odd] = rng.integers(-2, LE + 10, int(odd.sum()))
    return t, tl, e, el


# ---- the vote fold (kernel K9) ----------------------------------------------

# fold cases: (jobs, n_rows = Lt, band, G); W_e = n_rows + max(band, n_rows // 2)
# (8,192 rows: a deleted run of 16-40 rows can lie inside one thread's
# 32-row segment of K9)
FOLD_CASES = {"odd 300 x 256": (300, 256, 128, 8), "odd 600 x 512": (600, 512, 256, 16),
              "odd 97 x 64": (97, 64, 32, 4), "odd 40 x 8192": (40, 8192, 256, 4)}
FOLD_WEIGHT_MAX = 1.9921875  # the largest bfloat16 below 2 (a weight 1 + meanQV / 256)


def fold_case(seed: int, n: int, n_rows: int, band: int, G: int):
    """The vote fold's inputs for n jobs, as the DP leaves them, with every
    odd spot planted: (js int32[n, n_rows + 1], t_sub uint8[n, n_rows],
    e_sub uint8[n, W_e], cols int32[9, n]: t_idx = e_idx = the job, t_bgn,
    t_span, e_lo 0, e_span, flipped 0, slot, the weight's float32 bits).

    Templates with homopolymer runs (a base repeats with chance 0.35), and
    in a third of the jobs a run of 16-40 rows whose rows all delete (dj
    0), in one job the run ending at the last row; steps dj of 0-4 (dj >=
    3 the second insertion); paths starting at 0 and idle there, running
    to e_span and past W_e; e_span from W_e / 2 to past W_e; t_span from 0
    to past n_rows (rows past it vote nothing); t_bgn mostly small, a
    quarter with bits above log_rounds(n_rows) set, one negative; pad jobs
    (t_span 0, weight 0); slots over 0..G-1, one off the block; weights 1
    + q / 256 (q in 0..255) and the largest below 2."""
    rng = np.random.default_rng(seed)
    W_e = n_rows + max(band, n_rows // 2)
    change = rng.random((n, n_rows)) >= 0.35
    long_run = rng.random(n) < 1 / 3
    long_run[0] = long_run[1] = True
    run_len = rng.integers(16, 41, n)
    run_at = rng.integers(0, max(1, n_rows - 41), n)
    run_at[1] = n_rows - run_len[1]  # a deleted run reaching the last row
    rows = np.arange(n_rows)[None, :]
    in_run = long_run[:, None] & (rows >= run_at[:, None]) & (rows < (run_at + run_len)[:, None])
    change[in_run & (rows > run_at[:, None])] = False  # one template run
    change[:, 0] = True
    t_sub = (np.cumsum(change * rng.integers(1, 4, (n, n_rows)), axis=1) % 4).astype(np.uint8)
    dj = rng.choice(5, (n, n_rows), p=[0.12, 0.66, 0.12, 0.06, 0.04]).astype(np.int64)
    dj[in_run] = 0
    js0 = rng.integers(0, 12, n)
    idle = rng.random(n) < 0.1  # paths idle at 0 for their first rows
    js0[idle] = 0
    dj[idle, : 6] = 0
    js = np.concatenate([js0[:, None], js0[:, None] + np.cumsum(dj, axis=1)], axis=1)
    runaway = rng.random(n) < 0.1  # paths running past the window
    runaway[:2] = False
    js[runaway] += W_e // 2
    e_sub = rng.integers(0, 4, (n, W_e)).astype(np.uint8)
    cols = np.zeros((9, n), np.int32)
    cols[0] = cols[1] = np.arange(n)
    t_bgn = rng.integers(0, max(1, n_rows // 4), n)
    high = rng.random(n) < 0.25
    t_bgn[high] += n_rows * rng.integers(1, 6, int(high.sum()))
    t_bgn[2] = -3
    cols[2] = t_bgn
    t_span = rng.integers(0, n_rows + 11, n)
    full = rng.random(n) < 0.4
    t_span[full] = n_rows
    t_span[:2] = n_rows
    t_span[6] = n_rows + 7
    cols[3] = t_span
    cols[5] = rng.integers(W_e // 2, W_e + 51, n)
    cols[5][:2] = W_e + 10  # the long deleted runs stay inside the evidence
    cols[7] = rng.integers(0, G, n)
    cols[7][3] = G  # off the block: votes nothing
    w = (1.0 + rng.integers(0, 256, n) / 256.0).astype(np.float32)
    w[4] = FOLD_WEIGHT_MAX
    pad = rng.random(n) < 0.05
    pad[:2] = False
    pad[5] = True
    cols[3][pad] = 0
    w[pad] = 0.0
    cols[8] = w.view(np.int32)
    return js.astype(np.int32), t_sub, e_sub, cols


def fold_exact_case(n: int, n_rows: int, band: int):
    """n jobs of slot 0 voting one column with all they can: a template run
    of 20 rows at row 0 that every job deletes (its count clamped to 15)
    at the largest weight below 2, t_bgn 0: the column's deletion votes sum
    to 15 x n x FOLD_WEIGHT_MAX (7,650 for 256 jobs), the exactness
    condition's case."""
    W_e = n_rows + max(band, n_rows // 2)
    t_sub = np.tile((np.arange(n_rows) % 4).astype(np.uint8), (n, 1))
    t_sub[:, :20] = 2
    dj = np.ones((n, n_rows), np.int64)
    dj[:, :20] = 0
    js = np.concatenate([np.full((n, 1), 5), 5 + np.cumsum(dj, axis=1)], axis=1)
    e_sub = np.tile((np.arange(W_e) % 4).astype(np.uint8), (n, 1))
    cols = np.zeros((9, n), np.int32)
    cols[0] = cols[1] = np.arange(n)
    cols[3] = n_rows
    cols[5] = W_e - 1
    cols[8] = np.full(n, FOLD_WEIGHT_MAX, np.float32).view(np.int32)
    return js.astype(np.int32), t_sub, e_sub, cols


# kernel K9's tile edges (a block owns one slot's tile of 64 template
# columns; the planted edges sit at 32, 64, 128 and 256): name -> (seed,
# jobs, n_rows, band, G, Lt) of fold_tile_case
FOLD_TILE_CASES = {
    "deleted runs across tile edges": (21, 64, 512, 128, 4, 512),
    "undeleted run longer than a tile": (22, 48, 512, 128, 4, 512),
    "run past Lt": (23, 64, 256, 128, 4, 200),
    "every job in one slot": (24, 90, 256, 128, 8, 256),
    "slots interleaved in job order": (25, 96, 256, 128, 8, 256),
    "pads and slots off the block": (26, 80, 256, 128, 8, 256),
    "Lt below the tile, not a multiple of it": (27, 60, 128, 64, 4, 100),
    "t_bgn bits above t_mask": (28, 70, 256, 128, 4, 300),
}


def fold_tile_case(name: str):
    """FOLD_TILE_CASES[name]'s fold inputs: fold_case's jobs with the named
    spot planted.  Returns (js, t_sub, e_sub, cols, n_rows, Lt, G)."""
    seed, n, n_rows, band, G, Lt = FOLD_TILE_CASES[name]
    js, t_sub, e_sub, cols = fold_case(seed, n, n_rows, band, G)
    rng = np.random.default_rng(seed)
    W_e = e_sub.shape[1]

    def plant(b, t_bgn, runs, dels, slot=0, t_span=n_rows):
        """Job b at t_bgn: template runs [lo, hi) of one base each, deletion
        rows (dj 0) at `dels`, dj 1 elsewhere, inside the evidence."""
        t = (np.arange(n_rows) % 4).astype(np.uint8)
        for lo, hi in runs:
            t[lo:hi] = t[lo - 1] ^ 1 if lo else 1
            if hi < n_rows:
                t[hi] = t[hi - 1] ^ 2
        t_sub[b] = t
        dj = np.ones(n_rows, np.int64)
        dj[list(dels)] = 0
        js[b] = np.concatenate([[2], 2 + np.cumsum(dj)]).astype(np.int32)
        cols[2, b], cols[3, b], cols[5, b], cols[7, b] = t_bgn, t_span, W_e - 1, slot
        cols[8, b] = np.float32(1.0 + b / 256.0).view(np.int32)

    if name == "deleted runs across tile edges":
        # columns = rows (t_bgn 0): runs over the edges at 32, 64, 128, 256
        plant(0, 0, [(100, 140)], range(100, 140))  # 40 deleted rows over 128: clamped
        plant(1, 0, [(120, 136)], range(120, 136))  # 16 over 128, from 8 rows before it
        plant(2, 0, [(128, 150)], range(130, 140))  # a run starting on the edge
        plant(3, 0, [(127, 150)], range(128, 131))  # a run starting on a tile's last row
        plant(4, 0, [(250, 270)], [252, 260])  # two deletions across 256
        plant(5, 7, [(60, 70), (121, 140)], list(range(60, 68)) + list(range(121, 138)),
              slot=1)  # shifted: the run at 121 crosses column 128 at row 121
    elif name == "undeleted run longer than a tile":
        plant(0, 0, [(10, 310)], [])  # 300 rows, no deletion
        plant(1, 0, [(10, 310)], range(250, 261))  # its deletions 2 tiles past its start
        plant(2, 5, [(0, 400)], range(390, 420))  # from row 0; the last rows past the run
        plant(3, 0, [(100, 400)], [399])  # one deletion on its last row
        # deletions on the rows a walk past a tile of 32, 64, 128 or 256 starts at
        plant(4, 0, [(10, 310)], [64, 96, 128, 160, 161, 224, 256, 288])
        plant(5, 0, [(100, 300)], range(225, 261), t_span=230)  # rows from T on do not count
    elif name == "run past Lt":
        # Lt 200: rows from Lt - t_bgn on land past the block, yet count
        plant(0, 150, [(40, 80)], range(45, 80))  # the run's start at column 190
        plant(1, 150, [(49, 60)], range(50, 60))  # starts on the block's last column
        plant(2, 199, [(0, 30)], range(0, 30))  # only row 0 lands on the block
        plant(3, 0, [(190, 256)], range(195, 256))  # to the path's last row
    elif name == "every job in one slot":
        cols[7] = 0
    elif name == "slots interleaved in job order":
        cols[7] = np.arange(n) % G
    elif name == "pads and slots off the block":
        pad = rng.random(n) < 0.3
        cols[3][pad] = 0
        cols[8][pad] = np.float32(0.0).view(np.int32)
        cols[7][rng.random(n) < 0.15] = G
        cols[7][rng.random(n) < 0.1] = -1
        cols[8][7] = np.float32(-0.0).view(np.int32)  # a weight of -0: votes nothing
        cols[3][8] = 40  # t_span > 0 at weight 0
        cols[8][8] = 0
    elif name == "t_bgn bits above t_mask":
        # Lt 300: t_mask 511; t_bgn's bits above it dropped, as the plain shift drops them
        cols[2] = rng.integers(0, 512, n) + 512 * rng.integers(-4, 5, n)
        cols[2][:4] = [511 + 1024, 299 + 512, 256 - 2048, -1]
    return js, t_sub, e_sub, cols, n_rows, Lt, G


def fold_tiles(votes, js, t_sub, e_sub, cols, n_rows: int, Lt: int, G: int, tile: int):
    """A numpy model of kernel K9's tiling: the fold (ops.votepile
    ._fold_chunk's votes) added into votes float32[G, 15, Lt], computed
    for each (slot, tile of `tile` columns) from the jobs of that slot in
    group order, their rows that land on the tile, the deletion counts at
    each run start inside the tile, and the run open at the tile's right
    end carried by a walk past it, 32 rows a step, that stops at a run
    start, at min(t_span, n_rows) or at 15 deletion rows."""
    out = votes.copy()
    W_e = e_sub.shape[1]
    t_mask = (1 << max(0, int(Lt - 1).bit_length())) - 1
    w_all = torch.from_numpy(np.ascontiguousarray(cols[8])).view(torch.float32)
    w_all = w_all.to(torch.bfloat16).to(torch.float32).numpy()
    slot = cols[7].astype(np.int64)
    votes_of = (cols[3] > 0) & (w_all != 0) & (slot >= 0) & (slot < G)
    order = np.flatnonzero(votes_of)
    order = order[np.argsort(slot[order], kind="stable")]

    def deleted(b, rows, e_span):
        j0, j1 = js[b, rows].astype(np.int64), js[b, rows + 1].astype(np.int64)
        return (j1 > 0) & (j0 < e_span) & (j1 == j0)

    for s in range(G):
        jobs = order[slot[order] == s]
        for c0 in range(0, Lt, tile):
            acc = np.zeros((15, tile), np.float32)
            met = False
            for b in jobs:
                T = min(int(cols[3, b]), n_rows)
                tm = int(np.int64(cols[2, b]) & t_mask)
                lim, r0 = min(Lt - tm, T), c0 - tm
                if r0 >= lim or r0 + tile <= 0:
                    continue
                met = True
                e_span = min(int(cols[5, b]), W_e - 1)
                rows = r0 + np.arange(tile)
                ok = (rows >= 0) & (rows < T)
                r = rows[ok]
                start = np.ones(tile, bool)
                start[ok] = (r == 0) | (t_sub[b, r] != t_sub[b, np.maximum(r - 1, 0)])
                d = np.zeros(tile, np.int64)
                d[ok] = deleted(b, r, e_span)
                carry = 0
                last = rows[start].max() if start.any() else -1
                if r0 + tile < T and 0 <= last < lim:
                    p0 = r0 + tile
                    while True:
                        p = p0 + np.arange(32)
                        on = p < T
                        q = p[on]
                        st = np.ones(32, bool)
                        st[on] = t_sub[b, q] != t_sub[b, q - 1]
                        dd = np.zeros(32, bool)
                        dd[on] = deleted(b, q, e_span)
                        first = int(np.argmax(st)) if st.any() else 32
                        carry += int(dd[:first].sum())
                        if st.any() or carry >= 15:
                            break
                        p0 += 32
                seg = np.cumsum(start) - 1  # each row's run, counted from the tile's first start
                del_at = np.zeros(tile, np.int64)
                if start.any():
                    live = seg >= 0
                    per = np.bincount(seg[live], weights=d[live], minlength=int(seg[-1]) + 1)
                    per = per.astype(np.int64)
                    per[-1] += carry
                    del_at[start] = np.minimum(per[seg[start]], 15)
                vis = (rows >= 0) & (rows < lim)
                i = rows[vis]
                k = np.flatnonzero(vis)
                j0, j1 = js[b, i].astype(np.int64), js[b, i + 1].astype(np.int64)
                dj = j1 - j0
                active = (j1 > 0) & (j0 < e_span)

                def chr_at(pos):
                    return e_sub[b, np.clip(pos, 0, W_e - 1)]

                bchr, ichr, i2chr = chr_at(j1 - 1), chr_at(j0), chr_at(j0 + 1)
                base, ins, ins2 = active & (dj >= 1), active & (dj >= 2), active & (dj >= 3)
                w = np.float32(w_all[b])
                for c in range(4):
                    acc[c, k] += np.where(base & (bchr == c), w, np.float32(0))
                    acc[6 + c, k] += np.where(ins & (ichr == c), w, np.float32(0))
                    acc[11 + c, k] += np.where(ins2 & (i2chr == c), w, np.float32(0))
                acc[4, k] += del_at[vis].astype(np.float32) * w
                acc[5, k] += np.where(ins, w, np.float32(0))
                acc[10, k] += np.where(ins2, w, np.float32(0))
            if met:
                hi = min(c0 + tile, Lt)
                out[s, :, c0:hi] += acc[:, : hi - c0]
    return out


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


def k1_rows_plain(starts, a, s_bits, b, a_len, b_len, n_run: int, cap_q: int, seg: int):
    """The plain rows (ops.myers._myers_row) of one kernel K1 launch
    (myers_rows_cuda's arguments; ``starts`` in place of its carry), cut
    into segments of ``seg`` rows that run at once, stacked as lanes:
    segment t starts from starts[t], the carry planes int32[NC, B] after
    rows 1..t*seg, and runs rows t*seg+1 .. (t+1)*seg.  Returns int32[NC,
    len(starts), B], each segment's carry at its end.  With K1's carries
    at the segment starts, every row of a long launch is held to the
    plain loop at the cost of seg rows of it.  Rows past n_run change
    nothing, since no lane is live there; that needs every a_len <=
    n_run, as the engine's own launches have it."""
    import torch

    from canu_tpu_torch.ops import myers as MY

    T, B = len(starts), a.shape[0]
    rows = T * seg
    if rows < n_run or (rows > n_run and int(a_len.max()) > n_run):
        raise ValueError(f"{T} segments of {seg} rows do not cover the {n_run} rows exactly")
    dev = a.device
    sh = torch.arange(MY.WORD, dtype=torch.int64, device=dev)
    s = ((s_bits.T.to(torch.int64)[:, :, None] >> sh) & 1).reshape(B, -1)[:, :n_run]
    s = torch.nn.functional.pad(s, (0, rows - n_run))
    # the schedule's window start o(i) of rows 1..rows, and the B char a
    # shifted row lets in
    o = MY._carry_unpack(starts[0]).o.to(torch.int64)[:, None] + torch.cumsum(s, dim=1)
    bch = torch.gather(b, 1, torch.clamp(o + MY.NW * MY.WORD - 1, 0, b.shape[1] - 1))
    a = torch.nn.functional.pad(a[:, :rows], (0, max(0, rows - a.shape[1])))

    def lanes(x):  # [B, rows] -> [T * B, seg], segment-major
        return x.reshape(B, T, seg).transpose(0, 1).reshape(T * B, seg)

    a_l, s_l, b_l = lanes(a), lanes(s), lanes(bch)
    i0 = (torch.arange(T, dtype=torch.int32, device=dev) * seg).repeat_interleave(B)
    al, bl = a_len.to(torch.int32).repeat(T), b_len.to(torch.int32).repeat(T)
    carry = MY._carry_unpack(torch.cat(starts, dim=1))
    for r in range(seg):
        carry = MY._myers_row(carry, s_l[:, r], a_l[:, r], b_l[:, r], i0 + (r + 1), al, bl,
                              cap_q, MY.NW * MY.WORD)
    return MY._carry_pack(carry).reshape(MY.NC, T, B)


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


def myers_schedule_cases():
    """Kernel K10's cases: {name: (centers int32[B, C], b uint8[B, LB],
    a_len, b_len int32[B], n_rows, n_run)}: the band schedule of rows
    0..n_rows and the shift bits of rows 1..n_run.

    The centres are narrower than n_rows + 1 (the last one repeats) or
    wider; the schedule rises steeply after n_run, which only the backward
    envelope sees; b_len and a_len are 0 or negative; o0 sits at or past
    the end of B (the Peq index clamped, its bits cleared); centres near
    the int32 limits wrap as int32 arithmetic does; n_rows + 1 and n_run
    are off the 32-row words; one case runs tens of thousands of rows."""
    rng = np.random.default_rng(19)
    i32 = np.iinfo(np.int32)
    cases = {}

    def reads(B, LB):
        return rng.integers(0, 5, (B, LB)).astype(np.uint8)  # 4 (N) matches no char

    def drift(B, C, p=0.7, start=0):
        c = np.cumsum(rng.random((B, C)) < p, axis=1).astype(np.int64)
        return np.asarray(c - c[:, :1] + start, np.int32)  # row 0 at start

    # centres narrower than the rows (300 of 701), and wider (900)
    B, n_rows = 40, 700
    b = reads(B, n_rows + 128)
    a_len = rng.integers(1, n_rows + 1, B).astype(np.int32)
    b_len = rng.integers(1, n_rows + 129, B).astype(np.int32)
    cases["narrow"] = (drift(B, 300), b, a_len, b_len, n_rows, 512)
    cases["wide"] = (drift(B, 900, 0.9, 40), b, a_len, b_len, n_rows, 700)
    # flat until row 600, then a rise of 2 a row: the backward envelope
    # lifts the schedule before row n_run = 512 already
    B, n_rows = 33, 1024
    c = np.zeros((B, n_rows + 1), np.int64)
    c[:, 600:] = 2 * np.arange(n_rows + 1 - 600)[None, :] + rng.integers(0, 64, (B, 1))
    c[::3, 300:] += 300  # a step, then the rise
    b = reads(B, 3000)
    cases["rise_after_run"] = (np.asarray(c + 64, np.int32), b,
                               rng.integers(500, 1025, B).astype(np.int32),
                               rng.integers(1500, 3001, B).astype(np.int32), n_rows, 512)
    # lengths 0 and negative, o0 at, beside and past the end of B (LB 100,
    # b_len up to 300: the Peq index clamped and its bits cleared), b_len -
    # o0 at 127 and 128 (the window's last column and past it)
    B, n_rows = 64, 256
    b = reads(B, 100)
    a_len = rng.integers(0, 3, B).astype(np.int32)
    b_len = np.concatenate([[0, 0, -1, -5, 1, 2, 100, 100, 99, 101, 227, 228, 300, 300],
                            rng.integers(0, 301, B - 14)]).astype(np.int32)
    c0 = np.concatenate([[0, 500, 0, 70, 64, 65, 163, 164, 100, 36, 163, 165, 214, 364],
                         rng.integers(0, 400, B - 14)])
    c = c0[:, None] + drift(B, n_rows + 1, 0.5)
    cases["lengths_and_o0"] = (np.asarray(c, np.int32), b, a_len, b_len, n_rows, 256)
    # centres near the int32 limits (centre - 64 wraps), n_rows + 1 and
    # n_run off the 32-row words
    B, n_rows = 36, 333
    c = drift(B, n_rows + 1).astype(np.int64)
    c[0] = i32.min + np.arange(n_rows + 1)
    c[1] = i32.max - np.arange(n_rows + 1)
    c[2, ::2] = i32.min + 5
    c[3, :] = i32.max
    c[4, 100:] = -1000
    cases["int32_limits"] = (np.asarray(c, np.int32), reads(B, 500),
                             rng.integers(0, 400, B).astype(np.int32),
                             rng.integers(0, 500, B).astype(np.int32), n_rows, 77)
    # centres that fall and stay low after a run of high ones: the running
    # max carries the earlier rows' target into every later row
    B, n_rows = 8, 900
    c = np.full((B, n_rows + 1), 500, np.int64)
    c[:, :200] = 3000 + drift(B, 200, 0.5)
    c[4:, 130:] = 100  # the fall inside a 128-row step
    cases["fall"] = (np.asarray(c, np.int32), reads(B, 4200), np.full(B, n_rows, np.int32),
                     np.full(B, 4000, np.int32), n_rows, 896)
    # one row (n_rows 1, n_run 0 and 1) and a single centre column
    B = 5
    cases["one_row"] = (rng.integers(0, 200, (B, 1)).astype(np.int32), reads(B, 160),
                        np.array([0, 1, 1, 2, 0], np.int32), np.array([0, 1, 150, 40, 3], np.int32),
                        1, 1)
    # tens of thousands of rows: many 32-row steps in both passes
    B, n_rows = 3, 40_000
    cases["long"] = (drift(B, n_rows + 1, 0.8), reads(B, n_rows + 128),
                     np.full(B, n_rows, np.int32), np.full(B, n_rows - 5000, np.int32),
                     n_rows, 38_912)
    return cases


def myers_split_case(seed: int = 29):
    """K10's case for an extension split across blocks: (centers int32[3,
    n_rows + 1], b uint8[3, LB], a_len, b_len int32[3], n_rows, n_run), 3
    extensions x 200,003 rows, so that the few extensions spread over many
    blocks and each crosses many 1,024-row steps: one drifts at ~0.9 a row,
    one steps up by 2,000 after a long flat run (only the backward envelope
    sees the step before it), one falls back after a run of high centres
    (the running max carries it); n_rows + 1 and n_run off the 32-row
    words."""
    rng = np.random.default_rng(seed)
    B, n_rows = 3, 200_003
    c = np.zeros((B, n_rows + 1), np.int64)
    c[0] = np.cumsum(rng.random(n_rows + 1) < 0.9) + 64
    c[1] = np.arange(n_rows + 1) // 2 + 64
    c[1, 150_000:] += 2_000
    c[2] = np.cumsum(rng.random(n_rows + 1) < 0.8) + 64
    c[2, 40_000:41_000] += 5_000
    b = rng.integers(0, 4, (B, 2_048)).astype(np.uint8)
    a_len = np.array([n_rows, 120_000, 0], np.int32)
    b_len = np.array([n_rows - 4_000, 200_000, 190_000], np.int32)
    return np.asarray(c, np.int32), b, a_len, b_len, n_rows, n_rows - 37


def myers_finish_cases(seed: int = 23):
    """Kernel K11's cases: (planes int32[43, B], a_len, b_len int32[B]) of
    final carries: random A-exhausted rows, fin_o beside b_len (columns cut
    off, and every column off: all INF), rows of equal scores (the first
    minimum), the best B-exhausted cost equal to the A end's (ties go to
    the A end), INF costs, and partial endpoints past the reads."""
    from canu_tpu_torch.ops import myers as MY

    rng = np.random.default_rng(seed)
    NW = MY.NW
    B = 256

    def u32(n):
        return rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)

    fvp = np.stack([u32(B) for _ in range(NW)])
    fvn = np.stack([u32(B) & ~fvp[k] for k in range(NW)])  # Myers' VP and VN are disjoint
    fvp[:, :16] = 0  # equal scores: every column fin_sf
    fvn[:, :16] = 0
    fvn[:, 16:32] = np.uint32(0xFFFFFFFF)  # falling scores, VP 0
    fvp[:, 16:32] = 0
    fin_sf = rng.integers(0, 5000, B).astype(np.int64)
    fin_o = rng.integers(0, 3000, B).astype(np.int64)
    b_len = fin_o + rng.integers(-40, 200, B)
    edge = np.array([-1, 0, 1, 31, 32, 127, 128, -100])
    b_len[:8] = fin_o[:8] + edge  # on equal scores
    b_len[16:24] = fin_o[16:24] + edge  # on falling ones: the last column counted is the least
    a_len = rng.integers(0, 4000, B)
    # the best B-exhausted cost: random, INF, or the A end's minimum (a tie)
    best = fin_sf + rng.integers(-100, 100, B)
    best[32:64] = MY.INF
    scores = fin_sf[:, None] + np.concatenate(
        [np.zeros((B, 1), np.int64),
         np.cumsum(np.stack([((fvp[k][:, None] >> np.arange(32, dtype=np.uint32)) & 1)
                             .astype(np.int64) - ((fvn[k][:, None] >> np.arange(32, dtype=np.uint32))
                                                  & 1).astype(np.int64)
                             for k in range(NW)], axis=1).reshape(B, NW * 32), axis=1)[:, :-1]],
        axis=1)
    cols = fin_o[:, None] + np.arange(NW * 32)[None, :]
    amin = np.where(cols <= b_len[:, None], scores, MY.INF).min(axis=1)
    best[64:128] = amin[64:128]
    planes = np.zeros((MY.NC, B), np.int64)
    p = 0
    planes[p:p + NW] = rng.integers(0, 1 << 32, (NW, B))  # VP, VN, Peq: not read
    p += 2 * NW + 4 * NW
    planes[p:p + 5] = np.stack([fin_sf + 7, fin_o + 3, best, rng.integers(0, 4000, B),
                                rng.integers(0, 4000, B)])
    p += 5
    planes[p:p + NW], planes[p + NW:p + 2 * NW] = fvp, fvn
    p += 2 * NW
    p_a = a_len + rng.integers(-50, 50, B)
    p_b = b_len + rng.integers(-50, 50, B)
    planes[p:p + 6] = np.stack([fin_sf, fin_o, rng.integers(0, 9000, B),
                                rng.integers(0, 900, B), p_a, p_b])
    planes = (planes & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return planes, a_len.astype(np.int32), b_len.astype(np.int32)


PAIR_STATS_CASES = ("k16", "k16_fk", "k22", "k22_fk")


def pair_stats_case(name: str, seed: int = 29):
    """Kernel K12's chunk of C = 64 pairs for a case of PAIR_STATS_CASES:
    (wordsA uint32[C, W], lenA int32[C], wordsB, lenB, fk uint32[F >= 1]
    sorted, k), W 64 words (1,024 bases).

    Pairs that overlap forward and reverse-complemented, a read against
    itself, unrelated reads, reads of tandem repeats (one key at many
    positions: A's last and B's first entry are the hit), a tied strand
    vote (A = Y + rc(Z), B = Y + Z), empty reads, reads of k - 1, k and
    k + 1 bases and lengths on word edges; two clusters of diagonals of
    equal size far apart (the lower median differs from the upper), a
    cluster exactly tol from the median, and A one base short of B, its
    zero padding the base B has there (a window past A's end would hit);
    random bases in the padding past the other reads (which no valid
    window reads).  With _fk a frequent table of
    some keys of the B reads (the repeats' among them) and keys >= 2^31;
    without, the one-sentinel table place_candidates passes."""
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.utils.bitpack import pack_codes

    k = 16 if name.startswith("k16") else 22
    rng = np.random.default_rng(seed + k + len(name))
    C, W = 64, 64
    L = 16 * W
    genome = rng.integers(0, 4, 6000).astype(np.uint8)

    def mut(x, er=0.05):
        return mutate(rng, x, er)[:L].astype(np.uint8)

    def rc(x):
        return (3 - x[::-1]).astype(np.uint8)

    pairs = []
    kinds = 11
    for q in range(C):
        kind = q % kinds
        la = int(rng.integers(300, L + 1))
        s0 = int(rng.integers(0, len(genome) - 2 * L))
        A = genome[s0:s0 + la]
        if kind == 0:  # forward overlap, B shifted
            sh = int(rng.integers(0, la // 2))
            B = mut(genome[s0 + sh:s0 + sh + int(rng.integers(200, L))])
        elif kind == 1:  # reverse-complemented overlap
            B = rc(mut(genome[s0 + 50:s0 + 50 + int(rng.integers(200, L - 50))]))
        elif kind == 2:  # itself
            B = A.copy()
        elif kind == 3:  # unrelated
            B = rng.integers(0, 4, int(rng.integers(0, L + 1))).astype(np.uint8)
        elif kind == 4:  # tandem repeats: one key at many positions
            unit = rng.integers(0, 4, int(rng.integers(20, 60))).astype(np.uint8)
            A = np.tile(unit, L)[: int(rng.integers(k, L + 1))]
            B = mut(np.tile(unit, L)[: int(rng.integers(k, L + 1))], 0.02)
        elif kind == 5:  # a tied vote: Y agrees, Z is reversed
            y = genome[s0:s0 + 200]
            z = genome[s0 + 3000:s0 + 3200]
            A = np.concatenate([y, rc(z), rng.integers(0, 4, 100).astype(np.uint8)])
            B = np.concatenate([y, z])
        elif kind == 6:  # short reads: empty, k - 1, k, k + 1, word edges
            short = [0, k - 1, k, k + 1, 16, 32, 33, 47]
            la, lb = short[(q // kinds) % 8], short[(q // kinds + 3) % 8]
            A = genome[s0:s0 + la]
            B = genome[s0:s0 + lb] if lb > 8 else genome[s0 + 1:s0 + 1 + lb]
        elif kind == 7:  # overlapping at the far end: B's start against A's end
            B = mut(np.concatenate([genome[s0 + la - 300:s0 + la],
                                    rng.integers(0, 4, 400).astype(np.uint8)]))
        elif kind == 8:  # diagonals 0 and 600, equal clusters
            x, g, y = genome[s0:s0 + 200], genome[s0 + 2000:s0 + 2600], genome[s0 + 4000:s0 + 4200]
            A, B = np.concatenate([x, g, y]), np.concatenate([x, y])
        elif kind == 9:  # diagonals 0 (120 bases) and 100 = tol (100 bases)
            x, g, y = genome[s0:s0 + 120], genome[s0 + 2000:s0 + 2100], genome[s0 + 4000:s0 + 4100]
            A, B = np.concatenate([x, g, y]), np.concatenate([x, y])
        else:  # A is B less its last base, an A (0) as the zero padding
            B = np.concatenate([genome[s0:s0 + int(rng.integers(100, 500))], [0]]).astype(np.uint8)
            A = B[:-1]
        pairs.append((np.asarray(A[:L], np.uint8), np.asarray(B[:L], np.uint8)))

    def block(reads):
        words = np.zeros((C, W), np.uint32)
        lens = np.zeros(C, np.int32)
        for i, r in enumerate(reads):
            pk = pack_codes(r)
            words[i, : len(pk)] = pk
            lens[i] = len(r)
            if i % 3 == 0 and i % kinds != 10 and len(r) < L - 16:  # random bases past it
                tail = pack_codes(rng.integers(0, 4, L - len(r)).astype(np.uint8))
                base = len(r) // 16
                keep = len(r) % 16
                if keep:
                    mask = np.uint32((1 << (2 * keep)) - 1)
                    words[i, base] = (words[i, base] & mask) | (np.uint32(tail[0]) << np.uint32(2 * keep))
                    base += 1
                words[i, base:] = rng.integers(0, 1 << 32, W - base, dtype=np.uint64).astype(np.uint32)
        return words, lens

    wa, la_ = block([a for a, _ in pairs])
    wb, lb_ = block([b for _, b in pairs])
    fk = np.full(1, 0xFFFFFFFF, np.uint32)
    if name.endswith("_fk"):
        import torch

        canon, _ = KM.extract_kmers_any(torch.from_numpy(wb.astype(np.int64)),
                                        torch.from_numpy(lb_), k)
        keys = np.unique(canon.numpy()[canon.numpy() != KM.INVALID_KMER])
        pick = keys[rng.random(len(keys)) < 0.05]
        rep = canon.numpy()[4::8]  # every key of the repeat pairs' B reads
        rep = np.unique(rep[rep != KM.INVALID_KMER])
        big = rng.integers(1 << 31, 1 << 32, 50, dtype=np.uint64)
        fk = np.unique(np.concatenate([pick, rep[::2], big]).astype(np.uint32))
    return wa, la_, wb, lb_, fk, k


def _mix32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def skewed_read(rng, n_pos: int, below: int, k: int = 16) -> np.ndarray:
    """A read (codes uint8) of n_pos + k - 1 bases whose n_pos canonical
    k-mer keys (k <= 16: min of the forward and reverse-complement 2-bit
    codes) are distinct and all have mix32(key) < below: each next base is
    one whose k-mer keeps that, the last base taken back where none does,
    and a new first k-mer where every path from it ends (below should
    leave a base more than one choice in four)."""
    mask, top = (1 << (2 * k)) - 1, 2 * k - 2
    opts: list = []
    while len(opts) < n_pos:
        if not opts:  # a new first k-mer
            first = rng.integers(0, 4, k)
            fw = rc = 0
            for i, b in enumerate(first):
                fw |= int(b) << (2 * (k - 1 - i))
                rc |= (3 - int(b)) << (2 * i)
            if _mix32(min(fw, rc)) >= below:
                continue
            bases, fws, rcs, keys = list(first), [fw], [rc], [min(fw, rc)]
            seen, opts = set(keys), [rng.permutation(4).tolist()]
            continue
        if not opts[-1]:  # no base extends the read: take its last one back
            opts.pop()
            if opts:
                seen.discard(keys.pop())
                bases.pop(), fws.pop(), rcs.pop()
            continue
        b = opts[-1].pop()
        fw, rc = ((fws[-1] << 2) | b) & mask, (rcs[-1] >> 2) | ((3 - b) << top)
        key = min(fw, rc)
        if key in seen or _mix32(key) >= below:
            continue
        bases.append(b), fws.append(fw), rcs.append(rc), keys.append(key)
        seen.add(key)
        opts.append(rng.permutation(4).tolist())
    return np.asarray(bases, np.uint8)


def pair_stats_retry_case(n_pos: int, below: int, W: int, seed: int = 31):
    """Kernel K12's chunk (as pair_stats_case, k 16, no frequent key) whose
    A reads have n_pos k-mers, each key's mix32 below `below`: so one of
    K12's equal mix32 ranges holds more of A's keys than its plan gives a
    round, and the kernel takes rounds again over narrower ranges.  Pairs:
    A against itself, its reverse complement, itself less its first 40
    bases and a random tail, a random read; a second skewed A against
    itself; an empty pair."""
    from canu_tpu_torch.utils.bitpack import pack_codes

    k = 16
    rng = np.random.default_rng(seed + n_pos)
    A1, A2 = skewed_read(rng, n_pos, below, k), skewed_read(rng, n_pos, below, k)
    assert len(A1) <= 16 * W
    rand = rng.integers(0, 4, len(A1)).astype(np.uint8)
    pairs = [(A1, A1), (A1, (3 - A1[::-1]).astype(np.uint8)),
             (A1, np.concatenate([A1[40:], rand[:40]])), (A1, rand), (A2, A2),
             (np.zeros(0, np.uint8), np.zeros(0, np.uint8))]

    def block(reads):
        words = np.zeros((len(reads), W), np.uint32)
        lens = np.zeros(len(reads), np.int32)
        for i, r in enumerate(reads):
            pk = pack_codes(r)
            words[i, : len(pk)] = pk
            lens[i] = len(r)
        return words, lens

    wa, la = block([a for a, _ in pairs])
    wb, lb = block([b for _, b in pairs])
    return wa, la, wb, lb, np.full(1, 0xFFFFFFFF, np.uint32), k


# an overlap store's columns, in store_digest's order
STORE_COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")


def candidate_sample(pairs: np.ndarray, n: int = 2048, second: bool = False) -> np.ndarray:
    """Every floor(M/n)-th row of the sorted candidate rows, n of them
    (all of them when M <= n); second=True starts half a stride in, so the
    two samples share no row where the stride is 2 or more."""
    step = max(1, len(pairs) // n)
    return pairs[(step // 2 if second else 0) :: step][:n]


def store_rows_of_pairs(st, pairs: np.ndarray) -> SimpleNamespace:
    """The rows of store st whose read pair, either way round, is an
    (a_id, b_id) row of pairs: the 8 store columns, for store_digest."""
    a, b = np.asarray(st.a_id).astype(np.int64), np.asarray(st.b_id).astype(np.int64)
    key = np.minimum(a, b) << 32 | np.maximum(a, b)
    want = np.asarray(pairs[:, 0], np.int64) << 32 | np.asarray(pairs[:, 1], np.int64)
    m = np.isin(key, want)
    return SimpleNamespace(**{c: np.asarray(getattr(st, c))[m] for c in STORE_COLS})


TEMPLATE_SAMPLE = 256  # templates whose corrected reads stand in for a whole correction


def template_sample(template_ids: np.ndarray, n: int = TEMPLATE_SAMPLE) -> np.ndarray:
    """Every floor(T/n)-th id of the sorted template ids, n of them (all of
    them when T <= n)."""
    ids = np.sort(np.asarray(template_ids))
    return ids[:: max(1, len(ids) // n)][:n]


def pairs_of_reads(pairs: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """The candidate rows with a read of ids on either side."""
    return pairs[np.isin(pairs[:, 0], ids) | np.isin(pairs[:, 1], ids)]


def store_of_templates(st, ids: np.ndarray, cls=SimpleNamespace):
    """The rows of store st whose a_id is in ids, as cls(n_reads, **columns)
    (an OverlapStore class of either package) or, by default, a namespace
    of the 8 columns for store_digest.  The mirror rows (b_id in ids) stay
    out: they would make the partners templates with part of their
    evidence, whose corrected reads differ from the full run's."""
    m = np.isin(np.asarray(st.a_id), ids)
    kept = {c: np.asarray(getattr(st, c))[m] for c in STORE_COLS}
    return SimpleNamespace(**kept) if cls is SimpleNamespace else cls(st.n_reads, **kept)


def corrected_digest(records) -> str:
    """sha256 over the sorted (name, seq) records of a block of corrected
    reads, each as the bytes of "name<TAB>seq<LF>"."""
    h = hashlib.sha256()
    for name, seq in sorted(records):
        h.update(f"{name}\t{seq}\n".encode())
    return h.hexdigest()


def _sha_of(items) -> str:
    """sha256 over the sorted records, each as its fields joined by TAB
    and ended by LF."""
    h = hashlib.sha256()
    for rec in sorted(items):
        h.update(("\t".join(str(x) for x in rec) + "\n").encode())
    return h.hexdigest()


def fasta_records(path: str) -> list[tuple[str, str]]:
    """(name, seq) records of a FASTA file, gzipped or not."""
    opener = gzip.open if path.endswith(".gz") else open
    recs: list[list[str]] = []
    with opener(path, "rt") as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                recs.append([line[1:], ""])
            elif recs:
                recs[-1][1] += line
    return [(n, s) for n, s in recs]


def tig_records(store_dir: str, version: int = 1) -> list[tuple]:
    """(tig_id, class, read_id, bgn, end, rev) per placement of a tig store
    version (the format both packages write: v###.npz + v###.meta.json)."""
    with open(os.path.join(store_dir, f"v{version:03d}.meta.json")) as fh:
        meta = json.load(fh)
    out = []
    with np.load(os.path.join(store_dir, f"v{version:03d}.npz")) as z:
        for i, m in enumerate(meta):
            for r, b, e, v in zip(z[f"t{i}_read_id"].tolist(), z[f"t{i}_bgn"].tolist(),
                                  z[f"t{i}_end"].tolist(), z[f"t{i}_rev"].tolist()):
                out.append((int(m["tig_id"]), int(m["class"]), r, b, e, int(v)))
    return out


def corrections_records(corr: dict) -> list[tuple[int, int, int]]:
    """(read, position, base) of RED's corrections {read: int32[M, 2]}."""
    return [(int(rid), int(p), int(b)) for rid, v in corr.items() for p, b in np.asarray(v)]


def assembly_digests(work_dir: str, prefix: str, corrections: dict | None = None) -> dict:
    """Each gate of a trimming + assembly run in work_dir as {"n": records,
    "sha256": digest of the sorted records}: the trimmed reads, the utg
    store and the store with OEA's adjusted erates (store_digest), RED's
    corrections (when given), the unitig and contig layouts (utgStore and
    ctgStore v1), the contigs, unassembled and unitigs FASTA files,
    layout.tsv, and the GFA's S and L lines."""
    from canu_tpu_torch.stores.overlaps import OverlapStore, store_digest

    def path(*p):
        return os.path.join(work_dir, *p)

    def recs(items) -> dict:
        items = list(items)
        return {"n": len(items), "sha256": _sha_of(items)}

    out = {"trimmed": recs(fasta_records(path("trimming", f"{prefix}.trimmedReads.fasta.gz")))}
    for key, name in (("utg_store", "ovlStore"), ("adjusted_store", "ovlStore.adjusted")):
        d = path("unitigging", f"{prefix}.{name}")
        if os.path.isdir(d):
            st = OverlapStore.load(d)
            out[key] = {"n": len(st), "sha256": store_digest(st)}
    if corrections is not None:
        out["red"] = recs(corrections_records(corrections))
    out["utg_layouts"] = recs(tig_records(path("unitigging", f"{prefix}.utgStore")))
    out["ctg_layouts"] = recs(tig_records(path("unitigging", f"{prefix}.ctgStore")))
    for kind in ("contigs", "unassembled", "unitigs"):
        out[kind] = recs(fasta_records(path(f"{prefix}.{kind}.fasta")))
    with open(path(f"{prefix}.layout.tsv")) as fh:
        out["layout_tsv"] = recs(tuple(ln.split("\t")) for ln in fh.read().splitlines())
    with open(path(f"{prefix}.contigs.gfa")) as fh:
        lines = fh.read().splitlines()
    out["gfa"] = recs(tuple(ln.split("\t")) for ln in lines if ln[:2] in ("S\t", "L\t"))
    out["gfa"]["l_lines"] = sum(1 for ln in lines if ln.startswith("L\t"))
    return out


# ---- the E. coli assembly's stage boundaries: each stage of a trimming +
# assembly run at E. coli scale held to the reference on its own input
# (chip_smoke.py's ecoliasm phase, scripts/torch_ecoli_assembly_reference.py,
# test_torch_ecoli_assembly_sample.py shows the sample rules sound)

def rows_of_reads(st, ids: np.ndarray, cls=SimpleNamespace):
    """The rows of store st with a read of ids on either side, both mirror
    copies, as cls(n_reads, **columns) or a namespace of the 8 columns:
    what OEA's adjust of those reads' overlaps reads and writes (it
    verifies each pair once, from its a_id < b_id row)."""
    a, b = np.asarray(st.a_id), np.asarray(st.b_id)
    m = np.isin(a, ids) | np.isin(b, ids)
    kept = {c: np.asarray(getattr(st, c))[m] for c in STORE_COLS}
    return SimpleNamespace(**kept) if cls is SimpleNamespace else cls(st.n_reads, **kept)


def trimmed_of(records, names: set) -> list[tuple[str, str]]:
    """The trimmed records <read>_trim_<bgn>_<end>[_s<i>] of the reads in
    names."""
    return [(n, s) for n, s in records if n.rsplit("_trim_", 1)[0] in names]


def verify_kwargs(cfg, tag: str) -> dict:
    """The overlap stage's verify arguments for tag (both packages'
    stages.overlap), without the device."""
    ms = int(cfg.get(tag + "MinShared"))
    return dict(k=int(cfg.get(tag + "MerSize")), band=int(cfg.get(tag + "OvlBandWidth")),
                max_erate=float(cfg.get(tag + "OvlErrorRate")),
                min_overlap=int(cfg.get("minOverlapLength")), chunk=512, min_shared=ms,
                partial=tag in ("cor", "obt"), palindromic_min=ms if tag == "obt" else 0)


def red_kwargs(cfg) -> dict:
    """The oea stage's detect_read_errors arguments."""
    return dict(min_alt_votes=int(cfg.get("oeaMinAltVotes")),
                max_own_votes=int(cfg.get("oeaMaxOwnVotes")),
                band=int(cfg.get("utgBandWidth")) * 2)


def adjust_kwargs(cfg) -> dict:
    """The oea stage's adjust_overlap_erates arguments."""
    return dict(band=int(cfg.get("utgBandWidth")), chunk=int(cfg.get("oeaBatchSize")),
                only_changed=bool(cfg.get("oeaOnlyChanged")))


def _with_stages(stages, rs, st, call):
    """call() with a package's gatekeeper, meryl and overlap stages standing
    in by the given read set and store (the stages module's globals,
    restored after)."""
    real = {n: getattr(stages, n) for n in ("gatekeeper", "meryl", "overlap")}
    stages.gatekeeper = lambda *a, **k: rs
    stages.meryl = lambda *a, **k: None
    stages.overlap = lambda *a, **k: st
    try:
        return call()
    finally:
        for n, f in real.items():
            setattr(stages, n, f)


def trim_with_store(stages, ctx, rs, st, **kw) -> list[tuple[str, str]]:
    """A package's trimming_phase in ctx on the obt read set rs and store st
    (its gatekeeper, meryl and overlap stages stand in by them): the
    trimmed records it writes.  With a store of some reads' a_id rows, the
    records of those reads."""
    _with_stages(stages, rs, st, lambda: stages.trimming_phase(ctx, ["-"], **kw))
    return fasta_records(os.path.join(ctx.work_dir, "trimming",
                                      f"{ctx.prefix}.trimmedReads.fasta.gz"))


def unitig_layouts(stages, StopPipeline, ctx, rs, adjusted, **kw) -> dict:
    """A package's assembly_phase in ctx up to its unitig stage on the utg
    read set rs and the OEA-adjusted store (saved where the oea stage
    leaves it, so that stage resumes; stopAfter=unitig): the digests of
    the unitig and contig layouts, as assembly_digests gives them."""
    d = os.path.join(ctx.work_dir, "unitigging")
    os.makedirs(d, exist_ok=True)
    adjusted.save(os.path.join(d, f"{ctx.prefix}.ovlStore.adjusted"))
    ctx.cfg.set("stopAfter", "unitig")

    def run():
        try:
            stages.assembly_phase(ctx, ["-"], **kw)
        except StopPipeline:
            pass

    _with_stages(stages, rs, None, run)
    out = {}
    for key, name in (("utg_layouts", "utgStore"), ("ctg_layouts", "ctgStore")):
        items = tig_records(os.path.join(d, f"{ctx.prefix}.{name}"))
        out[key] = {"n": len(items), "sha256": _sha_of(items)}
    return out


_ACGT = np.full(256, 255, np.uint8)
_ACGT[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def pack_records(records) -> dict[str, np.ndarray]:
    """(name, seq) records as arrays for np.savez: the names joined by LF,
    each sequence's length, the bases at 2 bits (A, C, G, T; four a
    byte) and the position and byte of every other character."""
    names = "\n".join(n for n, _ in records).encode()
    seqs = [s.encode() for _, s in records]
    raw = np.frombuffer(b"".join(seqs), np.uint8)
    codes = _ACGT[raw]
    odd = np.flatnonzero(codes == 255)
    codes = np.where(codes == 255, 0, codes).astype(np.uint8)
    codes = np.concatenate([codes, np.zeros(-len(codes) % 4, np.uint8)]).reshape(-1, 4)
    packed = codes[:, 0] | codes[:, 1] << 2 | codes[:, 2] << 4 | codes[:, 3] << 6
    return {"names": np.frombuffer(names, np.uint8), "lengths": np.array([len(s) for s in seqs],
                                                                          np.int64),
            "packed": packed.astype(np.uint8), "odd_pos": odd.astype(np.int64),
            "odd_byte": raw[odd]}


def unpack_records(z) -> list[tuple[str, str]]:
    """pack_records' arrays back to the (name, seq) records."""
    names = bytes(np.asarray(z["names"])).decode().split("\n")
    p = np.asarray(z["packed"])
    codes = np.stack([(p >> s) & 3 for s in (0, 2, 4, 6)], axis=1).reshape(-1)
    raw = np.frombuffer(b"ACGT", np.uint8)[codes]
    raw[np.asarray(z["odd_pos"])] = np.asarray(z["odd_byte"])
    ends = np.cumsum(np.asarray(z["lengths"]))
    buf = raw[: int(ends[-1]) if len(ends) else 0].tobytes()
    starts = np.concatenate([[0], ends[:-1]])
    return [(n, buf[int(b):int(e)].decode()) for n, b, e in zip(names, starts, ends)]


def trimmed_from_names(corrected, names) -> list[tuple[str, str]]:
    """The trimmed records named <read>_trim_<bgn>_<end>[_s<i>], cut from
    the corrected records (name, seq) by the coordinates in their names."""
    seq_of = dict(corrected)
    out = []
    for n in names:
        read, coords = n.rsplit("_trim_", 1)
        bgn, end = (int(x) for x in coords.split("_")[:2])
        out.append((n, seq_of[read][bgn:end]))
    return out


def store_halves(st) -> dict[str, np.ndarray]:
    """An overlap store as arrays for np.savez: its a_id < b_id rows (the
    other copy of each is their mirror) and every row's erate_q, which
    OEA's adjust can leave differing between the two copies."""
    half = np.asarray(st.a_id) < np.asarray(st.b_id)
    out = {c: np.asarray(getattr(st, c))[half] for c in STORE_COLS[:-1]}
    out.update(erate_q=np.asarray(st.erate_q), n_reads=np.int64(st.n_reads))
    return out


def store_from_halves(cls, z):
    """store_halves' arrays back to an OverlapStore of class cls: the
    mirror rows added and sorted as OverlapStore.build sorts them, then
    every row's erate_q."""
    h = {c: np.asarray(z[c]) for c in STORE_COLS[:-1]}
    a = np.concatenate([h["a_id"], h["b_id"]])
    b = np.concatenate([h["b_id"], h["a_id"]])
    order = np.lexsort((b, a))
    cols = {"a_id": a, "b_id": b, "flipped": np.concatenate([h["flipped"]] * 2)}
    for x, y in (("a_bgn", "b_bgn"), ("a_end", "b_end")):
        cols[x] = np.concatenate([h[x], h[y]])
        cols[y] = np.concatenate([h[y], h[x]])
    dt = {"a_id": np.int32, "b_id": np.int32, "flipped": bool, "a_bgn": np.int32,
          "a_end": np.int32, "b_bgn": np.int32, "b_end": np.int32}
    out = {c: np.ascontiguousarray(cols[c][order].astype(dt[c])) for c in STORE_COLS[:-1]}
    out["erate_q"] = np.asarray(z["erate_q"]).astype(np.uint16)
    return cls(int(z["n_reads"]), **out)


def corrections_arrays(corr: dict) -> dict[str, np.ndarray]:
    """RED's corrections {read: int32[M, 2]} as arrays for np.savez (read,
    position, base), sorted by read."""
    ids = sorted(corr)
    if not ids:
        return {"read": np.zeros(0, np.int32), "pos": np.zeros(0, np.int32),
                "base": np.zeros(0, np.uint8)}
    v = [np.asarray(corr[r]) for r in ids]
    return {"read": np.repeat(np.asarray(ids, np.int32), [len(x) for x in v]),
            "pos": np.concatenate([x[:, 0] for x in v]).astype(np.int32),
            "base": np.concatenate([x[:, 1] for x in v]).astype(np.uint8)}


def corrections_from_arrays(z) -> dict[int, np.ndarray]:
    """corrections_arrays' arrays back to {read: int32[M, 2]}."""
    rid, pos, base = (np.asarray(z[k]) for k in ("read", "pos", "base"))
    cut = np.flatnonzero(np.diff(rid)) + 1
    out = {}
    for r, p, b in zip(np.split(rid, cut), np.split(pos, cut), np.split(base, cut)):
        if len(r):
            out[int(r[0])] = np.stack([p, b.astype(np.int32)], axis=1).astype(np.int32)
    return out


# the read sets of chip_smoke.py's assemble phase: corrected reads at the
# bench's shapes (coverage 12, mean 3,500, 1,500-7,800) at 1.5% error;
# 11a's genome carries three copies of a 9 kb repeat, longer than any read
ASSEMBLY_READ_SEED = 72
ASSEMBLY_ERROR_RATE = 0.015
ASSEMBLY_REPEATS = [(9000, 3)]
# run -> (genome length, random_genome seed, planted repeats): 11a is cut
# from the bench's 300 kb so the CPU reference finishes; 11b is the bench
# genome
ASSEMBLY_RUNS = {"a": (100_000, 71, ASSEMBLY_REPEATS), "b": (300_000, 42, None)}


def write_assembly_reads(path: str, genome: int, genome_seed: int, repeats=None):
    """Simulate an assemble-phase read set and write it to a FASTA file;
    returns (genome codes, reads, bases, sha256 of the file)."""
    from canu_tpu_torch.io.fastx import write_fasta
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(genome, seed=genome_seed, repeat_spec=repeats)
    rs, _ = simulate_reads(g, coverage=12, mean_len=3500, min_len=1500, max_len=7800,
                           error_rate=ASSEMBLY_ERROR_RATE, seed=ASSEMBLY_READ_SEED)
    write_fasta(path, ((rs.name(i), rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
    with open(path, "rb") as fh:
        return g, rs.n_reads, int(rs.total_bases), hashlib.sha256(fh.read()).hexdigest()


IDENTITY_WINDOW = 5000  # contig bases between the anchors of identity_vs_genome


def identity_vs_genome(codes, genome, dev) -> tuple[float, int]:
    """A contig's identity to the simulated genome, measured as
    test_assembly_slice.py identity_vs_genome does (an exact 32-mer
    of the contig found in the genome anchors a banded extension at band
    512, 1 - edits / contig bases), once every IDENTITY_WINDOW bases, so
    that indel drift along a contig of hundreds of kb never leaves the
    band: the contig, in the orientation that anchors more windows, is
    cut at each window's first anchor, and each piece is extended from
    its anchor to the next (ops.align.banded_extend, one batch: kernel K2
    on the card).  Bases before the first anchor, and bases a piece's
    extension leaves unused, count as edits.  The genome is circular (the
    simulator's default), so it is searched and aligned as two copies
    back to back.  Returns (identity, misjoins): consecutive anchors
    that are not collinear in the genome."""
    from canu_tpu_torch.ops.align import banded_extend
    from canu_tpu_torch.utils import bitpack

    genome = np.concatenate([genome, genome])
    g_str = bitpack.codes_to_seq(genome)
    band = 512
    best = None
    for cand in (codes, bitpack.revcomp_codes(codes)):
        c_str = bitpack.codes_to_seq(cand)
        anchors = []
        for w0 in range(0, len(cand), IDENTITY_WINDOW):
            for p in range(w0, min(len(cand) - 32, w0 + IDENTITY_WINDOW), 50):
                off = -1
                if anchors:  # the collinear copy first (the genome is doubled)
                    want = anchors[-1][1] + p - anchors[-1][0]
                    off = g_str.find(c_str[p : p + 32], max(0, want - 2000), want + 2032)
                if off < 0:
                    off = g_str.find(c_str[p : p + 32])
                if off >= 0:
                    anchors.append((p, off))
                    break
        if best is None or len(anchors) > len(best[1]):
            best = (cand, anchors)
    cand, anchors = best
    if not anchors:
        return 0.0, 0
    ends = [p for p, _ in anchors[1:]] + [len(cand)]
    la = np.array([e - p for (p, _), e in zip(anchors, ends)], np.int32)
    lb = np.array([min(len(genome) - off, n + band) for (_, off), n in zip(anchors, la)], np.int32)
    n_rows = int(la.max())
    L = n_rows + band
    aa = np.zeros((len(anchors), L), np.uint8)
    bb = np.zeros((len(anchors), L), np.uint8)
    cc = np.zeros((len(anchors), n_rows + 1), np.int32)
    for i, ((p, off), n) in enumerate(zip(anchors, la)):
        aa[i, :n] = cand[p : p + n]
        bb[i, : lb[i]] = genome[off : off + lb[i]]
        cc[i, : n + 1] = np.round(np.linspace(0, min(lb[i], n), n + 1)).astype(np.int32)
        cc[i, n + 1 :] = cc[i, n]
    e, au, _bu = (x.cpu().numpy().astype(np.int64) for x in banded_extend(
        *(torch.from_numpy(x).to(dev) for x in (aa, la, bb, lb, cc)), band, n_rows))
    edits = int(e.sum()) + int((la - au).sum()) + anchors[0][0]
    # a misjoin: the next anchor is not where this piece's alignment ends
    breaks = sum(1 for (p0, o0), (p1, o1) in zip(anchors, anchors[1:])
                 if abs((o1 - o0) - (p1 - p0)) > band // 2)
    return 1.0 - edits / max(1, len(cand)), breaks


def largest_contig_identity(work_dir: str, prefix: str, genome, dev) -> dict:
    """identity_vs_genome of a run's largest contig (the first of the
    longest in ``<prefix>.contigs.fasta``): its length, identity and
    misjoins, which chip_smoke.py's assemble phase holds against
    scripts/torch_assembly_reference.py's."""
    from canu_tpu_torch.utils import bitpack

    contigs = fasta_records(os.path.join(work_dir, f"{prefix}.contigs.fasta"))
    if not contigs:
        return {"length": 0, "identity": 0.0, "misjoins": 0}
    seq = max(contigs, key=lambda r: len(r[1]))[1]
    ident, breaks = identity_vs_genome(bitpack.seq_to_codes(seq), genome, dev)
    return {"length": len(seq), "identity": ident, "misjoins": breaks}


# the GFA cases: write_gfa's links from an overlap store between tig end
# reads; tig t holds reads 10t+1..10t+3, the last at its sequence's end.
# The end reads of tigs 1 and 2 dovetail (a true link, which survives
# align_links), tig 3's end read overlaps tig 1's (a link it drops)
GFA_STORE_ROWS = [(13, 21, False, 0, 600, 0, 600, 100), (31, 13, False, 0, 500, 0, 500, 900),
                  (22, 12, False, 0, 300, 0, 300, 50)]


def gfa_tigs(T, seqs, first_read=1):
    """test_gfa.py's tigs (of the tigs module ``T``, either package's):
    three reads placed along each sequence."""
    out = []
    for i, cns in enumerate(seqs):
        tid = i + 1
        bgn = np.linspace(0, len(cns) - 100, 3).astype(np.int32)
        out.append(T.Tig(tid, (np.arange(first_read, first_read + 3) + 10 * tid).astype(np.int32),
                         bgn, bgn + 100, np.zeros(3, bool), consensus=cns))
    return T.TigStore(out)


def gfa_cases():
    """test_gfa.py's cases: (tig sequences, links) three times."""
    from canu_tpu_torch.utils import bitpack

    rng = np.random.default_rng(5)
    whole = rng.integers(0, 4, size=3000).astype(np.uint8)
    rng6 = np.random.default_rng(6)
    w6 = rng6.integers(0, 4, size=2400).astype(np.uint8)
    return [
        # a true 600-base suffix/prefix overlap and an unrelated tig
        ([whole[:1800], whole[1200:], rng.integers(0, 4, size=1500).astype(np.uint8)],
         [(1, "+", 2, "+", 600), (1, "+", 3, "+", 600)]),
        # the second tig holds the reverse complement of the tail
        ([w6[:1500], bitpack.revcomp_codes(w6[900:])], [(1, "+", 2, "-", 600)]),
        # estimates off by tens of bases, both orientations, a zero length
        ([whole[:2000], whole[1500:], bitpack.revcomp_codes(whole[:1000])],
         [(1, "+", 2, "+", 540), (2, "-", 1, "-", 470), (3, "-", 2, "+", 0),
          (1, "-", 3, "+", 1000)]),
    ]


def gfa_store(AL, OV, rows, n_reads):
    """An overlap store (of the align and overlaps modules ``AL``, ``OV``)
    from rows (a_id, b_id, flipped, a_bgn, a_end, b_bgn, b_end, erate_q)."""
    cols = list(zip(*rows))
    names = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")
    dt = (np.int32, np.int32, bool, np.int32, np.int32, np.int32, np.int32, np.uint16)
    return OV.OverlapStore.build(AL.OverlapTable(**{c: np.array(v, d) for c, v, d in
                                                    zip(names, cols, dt)}), n_reads)


# ---- the tools CLI's scripted session (chip_smoke.py phase 13,
# scripts/torch_tools_reference.py, tests/test_torch_tools.py) ---------------

TOOLS_GENOME = 100_000  # chip_smoke.py's session: a third of the bench genome
TOOLS_SIM_SEED = 81  # simulate -seed (the reads draw from seed + 1)
TOOLS_SETUP_SEED = 82  # the PAF lines and the judged contigs
TOOLS_MISJOIN = 40_000  # where the misjoined contig jumps (test_bogus.py's case)
TOOLS_COLLAPSE = 700  # bases a collapsed contig drops (bogus.py _merge_placements)
# the steps whose DB is the k=22 one saved by kmer-count: canu_tpu's
# KmerCounts.load casts it to uint32 (a fault the port does not copy), so
# their reference is canu_tpu's result on the DB as saved
TOOLS_DB22_STEPS = ("map-mers stats", "map-mers regions", "mask-mers", "mer-trim db")


def tools_session(work: str, genome: int = TOOLS_GENOME) -> list[tuple[str, list | None]]:
    """The steps of the tools session in ``work``: (name, argv) in order; a
    None argv is the setup (tools_setup), which makes the read store, the
    PAF file and the contigs that later steps read."""
    def w(name):
        return os.path.join(work, name)

    reads, db16, db22 = w("reads.fasta"), w("reads16.npz"), w("reads22.npz")
    steps = [
        ("simulate", ["simulate", "-genomesize", str(genome), "-coverage", "12", "-meanlen",
                      "3500", "-minlen", "1500", "-error", "0.1", "-seed", str(TOOLS_SIM_SEED),
                      "-o", reads, "-genome-out", w("genome.fasta"),
                      "-truth-out", w("truth.tsv")]),
        ("setup", None),
        ("analyze", ["analyze", reads]),
        ("sample fraction", ["sample", reads, "-o", w("sample.fasta"), "-fraction", "0.3",
                             "-seed", "5"]),
        ("sample longest", ["sample", reads, "-o", w("longest.fasta"), "-coverage", "2",
                            "-genomesize", str(genome), "-longest"]),
        ("kmer-count 16", ["kmer-count", reads, "-k", "16", "-threshold-fraction", "0.9995",
                           "-o", w("reads16")]),
        ("kmer-count 16 sample", ["kmer-count", w("sample.fasta"), "-k", "16",
                                  "-o", w("sample16")]),
        ("kmer-count 22", ["kmer-count", reads, "-k", "22", "-maxcount", "200",
                           "-o", w("reads22")]),
    ]
    for op in ("add", "union-min", "union-max", "intersect-min", "intersect-max",
               "intersect-sum", "subtract", "difference"):
        steps.append((f"kmer-op {op}", ["kmer-op", op, db16, w("sample16.npz"),
                                        "-o", w(f"op_{op}")]))
    steps += [
        ("kmer-op at-least", ["kmer-op", "at-least", db16, "-n", "3", "-o", w("op_at-least")]),
        ("kmer-op at-most", ["kmer-op", "at-most", db16, "-n", "2", "-o", w("op_at-most")]),
        ("map-mers stats", ["map-mers", "--db", db22, "--fasta", w("longest.fasta")]),
        ("map-mers regions", ["map-mers", "--db", db22, "--fasta", w("longest.fasta"),
                              "--mode", "regions", "--lo", "2"]),
        ("mask-mers", ["mask-mers", "--db", db22, "--fasta", w("longest.fasta"),
                       "--out", w("masked.fasta"), "--lo", "3"]),
        ("mer-trim db", ["mer-trim", "--fasta", w("longest.fasta"), "--db", db22,
                         "--threshold", "3"]),
        ("mer-trim", ["mer-trim", "--fasta", w("longest.fasta"), "-k", "22"]),
        ("mercy", ["mercy", "--reads", reads, "--assembly", w("contigs.fasta"), "-k", "22"]),
        ("ov-import random", ["ov-import", "-random", "5000", "-nreads", "400", "-seed", "3",
                              "-o", w("ovl_random")]),
        ("ov-stats random", ["ov-stats", w("ovl_random")]),
        ("ov-import paf", ["ov-import", "-paf", w("reads.paf"), "-readstore", w("gkp"),
                           "-o", w("ovl_paf")]),
        ("ov-stats paf", ["ov-stats", w("ovl_paf")]),
        ("ov-dump", ["ov-dump", w("ovl_paf"), "-o", w("ovl_paf.tsv")]),
        ("ov-import text", ["ov-import", "-i", w("ovl_paf.tsv"), "-o", w("ovl_text")]),
        ("best-edges", ["best-edges", w("ovl_paf"), w("gkp"), "-o", w("edges.tsv")]),
        ("dump-reads", ["dump-reads", w("gkp"), "-o", w("dump.fasta"), "-b", "10", "-e", "60"]),
        ("dump-meta", ["dump-meta", w("gkp"), "-bin", "500"]),
        ("options", ["options"]),
        ("options markdown", ["options", "-markdown"]),
        ("bogus", ["bogus", "-genome", w("genome.fasta"), "-assembly", w("contigs.fasta"),
                   "-intervals", "-verbose"]),
    ]
    return steps


def _revcomp_str(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def tools_setup(work: str, ReadSet) -> None:
    """The session's inputs beside the simulated reads, made by numpy from
    TOOLS_SETUP_SEED: the read store ``gkp`` (of the package's ReadSet),
    ``reads.paf`` (3,000 random PAF lines between the reads) and
    ``contigs.fasta``, the contigs the bogus step judges: the whole genome
    with 1% point errors, a misjoin (two genome pieces glued at
    TOOLS_MISJOIN, or a seventh of a smaller genome) and, reverse-complemented, a piece that drops
    TOOLS_COLLAPSE bases (a collapsed repeat copy)."""
    rng = np.random.default_rng(TOOLS_SETUP_SEED)
    rs, _ = ReadSet.from_fastx([os.path.join(work, "reads.fasta")])
    rs.save(os.path.join(work, "gkp"))
    names = [rs.name(i) for i in range(1, rs.n_reads + 1)]
    lens = np.asarray(rs.length, np.int64)
    with open(os.path.join(work, "reads.paf"), "w") as fh:
        for _ in range(3000):
            q, t = rng.choice(rs.n_reads, size=2, replace=False)
            span = int(rng.integers(200, max(201, min(lens[q], lens[t]))))
            qs = int(rng.integers(0, lens[q] - span + 1))
            ts = int(rng.integers(0, lens[t] - span + 1))
            alen = span + int(rng.integers(0, 50))
            nm = int(alen * rng.uniform(0.8, 1.0))
            fh.write(f"{names[q]}\t{lens[q]}\t{qs}\t{qs + span}\t{'+-'[rng.integers(2)]}\t"
                     f"{names[t]}\t{lens[t]}\t{ts}\t{ts + span}\t{nm}\t{alen}\t60\n")
    g = fasta_records(os.path.join(work, "genome.fasta"))[0][1]
    G = len(g)
    noisy = np.frombuffer(g.encode(), np.uint8).copy()
    pos = rng.choice(G, size=G // 100, replace=False)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    code = np.searchsorted(acgt, noisy[pos])
    noisy[pos] = acgt[(code + rng.integers(1, 4, size=len(pos))) % 4]
    # the misjoin's second piece starts a jump of at least 6 kb on, past
    # the 5 kb that evaluate_assembly still merges as a structural indel
    m = min(TOOLS_MISJOIN, G // 7)
    s0, jump = G // 4, max(m, 6000)
    c0 = G // 2
    contigs = [("noisy_copy", noisy.tobytes().decode()),
               ("misjoin", g[s0 : s0 + m] + g[s0 + m + jump : s0 + 2 * m + jump]),
               ("collapse", _revcomp_str(g[c0 : c0 + 2 * m]
                                         + g[c0 + 2 * m + TOOLS_COLLAPSE : G - G // 8]))]
    with open(os.path.join(work, "contigs.fasta"), "w") as fh:
        for name, seq in contigs:
            fh.write(f">{name}\n{seq}\n")


def tools_run(main, argv: list[str], **kw) -> tuple[int, str, str]:
    """One tools step in this process: (exit code, stdout, stderr)."""
    import contextlib
    import io
    import warnings

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(argv, **kw)
    return rc, out.getvalue(), err.getvalue()


def file_digest(path: str) -> str:
    """sha256 of an output: a file's bytes; an .npz archive's arrays (name,
    dtype, shape, bytes; its zip members carry timestamps); a directory's
    files in name order, each as its name and digest."""
    h = hashlib.sha256()
    if os.path.isdir(path):
        for f in sorted(os.listdir(path)):
            h.update(f"{f}\t{file_digest(os.path.join(path, f))}\n".encode())
    elif path.endswith(".npz"):
        with np.load(path) as z:
            for n in sorted(z.files):
                a = np.ascontiguousarray(z[n])
                h.update(f"{n}\t{a.dtype.str}\t{a.shape}\n".encode())
                h.update(a.tobytes())
    else:
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()


def tools_outputs(work: str, before: set) -> dict:
    """{name: file_digest} of the entries a step added to ``work``."""
    return {f: file_digest(os.path.join(work, f)) for f in sorted(set(os.listdir(work)) - before)}


def tools_record(work: str, rc: int, out: str, err: str, files: dict) -> dict:
    """A step's result as the references hold it: the exit code, the sha256
    of its stdout and stderr with the work directory written <work>, and
    its output files' digests."""
    def sha(s):
        return hashlib.sha256(s.replace(work, "<work>").encode()).hexdigest()

    return {"rc": rc, "stdout": sha(out), "stderr": sha(err), "files": files}


def db22_loaded_as_saved(kmer_module):
    """``around`` for run_tools_session: during the TOOLS_DB22_STEPS,
    ``kmer_module.KmerCounts.load`` keeps the saved k-mer dtype.
    canu_tpu's load casts a k > 16 DB's exact uint64 k-mers to uint32, so
    its reference of those steps is its result on the DB as counted and
    saved."""
    import contextlib

    KC = kmer_module.KmerCounts

    def load(path: str):
        p = str(path)
        if not p.endswith(".npz") and os.path.exists(p + ".npz"):
            p = p + ".npz"
        with np.load(p) as z:
            return KC(int(z["k"]), z["unique"], z["counts"].astype(np.int64))

    @contextlib.contextmanager
    def around(name: str):
        real = KC.load
        if name in TOOLS_DB22_STEPS:
            KC.load = staticmethod(load)
        try:
            yield
        finally:
            KC.load = real

    return around


def run_tools_session(work: str, genome: int, main, ReadSet, around=None, **kw):
    """Run tools_session in ``work`` with a package's tools ``main`` and
    ``ReadSet``; ``around(name)``, if given, is a context manager entered
    around each step; ``kw`` goes to main.  Returns ({name: tools_record},
    {name: wall seconds}, {name: stdout})."""
    import contextlib
    import time

    recs, secs, outs = {}, {}, {}
    for name, argv in tools_session(work, genome):
        before = set(os.listdir(work))
        t = time.time()
        with (around(name) if around else contextlib.nullcontext()):
            if argv is None:
                tools_setup(work, ReadSet)
                rc, out, err = 0, "", ""
            else:
                rc, out, err = tools_run(main, argv, **kw)
        secs[name] = time.time() - t
        recs[name] = tools_record(work, rc, out, err, tools_outputs(work, before))
        outs[name] = out.replace(work, "<work>")
    return recs, secs, outs


# ---- kernels K5 and K6: the MinHash sketch and block matcher --------------

# (k, H, frequent table): k = 16 (one lane) and 22 (the two-lane fold), the
# sensitivity presets' widest H and a lone slot, the no-op sentinel and a
# table of thousands of keys, most >= 2^31, that holds every key of read 5
SKETCH_EDGE_CASES = tuple((k, H, fk) for k in (16, 22) for H in (1, 64, 768)
                          for fk in ("sentinel", "frequent"))
SKETCH_EDGE_WORDS = 8  # 128 bases a padded read


def sketch_edge_case(k: int, H: int, fk: str, seed: int = 3):
    """(words uint32[10, 8], lengths int32[10], seeds uint32[H], fk
    uint32[F], k) of ops.minhash._sketch_kernel: reads of 0, k - 1, k, 17,
    33, 100, 127, 55, 128 bases and a copy of read 5 shortened to 90
    (lengths off the 16-base words, the window walk's ends; the words past
    each read zero, as ReadSet.block_words pads).  With fk="frequent",
    every key of read 5 is frequent, so its row is UINT32_MAX."""
    from canu_tpu_torch.ops.hashing import hash_seeds
    from canu_tpu_torch.ops.kmer import INVALID_KMER, extract_kmers_any

    rng = np.random.default_rng(seed + k)
    W = SKETCH_EDGE_WORDS
    lens = [0, k - 1, k, 17, 33, 100, 127, 55, 16 * W, 90]
    words = rng.integers(0, 2**32, (len(lens), W), dtype=np.uint64).astype(np.uint32)
    words[9] = words[5]
    for r, n in enumerate(lens):
        nw = -(-n // 16)
        words[r, nw:] = 0
        if n % 16:
            words[r, nw - 1] &= np.uint32((1 << (2 * (n % 16))) - 1)
    lengths = np.asarray(lens, np.int32)
    seeds = hash_seeds(H, 11 + H)
    if fk == "sentinel":
        table = np.full(1, 0xFFFFFFFF, np.uint32)
    else:
        canon, _ = extract_kmers_any(torch.from_numpy(words.astype(np.int64)),
                                     torch.from_numpy(lengths), k)
        keys = canon.numpy()
        own = keys[5][keys[5] != INVALID_KMER]
        other = keys[6][keys[6] != INVALID_KMER][:7]
        high = rng.integers(2**31, 2**32, 3000, dtype=np.uint64)
        table = np.unique(np.concatenate([own, other, high]).astype(np.uint64)).astype(np.uint32)
    return words, lengths, seeds, table, k


# (Na, Nb, H, min_matches, self_block, max_out): self and cross blocks,
# Na != Nb, block edges off the 64-cell tiles, max_out above and below
# n_found, min_matches 0 (every cell set)
MATCH_EDGE_CASES = ((70, 70, 40, 2, True, 10_000), (70, 130, 33, 3, False, 50),
                    (1, 5, 7, 1, False, 8), (129, 129, 65, 1, True, 100),
                    (64, 64, 32, 0, False, 5_000), (200, 65, 64, 2, False, 20))


def match_edge_case(Na: int, Nb: int, H: int, seed: int = 5):
    """(SA uint32[Na, H], SB uint32[Nb, H]) of ops.minhash._match_kernel:
    values from a small alphabet so that many slots agree, a fifth of the
    slots UINT32_MAX, SA's row 3 an empty read's (all UINT32_MAX: never a
    match) and row 0 values >= 2^31, which SB's row 0 repeats.  A self block uses SA as
    SB."""
    rng = np.random.default_rng(seed + Na + 7 * Nb + 31 * H)
    SA = rng.integers(0, 6, (Na, H)).astype(np.uint32)
    SB = rng.integers(0, 6, (Nb, H)).astype(np.uint32)
    SA[SA == 5] = 0xFFFFFFFF
    SB[SB == 5] = 0xFFFFFFFF
    SA[3 % Na] = 0xFFFFFFFF
    SA[0] = rng.integers(2**31, 2**32, H, dtype=np.uint64).astype(np.uint32)
    SB[0 % Nb] = SA[0, :]
    return SA, SB


# kernel K6's block pairs (a count launch and a compact launch each):
# name -> (Na, Nb, H, min_matches, self_block, max_out, alphabet) of
# match_pair_case; the pipeline's blocks are 1,024 reads, H 512
MATCH_PAIR_CASES = {
    "1 x 1": (1, 1, 512, 2, False, 1 << 17, 6),
    "1 x 1 self": (1, 1, 512, 2, True, 1 << 17, 6),
    "1 x 1024": (1, 1024, 512, 2, False, 1 << 17, 6),
    "1024 x 1": (1024, 1, 512, 2, False, 1 << 17, 6),
    "self, set cells in one tile row": (300, 300, 64, 3, True, 5000, 0),
    "n_found above max_out": (200, 150, 40, 2, False, 100, 6),
    "max_out 0": (130, 70, 33, 2, True, 0, 6),
    "Na above 1024": (1100, 70, 48, 3, False, 1 << 17, 6),
    "self, Na above 1024": (1300, 1300, 24, 4, True, 1 << 17, 16),
    "Na above 2,048, Nb 3": (2200, 3, 16, 2, False, 1 << 13, 6),
    "Nb above 32 column tiles": (5, 2100, 16, 2, False, 20_000, 6),
}


def match_pair_case(name: str):
    """MATCH_PAIR_CASES[name]'s block pair: (SA uint32[Na, H], SB
    uint32[Nb, H], min_matches, self_block, max_out), SB SA itself for a
    self block.  Values from a small alphabet whose last letter is
    UINT32_MAX (an empty slot); in blocks of more than 3 reads SA's row 3
    an empty read's and row 0 values >= 2^31 that SB's row 0 repeats
    (match_edge_case's rows); alphabet 0:
    distinct values but for rows 64-95 of a self block, each sharing 3-9
    slots with two rows past 127 (other slots for each), so every set cell
    lies in one tile row (of K6's 32 rows, and of 64)."""
    Na, Nb, H, mm, self_block, max_out, alphabet = MATCH_PAIR_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if alphabet:
        SA = rng.integers(0, alphabet, (Na, H)).astype(np.uint32)
        SB = rng.integers(0, alphabet, (Nb, H)).astype(np.uint32)
        SA[SA == alphabet - 1] = 0xFFFFFFFF
        SB[SB == alphabet - 1] = 0xFFFFFFFF
        if min(Na, Nb) > 3:
            SA[3] = 0xFFFFFFFF
            SA[0] = rng.integers(2**31, 2**32, H, dtype=np.uint64).astype(np.uint32)
            SB[0] = SA[0]
    else:
        SA = (np.arange(Na * H, dtype=np.uint32) * 7 + 11).reshape(Na, H)  # no two equal
        SB = SA
        later = rng.permutation(np.arange(128, Na))
        for i in range(64, 96):  # two rows past 127 share slots with row i
            h = rng.permutation(H)
            j1, j2 = later[2 * (i - 64)], later[2 * (i - 64) + 1]
            n1, n2 = rng.integers(3, 10, 2)
            SA[j1, h[:n1]] = SA[i, h[:n1]]
            SA[j2, h[n1 : n1 + n2]] = SA[i, h[n1 : n1 + n2]]
    return SA, (SA if self_block else SB), mm, self_block, max_out


# ---- chip_smoke.py's frequent-mer drive (phase 4c) --------------------------

# the bench genome's size and read shapes, with a 1.5 kb repeat family of 24
# copies (12% of the genome): the cor meryl's table holds ~1,500 k=16 mers.
# cor runs on raw reads (10% error), obt on corrected ones (3%), as the
# bench read sets of phases 4 and 6 are
FREQUENT_GENOME = (300_000, 45, [(1500, 24)])
FREQUENT_SIM = dict(coverage=12, mean_len=3500, min_len=1500, max_len=7800)
FREQUENT_READS = {"cor": dict(error_rate=0.10, seed=46), "obt": dict(error_rate=0.03, seed=47)}


def frequent_reads(sim, ReadSet, tag: str):
    """The frequent-mer drive's read set for stage `tag` from either
    package's simulator module and ReadSet class: the simulated reads plus
    one chimeric read (the longest read's first half, then its second half
    reverse-complemented), whose pair with that read is palindromic: obt
    verifies it in both orientations."""
    length, seed, repeats = FREQUENT_GENOME
    g = sim.random_genome(length, seed=seed, repeat_spec=repeats)
    rs, _ = sim.simulate_reads(g, **FREQUENT_SIM, **FREQUENT_READS[tag])
    codes = [rs.get_codes(i) for i in range(1, rs.n_reads + 1)]
    c = max(codes, key=len)
    h = len(c) // 2
    codes.append(np.concatenate([c[:h], (3 - c[h:])[::-1]]).astype(np.uint8))
    return ReadSet.from_codes_list(codes, [f"r{i}" for i in range(len(codes))])


def candidates_digest(pairs: np.ndarray) -> str:
    """sha256 of a candidate list's int64 little-endian bytes, C order."""
    return hashlib.sha256(np.ascontiguousarray(np.asarray(pairs).astype("<i8")).tobytes()
                          ).hexdigest()


# ---- verify's anchor-and-inputs step (K7) and the syncmer index (K8) --------

# (k, index words a read W, band, orient): k 16 and 22, a power-of-two W and
# one that is not (the shift masks of _shift_rows, the stride-16 centre grid
# cut at n_rows + 1 = 16 W + 1), bands 128, 256 and 1024, the strand vote
# and the given orientation
VERIFY_PRE_EDGE_CASES = ((16, 64, 128, True), (16, 96, 256, False), (22, 64, 1024, True),
                         (22, 96, 128, False), (16, 64, 1024, False), (22, 96, 256, True))
VERIFY_PRE_CHUNK = 32  # pairs a chunk: each case is a group of 3 chunks
# (k, W, band, orient, n_rows): verify_pre_edge_case's pairs with base and
# centre rows whose widths are no multiple of 16 bytes (rows that start and
# end off 16-byte boundaries)
VERIFY_PRE_ODD_CASES = ((16, 64, 200, True, 16 * 64 - 5), (22, 96, 136, False, 16 * 96 - 9))


def _plant(planes: dict, row: int, keys, pos, strands) -> None:
    n = len(keys)
    planes["mker"][row] = 0xFFFFFFFF
    planes["mpos"][row] = -1
    planes["mstr"][row] = 0
    planes["mker"][row, :n] = keys
    planes["mpos"][row, :n] = pos
    planes["mstr"][row, :n] = strands


def verify_pre_edge_case(k: int, W: int, band: int, orient: bool, seed: int = 9):
    """(planes, a_idx int64[96], b_idx int64[96], flipped bool[96], n_rows)
    for ops.align._verify_pre in 3 chunks of VERIFY_PRE_CHUNK pairs.  planes
    (words, length, mker uint32 / int32 numpy, n_reads, pm) is the port's
    read index of reads of 400-1,000 bases (the plain index on the CPU),
    its words padded to W columns, with rows 0-5 replaced: reads 0 and 1
    share one key (one anchor); 2 and 3 share four, two of them on
    opposite strands (n_same == n_opp); 4 and 5 share four keys, one of
    them twice in each read (only read 4's later copy and read 5's first
    copy join), three of read 4's at one position (repeated anchor
    positions: the dx == 0 branch of the centres); 10 and 11 share a
    chain of five keys whose centre at row 16 rounds one way in
    jnp.interp's order of operations and the other with the product taken
    first.  The pairs: those planted (the first three both ways), the all-zero padding row against itself and a read
    (zero anchors, length 0), two reads against themselves (more than
    MAX_ANCHORS kept: the even subsample), true overlaps of the simulated
    reads and random pairs; flipped drawn at random."""
    from canu_tpu_torch.ops.minimizers import build_read_index
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads, true_overlaps

    rng = np.random.default_rng(seed + k + W + band)
    g = random_genome(6000, seed=seed)
    rs, truth = simulate_reads(g, coverage=8, mean_len=800, min_len=400, max_len=1000,
                               error_rate=0.08, seed=seed + 1)
    idx = build_read_index(rs, k=k, block_size=32, device="cpu")
    words = idx.words.numpy().astype(np.uint32)
    planes = {"words": np.zeros((words.shape[0], W), np.uint32),
              "length": idx.length.numpy().copy(), "mker": idx.mker.numpy().astype(np.uint32),
              "mpos": idx.mpos.numpy().copy(), "mstr": idx.mstr.numpy().copy(),
              "n_reads": idx.n_reads, "pm": idx.pm}
    planes["words"][:, : words.shape[1]] = words
    used = set(planes["mker"].ravel().tolist())
    fresh = iter(x for x in range(0x0100_0000, 0x0200_0000, 7919) if x not in used)
    K = [next(fresh) for _ in range(40)]
    K[:4] = sorted(K[:4])
    _plant(planes, 0, [K[10], K[0], K[11]], [40, 300, 500], [0, 0, 1])
    _plant(planes, 1, [K[12], K[13], K[0]], [10, 20, 250], [1, 0, 0])
    _plant(planes, 2, K[:4] + [K[14]], [100, 200, 300, 400, 450], [0, 0, 0, 0, 1])
    _plant(planes, 3, [K[15]] + K[:4], [5, 80, 190, 290, 380], [0, 0, 0, 1, 1])
    _plant(planes, 4, [K[0], K[1], K[2], K[0], K[3], K[16]], [200, 200, 200, 300, 400, 420],
           [0, 0, 0, 0, 0, 1])
    _plant(planes, 5, [K[0], K[1], K[2], K[3], K[0], K[17]], [100, 110, 120, 300, 50, 310],
           [0, 0, 0, 0, 0, 1])
    # a chain whose forward centre at row 16 is 14.5000005 in jnp.interp's
    # order, (16 - 4) / 40 * 45 + 1, and 14.5 (rounded to 14) with the
    # product taken first
    _plant(planes, 10, K[20:25], [280, 290, 300, 304, 344], [0, 0, 0, 0, 0])
    _plant(planes, 11, K[20:25], [282, 291, 300, 301, 346], [0, 0, 0, 0, 0])
    pad = idx.n_reads
    pairs = [(0, 1), (1, 0), (2, 3), (3, 2), (4, 5), (5, 4), (pad, pad), (pad, 7), (7, pad),
             (8, 8), (9, 9), (10, 11)]
    ov = true_overlaps(truth, min_overlap=200)
    ov = ov[(ov[:, 0] > 12) & (ov[:, 1] > 12)]
    pick = rng.choice(len(ov), size=min(len(ov), 50), replace=False)
    pairs += [(int(a) - 1, int(b) - 1) for a, b, _ in ov[pick]]
    n = 3 * VERIFY_PRE_CHUNK
    while len(pairs) < n:
        pairs.append(tuple(int(x) for x in rng.integers(0, idx.n_reads, 2)))
    a_idx = np.asarray([a for a, _ in pairs], np.int64)
    b_idx = np.asarray([b for _, b in pairs], np.int64)
    flipped = rng.random(n) < 0.5
    flipped[11] = False
    return planes, a_idx, b_idx, flipped, 16 * W


# (k, words a read W, pm): k 16 and 22, pm above n_sel and a small pm below
# it (n_sel > pm), reads shorter and longer than 16 words
SYNCMER_EDGE_CASES = ((16, 8, 64), (16, 8, 6), (22, 8, 64), (22, 8, 6), (16, 64, 512),
                      (22, 64, 256))


def _mix32_inverse(y: int) -> int:
    def unxorshift(x, s):
        r = x
        for _ in range(32 // s + 1):
            r = x ^ (r >> s)
        return r & 0xFFFFFFFF

    y = unxorshift(y, 16)
    y = (y * pow(0xC2B2AE35, -1, 1 << 32)) & 0xFFFFFFFF
    y = unxorshift(y, 13)
    y = (y * pow(0x85EBCA6B, -1, 1 << 32)) & 0xFFFFFFFF
    return unxorshift(y, 16)


def _kmer_bases(v: int, k: int) -> np.ndarray:
    return np.asarray([(v >> (2 * (k - 1 - j))) & 3 for j in range(k)], np.uint8)


def _pack_codes(codes: np.ndarray, W: int) -> np.ndarray:
    out = np.zeros(W, np.uint32)
    for i, c in enumerate(codes):
        out[i // 16] |= np.uint32(int(c) << (2 * (i % 16)))
    return out


def umax_key_kmer(k: int, seed: int = 13):
    """The bases of a canonical k-mer that open-syncmer selection keeps and
    whose key's mix32 is UINT32_MAX (it ties with every unselected position
    in ops.minimizers._syncmer_kernel's compaction), found by a seeded
    search, or None where there is none: at k <= 16 the one k-mer with that
    key, at 16 < k <= 32 every high lane with its low lane solved through
    the inverse mix32."""
    from canu_tpu_torch.ops.minimizers import _syncmer_kernel_plain

    target = _mix32_inverse(0xFFFFFFFF)  # the key whose mix32 is UINT32_MAX
    if k <= 16:
        cands = [target] if target < 1 << (2 * k) else []
    else:
        y = _mix32_inverse(target)  # hi ^ mix32(lo) of the fold
        his = np.random.default_rng(seed).permutation(1 << (2 * k - 32))
        cands = [(int(h) << 32) | _mix32_inverse(y ^ int(h)) for h in his[:512]]
    W = -(-k // 16)
    for v in cands:
        bases = _kmer_bases(v, k)
        rc = int("".join(str(3 - b) for b in bases[::-1]), 4)
        if v > rc:  # not canonical: its key is the reverse complement's
            continue
        words = torch.from_numpy(_pack_codes(bases, W).astype(np.int64))[None]
        n_sel = _syncmer_kernel_plain(words, torch.tensor([k], dtype=torch.int32), k, 4)[3]
        if int(n_sel[0]) == 1:
            return bases
    return None


def syncmer_edge_case(k: int, W: int, pm: int, seed: int = 7):
    """(words uint32[B, W], lengths int32[B]) of ops.minimizers
    ._syncmer_kernel: random reads of 0, k - 1, k, 17, 33, 55 and 90 bases,
    16 W - 5 and 16 W; a read of a repeated 37-base motif (repeated k-mers:
    ties in key); and, where umax_key_kmer(k) finds one, a read holding
    that k-mer three times (a selected position of key UINT32_MAX) and a
    read of 16 W - 3 bases holding it once past its middle.  The words past
    each read are zero, as ReadSet.block_words pads."""
    rng = np.random.default_rng(seed + 31 * k + W)
    L = 16 * W
    lens = [0, k - 1, k, 17, 33, 55, 90, L - 5, L]
    reads = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    motif = rng.integers(0, 4, 37).astype(np.uint8)
    reads.append(np.tile(motif, -(-(L - 9) // 37))[: L - 9])
    planted = umax_key_kmer(k)
    if planted is not None:
        r = rng.integers(0, 4, min(L, 200)).astype(np.uint8)
        for p in (30, 70, 140):
            if p + k <= len(r):
                r[p : p + k] = planted
        reads.append(r)
        r = rng.integers(0, 4, L - 3).astype(np.uint8)
        p = (L - 3) // 2 + 11
        r[p : p + k] = planted
        reads.append(r)
    words = np.stack([_pack_codes(r, W) for r in reads])
    return words, np.asarray([len(r) for r in reads], np.int32)


LONG_READ_W = 16384  # index words a read once any read exceeds 131,072 bases


def verify_pre_long_case(seed: int = 21):
    """verify_pre_edge_case's (planes, a_idx, b_idx, flipped, n_rows) for a
    read set whose reads exceed 131,072 bases, so the index's W is
    LONG_READ_W (n_rows 262,144): four reads of 135-170 kb at 5% error from
    one 200 kb genome (circular: they overlap) and a 2 kb read, their plain index at k 16 (Pm
    2,048).  The pairs, 3 chunks of 4: overlapping long reads both ways,
    the short read against long reads it overlaps and one it does not, a
    long read against the short one, the padding row against a long read,
    a long read against itself; flipped drawn at random (the strand vote
    picks it, or it is given)."""
    from canu_tpu_torch.ops.minimizers import build_read_index
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads
    from canu_tpu_torch.stores.readset import ReadSet

    g = random_genome(200_000, seed=seed)
    long_rs, _ = simulate_reads(g, coverage=2.6, mean_len=150_000, min_len=135_000,
                                max_len=170_000, error_rate=0.05, seed=seed + 1)
    reads = [long_rs.get_codes(i) for i in range(1, 5)] + [g[1000:3000].astype(np.uint8)]
    rs = ReadSet.from_codes_list(reads)
    idx = build_read_index(rs, k=16, device="cpu")
    assert idx.words.shape[1] == LONG_READ_W, idx.words.shape
    planes = {"words": idx.words.numpy().astype(np.uint32), "length": idx.length.numpy(),
              "mker": idx.mker.numpy().astype(np.uint32), "mpos": idx.mpos.numpy(),
              "mstr": idx.mstr.numpy(), "n_reads": idx.n_reads, "pm": idx.pm}
    pad = idx.n_reads
    pairs = [(0, 1), (1, 0), (0, 2), (2, 1), (1, 3), (3, 2), (4, 1), (pad, 3), (4, 0), (2, 4),
             (4, 2), (3, 3)]
    flipped = np.random.default_rng(seed).random(len(pairs)) < 0.5
    return (planes, np.asarray([a for a, _ in pairs], np.int64),
            np.asarray([b for _, b in pairs], np.int64), flipped, 16 * LONG_READ_W)


# ---- the long-read stage gate: reads above 131,072 bases through `cor` ------

# a circular genome and raw reads of 132-170 kb at 10% error: every read
# exceeds 131,072 bases, so the read index's W is LONG_READ_W and the
# verify runs 16 W = 262,144 rows a pair (the long-read coordinates of the
# band centres and the syncmer cut at pm)
LONGREAD_GENOME = (300_000, 23)
LONGREAD_SIM = {"coverage": 3, "mean_len": 150_000, "min_len": 132_000, "max_len": 170_000,
                "error_rate": 0.10, "seed": 24}


def longread_reads(sim):
    """The long-read gate's read set from a simulator module (canu_tpu's or
    the port's: the same reads)."""
    length, seed = LONGREAD_GENOME
    rs, _ = sim.simulate_reads(sim.random_genome(length, seed=seed), **LONGREAD_SIM)
    return rs


PLACED_COLS = ("a_id", "b_id", "flipped", "diag", "n_shared", "a_lo", "a_hi", "b_lo", "b_hi")


def placed_digest(placed) -> str:
    """sha256 of placed candidates' nine columns (int64 little-endian, the
    flags as 0/1), rows in their order: equal digests mean equal
    place_candidates results, whichever package made them."""
    h = hashlib.sha256()
    for c in PLACED_COLS:
        h.update(np.ascontiguousarray(np.asarray(getattr(placed, c)).astype("<i8")).tobytes())
    return h.hexdigest()


def readset_digest(rs) -> str:
    """sha256 of a read set's lengths (int64) and its 2-bit bases, read by
    read (uint8 codes), little-endian, C order."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(rs.length).astype("<i8")).tobytes())
    for i in range(1, rs.n_reads + 1):
        h.update(np.ascontiguousarray(rs.get_codes(i).astype(np.uint8)).tobytes())
    return h.hexdigest()


# ---- K7 at the sizes of its sorts, K8 at its cut at pm ------------------------

# (name, a row, b row) of verify_pre_size_case's planted pairs
VERIFY_PRE_SIZE_PAIRS = (("1 entry", 0, 1), ("2 entries", 2, 3), ("2,048 entries", 4, 5),
                         ("4,096 entries", 6, 7), ("one key", 8, 9), ("a read with itself", 10, 10),
                         ("the first inlier before B's start", 11, 12),
                         ("a short B read", 13, 14), ("diagonals across 256", 15, 16),
                         ("a B row out of order with a key twice", 17, 18))


def verify_pre_size_case(k: int = 16, seed: int = 19):
    """verify_pre_edge_case's (planes, a_idx, b_idx, flipped, n_rows) at Pm
    2,048 (reads of 6-8 kb, W 512) with rows 0-9 replaced so that the
    planted pairs' join holds 1 valid entry (0: one, 1: none), 2 (one key
    shared), 2,048 (1,024 a read, half of them shared, row 4 in K8's
    mix32 order and row 5 shuffled), 4,096 (2,048 a read, most shared,
    along a diagonal with strays, both strands) and 4,096 entries of one
    key (rows 8 and 9: the join's one hit is row 8's last entry and row
    9's first); row 10 is a read's own row, joined with itself; rows 11
    and 12 share five keys on opposite strands whose first (smallest posA)
    lies at posB lenB - k + 5, so at -5 on the flipped B (not kept: the
    chain starts against -1); row 14 is cut to 600 bases, so its tol with
    row 13 is 180, not 0.3 lenA, and a hit 800 off the diagonal is no
    inlier; rows 15 and 16 share five keys on diagonals 10, 20, 300, 310
    and 320 (the median's radix select starts at bit 8); row 18 holds
    row 17's two keys out of mix32 order, the first of them twice (only
    its first copy joins).  The pairs, 5 chunks of 4: each planted pair
    both ways (the read with itself once) and the padding row against row
    6; flipped drawn at random."""
    from canu_tpu_torch.ops.hashing import mix32
    from canu_tpu_torch.ops.minimizers import build_read_index
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    rng = np.random.default_rng(seed + k)
    g = random_genome(30_000, seed=seed)
    rs, _ = simulate_reads(g, coverage=5, mean_len=7000, min_len=6000, max_len=8000,
                           error_rate=0.08, seed=seed + 1)
    idx = build_read_index(rs, k=k, device="cpu")
    assert idx.pm == 2048 and rs.n_reads > 18, (idx.pm, rs.n_reads)
    planes = {"words": idx.words.numpy().astype(np.uint32), "length": idx.length.numpy().copy(),
              "mker": idx.mker.numpy().astype(np.uint32), "mpos": idx.mpos.numpy().copy(),
              "mstr": idx.mstr.numpy().copy(), "n_reads": idx.n_reads, "pm": idx.pm}
    keys = rng.choice(0xFFFFFFFE, size=8192, replace=False).astype(np.int64)

    def mix_order(ks):
        return np.argsort(mix32(torch.from_numpy(ks)).numpy(), kind="stable")

    _plant(planes, 0, [keys[0]], [100], [0])
    _plant(planes, 1, [], [], [])
    _plant(planes, 2, [keys[1]], [300], [1])
    _plant(planes, 3, [keys[1]], [250], [0])
    # 1,024 a read, 512 shared, on a diagonal 60 apart with a jitter
    shared = keys[2:514]
    ka = np.concatenate([shared, keys[514:1026]])
    kb = np.concatenate([shared, keys[1026:1538]])
    pa = np.concatenate([np.arange(512) * 12 + rng.integers(0, 6, 512),
                         rng.integers(0, 6500, 512)]).astype(np.int32)
    pb = np.concatenate([np.arange(512) * 12 + 60 + rng.integers(0, 6, 512),
                         rng.integers(0, 6500, 512)]).astype(np.int32)
    o = mix_order(ka)
    _plant(planes, 4, ka[o], pa[o], rng.integers(0, 2, 1024)[o])
    o = rng.permutation(1024)
    _plant(planes, 5, kb[o], pb[o], rng.integers(0, 2, 1024)[o])
    # 2,048 a read, 1,800 shared: a diagonal with strays, both strands
    shared = keys[1538:3338]
    ka = np.concatenate([shared, keys[3338:3586]])
    kb = np.concatenate([shared, keys[3586:3834]])
    pa = np.concatenate([np.sort(rng.integers(0, 7000, 1800)), rng.integers(0, 7000, 248)])
    pb = pa.copy()
    pb[:1800] = np.clip(pa[:1800] - 300 + rng.integers(-4, 5, 1800), 0, None)
    pb[1500:1600] = rng.integers(0, 7000, 100)  # strays off the diagonal
    sa = rng.integers(0, 2, 2048)
    sb = sa.copy()
    sb[:200] ^= 1  # the minority orientation
    o = mix_order(ka)
    _plant(planes, 6, ka[o], pa[o].astype(np.int32), sa[o])
    o = mix_order(kb)
    _plant(planes, 7, kb[o], pb[o].astype(np.int32), sb[o])
    # one key throughout both reads
    _plant(planes, 8, np.full(2048, keys[4000]), rng.integers(0, 7000, 2048).astype(np.int32),
           rng.integers(0, 2, 2048))
    _plant(planes, 9, np.full(2048, keys[4000]), rng.integers(0, 7000, 2048).astype(np.int32),
           rng.integers(0, 2, 2048))
    lenB = int(planes["length"][12])
    _plant(planes, 11, keys[4001:4006], [10, 20, 30, 40, 50], [0, 0, 0, 0, 0])
    _plant(planes, 12, keys[4001:4006], [lenB - k + 5, lenB - k - 15, lenB - k - 25,
                                          lenB - k - 35, lenB - k - 45], [1, 1, 1, 1, 1])
    planes["length"][14] = 600
    _plant(planes, 13, keys[4006:4011], [100, 200, 300, 400, 1300], [0, 0, 0, 0, 0])
    _plant(planes, 14, keys[4006:4011], [100, 200, 300, 400, 500], [0, 0, 0, 0, 0])
    _plant(planes, 15, keys[4011:4016], [1000, 1100, 1200, 1300, 1400], [0, 0, 0, 0, 0])
    _plant(planes, 16, keys[4011:4016], [990, 1080, 900, 990, 1080], [0, 0, 0, 0, 0])
    x, y = keys[4016], keys[4017]
    _plant(planes, 17, [x, y], [100, 200], [0, 0])
    _plant(planes, 18, [x, y, x], [100, 200, 150], [0, 0, 0])
    pad = idx.n_reads
    pairs = [(0, 1), (1, 0), (2, 3), (3, 2), (4, 5), (5, 4), (6, 7), (7, 6), (8, 9), (9, 8),
             (10, 10), (pad, 6), (11, 12), (12, 11), (13, 14), (14, 13), (15, 16), (16, 15),
             (17, 18), (18, 17)]
    flipped = rng.random(len(pairs)) < 0.5
    return (planes, np.asarray([a for a, _ in pairs], np.int64),
            np.asarray([b for _, b in pairs], np.int64), flipped, 16 * planes["words"].shape[1])


VERIFY_PRE_SIZE_CHUNK = 4  # pairs a chunk: verify_pre_size_case is 5 chunks


def syncmer_cut_case(k: int, seed: int = 29):
    """(words uint32[5, W], lengths int32[5], pm) for
    ops.minimizers._syncmer_kernel at its cut at pm: a read of a repeated
    41-base motif whose (key, position) order has equal keys at slots pm -
    1 and pm (pm chosen so), then random reads cut so that they select pm -
    1, pm and pm + 1 positions, and one that selects 2 pm (the cut inside
    its keys).  Words past each read are zero."""
    from canu_tpu_torch.ops.minimizers import _syncmer_kernel_plain

    rng = np.random.default_rng(seed + k)
    W = 256
    L = 16 * W

    def selected(codes):
        words = torch.from_numpy(_pack_codes(codes, W).astype(np.int64))[None]
        mk, mp, _ms, n = _syncmer_kernel_plain(words, torch.tensor([len(codes)], dtype=torch.int32),
                                               k, L)
        return mk[0, : int(n[0])].numpy(), mp[0, : int(n[0])].numpy()

    motif = rng.integers(0, 4, 41).astype(np.uint8)
    rep = np.tile(motif, -(-(L - 7) // 41))[: L - 7]
    rep[::97] = rng.integers(0, 4, len(rep[::97]))  # a few changes: runs of equal keys
    mk, _ = selected(rep)
    from canu_tpu_torch.ops.hashing import mix32

    mx = mix32(torch.from_numpy(mk.astype(np.int64))).numpy()
    ties = [i for i in range(40, len(mx)) if mx[i - 1] == mx[i]]
    assert ties, "the motif read has no tie to cut at"
    pm = ties[0]
    reads = [rep]
    base = rng.integers(0, 4, L).astype(np.uint8)
    pos = np.sort(selected(base)[1])
    assert len(pos) > 2 * pm, (len(pos), pm)
    for n in (pm - 1, pm, pm + 1):
        reads.append(base[: int(pos[n - 1]) + k])
    reads.append(base[: int(pos[2 * pm - 1]) + k])
    words = np.stack([_pack_codes(r, W) for r in reads])
    return words, np.asarray([len(r) for r in reads], np.int32), pm


def bucket_reads(sim, seed: int = 33):
    """The codes of reads whose length buckets (block_size 4) pad to
    different widths: 16 bases to 9 kb, so the buckets' W runs from 8 to
    1,024 words and the index's global W is 1,024 (pm 2,048)."""
    g = sim.random_genome(40_000, seed=seed)
    rng = np.random.default_rng(seed)
    codes = []
    for n in (40, 60, 120, 200, 310, 500, 700, 1000, 1500, 2100, 3000, 4100, 5000, 6500, 8200,
              9000, 90, 2600, 16, 7000):
        s = int(rng.integers(0, len(g) - n))
        codes.append(g[s : s + n].astype(np.uint8))
    return codes
