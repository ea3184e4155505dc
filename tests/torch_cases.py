"""Shared helpers of the port's tests and chip_smoke.py; imports nothing of
jax or canu_tpu.

``one_torch_thread``: an autouse fixture a test module imports to run its
torch CPU ops on one thread.  ``pack_pairs``, ``x8_cases`` and
``edge_cases``: the INF-walled extension's inputs as numpy arrays, held
against canu_tpu's banded extension on the CPU and against kernels K2
and K3 on the card; ``extend_exit_rows``: the row after which each
extension's outputs are fixed, where K2 and K3 stop (the tests check the
argument; chip_smoke.py counts the kernels' bound up to it).
``myers_edge_cases``: kernel K1's.  ``candidate_sample`` and
``store_rows_of_pairs``: a sample of a candidate list and a store's rows
for it, which stand in for a full verify where the reference cannot run
one (chip_smoke.py's ecoli phase; scripts/torch_ecoli_reference.py).
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


def candidate_sample(pairs: np.ndarray, n: int = 2048) -> np.ndarray:
    """Every floor(M/n)-th row of the sorted candidate rows, n of them
    (all of them when M <= n)."""
    return pairs[:: max(1, len(pairs) // n)][:n]


def store_rows_of_pairs(st, pairs: np.ndarray) -> SimpleNamespace:
    """The rows of store st whose read pair, either way round, is an
    (a_id, b_id) row of pairs: the 8 store columns, for store_digest."""
    cols = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")
    a, b = np.asarray(st.a_id).astype(np.int64), np.asarray(st.b_id).astype(np.int64)
    key = np.minimum(a, b) << 32 | np.maximum(a, b)
    want = np.asarray(pairs[:, 0], np.int64) << 32 | np.asarray(pairs[:, 1], np.int64)
    m = np.isin(key, want)
    return SimpleNamespace(**{c: np.asarray(getattr(st, c))[m] for c in cols})


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
