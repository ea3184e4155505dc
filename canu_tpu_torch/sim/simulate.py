"""Read simulator + truth harness (fastqSimulate equivalent).

The port's own copy of canu_tpu.sim.simulate: it draws from numpy's
generator in the same order, so the same seeds give the same genome,
reads and truth in both packages.

Replaces the reference's test-data generators
(Canu src/fastq-utilities/fastqSimulate.C) and the
true-overlap inference harness
(Canu src/overlapInCore/overlapInCore-analysis/
 infer-olaps-from-genomic-coords.pl): generates a random genome, samples
noisy long reads with known coordinates, and derives the set of TRUE
pairwise overlaps from those coordinates so sketch/align stages can be
scored for recall/precision without any external aligner.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..stores.readset import ReadSet
from ..utils import bitpack


@dataclass
class ReadTruth:
    """Genome coordinates of each simulated read (arrays indexed read_id-1).

    start/end are genome coordinates of the sampled (error-free) template,
    end exclusive; reads from a circular genome may wrap (end > genome_len
    means wrap-around).  strand 0 = forward, 1 = the stored read is the
    reverse complement of genome[start:end].
    """

    genome_len: int
    circular: bool
    start: np.ndarray
    end: np.ndarray
    strand: np.ndarray


def random_genome(length: int, seed: int = 0, repeat_spec: list[tuple[int, int]] | None = None) -> np.ndarray:
    """Random genome as 2-bit codes.

    repeat_spec: list of (copy_len, n_copies) — plants exact repeat copies
    at random positions to exercise repeat handling (bogart equivalent),
    like the reference's simple-repeat-test.pl
    (Canu src/pipelines/simple-repeat-test.pl).
    """
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)
    if repeat_spec:
        for copy_len, n_copies in repeat_spec:
            unit = rng.integers(0, 4, size=copy_len).astype(np.uint8)
            for _ in range(n_copies):
                pos = int(rng.integers(0, length - copy_len))
                g[pos : pos + copy_len] = unit
    return g


def mutate_read(
    codes: np.ndarray,
    error_rate: float,
    rng: np.random.Generator,
    p_mis: float = 0.4,
    p_ins: float = 0.35,
    p_del: float = 0.25,
) -> np.ndarray:
    """Apply a long-read error model (mismatch/insert/delete mix).

    Default mix approximates PacBio/ONT indel-heavy profiles; vectorized
    construction (no per-base Python loop).
    """
    n = len(codes)
    if n == 0 or error_rate <= 0:
        return codes.copy()
    r = rng.random(n)
    # event code per template base: 0=match 1=mismatch 2=insert-before 3=delete
    ev = np.zeros(n, dtype=np.uint8)
    ev[r < error_rate * (p_mis + p_ins + p_del)] = 1
    ev[r < error_rate * (p_ins + p_del)] = 2
    ev[r < error_rate * p_del] = 3
    # output length contribution: match/mismatch=1, insert=2, delete=0
    contrib = np.array([1, 1, 2, 0], dtype=np.int64)[ev]
    out = np.empty(int(contrib.sum()), dtype=np.uint8)
    pos = np.zeros(n, dtype=np.int64)
    np.cumsum(contrib[:-1], out=pos[1:])
    keep = ev != 3
    # base written at the (possibly shifted) position; inserts write a random
    # base first then the template base.
    ins = ev == 2
    out[pos[ins]] = rng.integers(0, 4, size=int(ins.sum()), dtype=np.int64).astype(np.uint8)
    base_pos = pos + ins.astype(np.int64)  # template base goes after insertion
    tmpl = codes.copy()
    mis = ev == 1
    # mismatch: add 1..3 mod 4 so the base always changes
    tmpl[mis] = (tmpl[mis] + rng.integers(1, 4, size=int(mis.sum()), dtype=np.int64).astype(np.uint8)) % 4
    out[base_pos[keep]] = tmpl[keep]
    return out


def simulate_reads(
    genome: np.ndarray,
    coverage: float,
    mean_len: int = 8000,
    min_len: int = 1000,
    error_rate: float = 0.1,
    seed: int = 1,
    circular: bool = True,
    max_len: int | None = None,
) -> tuple[ReadSet, ReadTruth]:
    """Sample noisy reads to the requested coverage with known truth.

    Lengths ~ clipped gamma around mean_len (long-read-like tail); strand
    uniform; positions uniform (wrapping if circular).
    """
    rng = np.random.default_rng(seed)
    G = len(genome)
    target = int(coverage * G)
    lens: list[int] = []
    total = 0
    while total < target:
        l = int(rng.gamma(shape=2.0, scale=mean_len / 2.0))
        l = max(min_len, min(l, max(min_len, G if circular else G)))
        if max_len is not None:
            l = min(l, max_len)
        lens.append(l)
        total += l
    n = len(lens)
    starts = rng.integers(0, G, size=n)
    strands = rng.integers(0, 2, size=n).astype(np.uint8)

    if circular:
        genome2 = np.concatenate([genome, genome])
    reads: list[np.ndarray] = []
    t_start = np.empty(n, dtype=np.int64)
    t_end = np.empty(n, dtype=np.int64)
    for i in range(n):
        s, l = int(starts[i]), lens[i]
        if circular:
            tmpl = genome2[s : s + l]
        else:
            l = min(l, G - s)
            tmpl = genome[s : s + l]
        t_start[i] = s
        t_end[i] = s + len(tmpl)
        if strands[i]:
            tmpl = bitpack.revcomp_codes(tmpl)
        reads.append(mutate_read(tmpl, error_rate, rng))
    names = [f"sim{i+1}_{t_start[i]}_{t_end[i]}_{'-' if strands[i] else '+'}" for i in range(n)]
    rs = ReadSet.from_codes_list(reads, names)
    truth = ReadTruth(G, circular, t_start, t_end, strands)
    return rs, truth


def true_overlaps(truth: ReadTruth, min_overlap: int = 500) -> np.ndarray:
    """All TRUE overlapping pairs from genome coordinates.

    Returns int64 array [M, 3] of (a_id, b_id, overlap_len) with a_id <
    b_id, 1-based ids, template-coordinate overlap length >= min_overlap.
    Handles circular wrap by also testing +/- genome_len shifts.
    """
    n = len(truth.start)
    s, e = truth.start, truth.end
    out: list[tuple[int, int, int]] = []
    order = np.argsort(s, kind="stable")
    G = truth.genome_len
    shifts = (0, G, -G) if truth.circular else (0,)
    # sweep: for each read, compare against reads starting before its end
    for sh in shifts:
        ss = s + sh
        ee = e + sh
        for ai in range(n):
            # overlap of [ss[ai], ee[ai]) with [s[bi], e[bi])
            lo = np.maximum(ss[ai], s)
            hi = np.minimum(ee[ai], e)
            ov = hi - lo
            hits = np.flatnonzero(ov >= min_overlap)
            for bi in hits:
                if bi == ai:
                    continue
                a, b = (ai, bi) if ai < bi else (bi, ai)
                out.append((a + 1, b + 1, int(ov[bi])))
    if not out:
        return np.zeros((0, 3), dtype=np.int64)
    arr = np.array(sorted(set(map(tuple, out))), dtype=np.int64)
    # dedupe keeping max overlap length per pair
    keys = arr[:, 0] * (n + 1) + arr[:, 1]
    best: dict[int, int] = {}
    for k, ol in zip(keys, arr[:, 2]):
        if best.get(int(k), -1) < ol:
            best[int(k)] = int(ol)
    rows = [(int(k) // (n + 1), int(k) % (n + 1), v) for k, v in best.items()]
    return np.array(sorted(rows), dtype=np.int64)
