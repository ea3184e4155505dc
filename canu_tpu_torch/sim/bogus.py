"""Ideal-assembly construction and assembly-vs-truth evaluation (the port's
counterpart of canu_tpu.sim.bogus, with the same results).

The reference validates assemblies with ``bogus``, which builds the ideal
assembly from read-to-reference alignments and classes genome intervals
as UNIQ/REPT (Canu src/bogus/bogus.C:61-80,441), and ``bogusness``, which
scores unitigs against it (Canu src/bogus/bogusness.C).  Here, for
simulated truth:

  * read placements are exact (sim/simulate.ReadTruth), no aligner;
  * UNIQ/REPT comes from genome k-mer multiplicity;
  * contig placement chains unique-k-mer anchors, and each placed
    segment's identity is measured with the assembler's own Myers
    engine (ops.myers.banded_extend_myers: kernel K1 on the card, the
    plain loop on the CPU), its band following the anchor chain.

Everything but the identity ruler is host numpy, copied from canu_tpu;
the ruler runs on ``device`` (the card unless the caller asks for the
CPU).  Outputs mirror bogusness's verdict: placements, misjoins, genome
fraction, duplication, identity.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.bitpack import revcomp_codes, seq_to_codes
from .simulate import ReadTruth


# ---- genome k-mer classification (bogus REPT/UNIQ) --------------------------


def _pack_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Forward k-mers of a code array as uint64[n-k+1] (2 bits/base)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    acc = np.zeros(n, np.uint64)
    for i in range(k):
        acc = (acc << np.uint64(2)) | codes[i : i + n].astype(np.uint64)
    return acc


def _canonical(kmers: np.ndarray, k: int) -> np.ndarray:
    """Canonical (min of fwd, rc) k-mers."""
    rc = np.zeros_like(kmers)
    fw = kmers.copy()
    for _ in range(k):
        rc = (rc << np.uint64(2)) | (np.uint64(3) - (fw & np.uint64(3)))
        fw >>= np.uint64(2)
    return np.minimum(kmers, rc)


def classify_genome(genome: np.ndarray, k: int = 21) -> tuple[np.ndarray, np.ndarray]:
    """REPT/UNIQ genome intervals from canonical k-mer multiplicity.

    Returns (rept, uniq): int64 interval arrays [m, 2] (end-exclusive),
    the role of bogus's REPT/UNIQ intervalLists (bogus.C:70-71).  A
    position is repetitive when the k-mer starting there occurs more
    than once (either strand) in the genome.
    """
    km = _canonical(_pack_kmers(genome, k), k)
    if len(km) == 0:
        return np.zeros((0, 2), np.int64), np.array([[0, len(genome)]], np.int64)
    uniq, inv, counts = np.unique(km, return_inverse=True, return_counts=True)
    rep = counts[inv] > 1  # bool per k-mer start position
    # merge consecutive repeat starts into intervals covering k bases each
    idx = np.flatnonzero(rep)
    rept: list[list[int]] = []
    for p in idx:
        if rept and p <= rept[-1][1]:
            rept[-1][1] = max(rept[-1][1], int(p) + k)
        else:
            rept.append([int(p), int(p) + k])
    ra = np.array(rept, np.int64) if rept else np.zeros((0, 2), np.int64)
    # complement -> UNIQ
    uq: list[tuple[int, int]] = []
    pos = 0
    for b, e in ra:
        if b > pos:
            uq.append((pos, int(b)))
        pos = max(pos, int(e))
    if pos < len(genome):
        uq.append((pos, len(genome)))
    ua = np.array(uq, np.int64) if uq else np.zeros((0, 2), np.int64)
    return ra, ua


# ---- ideal assembly from read truth (bogus processMatches) ------------------


def ideal_contigs(truth: ReadTruth, min_overlap: int = 500) -> np.ndarray:
    """Ideal contig intervals from exact read placements.

    Chains reads whose genome intervals overlap by >= min_overlap — the
    best any overlap-based assembler can do with these reads (bogus's
    ideal unitigs, without the repeat-break pessimism).  Returns int64
    [m, 2] genome intervals; a circular genome that is fully covered
    yields one interval [0, G).
    """
    s = truth.start.astype(np.int64)
    e = truth.end.astype(np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    out: list[list[int]] = []
    for b, x in zip(s, e):
        if out and b <= out[-1][1] - min_overlap:
            out[-1][1] = max(out[-1][1], int(x))
        else:
            out.append([int(b), int(x)])
    if not out:
        return np.zeros((0, 2), np.int64)
    G = truth.genome_len
    if truth.circular and len(out) > 1:
        # wrap: reads with end > G continue at 0
        if out[-1][1] - G >= out[0][0] + min_overlap:
            out[0][0] = out[-1][0] - G
            out.pop()
    arr = np.array(out, np.int64)
    return arr


def ng50(lengths: np.ndarray, genome_len: int) -> int:
    """NG50: length at which sorted contigs cover half the GENOME."""
    if len(lengths) == 0:
        return 0
    ls = np.sort(np.asarray(lengths))[::-1]
    c = np.cumsum(ls)
    i = np.searchsorted(c, genome_len // 2)
    return int(ls[min(i, len(ls) - 1)])


# ---- contig placement + evaluation (bogusness) -------------------------------


@dataclass
class Placement:
    """One colinear placed segment of a contig on the genome."""

    contig: int  # index into the contig list
    c_bgn: int
    c_end: int
    g_bgn: int
    g_end: int
    reverse: bool
    n_anchors: int
    identity: float = 0.0
    # anchor chain in segment-local coords (a = oriented contig offset,
    # b = genome offset from g_bgn), ascending in a — the identity
    # ruler's band follows this chain, so indel random-walk over long
    # segments never leaves the band
    anchor_a: np.ndarray | None = None
    anchor_b: np.ndarray | None = None


@dataclass
class AssemblyEval:
    """bogusness-style verdict for one assembly vs its truth genome."""

    placements: list[Placement]
    n_contigs: int
    n_placed: int
    n_misjoins: int  # chain breaks between confident segments of one contig
    genome_fraction: float  # union of placed genome intervals / G
    duplication: float  # placed contig bases / covered genome bases
    identity: float  # alignment identity, weighted by segment length
    contig_ng50: int
    ideal_ng50: int

    def summary(self) -> str:
        return (
            f"contigs {self.n_contigs} (placed {self.n_placed}); "
            f"misjoins {self.n_misjoins}; genome fraction "
            f"{self.genome_fraction:.4f}; duplication {self.duplication:.3f}; "
            f"identity {self.identity:.4f}; NG50 {self.contig_ng50} "
            f"(ideal {self.ideal_ng50})"
        )


def _genome_unique_index(genome: np.ndarray, k: int, circular: bool):
    """Position map of k-mers that occur exactly once (forward strand of
    the doubled genome if circular, so wrap-spanning anchors exist)."""
    g = np.concatenate([genome, genome[: 4 * k]]) if circular else genome
    km = _pack_kmers(g, k)
    can = _canonical(km, k)
    uniq, first, counts = np.unique(can, return_index=True, return_counts=True)
    keep = counts == 1
    return uniq[keep], first[keep].astype(np.int64)


def _contig_anchors(codes: np.ndarray, gk: np.ndarray, gpos: np.ndarray, k: int):
    """(c_pos, g_pos, fwd_kmer) anchors: contig k-mers matching unique
    genome k-mers (canonical match; the caller derives orientation by
    comparing the contig's forward k-mer to the genome's forward k-mer
    at the matched position — equal iff the anchor is forward)."""
    km = _pack_kmers(codes, k)
    can = _canonical(km, k)
    j = np.searchsorted(gk, can)
    j = np.clip(j, 0, len(gk) - 1)
    hit = gk[j] == can
    cpos = np.flatnonzero(hit).astype(np.int64)
    gp = gpos[j[hit]]
    return cpos, gp, km[cpos]


def place_contig(
    codes: np.ndarray,
    gk: np.ndarray,
    gpos: np.ndarray,
    gkm_fwd: np.ndarray,
    k: int,
    contig_idx: int,
    min_anchors: int = 8,
    min_seg_len: int = 1000,
    wobble: int = 500,
) -> list[Placement]:
    """Chain unique-k-mer anchors into colinear placements.

    A contig that is one faithful genome segment yields ONE placement;
    chain breaks between confident segments are misjoin evidence
    (bogusness's BEGINSinUNIQ/ENDSinUNIQ style judgements reduced to
    colinearity).
    """
    cpos, gp, kfwd = _contig_anchors(codes, gk, gpos, k)
    if len(cpos) < min_anchors:
        return []
    rc = gkm_fwd[gp] != kfwd  # anchor matched genome in reverse
    segs: list[Placement] = []
    # split anchors into runs of consistent orientation + diagonal
    run_start = 0
    for i in range(1, len(cpos) + 1):
        brk = i == len(cpos)
        if not brk:
            dc = cpos[i] - cpos[i - 1]
            dg = gp[i] - gp[i - 1]
            same_or = rc[i] == rc[i - 1]
            exp = -dc if rc[i - 1] else dc
            brk = (not same_or) or abs(int(dg) - int(exp)) > wobble + dc // 3
        if brk:
            n = i - run_start
            c0, c1 = int(cpos[run_start]), int(cpos[i - 1]) + k
            if rc[run_start]:
                g0, g1 = int(gp[i - 1]), int(gp[run_start]) + k
            else:
                g0, g1 = int(gp[run_start]), int(gp[i - 1]) + k
            if n >= min_anchors and c1 - c0 >= min_seg_len:
                ca = cpos[run_start:i]
                ga = gp[run_start:i]
                if rc[run_start]:
                    # oriented-a offset of a k-mer at contig pos cp: rc of
                    # the segment [c0, c1) maps window [cp, cp+k) to
                    # [(c1-c0) - (cp-c0) - k, ...) = [c1 - cp - k, ...)
                    aa = c1 - ca - k
                    order = np.argsort(aa)
                    aa = aa[order]
                    bb = ga[order] - g0
                else:
                    aa = ca - c0
                    bb = ga - g0
                segs.append(
                    Placement(
                        contig=contig_idx, c_bgn=c0, c_end=c1, g_bgn=g0,
                        g_end=g1, reverse=bool(rc[run_start]), n_anchors=n,
                        anchor_a=aa.astype(np.int64),
                        anchor_b=bb.astype(np.int64),
                    )
                )
            run_start = i
    return segs


def _merge_placements(s1: "Placement", s2: "Placement", k: int):
    """Merge two colinear-adjacent same-orientation placements of one
    contig into a single placement whose anchor chain carries the
    structural jump between them (the identity ruler splits at the jump
    and charges it).  Returns None when either side has no anchors."""
    if s1.anchor_a is None or s2.anchor_a is None:
        return None
    if len(s1.anchor_a) == 0 or len(s2.anchor_a) == 0:
        return None

    def raw(s):
        # recover absolute (contig_pos, genome_pos) from oriented-local
        if s.reverse:
            ca = s.c_end - np.asarray(s.anchor_a, np.int64) - k
            ga = np.asarray(s.anchor_b, np.int64) + s.g_bgn
        else:
            ca = np.asarray(s.anchor_a, np.int64) + s.c_bgn
            ga = np.asarray(s.anchor_b, np.int64) + s.g_bgn
        return ca, ga

    (ca1, ga1), (ca2, ga2) = raw(s1), raw(s2)
    ca = np.concatenate([ca1, ca2])
    ga = np.concatenate([ga1, ga2])
    c0, c1 = s1.c_bgn, s2.c_end
    if s1.reverse:
        g0, g1 = s2.g_bgn, s1.g_end
        aa = c1 - ca - k
    else:
        g0, g1 = s1.g_bgn, s2.g_end
        aa = ca - c0
    bb = ga - g0
    if g1 <= g0:
        return None  # degenerate (heavy overlap); keep segments apart
    order = np.argsort(aa, kind="stable")
    return Placement(
        contig=s1.contig, c_bgn=c0, c_end=c1, g_bgn=g0, g_end=g1,
        reverse=s1.reverse, n_anchors=len(aa),
        anchor_a=aa[order], anchor_b=bb[order],
    )


def _segment_identity(
    contigs: list[np.ndarray], genome_ext: np.ndarray, segs: list[Placement],
    k: int, band: int = 128, device=None,
) -> None:
    """Measure the alignment identity of each placed segment in one batched
    Myers pass on ``device`` (the assembler's own verify engine as a ruler).

    Structural indels (collapsed or expanded repeat copies) shift the
    alignment diagonal by more than the band in one step, which a band-128
    DP cannot cross, so each placement is split at anchor-diagonal jumps
    > band/2; the pieces are measured independently, and each jump is
    charged max(|delta diagonal|, the anchor gap on either side) edits
    once: identity = 1 - (piece edits + jumps + skips) / (span + charges).
    A piece's band centre follows its anchor chain (piecewise linear,
    slope 1 past the last anchor); rows without anchors are padded with
    BIG + ramp points, which pass through float32 as canu_tpu's int32 ->
    float32 path rounds them.  n_rows is the longest piece, a whole contig
    at most; max_rows stops the row loop there.
    """
    if not segs:
        return
    import torch

    from ..device import resolve_device
    from ..ops.align import CENTER_STRIDE, _interp_grid
    from ..ops.myers import banded_extend_myers

    dev = resolve_device(device)

    slack = band
    # ---- split each placement at anchor-diagonal jumps ----------------
    # sub: (parent_i, a0, a1, b0, b1, pts_a, pts_b) in the parent's
    # ORIENTED local coordinates (a into the oriented contig slice,
    # b relative to g_bgn)
    sub: list[tuple] = []
    jump_pen = np.zeros(len(segs), np.int64)
    skip_pen = np.zeros(len(segs), np.int64)  # unmeasured piece spans,
    # charged as unaligned (conservative): a skipped run must not
    # silently inflate identity by leaving both numerator+denominator
    for i, s in enumerate(segs):
        span_a = s.c_end - s.c_bgn
        span_b = s.g_end - s.g_bgn
        if s.anchor_a is None or len(s.anchor_a) < 2:
            sub.append((i, 0, span_a, 0, span_b, None, None))
            continue
        aa = np.asarray(s.anchor_a, np.int64)
        bb = np.asarray(s.anchor_b, np.int64)
        d = bb - aa
        cut = np.flatnonzero(np.abs(np.diff(d)) > band // 2)
        # per-jump charge: |Δdiagonal| covers pure indels; a substituted
        # block (x contig bases replacing y genome bases) has Δd = y - x
        # but needs >= max(x, y) edits — charge the anchor gap on both
        # sides too (conservative lower bound on the true edit cost)
        gap_a = np.maximum(aa[cut + 1] - (aa[cut] + k), 0)
        gap_b = np.maximum(bb[cut + 1] - (bb[cut] + k), 0)
        jump_pen[i] = int(
            np.maximum(np.abs(np.diff(d)[cut]),
                       np.maximum(gap_a, gap_b)).sum()
        )
        starts = np.concatenate([[0], cut + 1])
        ends = np.concatenate([cut, [len(aa) - 1]])
        for s0, s1 in zip(starts.tolist(), ends.tolist()):
            if s1 < s0:
                continue
            a0, a1 = int(aa[s0]), int(aa[s1]) + k
            b0, b1 = int(bb[s0]), int(bb[s1]) + k
            if s0 == 0:
                a0, b0 = 0, 0
            if s1 == len(aa) - 1:
                a1, b1 = span_a, span_b
            if s1 == s0 or a1 - a0 < k:
                # single-anchor run between jumps, or a sub-k sliver:
                # too short to band-align — charge its span as unaligned
                skip_pen[i] += max(0, a1 - a0)
                continue
            sub.append((i, a0, a1, b0, b1, aa[s0 : s1 + 1] - a0,
                        bb[s0 : s1 + 1] - b0))
    if not sub:
        return
    max_a = max(t[2] - t[1] for t in sub)
    n_rows = max_a
    B = len(sub)
    a = np.zeros((B, max_a), np.uint8)
    b = np.zeros((B, max_a + 2 * slack), np.uint8)
    a_len = np.zeros(B, np.int32)
    b_len = np.zeros(B, np.int32)
    ori_cache: dict[int, np.ndarray] = {}
    for j, (i, a0, a1, b0, b1, _pa, _pb) in enumerate(sub):
        s = segs[i]
        if i not in ori_cache:
            ac_full = contigs[s.contig][s.c_bgn : s.c_end]
            ori_cache[i] = revcomp_codes(ac_full) if s.reverse else ac_full
        ac = ori_cache[i][a0:a1]
        # b starts EXACTLY at the piece's first anchor genome position:
        # the DP is semi-global from (0,0); right slack absorbs contig
        # insertions.  Clip to the buffer (a piece whose genome span
        # exceeds contig span + slack would overflow the rows).
        gc = genome_ext[s.g_bgn + b0 : s.g_bgn + b1 + slack][: max_a + 2 * slack]
        a[j, : len(ac)] = ac
        b[j, : len(gc)] = gc
        a_len[j] = len(ac)
        b_len[j] = len(gc)
    # band center follows each piece's anchor chain (piecewise linear,
    # slope-1 extrapolation past the last anchor) — a straight diagonal
    # drifts out of a 128-band over tens-of-kb pieces because indel
    # noise random-walks
    M = 2048
    BIG = np.int64(1 << 24)
    ramp = np.arange(M, dtype=np.int64)
    xa = np.tile(BIG + ramp, (B, 1))
    xb = xa.copy()
    for j, (_i, _a0, _a1, _b0, _b1, pa, pb) in enumerate(sub):
        if pa is None or len(pa) == 0:
            xa[j, 0] = 0
            xb[j, 0] = 0
            continue
        pts_a = np.concatenate([[0], pa])
        pts_b = np.concatenate([[0], pb])
        if len(pts_a) > M:
            pick = np.linspace(0, len(pts_a) - 1, M).astype(np.int64)
            pts_a, pts_b = pts_a[pick], pts_b[pick]
        # strictly ascending in a (interp needs monotone sample points)
        keep = np.concatenate([[True], np.diff(pts_a) > 0])
        pts_a, pts_b = pts_a[keep], pts_b[keep]
        m = len(pts_a)
        xa[j, :m] = pts_a
        xb[j, :m] = pts_b
        xa[j, m:] = pts_a[-1] + 1 + ramp[: M - m]
        xb[j, m:] = pts_b[-1] + 1 + ramp[: M - m]
    # the centres on their 16-row grid, which the extension reads as it is
    cen = _interp_grid(torch.from_numpy(xa).to(dev), torch.from_numpy(xb).to(dev), n_rows)
    e, au, _bu = banded_extend_myers(
        *(torch.from_numpy(x).to(dev) for x in (a, a_len, b, b_len)),
        cen, band, n_rows, max_rows=int(a_len.max()), center_stride=CENTER_STRIDE,
    )
    e = e.cpu().numpy()
    au = au.cpu().numpy()
    tot_e = np.zeros(len(segs), np.int64)
    tot_sp = np.zeros(len(segs), np.int64)
    for j, (i, *_rest) in enumerate(sub):
        tot_e[i] += int(e[j])
        tot_sp[i] += max(1, int(au[j]))
    for i, s in enumerate(segs):
        denom = max(1, int(tot_sp[i] + jump_pen[i] + skip_pen[i]))
        s.identity = max(
            0.0,
            1.0 - float(tot_e[i] + jump_pen[i] + skip_pen[i]) / denom,
        )


def evaluate_assembly(
    genome: np.ndarray,
    contigs: list[str | np.ndarray],
    truth: ReadTruth | None = None,
    k: int = 21,
    circular: bool = True,
    min_overlap: int = 500,
    measure_identity: bool = True,
    device=None,
) -> AssemblyEval:
    """Score an assembly against its truth genome (bogusness verdict); the
    identity ruler runs on ``device``."""
    ctg = [
        seq_to_codes(c) if isinstance(c, str) else np.asarray(c, np.uint8)
        for c in contigs
    ]
    gk, gpos = _genome_unique_index(genome, k, circular)
    g_ext = np.concatenate([genome, genome[: 8 * k]]) if circular else genome
    gkm_fwd = _pack_kmers(g_ext, k)
    placements: list[Placement] = []
    n_misjoins = 0
    placed_ids = set()
    for ci, codes in enumerate(ctg):
        segs = place_contig(codes, gk, gpos, gkm_fwd, k, ci)
        if segs:
            placed_ids.add(ci)
        # Adjacent confident segments of one contig that are NOT genome-
        # adjacent (allowing circular wrap) indicate a misjoin.
        # Colinear-adjacent SAME-orientation pairs (|genome gap - contig
        # gap| < 5000) are structural indels — collapsed/expanded repeat
        # copies or substituted blocks — NOT misjoins; they are MERGED
        # back into one placement so the identity ruler's jump-split
        # charges the event (scored as two exact placements, a 700-base
        # collapse would measure identity 1.0).
        merged: list[Placement] = []
        for s2 in segs:
            if not merged:
                merged.append(s2)
                continue
            s1 = merged[-1]
            gap_c = s2.c_bgn - s1.c_end
            if s1.reverse == s2.reverse:
                d = (s2.g_bgn - s1.g_end) if not s1.reverse else (s1.g_bgn - s2.g_end)
                adjacent = abs(d - gap_c) < 5000
                wrapped = circular and not adjacent and (
                    abs((d % len(genome)) - gap_c) < 5000
                )
            else:
                adjacent = wrapped = False  # orientation flip in a contig
            if adjacent:
                m = _merge_placements(s1, s2, k)
                if m is not None:
                    merged[-1] = m
                    continue
            elif not wrapped:
                n_misjoins += 1
            merged.append(s2)
        placements.extend(merged)

    if measure_identity and placements:
        _segment_identity(ctg, g_ext, placements, k, device=device)

    G = len(genome)
    # genome coverage: union of placed intervals (mod G)
    cov = np.zeros(G, bool)
    placed_bases = 0
    for s in placements:
        b, e = s.g_bgn % G, s.g_bgn % G + (s.g_end - s.g_bgn)
        cov[b : min(e, G)] = True
        if e > G:
            cov[: e - G] = True
        placed_bases += s.c_end - s.c_bgn
    covered = int(cov.sum())
    ident_w = sum(s.identity * (s.c_end - s.c_bgn) for s in placements)

    lens = np.array([len(c) for c in ctg], np.int64)
    ideal = (
        ideal_contigs(truth, min_overlap) if truth is not None else np.zeros((0, 2), np.int64)
    )
    return AssemblyEval(
        placements=placements,
        n_contigs=len(ctg),
        n_placed=len(placed_ids),
        n_misjoins=n_misjoins,
        genome_fraction=covered / max(1, G),
        duplication=placed_bases / max(1, covered),
        identity=ident_w / max(1, placed_bases),
        contig_ng50=ng50(lens, G),
        ideal_ng50=ng50(ideal[:, 1] - ideal[:, 0], G) if len(ideal) else 0,
    )
