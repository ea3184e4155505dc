"""Ancillary k-mer analysis: the mapMers / maskMers / merTrim / mercy roles
(the port's own copy of canu_tpu.ops.mermap, no torch, with the same
results).

  * mapMers (Canu src/meryl/mapMers.C): map a meryl DB onto sequences:
    per-sequence stats or merged hit regions, in a [lo, hi] count window;
  * maskMers (Canu src/meryl/maskMers.C): the base intervals covered by DB
    k-mers, which the CLI masks;
  * merTrim (Canu src/merTrim/merTrim.C): per-read clear range = the
    longest run of trusted k-mers (count >= threshold); trim only;
  * mercy (Canu src/mercy/mercy.C): the read set's k-mers classed by
    count and by their presence in the assembly.

One-shot host utilities: vectorized numpy passes (one shifted-add k-mer
scan, searchsorted membership against the sorted DB).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..stores.readset import ReadSet
from ..utils import bitpack
from .kmer import KmerCounts


def positional_kmers(rs: ReadSet, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Canonical k-mer code at every flat base position, plus validity.

    Returns (canon[m], valid[m]) with m = total_bases - k + 1 in the
    packed flat coordinate system; valid marks positions whose k bases
    all fall inside one read.  Position p of read r is flat index
    word_off[r-1]*16 + p.
    """
    assert 1 < k <= 32
    words = np.asarray(rs.words)
    n = len(words) * bitpack.BASES_PER_WORD
    m = n - k + 1
    if m <= 0 or rs.n_reads == 0:
        return np.zeros(0, np.uint64), np.zeros(0, bool)
    allb = bitpack.unpack_words(words, n)
    base0 = (rs.word_off[:-1] * bitpack.BASES_PER_WORD).astype(np.int64)
    L = rs.length.astype(np.int64)
    delta = np.zeros(n + 1, np.int32)
    np.add.at(delta, base0, 1)
    np.add.at(delta, base0 + np.maximum(L - k + 1, 0), -1)
    valid = (np.cumsum(delta[:-1]) > 0)[:m]
    dt = np.uint32 if k <= 16 else np.uint64
    fwd = np.zeros(m, dt)
    rc = np.zeros(m, dt)
    for j in range(k):
        bj = allb[j : j + m].astype(dt)
        fwd = (fwd << dt(2)) | bj
        rc |= (dt(3) - bj) << dt(2 * j)
    return np.minimum(fwd, rc), valid


def db_counts_at(canon: np.ndarray, db: KmerCounts) -> np.ndarray:
    """DB count for each positional k-mer (0 where absent)."""
    if len(db.unique) == 0 or len(canon) == 0:
        return np.zeros(len(canon), np.int64)
    pos = np.searchsorted(db.unique, canon)
    posc = np.minimum(pos, len(db.unique) - 1)
    hit = db.unique[posc] == canon
    out = np.zeros(len(canon), np.int64)
    out[hit] = db.counts[posc[hit]]
    return out


@dataclass
class MerMapStats:
    read_id: int
    length: int
    n_mers: int
    n_hits: int
    bases_covered: int


def _flat_layout(rs: ReadSet) -> tuple[np.ndarray, np.ndarray]:
    base0 = (rs.word_off[:-1] * bitpack.BASES_PER_WORD).astype(np.int64)
    return base0, rs.length.astype(np.int64)


def map_mers_stats(rs: ReadSet, db: KmerCounts, lo: int = 1,
                   hi: int = 2**63 - 1) -> list[MerMapStats]:
    """mapMers -stats: per-sequence hit counts + covered-base totals."""
    canon, valid = positional_kmers(rs, db.k)
    cnt = db_counts_at(canon, db)
    hit = valid & (cnt >= lo) & (cnt <= hi)
    base0, L = _flat_layout(rs)
    k = db.k
    out = []
    cov_runs = covered_intervals(rs, hit, k)
    for r in range(rs.n_reads):
        s, e = base0[r], base0[r] + max(L[r] - k + 1, 0)
        h = int(hit[s:e].sum())
        iv = cov_runs[r]
        cov = int((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0
        out.append(MerMapStats(r + 1, int(L[r]), int(max(L[r] - k + 1, 0)),
                               h, cov))
    return out


def covered_intervals(rs: ReadSet, hit_flat: np.ndarray,
                      k: int) -> list[np.ndarray]:
    """Per-read merged [start, end) base intervals covered by hit k-mers
    (each hit at position p covers bases [p, p+k)) — the maskMers /
    mapMers -regions geometry."""
    base0, L = _flat_layout(rs)
    out = []
    for r in range(rs.n_reads):
        s, e = base0[r], base0[r] + max(L[r] - k + 1, 0)
        h = hit_flat[s:e]
        if not h.any():
            out.append(np.zeros((0, 2), np.int64))
            continue
        p = np.flatnonzero(h)
        # merge hits whose covering windows [p, p+k) touch or overlap
        brk = np.flatnonzero(p[1:] - p[:-1] > k)
        starts = np.concatenate([[0], brk + 1])
        ends = np.concatenate([brk, [len(p) - 1]])
        iv = np.stack([p[starts], p[ends] + k], axis=1)
        out.append(np.minimum(iv, int(L[r])))
    return out


def mer_trim(rs: ReadSet, db: KmerCounts, threshold: int,
             min_length: int = 64) -> np.ndarray:
    """merTrim: clear range per read = the longest covered interval of
    trusted k-mers (count >= threshold).  Returns int64[n_reads, 2]
    (bgn, end), (0, 0) when no trusted region of min_length exists."""
    canon, valid = positional_kmers(rs, db.k)
    cnt = db_counts_at(canon, db)
    hit = valid & (cnt >= threshold)
    clear = np.zeros((rs.n_reads, 2), np.int64)
    for r, iv in enumerate(covered_intervals(rs, hit, db.k)):
        if len(iv) == 0:
            continue
        widths = iv[:, 1] - iv[:, 0]
        b = int(np.argmax(widths))
        if widths[b] >= min_length:
            clear[r] = iv[b]
    return clear


@dataclass
class MercyReport:
    """mercy assembly-QC classes (mercy.C's read-mer vs assembly-mer
    confrontation): how many of the read set's distinct k-mers, by
    read-count class, appear in the assembly."""

    k: int
    n_read_mers: int
    n_asm_mers: int
    classes: dict  # name -> {"distinct": int, "in_assembly": int}

    @property
    def missing_normal(self) -> int:
        c = self.classes["normal"]
        return c["distinct"] - c["in_assembly"]

    def summary(self) -> str:
        lines = [f"mercy k={self.k}: {self.n_read_mers} read mers, "
                 f"{self.n_asm_mers} assembly mers"]
        for name, c in self.classes.items():
            f = c["in_assembly"] / max(1, c["distinct"])
            lines.append(f"  {name:>9}: {c['distinct']:>10} distinct, "
                         f"{c['in_assembly']:>10} in assembly ({f:.2%})")
        return "\n".join(lines)


def mercy(read_db: KmerCounts, asm_db: KmerCounts,
          low_count: int = 3) -> MercyReport:
    """Classify read k-mers by read-count class and assembly presence.

    Classes: singleton (count 1 — almost all sequencing error), low
    (2..low_count), normal (> low_count — should be assembled; missing
    ones are the 'mercy' mers the reference's mercy.C hunts)."""
    assert read_db.k == asm_db.k
    in_asm = np.zeros(len(read_db.unique), bool)
    if len(asm_db.unique) and len(read_db.unique):
        pos = np.searchsorted(asm_db.unique, read_db.unique)
        posc = np.minimum(pos, len(asm_db.unique) - 1)
        in_asm = asm_db.unique[posc] == read_db.unique
    cls = {}
    for name, mask in (
        ("singleton", read_db.counts == 1),
        ("low", (read_db.counts > 1) & (read_db.counts <= low_count)),
        ("normal", read_db.counts > low_count),
    ):
        cls[name] = {"distinct": int(mask.sum()),
                     "in_assembly": int((mask & in_asm).sum())}
    return MercyReport(read_db.k, read_db.n_distinct, asm_db.n_distinct, cls)
