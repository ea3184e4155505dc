"""Overlap interchange: PAF import, text dump and load, and a random-overlap
generator (the port's own copy of canu_tpu.io.overlaps_io, no torch, with
the same results).

Equivalents of the reference's converters and test tooling:

  * PAF -> OverlapTable replaces mmapConvert (Canu src/mhap/mmapConvert.C:
    PAF lines -> ovOverlap records), the minimap2 path of OverlapMMap.pm;
  * text dump/load replaces overlapConvert / overlapImport
    (Canu src/stores/overlapImport.C, ovb <-> text);
  * random_overlaps replaces `overlapImport -random N` (Canu
    src/pipelines/parallel-ovl-store-test.sh:23), which exercises store
    builds without any reads.
"""

from __future__ import annotations

import gzip
from typing import Iterable

import numpy as np

from ..ops.align import OverlapTable

_TEXT_HEADER = "#a_id\tb_id\tflipped\ta_bgn\ta_end\tb_bgn\tb_end\terate"


def _open(path: str, mode: str = "rt"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def paf_to_table(
    path_or_lines: str | Iterable[str],
    name_to_id: dict[str, int],
    min_overlap: int = 0,
) -> OverlapTable:
    """Parse PAF (minimap2 output) into an OverlapTable.

    PAF columns (minimap2 man page): qname qlen qstart qend strand tname
    tlen tstart tend nmatch alnlen mapq [tags].  erate is estimated as
    1 - nmatch/alnlen (the same information mmapConvert packs into the
    ovOverlap evalue).  Reads absent from name_to_id are skipped.
    """
    cols = {k: [] for k in ("a_id", "b_id", "flipped", "a_bgn", "a_end",
                            "b_bgn", "b_end", "erate_q")}
    lines = _open(path_or_lines) if isinstance(path_or_lines, str) else path_or_lines
    try:
        for line in lines:
            if not line or line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 11:
                continue
            a = name_to_id.get(f[0])
            b = name_to_id.get(f[5])
            if a is None or b is None or a == b:
                continue
            qs, qe = int(f[2]), int(f[3])
            ts, te = int(f[7]), int(f[8])
            if min(qe - qs, te - ts) < min_overlap:
                continue
            nmatch, alnlen = int(f[9]), int(f[10])
            erate = 1.0 - (nmatch / alnlen if alnlen > 0 else 0.0)
            cols["a_id"].append(a)
            cols["b_id"].append(b)
            cols["flipped"].append(f[4] == "-")
            cols["a_bgn"].append(qs)
            cols["a_end"].append(qe)
            cols["b_bgn"].append(ts)  # PAF target coords are forward-strand
            cols["b_end"].append(te)
            cols["erate_q"].append(min(int(round(erate * 10000)), 65535))
    finally:
        if isinstance(path_or_lines, str):
            lines.close()
    return OverlapTable(
        a_id=np.array(cols["a_id"], np.int32),
        b_id=np.array(cols["b_id"], np.int32),
        flipped=np.array(cols["flipped"], bool),
        a_bgn=np.array(cols["a_bgn"], np.int32),
        a_end=np.array(cols["a_end"], np.int32),
        b_bgn=np.array(cols["b_bgn"], np.int32),
        b_end=np.array(cols["b_end"], np.int32),
        erate_q=np.array(cols["erate_q"], np.uint16),
    )


def write_table_text(path: str, table: OverlapTable) -> int:
    """Dump an OverlapTable as TSV (overlapConvert equivalent)."""
    with _open(path, "wt") as fh:
        fh.write(_TEXT_HEADER + "\n")
        for i in range(len(table)):
            fh.write(
                f"{table.a_id[i]}\t{table.b_id[i]}\t{int(table.flipped[i])}\t"
                f"{table.a_bgn[i]}\t{table.a_end[i]}\t{table.b_bgn[i]}\t"
                f"{table.b_end[i]}\t{table.erate_q[i] / 10000:.4f}\n"
            )
    return len(table)


def read_table_text(path: str) -> OverlapTable:
    """Load a TSV overlap dump (overlapImport equivalent)."""
    rows = []
    with _open(path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.split("\t")
            rows.append(
                (int(f[0]), int(f[1]), int(f[2]), int(f[3]), int(f[4]),
                 int(f[5]), int(f[6]), int(round(float(f[7]) * 10000)))
            )
    r = np.array(rows, np.int64) if rows else np.zeros((0, 8), np.int64)
    return OverlapTable(
        a_id=r[:, 0].astype(np.int32),
        b_id=r[:, 1].astype(np.int32),
        flipped=r[:, 2].astype(bool),
        a_bgn=r[:, 3].astype(np.int32),
        a_end=r[:, 4].astype(np.int32),
        b_bgn=r[:, 5].astype(np.int32),
        b_end=r[:, 6].astype(np.int32),
        erate_q=np.minimum(r[:, 7], 65535).astype(np.uint16),
    )


def random_overlaps(
    n: int,
    n_reads: int,
    read_len: int = 10000,
    seed: int = 0,
) -> OverlapTable:
    """Random plausible overlaps (overlapImport -random equivalent).

    Used by store scalability tests: exercises build/sort/index with no
    reads at all, like parallel-ovl-store-test.sh.
    """
    rng = np.random.default_rng(seed)
    a = rng.integers(1, n_reads + 1, size=n).astype(np.int32)
    off = rng.integers(1, n_reads, size=n).astype(np.int32)
    b = ((a - 1 + off) % n_reads + 1).astype(np.int32)
    span = rng.integers(500, read_len, size=n).astype(np.int32)
    a_bgn = rng.integers(0, read_len - 499, size=n).astype(np.int32)
    a_end = np.minimum(a_bgn + span, read_len).astype(np.int32)
    b_bgn = rng.integers(0, read_len - 499, size=n).astype(np.int32)
    b_end = np.minimum(b_bgn + (a_end - a_bgn), read_len).astype(np.int32)
    return OverlapTable(
        a_id=a,
        b_id=b,
        flipped=rng.integers(0, 2, size=n).astype(bool),
        a_bgn=a_bgn,
        a_end=a_end,
        b_bgn=b_bgn,
        b_end=b_end,
        erate_q=rng.integers(0, 3000, size=n).astype(np.uint16),
    )


def name_index(readset) -> dict[str, int]:
    """Read-name -> 1-based id map for PAF import."""
    if readset.names is None:
        return {f"read{i}": i for i in range(1, readset.n_reads + 1)}
    return {n: i + 1 for i, n in enumerate(readset.names)}
