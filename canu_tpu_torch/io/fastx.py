"""FASTA/FASTQ reading (gzip-transparent).

The port's own copy of canu_tpu.io.fastx's reader.

Host-side replacement for the reference's FASTA/FASTQ loaders
(Canu src/stores/gatekeeperCreate.C:182 loadFASTQ,
Canu src/AS_UTL/AS_UTL_fasta.C) — plain streaming parsers, no
external deps.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class SeqRecord:
    name: str
    seq: str
    qual: Optional[str] = None  # FASTQ quality string, if present


def _open_text(path: str | os.PathLike):
    path = os.fspath(path)
    raw = open(path, "rb")
    head = raw.read(2)
    raw.seek(0)
    if head == b"\x1f\x8b":
        return io.TextIOWrapper(gzip.GzipFile(fileobj=raw))
    return io.TextIOWrapper(raw)


def read_fastx(path: str | os.PathLike) -> Iterator[SeqRecord]:
    """Stream records from a FASTA or FASTQ file (optionally gzipped).

    Format is auto-detected from the first non-blank character ('>' FASTA,
    '@' FASTQ).  FASTA sequences may be multi-line; FASTQ is standard
    4-line (multi-line FASTQ is not supported, matching common practice).
    """
    with _open_text(path) as fh:
        first = None
        for line in fh:
            if line.strip():
                first = line
                break
        if first is None:
            return
        if first.startswith(">"):
            yield from _read_fasta(first, fh)
        elif first.startswith("@"):
            yield from _read_fastq(first, fh)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first[:20]!r})")


def _read_fasta(first: str, fh) -> Iterator[SeqRecord]:
    name = first[1:].split()[0] if len(first) > 1 else ""
    chunks: list[str] = []
    for line in fh:
        if line.startswith(">"):
            yield SeqRecord(name, "".join(chunks))
            name = line[1:].split()[0] if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line.strip())
    yield SeqRecord(name, "".join(chunks))


def _read_fastq(first: str, fh) -> Iterator[SeqRecord]:
    header = first
    while True:
        if not header or not header.strip():
            return
        if not header.startswith("@"):
            raise ValueError(f"bad FASTQ header line: {header[:40]!r}")
        name = header[1:].split()[0] if len(header) > 1 else ""
        seq = fh.readline().strip()
        plus = fh.readline()
        if not plus.startswith("+"):
            raise ValueError(f"bad FASTQ separator for read {name!r}")
        qual = fh.readline().strip()
        if len(qual) != len(seq):
            raise ValueError(f"FASTQ qual length mismatch for read {name!r}")
        yield SeqRecord(name, seq, qual)
        header = fh.readline()
