"""ReadSet — the read database (gkStore equivalent).

The port's own copy of canu_tpu.stores.readset: the same packed words,
lengths, blocks and on-disk layout, so either package reads the other's
stores.  FASTA/FASTQ loading uses the Python parser (io/fastx.py), which
gives the reads canu_tpu's native scanner gives.

Replaces the reference gkStore (Canu src/stores/gkStore.H) with
a columnar, numpy-backed store designed for device block loading:

  * sequences are 2-bit packed into one flat ``uint32`` array, each read
    starting on a word (16-base) boundary, so any subset of reads gathers
    into a dense padded ``uint32[B, W]`` device block with no bit surgery;
  * per-read metadata are parallel numpy arrays (length, word offset);
  * read IDs are **1-based** (0 = invalid), preserving the reference
    invariant that everything keys off a 1-based IID
    (Canu src/stores/gkStore.H:333-338);
  * the store is immutable once built; derived read sets (trimmed,
    corrected) are new ReadSets carrying a ``source_id``/``source_bgn``
    provenance mapping, replacing gkStore clear ranges + partitions.

On disk a ReadSet is a directory with ``reads.npz`` (arrays) and
``meta.json``; writes are atomic via the reference's ``.WORKING`` rename
convention (Canu src/pipelines/canu/OverlapMhap.pm:496-510).
"""

from __future__ import annotations

import json
import os
import weakref
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

from ..utils import bitpack

# Reference caps reads at 2 Mbp by bit allocation
# (Canu src/stores/gkStore.H:61 AS_MAX_READLEN_BITS=21).  We keep
# a cap for sanity but make it generous; device blocks bucket by length.
MAX_READ_LEN = 1 << 24


@dataclass
class ReadSetStats:
    n_input: int = 0
    n_loaded: int = 0
    n_skipped_short: int = 0
    n_split_at_n: int = 0
    bases_loaded: int = 0


class ReadSet:
    """Immutable set of 2-bit-packed reads with 1-based IDs."""

    def __init__(
        self,
        words: np.ndarray,
        word_off: np.ndarray,
        length: np.ndarray,
        names: Optional[list[str]] = None,
        source_id: Optional[np.ndarray] = None,
        source_bgn: Optional[np.ndarray] = None,
        quals: Optional[np.ndarray] = None,
    ):
        assert words.dtype == np.uint32
        self.words = words
        self.word_off = word_off.astype(np.int64)  # [n+1] word offsets
        self.length = length.astype(np.int32)  # [n] base lengths
        self.names = names
        # Optional quality plane: flat uint8 phred values, one per base,
        # reads concatenated in id order (offsets = cumsum of length).
        # The reference encodes QVs inside the gkStore blob
        # (Canu src/stores/gkStore.H:305-313); here they are a
        # separate columnar plane so FASTA-only runs pay nothing.
        if quals is not None:
            quals = np.ascontiguousarray(quals, dtype=np.uint8)
            assert quals.size == int(length.sum()), "qual plane size mismatch"
        self.quals = quals
        self._qual_off: Optional[np.ndarray] = None
        # Provenance: original read id (1-based, 0=none) and start offset in
        # the original read — set for trimmed/split/corrected read sets.
        n = len(length)
        self.source_id = (
            source_id.astype(np.int32) if source_id is not None else np.zeros(n, np.int32)
        )
        self.source_bgn = (
            source_bgn.astype(np.int32) if source_bgn is not None else np.zeros(n, np.int32)
        )

    # ---- construction ----

    @classmethod
    def from_codes_list(
        cls,
        codes_list: Sequence[np.ndarray],
        names: Optional[list[str]] = None,
        source_id: Optional[np.ndarray] = None,
        source_bgn: Optional[np.ndarray] = None,
        quals_list: Optional[Sequence[np.ndarray]] = None,
    ) -> "ReadSet":
        n = len(codes_list)
        length = np.array([len(c) for c in codes_list], dtype=np.int32)
        wc = np.array([bitpack.n_words(int(l)) for l in length], dtype=np.int64)
        word_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(wc, out=word_off[1:])
        words = np.zeros(int(word_off[-1]), dtype=np.uint32)
        for i, codes in enumerate(codes_list):
            if len(codes):
                words[word_off[i] : word_off[i] + wc[i]] = bitpack.pack_codes(codes)
        quals = None
        if quals_list is not None:
            assert len(quals_list) == n
            quals = (
                np.concatenate([np.asarray(q, np.uint8) for q in quals_list])
                if n
                else np.zeros(0, np.uint8)
            )
        return cls(words, word_off, length, names, source_id, source_bgn, quals)

    @classmethod
    def from_sequences(cls, seqs: Iterable[str], names: Optional[list[str]] = None) -> "ReadSet":
        return cls.from_codes_list([bitpack.seq_to_codes(s) for s in seqs], names)

    @classmethod
    def from_fastx(
        cls,
        paths: str | Sequence[str],
        min_read_length: int = 1000,
        keep_names: bool = True,
    ) -> tuple["ReadSet", ReadSetStats]:
        """Load reads from FASTA/FASTQ files (gatekeeperCreate equivalent).

        Reads are split at non-ACGT characters (the reference splits reads
        at Ns — Canu src/stores/gatekeeperCreate.C:336) and
        fragments shorter than ``min_read_length`` are dropped (reference
        ``minReadLength``, default 1000 —
        Canu src/pipelines/canu/Defaults.pm).
        """
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        stats = ReadSetStats()
        codes_list: list[np.ndarray] = []
        quals_list: list[np.ndarray] = []
        any_qual = False
        names: list[str] = []

        def add_record(name: str, codes: np.ndarray,
                       qual: Optional[np.ndarray] = None) -> None:
            nonlocal any_qual
            stats.n_input += 1
            frags = _split_at_invalid(codes)
            if len(frags) > 1:
                stats.n_split_at_n += 1
            for fi, (bgn, frag) in enumerate(frags):
                if len(frag) < min_read_length:
                    stats.n_skipped_short += 1
                    continue
                codes_list.append(frag)
                if qual is not None:
                    quals_list.append(qual[bgn : bgn + len(frag)])
                    any_qual = True
                else:
                    # FASTA mixed in: neutral QV 0 = "unknown"
                    quals_list.append(np.zeros(len(frag), np.uint8))
                if keep_names:
                    suffix = f"_frag{fi}" if len(frags) > 1 else ""
                    names.append(name + suffix)
                stats.n_loaded += 1
                stats.bases_loaded += len(frag)

        from ..io.fastx import read_fastx

        for path in paths:
            for rec in read_fastx(path):
                qual = None
                if rec.qual is not None:
                    qual = np.frombuffer(rec.qual.encode("ascii"), np.uint8) - 33
                add_record(rec.name, bitpack.seq_to_codes(rec.seq), qual)
        rs = cls.from_codes_list(
            codes_list,
            names if keep_names else None,
            quals_list=quals_list if any_qual else None,
        )
        return rs, stats

    # ---- basic accessors ----

    @property
    def n_reads(self) -> int:
        return len(self.length)

    @property
    def total_bases(self) -> int:
        return int(self.length.sum())

    @property
    def max_length(self) -> int:
        return int(self.length.max()) if self.n_reads else 0

    def _check_id(self, read_id: int) -> int:
        if not (1 <= read_id <= self.n_reads):
            raise IndexError(f"read id {read_id} out of range 1..{self.n_reads}")
        return read_id - 1

    def get_codes(self, read_id: int) -> np.ndarray:
        """2-bit codes of read `read_id` (1-based)."""
        i = self._check_id(read_id)
        w = self.words[self.word_off[i] : self.word_off[i + 1]]
        return bitpack.unpack_words(w, int(self.length[i]))

    def get_seq(self, read_id: int) -> str:
        return bitpack.codes_to_seq(self.get_codes(read_id))

    @property
    def has_quals(self) -> bool:
        return self.quals is not None

    @property
    def qual_off(self) -> np.ndarray:
        """[n+1] base offsets into the flat quality plane."""
        if self._qual_off is None:
            off = np.zeros(self.n_reads + 1, np.int64)
            np.cumsum(self.length, out=off[1:])
            self._qual_off = off
        return self._qual_off

    def get_qual(self, read_id: int) -> Optional[np.ndarray]:
        """Phred quality values of read `read_id` (1-based), or None."""
        if self.quals is None:
            return None
        i = self._check_id(read_id)
        off = self.qual_off
        return self.quals[off[i] : off[i + 1]]

    def mean_quals(self) -> Optional[np.ndarray]:
        """Per-read mean phred QV (float32[n]), or None if no qual plane."""
        if self.quals is None:
            return None
        cached = self.__dict__.get("_mean_quals")
        if cached is None:
            if self.quals.size == 0 or self.n_reads == 0:
                cached = np.zeros(self.n_reads, np.float32)
                self.__dict__["_mean_quals"] = cached
                return cached
            starts = np.minimum(self.qual_off[:-1], max(self.quals.size - 1, 0))
            sums = np.add.reduceat(self.quals.astype(np.float64), starts)
            sums[self.length == 0] = 0.0
            cached = (sums / np.maximum(self.length, 1)).astype(np.float32)
            self.__dict__["_mean_quals"] = cached
        return cached

    def name(self, read_id: int) -> str:
        i = self._check_id(read_id)
        return self.names[i] if self.names else f"read{read_id}"

    def __len__(self) -> int:
        return self.n_reads

    # ---- device block gather ----

    def block_words(self, ids: np.ndarray, pad_words: Optional[int] = None):
        """Gather reads `ids` (1-based) into a dense padded word block.

        Returns ``(words[B, W] uint32, lengths[B] int32)`` ready for
        ``jnp.asarray``.  Padding words are zero (= 'A' bases); kernels
        mask by length.
        """
        idx = np.asarray(ids, dtype=np.int64) - 1
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_reads):
            raise IndexError("read id out of range")
        wc = (self.word_off[idx + 1] - self.word_off[idx]).astype(np.int64)
        W = int(pad_words) if pad_words is not None else (int(wc.max()) if len(wc) else 1)
        if len(wc) and int(wc.max()) > W:
            raise ValueError(f"pad_words={W} < longest read ({int(wc.max())} words)")
        out = np.zeros((len(idx), W), dtype=np.uint32)
        for row, i in enumerate(idx):
            out[row, : wc[row]] = self.words[self.word_off[i] : self.word_off[i] + wc[row]]
        return out, self.length[idx].copy()

    def sliced(self, bgn: np.ndarray, end: np.ndarray) -> "ReadSet":
        """Derived ReadSet keeping [bgn[i], end[i]) of every read.

        Reads whose range is empty are dropped.  Provenance
        (source_id/source_bgn) and the quality plane carry over — the
        clear-range application of the reference's gatekeeperDumpFASTQ
        (Canu src/stores/gatekeeperDumpFASTQ.C), but producing
        a new immutable store instead of a sidecar file.
        """
        bgn = np.asarray(bgn, np.int64)
        end = np.asarray(end, np.int64)
        assert len(bgn) == self.n_reads and len(end) == self.n_reads
        codes_list: list[np.ndarray] = []
        quals_list: list[np.ndarray] | None = [] if self.has_quals else None
        names: list[str] | None = [] if self.names else None
        src_id: list[int] = []
        src_bgn: list[int] = []
        off = self.qual_off if self.has_quals else None
        for i in range(self.n_reads):
            b = int(max(0, bgn[i]))
            e = int(min(self.length[i], end[i]))
            if e <= b:
                continue
            codes_list.append(self.get_codes(i + 1)[b:e])
            if quals_list is not None:
                quals_list.append(self.quals[off[i] + b : off[i] + e])
            if names is not None:
                names.append(self.names[i])
            # chain provenance through already-derived sets
            src_id.append(int(self.source_id[i]) or (i + 1))
            src_bgn.append(int(self.source_bgn[i]) + b)
        return ReadSet.from_codes_list(
            codes_list,
            names,
            source_id=np.array(src_id, np.int32),
            source_bgn=np.array(src_bgn, np.int32),
            quals_list=quals_list,
        )

    def iter_blocks(self, block_size: int) -> Iterator[np.ndarray]:
        """Yield consecutive 1-based id arrays of at most block_size reads."""
        for bgn in range(1, self.n_reads + 1, block_size):
            yield np.arange(bgn, min(bgn + block_size, self.n_reads + 1), dtype=np.int32)

    # ---- persistence ----

    def save(self, path: str | os.PathLike) -> None:
        """Atomically write the store directory (``.WORKING`` rename).

        The big planes (packed words, quals) are raw ``.npy`` files so
        ``load`` can memory-map them — the reference's mmap'd gkStore
        blob (Canu src/AS_UTL/memoryMappedFile.H); npz would
        force a full copy on every open."""
        path = os.fspath(path)
        tmp = path + ".WORKING"
        os.makedirs(tmp, exist_ok=True)
        arrays = dict(
            words=self.words,
            word_off=self.word_off,
            length=self.length,
            source_id=self.source_id,
            source_bgn=self.source_bgn,
        )
        if self.quals is not None:
            arrays["quals"] = self.quals
        for name, arr in arrays.items():
            np.save(os.path.join(tmp, name + ".npy"), arr)
        meta = {
            "version": 1,
            "n_reads": self.n_reads,
            "total_bases": self.total_bases,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh, indent=1)
        if self.names is not None:
            with open(os.path.join(tmp, "names.txt"), "w") as fh:
                fh.write("\n".join(self.names))
                if self.names:
                    fh.write("\n")
        if os.path.exists(path):
            import shutil

            shutil.rmtree(path)
        os.rename(tmp, path)

    @classmethod
    def load(cls, path: str | os.PathLike, mmap: bool = True) -> "ReadSet":
        """Open a store; the big planes are memory-mapped by default."""
        path = os.fspath(path)

        def arr(name, mode):
            p = os.path.join(path, name + ".npy")
            if os.path.exists(p):
                return np.load(p, mmap_mode=mode)
            return None

        if os.path.exists(os.path.join(path, "words.npy")):
            big = "r" if mmap else None
            words = arr("words", big)
            word_off = arr("word_off", None)
            length = arr("length", None)
            source_id = arr("source_id", None)
            source_bgn = arr("source_bgn", None)
            quals = arr("quals", big)
        else:  # legacy npz store
            with np.load(os.path.join(path, "reads.npz")) as z:
                words = z["words"]
                word_off = z["word_off"]
                length = z["length"]
                source_id = z["source_id"] if "source_id" in z else None
                source_bgn = z["source_bgn"] if "source_bgn" in z else None
                quals = z["quals"] if "quals" in z else None
        names = None
        names_path = os.path.join(path, "names.txt")
        if os.path.exists(names_path):
            with open(names_path) as fh:
                names = fh.read().splitlines()
        return cls(words, word_off, length, names, source_id, source_bgn, quals)

    # ---- reports ----

    def length_histogram(self, bin_size: int = 1000) -> np.ndarray:
        """Read-length histogram (Gatekeeper.pm:360-470 equivalent)."""
        if self.n_reads == 0:
            return np.zeros(0, dtype=np.int64)
        return np.bincount(self.length // bin_size)


# the ReadSets that hold device tensors (weak: a cache lives no longer
# than its read set)
_DEVICE_CACHE_HOLDERS: "weakref.WeakSet[ReadSet]" = weakref.WeakSet()


def device_cache(readset: ReadSet, key: str) -> dict:
    """The dict in which ``key``'s owner caches device tensors of
    ``readset`` (immutable, so a cache never goes stale); made empty on
    first use.  drop_device_caches frees every one."""
    _DEVICE_CACHE_HOLDERS.add(readset)
    return readset.__dict__.setdefault("_device_caches", {}).setdefault(key, {})


def drop_device_caches() -> int:
    """Drop every device cache held on a live ReadSet (the stage runner's
    recovery from a CUDA out-of-memory attempt); returns how many read
    sets held one.  The next device_cache starts empty."""
    n = sum(rs.__dict__.pop("_device_caches", None) is not None
            for rs in list(_DEVICE_CACHE_HOLDERS))
    _DEVICE_CACHE_HOLDERS.clear()
    return n


def _split_at_invalid(codes: np.ndarray) -> list[tuple[int, np.ndarray]]:
    """Split a code array at invalid (255) positions; returns (bgn, frag)."""
    bad = codes == 255
    if not bad.any():
        return [(0, codes)]
    out: list[tuple[int, np.ndarray]] = []
    boundaries = np.flatnonzero(bad)
    prev = 0
    for b in boundaries:
        if b > prev:
            out.append((prev, codes[prev:b]))
        prev = b + 1
    if prev < len(codes):
        out.append((prev, codes[prev:]))
    return out
