"""OverlapStore — sorted, per-read-indexed overlap database (counterpart of
canu_tpu.stores.overlaps).

Every overlap is stored twice (A->B and B->A), rows sorted by (a_id,
b_id), ``index[r]:index[r+1]`` slicing read r's overlaps.  On disk a
store is a directory of one raw .npy per column plus meta.json (v2),
byte-compatible with canu_tpu's: either package loads the other's store.

Two builds: ``build`` symmetrizes and sorts a table in RAM; at scale the
overlap stage streams each verified chunk into an ``OverlapSpill`` file
of packed records and ``build_spilled`` sorts it with the native
external merge sort (canu_tpu_torch.native).  std::sort is not stable,
so rows with equal (a_id, b_id) (obt's palindromic pairs) may come out
in either order: compare stores by store_digest.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

from ..ops.align import OverlapTable

_COLS = ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")
_DTYPES = ("<i4", "<i4", "|b1", "<i4", "<i4", "<i4", "<i4", "<u2")

# packed on-disk record of the spill file; the layout is native/ovsort.cc's
# Rec (28 bytes, no padding holes)
REC_DTYPE = np.dtype([
    ("a_id", "<u4"), ("b_id", "<u4"),
    ("a_bgn", "<i4"), ("a_end", "<i4"), ("b_bgn", "<i4"), ("b_end", "<i4"),
    ("erate_q", "<u2"), ("flipped", "u1"), ("pad", "u1"),
])
assert REC_DTYPE.itemsize == 28

# calls of OverlapStore.build_spilled (chip_smoke.py checks a drive's path by it)
SPILL_BUILDS = 0


class OverlapStore:
    def __init__(self, n_reads: int, **cols: np.ndarray):
        self.n_reads = n_reads
        for c in _COLS:
            setattr(self, c, cols[c])
        # index[r] = first row with a_id == r
        self.index = np.zeros(self.n_reads + 2, dtype=np.int64)
        counts = np.bincount(self.a_id, minlength=self.n_reads + 1)
        np.cumsum(counts, out=self.index[1 : len(counts) + 1])
        self.index[len(counts) + 1 :] = self.index[len(counts)]

    @classmethod
    def build(cls, table: OverlapTable, n_reads: int) -> "OverlapStore":
        """Symmetrize + sort an OverlapTable (A->B rows only) into a store."""
        a_id = np.concatenate([table.a_id, table.b_id])
        b_id = np.concatenate([table.b_id, table.a_id])
        order = np.lexsort((b_id, a_id))
        cols = {
            "a_id": a_id, "b_id": b_id,
            "flipped": np.concatenate([table.flipped, table.flipped]),
            "a_bgn": np.concatenate([table.a_bgn, table.b_bgn]),
            "a_end": np.concatenate([table.a_end, table.b_end]),
            "b_bgn": np.concatenate([table.b_bgn, table.a_bgn]),
            "b_end": np.concatenate([table.b_end, table.a_end]),
            "erate_q": np.concatenate([table.erate_q, table.erate_q]),
        }
        return cls(n_reads, **{c: cols[c][order].astype(d) for c, d in zip(_COLS, _DTYPES)})

    @classmethod
    def from_records(cls, recs: np.ndarray, n_reads: int) -> "OverlapStore":
        """Store from a REC_DTYPE array already sorted by (a_id, b_id)."""
        return cls(
            n_reads,
            a_id=recs["a_id"].astype(np.int32), b_id=recs["b_id"].astype(np.int32),
            flipped=recs["flipped"].astype(bool),
            **{c: np.ascontiguousarray(recs[c])
               for c in ("a_bgn", "a_end", "b_bgn", "b_end", "erate_q")},
        )

    @classmethod
    def build_spilled(cls, spill: "OverlapSpill", n_reads: int, mem_budget: int = 1 << 30,
                      n_threads: int = 0) -> "OverlapStore":
        """Store from a spill file, sorted by the native external merge sort
        (the reference's bucketize/sort/index build of stores beyond RAM).
        The spill file and the sorted file are removed afterwards."""
        global SPILL_BUILDS
        from ..native import ovsort_file

        SPILL_BUILDS += 1
        spill.close()
        out = spill.path + ".sorted"
        ovsort_file(spill.path, out, os.path.dirname(spill.path) or ".", mem_budget, n_threads)
        recs = np.memmap(out, dtype=REC_DTYPE, mode="r") if spill.n_rows else \
            np.zeros(0, REC_DTYPE)
        st = cls.from_records(recs, n_reads)
        del recs
        os.remove(spill.path)
        os.remove(out)
        return st

    def __len__(self) -> int:
        return len(self.a_id)

    @property
    def n_overlaps(self) -> int:
        """Distinct overlaps (each stored twice)."""
        return len(self.a_id) // 2

    @property
    def erate(self) -> np.ndarray:
        return self.erate_q.astype(np.float32) / 10000.0

    def n_overlaps_per_read(self) -> np.ndarray:
        return np.diff(self.index[1 : self.n_reads + 2]).astype(np.int64)

    def save(self, path: str | os.PathLike) -> None:
        """One raw .npy per column (v2), written to path.WORKING and renamed."""
        path = os.fspath(path)
        tmp = path + ".WORKING"
        os.makedirs(tmp, exist_ok=True)
        for c in _COLS:
            np.save(os.path.join(tmp, c + ".npy"), getattr(self, c))
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump({"version": 2, "n_reads": self.n_reads, "rows": len(self)}, fh)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)

    @classmethod
    def load(cls, path: str | os.PathLike, mmap: bool = True) -> "OverlapStore":
        path = os.fspath(path)
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        if meta.get("version", 1) < 2:
            raise ValueError(f"{path}: only v2 (per-column .npy) stores are supported")
        cols = {c: np.load(os.path.join(path, c + ".npy"), mmap_mode="r" if mmap else None)
                for c in _COLS}
        return cls(meta["n_reads"], **cols)


class OverlapSpill:
    """Streaming writer of symmetrized overlap records to a spill file.

    Each verified OverlapTable chunk is appended in both orientations as
    REC_DTYPE records, never held in RAM; OverlapStore.build_spilled sorts
    the file into a store (the reference's per-job .ovb outputs that
    ovStoreBucketizer scatters, ovStoreBucketizer.C:50-71)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        self._fh = open(self.path, "wb")
        self.n_rows = 0

    def append(self, table: OverlapTable) -> None:
        m = len(table)
        if m == 0:
            return
        recs = np.zeros(2 * m, dtype=REC_DTYPE)
        for dst, fwd, rev in (("a_id", "a_id", "b_id"), ("b_id", "b_id", "a_id"),
                              ("a_bgn", "a_bgn", "b_bgn"), ("a_end", "a_end", "b_end"),
                              ("b_bgn", "b_bgn", "a_bgn"), ("b_end", "b_end", "a_end"),
                              ("erate_q", "erate_q", "erate_q"),
                              ("flipped", "flipped", "flipped")):
            recs[dst][:m] = getattr(table, fwd)
            recs[dst][m:] = getattr(table, rev)
        recs.tofile(self._fh)
        self.n_rows += 2 * m

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def store_digest(st) -> str:
    """sha256 of a store's 8 columns (fixed little-endian dtypes), rows in
    (a_id, b_id, flipped, ..., erate_q) order: equal digests mean equal
    stores row for row, whichever package built them."""
    cols = [np.asarray(getattr(st, c)).astype(d) for c, d in zip(_COLS, _DTYPES)]
    order = np.lexsort(tuple(reversed(cols)))
    h = hashlib.sha256()
    for c in cols:
        h.update(np.ascontiguousarray(c[order]).tobytes())
    return h.hexdigest()
