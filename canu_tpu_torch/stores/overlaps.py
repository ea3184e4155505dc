"""OverlapStore — sorted, per-read-indexed overlap database (counterpart of
canu_tpu.stores.overlaps, in-RAM build only).

Every overlap is stored twice (A->B and B->A), rows sorted by (a_id,
b_id), ``index[r]:index[r+1]`` slicing read r's overlaps.  On disk a
store is a directory of one raw .npy per column plus meta.json (v2),
byte-compatible with canu_tpu's: either package loads the other's store.
The spill-file external-sort build is not ported yet.
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
