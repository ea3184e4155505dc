"""TigStore — layouts + consensus, versioned (tgStore equivalent).

The port's own copy of canu_tpu.stores.tigs (no torch, no jax), with the same
results.

Replaces the reference tgStore/tgTig
(Canu src/stores/tgTig.H: tgPosition read placements with
orientation, tgTig gapped/ungapped bases, class
{unassembled,bubble,contig}; versioned seqDB.v###) with dataclasses +
columnar numpy placements.  Version semantics match the reference
pipeline: v001 = layouts from unitigging, v002 = +consensus
(Canu src/pipelines/canu/Consensus.pm:437-499).
The correction layouts store (corStore) is the same type, as in the
reference (Canu src/correction/generateCorrectionLayouts.C:329).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

CLASS_UNASSEMBLED = 0
CLASS_CONTIG = 1
CLASS_BUBBLE = 2

CLASS_NAMES = {CLASS_UNASSEMBLED: "unassembled", CLASS_CONTIG: "contig", CLASS_BUBBLE: "bubble"}


@dataclass
class Tig:
    """One tig: read placements in tig coordinates + optional consensus.

    placements: structured arrays; reverse reads have rev=True (the
    reference encodes this as bgn > end in tgPosition — tgTig.H:84-215).
    """

    tig_id: int
    read_id: np.ndarray  # int32 [m]
    bgn: np.ndarray  # int32 [m] tig coords, bgn < end
    end: np.ndarray  # int32 [m]
    rev: np.ndarray  # bool [m]
    tig_class: int = CLASS_CONTIG
    consensus: Optional[np.ndarray] = None  # uint8 codes or None

    @property
    def n_reads(self) -> int:
        return len(self.read_id)

    @property
    def length(self) -> int:
        if self.consensus is not None:
            return len(self.consensus)
        return int(self.end.max()) if len(self.end) else 0

    def coverage(self) -> float:
        span = self.length
        return float((self.end - self.bgn).sum()) / max(1, span)


class TigStore:
    """Versioned collection of tigs."""

    def __init__(self, tigs: Optional[list[Tig]] = None):
        self.tigs: list[Tig] = tigs or []

    def add(self, tig: Tig) -> None:
        self.tigs.append(tig)

    def __len__(self) -> int:
        return len(self.tigs)

    def __iter__(self):
        return iter(self.tigs)

    def __getitem__(self, i: int) -> Tig:
        return self.tigs[i]

    def n50(self) -> int:
        """NG-style N50 over tig lengths (Unitig.pm:62-160 report analog)."""
        lens = sorted((t.length for t in self.tigs if t.tig_class == CLASS_CONTIG), reverse=True)
        if not lens:
            return 0
        half = sum(lens) / 2
        acc = 0
        for l in lens:
            acc += l
            if acc >= half:
                return l
        return lens[-1]

    # ---- persistence (versioned like seqDB.v###) ----

    def save(self, path: str | os.PathLike, version: int = 1) -> None:
        path = os.fspath(path)
        os.makedirs(path, exist_ok=True)
        # np.savez appends ".npz" unless the name already ends with it
        tmp = os.path.join(path, f"v{version:03d}.WORKING.npz")
        final = os.path.join(path, f"v{version:03d}.npz")
        payload: dict[str, np.ndarray] = {
            "n_tigs": np.array([len(self.tigs)]),
        }
        meta = []
        for i, t in enumerate(self.tigs):
            payload[f"t{i}_read_id"] = t.read_id
            payload[f"t{i}_bgn"] = t.bgn
            payload[f"t{i}_end"] = t.end
            payload[f"t{i}_rev"] = t.rev
            if t.consensus is not None:
                payload[f"t{i}_cns"] = t.consensus
            meta.append({"tig_id": t.tig_id, "class": t.tig_class, "has_cns": t.consensus is not None})
        np.savez(tmp, **payload)
        with open(os.path.join(path, f"v{version:03d}.meta.json.WORKING"), "w") as fh:
            json.dump(meta, fh)
        os.rename(tmp, final)
        os.rename(
            os.path.join(path, f"v{version:03d}.meta.json.WORKING"),
            os.path.join(path, f"v{version:03d}.meta.json"),
        )

    @classmethod
    def load(cls, path: str | os.PathLike, version: int = 1) -> "TigStore":
        path = os.fspath(path)
        with open(os.path.join(path, f"v{version:03d}.meta.json")) as fh:
            meta = json.load(fh)
        tigs = []
        with np.load(os.path.join(path, f"v{version:03d}.npz")) as z:
            for i, m in enumerate(meta):
                tigs.append(
                    Tig(
                        tig_id=m["tig_id"],
                        read_id=z[f"t{i}_read_id"],
                        bgn=z[f"t{i}_bgn"],
                        end=z[f"t{i}_end"],
                        rev=z[f"t{i}_rev"],
                        tig_class=m["class"],
                        consensus=z[f"t{i}_cns"] if m["has_cns"] else None,
                    )
                )
        return cls(tigs)

    @staticmethod
    def latest_version(path: str | os.PathLike) -> int:
        path = os.fspath(path)
        if not os.path.isdir(path):
            return 0
        vs = [
            int(f[1:4])
            for f in os.listdir(path)
            if f.startswith("v") and f.endswith(".npz") and f[1:4].isdigit()
        ]
        return max(vs) if vs else 0
