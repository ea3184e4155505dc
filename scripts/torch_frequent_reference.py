"""Make canu_tpu_torch/frequent_overlap_reference.json: the JAX package's
cor and obt meryl + overlap outputs on a read set whose repeat family
fills the frequent-mer tables, for chip_smoke.py's phase 4c ("frequent")
to hold the port against.

    JAX_PLATFORMS=cpu python scripts/torch_frequent_reference.py

The read sets (tests/torch_cases.py frequent_reads): the bench genome's
size and read shapes with 24 copies of a 1.5 kb repeat, raw reads (10%
error) for cor and corrected ones (3%) for obt, each plus one chimeric
read whose pair with its source read is palindromic.  Each stage runs
canu_tpu on the CPU with Config() + genomeSize=300k + ovsMethod=spill (the
store through the spill file and the external sort), in a directory of
its own: meryl, then overlap.  Recorded per stage: the frequent table
(its size and digest), the candidates of the block matcher, and
the store (rows, store_digest, and the rows whose (a_id, b_id) repeat: a
palindromic pair verified in both orientations).  Each stage's wall
seconds go into the file beside its result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

TAGS = ("cor", "obt")


def frequent_digest(path: str) -> str:
    h = hashlib.sha256()
    with np.load(path) as z:
        for n in ("kmers", "fraction", "threshold", "total", "k"):
            h.update(np.ascontiguousarray(z[n]).tobytes())
    return h.hexdigest()


def repeated_rows(st) -> int:
    """Store rows whose (a_id, b_id) another row repeats."""
    pairs = np.stack([np.asarray(st.a_id), np.asarray(st.b_id)], axis=1)
    return int(len(pairs) - len(np.unique(pairs, axis=0)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "frequent_overlap_reference.json"))
    args = ap.parse_args()

    from canu_tpu.config import Config
    from canu_tpu.ops import minhash as MH
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import make_ctx
    from canu_tpu.sim import simulate
    from canu_tpu.stores.readset import ReadSet
    from canu_tpu_torch.stores.overlaps import store_digest
    from torch_cases import (FREQUENT_GENOME, FREQUENT_READS, FREQUENT_SIM, candidates_digest,
                             frequent_reads)

    length, seed, repeats = FREQUENT_GENOME
    ref = {
        "what": "canu_tpu (JAX, CPU) cor and obt meryl + overlap outputs under ovsMethod=spill "
                "on a read set with a repeat family, for chip_smoke.py's frequent phase (4c)",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_frequent_reference.py",
        "read_set": f"tests/torch_cases.py frequent_reads: random_genome({length}, seed={seed}, "
                    f"repeat_spec={repeats}); simulate_reads({FREQUENT_SIM}, the stage's "
                    "error_rate and seed) + one chimeric read",
        "config": "Config() + genomeSize=300k + ovsMethod=spill",
        "frequent_sha256_of": "sha256 over the bytes of the .frequent.npz arrays kmers, "
                              "fraction, threshold, total, k (in that order)",
        "candidates_sha256_of": "tests/torch_cases.py candidates_digest of the [M, 3] "
                                "candidates find_candidates returned in the stage",
        "store_sha256_of": "canu_tpu_torch.stores.overlaps.store_digest",
    }
    for tag in TAGS:
        t = time.time()
        rs = frequent_reads(simulate, ReadSet, tag)
        print(f"{tag}: {rs.n_reads} reads, {rs.total_bases} bases ({time.time() - t:.1f} s)",
              flush=True)
        cfg = Config()
        cfg.set("genomeSize", "300k")
        cfg.set("ovsMethod", "spill")
        work = tempfile.mkdtemp(prefix=f"frequent_ref_{tag}_")
        ctx = make_ctx(work, "freq", cfg)
        k = int(cfg.get(f"{tag}MerSize"))
        seen = []
        real = MH.find_candidates
        MH.find_candidates = lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1]
        try:
            t = time.time()
            fk = stages.meryl(ctx, tag, rs)
            t_meryl = time.time() - t
            st = stages.overlap(ctx, tag, rs, fk)
            t_overlap = time.time() - t - t_meryl
        finally:
            MH.find_candidates = real
        (pairs,) = seen  # the block matcher: 1,054 reads are below 5,000
        d = os.path.join(work, stages.TAG_DIR[tag])
        ref[tag] = {
            "reads": FREQUENT_READS[tag],
            "n_reads": int(rs.n_reads),
            "total_bases": int(rs.total_bases),
            "k": k,
            "frequent_n": int(fk.n),
            "frequent_threshold": int(fk.threshold),
            "frequent_sha256": frequent_digest(os.path.join(d, f"freq.ms{k}.frequent.npz")),
            "n_candidates": int(len(pairs)),
            "candidates_sha256": candidates_digest(pairs),
            "rows": int(len(st)),
            "repeated_rows": repeated_rows(st),
            "store_sha256": store_digest(st),
            "cpu_seconds": {"meryl": round(t_meryl, 1), "overlap": round(t_overlap, 1)},
        }
        print(tag, json.dumps(ref[tag]), flush=True)
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
