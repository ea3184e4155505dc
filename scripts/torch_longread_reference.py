"""Make canu_tpu_torch/longread_overlap_reference.json: the JAX package's
cor meryl + overlap outputs on reads above 131,072 bases, for
chip_smoke.py's long-read phase (17) to hold the port against.

    JAX_PLATFORMS=cpu python scripts/torch_longread_reference.py

The read set (tests/torch_cases.py longread_reads): six raw reads of
132-172 kb at 10% error from a circular 300 kb genome, so the read index
is 16,384 words wide and the verify runs 262,144 rows a pair.  canu_tpu
runs on the CPU with Config() + genomeSize=300k: meryl, then the cor
overlap stage.  Recorded: the read set's digest, the frequent table (its
size and digest), the candidates of the block matcher and the store (rows,
store_digest); each step's wall seconds beside its result.
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


def frequent_digest(path: str) -> str:
    h = hashlib.sha256()
    with np.load(path) as z:
        for n in ("kmers", "fraction", "threshold", "total", "k"):
            h.update(np.ascontiguousarray(z[n]).tobytes())
    return h.hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "longread_overlap_reference.json"))
    args = ap.parse_args()

    from canu_tpu.config import Config
    from canu_tpu.ops import minhash as MH
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import make_ctx
    from canu_tpu.sim import simulate
    from canu_tpu_torch.stores.overlaps import store_digest
    from torch_cases import (LONGREAD_GENOME, LONGREAD_SIM, candidates_digest, longread_reads,
                             readset_digest)

    t = time.time()
    rs = longread_reads(simulate)
    print(f"{rs.n_reads} reads, {rs.total_bases} bases, lengths {rs.length.tolist()} "
          f"({time.time() - t:.1f} s)", flush=True)
    cfg = Config()
    cfg.set("genomeSize", "300k")
    work = tempfile.mkdtemp(prefix="longread_ref_")
    ctx = make_ctx(work, "long", cfg)
    k = int(cfg.get("corMerSize"))
    seen = []
    real = MH.find_candidates
    MH.find_candidates = lambda *a, **kw: seen.append(real(*a, **kw)) or seen[-1]
    try:
        t = time.time()
        fk = stages.meryl(ctx, "cor", rs)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, "cor", rs, fk)
        t_overlap = time.time() - t - t_meryl
    finally:
        MH.find_candidates = real
    (pairs,) = seen
    d = os.path.join(work, stages.TAG_DIR["cor"])
    length, seed = LONGREAD_GENOME
    ref = {
        "what": "canu_tpu (JAX, CPU) cor meryl + overlap outputs on reads above 131,072 "
                "bases, for chip_smoke.py's long-read phase (17)",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_longread_reference.py",
        "read_set": f"tests/torch_cases.py longread_reads: random_genome({length}, seed={seed}); "
                    f"simulate_reads({LONGREAD_SIM})",
        "config": "Config() + genomeSize=300k",
        "reads_sha256_of": "tests/torch_cases.py readset_digest",
        "frequent_sha256_of": "sha256 over the bytes of the .frequent.npz arrays kmers, "
                              "fraction, threshold, total, k (in that order)",
        "candidates_sha256_of": "tests/torch_cases.py candidates_digest of the [M, 3] "
                                "candidates find_candidates returned in the stage",
        "store_sha256_of": "canu_tpu_torch.stores.overlaps.store_digest",
        "n_reads": int(rs.n_reads),
        "total_bases": int(rs.total_bases),
        "max_len": int(rs.length.max()),
        "reads_sha256": readset_digest(rs),
        "k": k,
        "frequent_n": int(fk.n),
        "frequent_sha256": frequent_digest(os.path.join(d, f"long.ms{k}.frequent.npz")),
        "n_candidates": int(len(pairs)),
        "candidates_sha256": candidates_digest(pairs),
        "rows": int(len(st)),
        "store_sha256": store_digest(st),
        "cpu_seconds": {"meryl": round(t_meryl, 1), "overlap": round(t_overlap, 1)},
    }
    print(json.dumps(ref, indent=1), flush=True)
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
