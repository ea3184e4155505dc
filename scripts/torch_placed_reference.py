"""Make canu_tpu_torch/placed_overlap_reference.json: the JAX package's
stage C (place_candidates) on the bench read set's candidates and the
verify of the placed candidates, for chip_smoke.py's placed-candidates
phase to hold the port against.

    JAX_PLATFORMS=cpu python scripts/torch_placed_reference.py [--genome N] [--out FILE]

The read set is bench.py's (chip_smoke.py bench_reads: random_genome(300
kb, seed 42), 12x, 10% error, seed 43); canu_tpu runs on the CPU with
Config() + genomeSize: the cor meryl (its frequent table), the cor
stage's sketches and block matcher (Config's sketch preset at the read
set's coverage, mhapBlockSize, blocks of 1,024), then place_candidates at
k 16 with the frequent table and at k 22 without one, and verify_overlaps
(band 128, its defaults) on each placed set.  Recorded per k: the placed
candidates' count and digest (tests/torch_cases.py placed_digest) and the
verified rows' count and store_digest; the candidates' count and digest;
each step's wall seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

BENCH_GENOME = 300_000
PLACED_KS = ((16, True), (22, False))  # (k, with the frequent table)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome", type=int, default=BENCH_GENOME)
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "placed_overlap_reference.json"))
    args = ap.parse_args()

    from canu_tpu.config import Config
    from canu_tpu.ops import align as JA
    from canu_tpu.ops import minhash as JM
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import make_ctx
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from canu_tpu_torch.stores.overlaps import store_digest
    from torch_cases import candidates_digest, placed_digest, readset_digest

    t = time.time()
    rs, _ = simulate_reads(random_genome(args.genome, seed=42), coverage=12, mean_len=3500,
                           min_len=1500, max_len=7800, error_rate=0.10, seed=43)
    walls = {"simulate": round(time.time() - t, 1)}
    cfg = Config()
    cfg.set("genomeSize", args.genome)
    ctx = make_ctx(tempfile.mkdtemp(prefix="placed_ref_"), "bench", cfg)
    t = time.time()
    fk = stages.meryl(ctx, "cor", rs)
    walls["meryl"] = round(time.time() - t, 1)
    coverage = rs.total_bases / max(1.0, cfg.get("genomeSize"))
    n_hashes, min_matches = cfg.sketch_preset("cor", coverage)
    t = time.time()
    sk = JM.build_sketches(rs, k=int(cfg.get("corMerSize")), n_hashes=n_hashes, frequent=fk,
                           block_size=int(cfg.get("mhapBlockSize")))
    pairs = JM.find_candidates(sk, min_matches=min_matches, block_size=1024)
    walls["candidates"] = round(time.time() - t, 1)
    print(f"{rs.n_reads} reads; frequent {fk.n}; H {n_hashes}, min_matches {min_matches}: "
          f"{len(pairs)} candidates ({walls})", flush=True)
    ref = {
        "what": "canu_tpu (JAX, CPU) place_candidates on the bench read set's cor candidates, "
                "and verify_overlaps of the placed candidates",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_placed_reference.py",
        "genome": args.genome, "n_reads": int(rs.n_reads), "reads_sha256": readset_digest(rs),
        "frequent_n": int(fk.n), "n_hashes": int(n_hashes), "min_matches": int(min_matches),
        "n_candidates": int(len(pairs)), "candidates_sha256": candidates_digest(pairs),
        "placed_sha256_of": "tests/torch_cases.py placed_digest",
        "rows_sha256_of": "canu_tpu_torch.stores.overlaps.store_digest",
    }
    for k, with_fk in PLACED_KS:
        t = time.time()
        placed = JM.place_candidates(rs, pairs[:, :2], k=k, frequent=fk if with_fk else None)
        t_place = time.time() - t
        t = time.time()
        table = JA.verify_overlaps(rs, placed, band=128)
        t_verify = time.time() - t
        ref[f"k{k}"] = {"k": k, "frequent": with_fk, "placed": len(placed),
                        "flipped": int(placed.flipped.sum()),
                        "placed_sha256": placed_digest(placed), "rows": len(table.a_id),
                        "rows_sha256": store_digest(table),
                        "place_s": round(t_place, 1), "verify_s": round(t_verify, 1)}
        print(f"k {k}: {ref[f'k{k}']}", flush=True)
    ref["walls_s"] = walls
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
