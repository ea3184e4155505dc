"""Make canu_tpu_torch/ecoli_overlap_reference.json: the JAX package's obt
meryl + candidate outputs at E. coli scale, and its store on a sample of
the candidates, for chip_smoke.py's "ecoli" phase to hold the port against.

    JAX_PLATFORMS=cpu python scripts/torch_ecoli_reference.py [--genome 3000000]

chip_smoke.py's phase 9 runs at 3 Mb (config 2's shapes cut to fit its
time limit; its 75 M k=22 instances still go to the host counter).

Runs canu_tpu on the CPU (the JAX package is the reference):
  meryl      canu_tpu.pipeline.stages.meryl(ctx, "obt", rs) (Config() +
             genomeSize; above 2^26 k=22 instances it counts on the host);
  candidates build_sketches + find_candidates_join with the obt sketch
             preset, as the overlap stage runs them above 5,000 reads;
  sample     every floor(M/2048)-th row of the sorted candidates, 2,048
             rows, verified with the obt arguments (band 128, partial,
             palindromic pairs) and built into an OverlapStore;
  sample2    the same from half a stride in: 2,048 other rows.
A verify of every candidate on the CPU would take hours; the sample's
rows equal the full store's rows for those pairs (verification is per
pair; tests/test_torch_scale_stage.py checks it), so it stands in.
Each step's wall seconds go into the file beside its result.
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

SAMPLE = 2048


def frequent_digest(path: str) -> str:
    h = hashlib.sha256()
    with np.load(path) as z:
        for n in ("kmers", "fraction", "threshold", "total", "k"):
            h.update(np.ascontiguousarray(z[n]).tobytes())
    return h.hexdigest()


def array_digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a.astype("<i8")).tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome", type=int, default=3_000_000)
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "ecoli_overlap_reference.json"))
    args = ap.parse_args()

    from canu_tpu.config import Config
    from canu_tpu.ops import align as AL
    from canu_tpu.ops import minhash as MH
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import make_ctx
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from canu_tpu.stores.overlaps import OverlapStore
    from canu_tpu_torch.stores.overlaps import store_digest
    from torch_cases import candidate_sample

    secs: dict[str, float] = {}

    def lap(name: str, t0: float) -> None:
        secs[name] = round(time.time() - t0, 1)
        print(f"{name}: {secs[name]} s", flush=True)

    t = time.time()
    g = random_genome(args.genome, seed=7)
    rs, _ = simulate_reads(g, coverage=25, mean_len=3500, min_len=1500, max_len=7800,
                           error_rate=0.03, seed=8)
    lap("simulate", t)
    print(f"{rs.n_reads} reads, {rs.total_bases} bases", flush=True)
    cfg = Config()
    cfg.set("genomeSize", args.genome)
    work = tempfile.mkdtemp(prefix="ecoli_ref_")
    ctx = make_ctx(work, "ecoli", cfg)
    tag = "obt"
    k = int(cfg.get(tag + "MerSize"))

    t = time.time()
    fk = stages.meryl(ctx, tag, rs)
    lap("meryl", t)
    fpath = os.path.join(work, stages.TAG_DIR[tag], f"ecoli.ms{k}.frequent.npz")

    coverage = rs.total_bases / max(1.0, cfg.get("genomeSize"))
    n_hashes, min_matches = cfg.sketch_preset(tag, coverage)
    t = time.time()
    sk = np.asarray(MH.build_sketches(rs, k=k, n_hashes=n_hashes, frequent=fk,
                                      block_size=int(cfg.get("mhapBlockSize"))))
    lap("sketch", t)
    t = time.time()
    pairs = MH.find_candidates_join(sk, min_matches=min_matches)
    lap("join", t)
    del sk

    ms = int(cfg.get(tag + "MinShared"))
    samples = {}
    for name, second in (("sample", False), ("sample2", True)):
        sample = candidate_sample(pairs, SAMPLE, second=second)
        t = time.time()
        ov = AL.verify_overlaps(rs, sample, k=k, band=int(cfg.get(tag + "OvlBandWidth")),
                                max_erate=float(cfg.get(tag + "OvlErrorRate")),
                                min_overlap=int(cfg.get("minOverlapLength")), chunk=512,
                                min_shared=ms, partial=True, palindromic_min=ms)
        st = OverlapStore.build(ov, rs.n_reads)
        lap(f"{name}_verify_store", t)
        step = max(1, len(pairs) // SAMPLE)
        samples[name] = {
            "rule": f"candidates[{step // 2 if second else 0}::max(1, M // {SAMPLE})][:{SAMPLE}]",
            "n": int(len(sample)),
            "candidates_sha256": array_digest(sample),
            "rows": int(len(st)),
            "store_sha256_of": "canu_tpu_torch.stores.overlaps.store_digest",
            "store_sha256": store_digest(st),
        }

    ref = {
        "what": "canu_tpu (JAX, CPU) obt meryl + hash-join candidates at E. coli scale, and "
                "its verify + OverlapStore.build on a sample of the candidates, for "
                "chip_smoke.py's ecoli phase",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_ecoli_reference.py"
                   + (f" --genome {args.genome}" if args.genome != 3_000_000 else ""),
        "read_set": f"random_genome({args.genome}, seed=7); simulate_reads(coverage=25, "
                    "mean_len=3500, min_len=1500, max_len=7800, error_rate=0.03, seed=8)",
        "config": f"Config() + genomeSize={args.genome}",
        "n_reads": int(rs.n_reads),
        "total_bases": int(rs.total_bases),
        "k": k,
        "n_hashes": int(n_hashes),
        "min_matches": int(min_matches),
        "frequent_sha256_of": "sha256 over the bytes of the .frequent.npz arrays kmers, "
                              "fraction, threshold, total, k (in that order)",
        "frequent_n": int(fk.n),
        "frequent_threshold": int(fk.threshold),
        "frequent_sha256": frequent_digest(fpath),
        "candidates_sha256_of": "sha256 of the int64 little-endian bytes of the [M, 3] "
                                "(a_id, b_id, slot_matches) rows, C order",
        "n_candidates": int(len(pairs)),
        "candidates_sha256": array_digest(pairs),
        **samples,
        "cpu_seconds": secs,
    }
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    print(json.dumps(ref, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
