"""Make canu_tpu_torch/correction_reference.json: the JAX package's corrected
reads of the bench read set, block by block, for chip_smoke.py's "correct"
phase to hold the port against.

    JAX_PLATFORMS=cpu python scripts/torch_correction_reference.py [--genome 300000]

Runs canu_tpu on the CPU (the JAX package is the reference):
  reads      bench.py's read set, random_genome(300 kb, seed=42) +
             simulate_reads(coverage=12, mean_len=3500, min_len=1500,
             max_len=7800, error_rate=0.10, seed=43), written to a FASTA file;
  stages     gatekeeper, meryl and overlap ("cor") with Config() +
             genomeSize, as correction_phase runs them;
  blocks     the template blocks correction_phase will make of them
             (canu_tpu.ops.falcon's selection, segment table and packing);
  correct    canu_tpu's correction_phase from the FASTA, every block.
A CPU run takes about half an hour (~13 s a chunk of 256 jobs at 2,048
rows on 8 cores).  Each block's reads are digested with
tests/torch_cases.py corrected_digest; each step's wall seconds go into
the file beside its result.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome", type=int, default=300_000)
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "correction_reference.json"))
    args = ap.parse_args()

    from canu_tpu.config import Config
    from canu_tpu.io.fastx import write_fasta
    from canu_tpu.ops import falcon as F
    from canu_tpu.ops import votepile as VP
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import make_ctx
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from canu_tpu_torch.stores.overlaps import store_digest
    from torch_cases import corrected_digest

    secs: dict[str, float] = {}

    def lap(name: str, t0: float) -> None:
        secs[name] = round(time.time() - t0, 1)
        print(f"{name}: {secs[name]} s", flush=True)

    work = tempfile.mkdtemp(prefix="correction_ref_")
    t = time.time()
    g = random_genome(args.genome, seed=42)
    raw, _ = simulate_reads(g, coverage=12, mean_len=3500, min_len=1500, max_len=7800,
                            error_rate=0.10, seed=43)
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    lap("simulate", t)
    cfg = Config()
    cfg.set("genomeSize", args.genome)
    ctx = make_ctx(work, "bench", cfg)

    t = time.time()
    rs = stages.gatekeeper(ctx, "cor", [fasta])
    lap("gatekeeper", t)
    t = time.time()
    fk = stages.meryl(ctx, "cor", rs)
    lap("meryl", t)
    t = time.time()
    st = stages.overlap(ctx, "cor", rs, fk)
    lap("overlap", t)

    # the blocks correction_phase makes (correct_reads_blocks' selection
    # and run_vote_blocks' packing, with the phase's arguments)
    tids = F.select_templates(rs, float(cfg.get("genomeSize")), int(cfg.get("corOutCoverage")))
    rows = F.select_evidence_rows(st, tids, rs.length, stages._cor_evidence_budget(ctx, rs),
                                  int(cfg.get("corMinEvidenceLength")),
                                  float(cfg.get("corMaxEvidenceErate")))
    jobs = F.evidence_vote_jobs(st, rows, rs.length)
    has_ev = np.zeros(rs.n_reads + 1, bool)
    has_ev[jobs.t_idx + 1] = True
    tids = tids[has_ev[tids]]
    S = F.VOTE_SEG
    G = max(8, min(256, VP.BLOCK_POS_BUDGET // S))
    tl, nseg, _row0 = F._segment_table(rs.length, tids, S)
    blocks = F._pack_template_blocks(tids, tl, nseg, G)
    block_of = {rs.name(int(tids[i])): bi for bi, tsel in enumerate(blocks) for i in tsel}
    covered = list(range(len(blocks)))

    t = time.time()
    stages.correction_phase(ctx, [fasta])
    lap("correction", t)
    out = os.path.join(work, "correction", "bench.correctedReads.fasta.gz")
    per_block: dict[int, list[tuple[str, str]]] = {bi: [] for bi in covered}
    name = None
    with gzip.open(out, "rt") as fh:
        recs = []
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                name = line[1:]
                recs.append([name, ""])
            else:
                recs[-1][1] += line
    for name, seq in recs:
        per_block[block_of[name.rsplit("_corr", 1)[0]]].append((name, seq))

    ref = {
        "what": "canu_tpu (JAX, CPU) correction_phase from a FASTA of the bench read set: "
                "the corrected reads of each of its template blocks, for "
                "chip_smoke.py's correct phase",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_correction_reference.py"
                   + (f" --genome {args.genome}" if args.genome != 300_000 else ""),
        "read_set": f"random_genome({args.genome}, seed=42); simulate_reads(coverage=12, "
                    "mean_len=3500, min_len=1500, max_len=7800, error_rate=0.10, seed=43)",
        "config": f"Config() + genomeSize={args.genome}",
        "gatekeeper_reads": int(rs.n_reads),
        "gatekeeper_bases": int(rs.total_bases),
        "cor_store_rows": int(len(st)),
        "cor_store_sha256": store_digest(st),
        "vote_seg": S,
        "segments_a_block": G,
        "n_templates": int(len(tids)),
        "n_jobs": int(len(jobs)),
        "n_blocks": len(blocks),
        "subset_rule": "every block",
        "blocks_covered": covered,
        "digest_of": "tests/torch_cases.py corrected_digest: sha256 over the sorted (name, "
                     "seq) records, each as 'name<TAB>seq<LF>'",
        "blocks": [{"index": bi, "templates": int(len(blocks[bi])),
                    "reads": len(per_block[bi]),
                    "bases": int(sum(len(s) for _, s in per_block[bi])),
                    "sha256": corrected_digest(per_block[bi])} for bi in covered],
        "cpu_seconds": secs,
    }
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    print(json.dumps(ref, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
