"""Make canu_tpu_torch/dag_reference.json: the JAX package's tag-chain (dag)
consensus on chip_smoke.py's dag phase, for phase 12 to hold the port
against.

    JAX_PLATFORMS=cpu python scripts/torch_dag_reference.py --part correction
    JAX_PLATFORMS=cpu python scripts/torch_dag_reference.py --part polish

Runs canu_tpu on the CPU and writes the part's entry into the file, keeping
the other:
  correction  canu_tpu's correction_phase with corConsensus=dag from a FASTA
              of the bench raw reads (scripts/torch_correction_reference.py's
              read set, Config() + genomeSize), on the blocks that
              correction_reference.json covers (every third block and the
              last); the other blocks get an empty block file first, so the
              phase's resume skips them.  Each block's reads are digested
              with tests/torch_cases.py corrected_digest.
  polish      canu_tpu's run_pipeline from the corrected reads of
              chip_smoke.py's 11a (tests/torch_cases.py ASSEMBLY_RUNS["a"],
              write_assembly_reads) with Config() + genomeSize and
              cnsConsensus=dag; the gates are tests/torch_cases.py
              assembly_digests of the run's directory.  The stages before
              the consensus do not read cnsConsensus, so this equals a
              resume of 11a's finished directory under cnsConsensus=dag,
              which is what phase 12b runs.
Each part records its command line, wall and CPU seconds and the host's
core count.
"""

from __future__ import annotations

import argparse
import gzip
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def cpu_seconds() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return round(ru.ru_utime + ru.ru_stime, 1)


def correction_part(genome: int) -> dict:
    from canu_tpu.config import Config
    from canu_tpu.io.fastx import write_fasta
    from canu_tpu.ops import falcon as F
    from canu_tpu.ops import votepile as VP
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import make_ctx
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from torch_cases import corrected_digest, fasta_records

    work = tempfile.mkdtemp(prefix="dag_ref_cor_")
    t0 = time.time()
    g = random_genome(genome, seed=42)
    raw, _ = simulate_reads(g, coverage=12, mean_len=3500, min_len=1500, max_len=7800,
                            error_rate=0.10, seed=43)
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    cfg = Config()
    cfg.set("genomeSize", genome)
    cfg.set("corConsensus", "dag")
    ctx = make_ctx(work, "bench", cfg)
    rs = stages.gatekeeper(ctx, "cor", [fasta])
    fk = stages.meryl(ctx, "cor", rs)
    st = stages.overlap(ctx, "cor", rs, fk)
    t_stages = time.time() - t0

    # the blocks correction_phase makes (as scripts/torch_correction_reference.py)
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
    n = len(blocks)
    subset = sorted(set(range(0, n, 3)) | {n - 1})
    bdir = os.path.join(work, "correction", "blocks")
    os.makedirs(bdir, exist_ok=True)
    for bi in range(n):
        if bi not in subset:
            with gzip.open(os.path.join(bdir, f"block_{bi:05d}.fasta.gz"), "wt"):
                pass
    t = time.time()
    stages.correction_phase(ctx, [fasta])
    t_cor = time.time() - t
    per_block: dict[int, list] = {bi: [] for bi in subset}
    for name, seq in fasta_records(os.path.join(work, "correction",
                                                "bench.correctedReads.fasta.gz")):
        per_block[block_of[name.rsplit("_corr", 1)[0]]].append((name, seq))
    shutil.rmtree(work)
    return {
        "what": "canu_tpu (JAX, CPU) correction_phase with corConsensus=dag from a FASTA of "
                "the bench read set: the corrected reads of a subset of its template blocks",
        "read_set": f"random_genome({genome}, seed=42); simulate_reads(coverage=12, "
                    "mean_len=3500, min_len=1500, max_len=7800, error_rate=0.10, seed=43)",
        "config": f"Config() + genomeSize={genome} + corConsensus=dag",
        "n_templates": int(len(tids)),
        "n_blocks": n,
        "blocks_covered": subset,
        "digest_of": "tests/torch_cases.py corrected_digest",
        "blocks": [{"index": bi, "reads": len(per_block[bi]),
                    "bases": int(sum(len(s) for _, s in per_block[bi])),
                    "sha256": corrected_digest(per_block[bi])} for bi in subset],
        "wall_seconds": {"stages": round(t_stages, 1), "correction": round(t_cor, 1)},
    }


def polish_part() -> dict:
    from canu_tpu.config import Config
    from canu_tpu.pipeline.driver import run_pipeline
    from torch_cases import ASSEMBLY_RUNS, assembly_digests, write_assembly_reads

    genome, seed, repeats = ASSEMBLY_RUNS["a"]
    work = tempfile.mkdtemp(prefix="dag_ref_polish_")
    fasta = os.path.join(work, "reads.fasta")
    _codes, n_reads, n_bases, fasta_sha = write_assembly_reads(fasta, genome, seed, repeats)
    cfg = Config()
    cfg.set("genomeSize", genome)
    cfg.set("cnsConsensus", "dag")
    t = time.time()
    run_pipeline(os.path.join(work, "asm"), "asm", cfg, corrected_reads=[fasta])
    wall = time.time() - t
    d = os.path.join(work, "asm")
    with open(os.path.join(d, "asm.stage-times.jsonl")) as fh:
        walls = [json.loads(ln) for ln in fh]
    out = {
        "what": "canu_tpu (JAX, CPU) run_pipeline from the corrected reads of chip_smoke.py's "
                "11a with cnsConsensus=dag",
        "read_set": f"tests/torch_cases.py write_assembly_reads(genome={genome}, "
                    f"genome_seed={seed}, repeats={repeats})",
        "config": f"Config() + genomeSize={genome} + cnsConsensus=dag",
        "input_reads": n_reads,
        "input_bases": n_bases,
        "input_fasta_sha256": fasta_sha,
        "digest_of": "tests/torch_cases.py assembly_digests",
        "gates": assembly_digests(d, "asm"),
        "stage_walls": walls,
        "wall_seconds": round(wall, 1),
    }
    shutil.rmtree(work)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--part", choices=("correction", "polish"), required=True)
    ap.add_argument("--genome", type=int, default=300_000,
                    help="the correction part's genome (a smaller one for a rehearsal)")
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch", "dag_reference.json"))
    args = ap.parse_args()
    t = time.time()
    ref = correction_part(args.genome) if args.part == "correction" else polish_part()
    ref["made_by"] = (f"JAX_PLATFORMS=cpu python scripts/torch_dag_reference.py --part "
                      f"{args.part}" + (f" --genome {args.genome}"
                                        if args.part == "correction" and args.genome != 300_000
                                        else ""))
    ref["process_wall_seconds"] = round(time.time() - t, 1)
    ref["cpu_seconds"] = cpu_seconds()
    ref["host_cores"] = os.cpu_count()
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            out = json.load(fh)
    out[args.part] = ref
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(json.dumps(ref, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
