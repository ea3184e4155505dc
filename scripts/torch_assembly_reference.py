"""Make canu_tpu_torch/assembly_reference.json: the JAX package's trimming +
assembly of chip_smoke.py's "assemble" read sets, for phase 11 to hold the
port against.

    JAX_PLATFORMS=cpu python scripts/torch_assembly_reference.py --run a
    JAX_PLATFORMS=cpu python scripts/torch_assembly_reference.py --run b

Runs canu_tpu on the CPU (the JAX package is the reference) and writes the
run's entry ("a" or "b") into the file, keeping the other:
  reads      run a (11a): random_genome(100 kb, seed=71, repeat_spec=
             [(9000, 3)]); run b (11b): the bench genome,
             random_genome(300 kb, seed=42); each with simulate_reads(
             coverage=12, mean_len=3500, min_len=1500, max_len=7800,
             error_rate=0.015, seed=72), written as corrected reads to a
             FASTA file by tests/torch_cases.py write_assembly_reads
             (canu_tpu_torch's simulator; the call chip_smoke.py makes);
  pipeline   canu_tpu's run_pipeline(corrected_reads=[fasta]) with
             Config() + genomeSize: trimming (obt gatekeeper, meryl,
             overlap, trimming), then assembly (utg gatekeeper, meryl,
             overlap, oea, unitig, consensus, outputs).
Each gate is tests/torch_cases.py assembly_digests of the run's directory
(a sha256 of sorted records) with RED's corrections, captured from
canu_tpu.ops.oea.detect_read_errors.  The entry also holds the stage walls
(stage-times.jsonl), the process's CPU seconds and the host's core count,
and the largest contig's length, identity to the simulated genome and
misjoins (tests/torch_cases.py largest_contig_identity, measured with
canu_tpu_torch's banded_extend on the CPU), which chip_smoke.py holds the
port's contig to: run a took 26-27 minutes on 8 cores, run b 50-59.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--run", choices=("a", "b"), default="a")
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "assembly_reference.json"))
    args = ap.parse_args()

    import torch

    from canu_tpu.config import Config
    from canu_tpu.ops import oea
    from canu_tpu.pipeline.driver import run_pipeline
    from torch_cases import (ASSEMBLY_ERROR_RATE, ASSEMBLY_READ_SEED, ASSEMBLY_RUNS,
                             assembly_digests, largest_contig_identity,
                             write_assembly_reads)

    genome, seed, repeats = ASSEMBLY_RUNS[args.run]
    work = tempfile.mkdtemp(prefix="assembly_ref_")
    fasta = os.path.join(work, "reads.fasta")
    codes, n_reads, n_bases, fasta_sha = write_assembly_reads(fasta, genome, seed, repeats)
    cfg = Config()
    cfg.set("genomeSize", genome)

    captured: dict = {}
    red = oea.detect_read_errors

    def capture(*a, **k):
        captured["corr"] = red(*a, **k)
        return captured["corr"]

    oea.detect_read_errors = capture
    t0 = time.time()
    run_pipeline(os.path.join(work, "asm"), "asm", cfg, corrected_reads=[fasta])
    wall = time.time() - t0
    oea.detect_read_errors = red

    d = os.path.join(work, "asm")
    walls = []
    with open(os.path.join(d, "asm.stage-times.jsonl")) as fh:
        for line in fh:
            walls.append(json.loads(line))
    ru = resource.getrusage(resource.RUSAGE_SELF)
    ref = {
        "what": f"canu_tpu (JAX, CPU) run_pipeline from corrected reads (trimming + assembly), "
                f"for chip_smoke.py's assemble phase (11{args.run})",
        "made_by": f"JAX_PLATFORMS=cpu python scripts/torch_assembly_reference.py --run {args.run}",
        "read_set": f"random_genome({genome}, seed={seed}, repeat_spec={repeats}); "
                    f"simulate_reads(coverage=12, mean_len=3500, min_len=1500, max_len=7800, "
                    f"error_rate={ASSEMBLY_ERROR_RATE}, seed={ASSEMBLY_READ_SEED})",
        "genome": genome,
        "config": f"Config() + genomeSize={genome}",
        "prefix": "asm",
        "input_reads": n_reads,
        "input_bases": n_bases,
        "input_fasta_sha256": fasta_sha,
        "digest_of": "tests/torch_cases.py assembly_digests: sha256 over each output's sorted "
                     "records, each as its fields joined by TAB and ended by LF",
        "gates": assembly_digests(d, "asm", captured.get("corr")),
        "red_changed_reads": len(captured.get("corr") or {}),
        "largest_contig": largest_contig_identity(d, "asm", codes, torch.device("cpu")),
        "stage_walls": walls,
        "wall_seconds": round(wall, 1),
        "cpu_seconds": round(ru.ru_utime + ru.ru_stime, 1),
        "host_cores": os.cpu_count(),
    }
    out = {}
    if os.path.exists(args.out):
        with open(args.out) as fh:
            out = json.load(fh)
    out[args.run] = ref
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(json.dumps(ref, indent=1), flush=True)
    shutil.rmtree(work)
    return 0


if __name__ == "__main__":
    sys.exit(main())
