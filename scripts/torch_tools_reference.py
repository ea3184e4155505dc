"""Make canu_tpu_torch/tools_reference.json: the JAX package's tools CLI on
chip_smoke.py's scripted tools session, for phase 13 to hold the port's
``python -m canu_tpu_torch.tools`` against.

    JAX_PLATFORMS=cpu python scripts/torch_tools_reference.py [--genome 100000]

Runs canu_tpu.tools.__main__.main in this process on the CPU, step by step,
in a temporary directory (tests/torch_cases.py tools_session; its setup
step, tools_setup, makes the read store with canu_tpu's ReadSet, a PAF file
and the judged contigs by numpy from fixed seeds).  Each step's record is
tests/torch_cases.py tools_record: its exit code, the sha256 of its stdout
and stderr (the directory written <work>) and of each file it made
(file_digest).  The steps of TOOLS_DB22_STEPS read the k=22 DB that
kmer-count saved; canu_tpu's KmerCounts.load casts its exact uint64 k-mers
to uint32 and keeps about 0.1% of them, so these steps run with a load
that keeps the saved dtype: their reference is canu_tpu's result on the
DB it counted.  The file also holds each step's wall seconds, the
process's CPU seconds and the command line.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome", type=int, default=100_000)
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "tools_reference.json"))
    args = ap.parse_args()

    from canu_tpu.ops import kmer as K
    from canu_tpu.stores.readset import ReadSet
    from canu_tpu.tools.__main__ import main as tools_main
    from torch_cases import TOOLS_DB22_STEPS, db22_loaded_as_saved, run_tools_session

    work = tempfile.mkdtemp(prefix="tools_ref_")
    steps, secs, outs = run_tools_session(work, args.genome, tools_main, ReadSet,
                                          db22_loaded_as_saved(K))
    for name, rec in steps.items():
        print(f"{name}: rc {rec['rc']}, {secs[name]:.1f} s; {outs[name][:300]!r}", flush=True)
    ru = resource.getrusage(resource.RUSAGE_SELF)
    ref = {
        "what": "canu_tpu (JAX, CPU) tools CLI on the scripted session of "
                "tests/torch_cases.py tools_session, for chip_smoke.py's tools phase",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_tools_reference.py"
                   + (f" --genome {args.genome}" if args.genome != 100_000 else ""),
        "genome": args.genome,
        "db22_steps": list(TOOLS_DB22_STEPS),
        "db22_note": "run with KmerCounts.load keeping the saved uint64 k-mers (canu_tpu's "
                     "load casts them to uint32)",
        "record_of": "tests/torch_cases.py tools_record: exit code, sha256 of stdout and stderr "
                     "with the work directory written <work>, file_digest of each file made",
        "steps": steps,
        "step_seconds": {k: round(v, 1) for k, v in secs.items()},
        "cpu_seconds": round(ru.ru_utime + ru.ru_stime, 1),
        "host_cores": os.cpu_count(),
    }
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    shutil.rmtree(work)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
