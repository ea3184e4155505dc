"""Phase 10 of chip_smoke.py (correction_phase from a FASTA of the bench
reads) on one card from two checkouts in turns, for an end-to-end
comparison of two versions within one call.

    python3 scripts/torch_correct_ab.py OTHER_ROOT [--pairs 3]

OTHER_ROOT is another checkout of the repository inside this one, in a
directory .gitignore lists (for example the parent commit unpacked there
by `git archive`); any other path is refused, since each run writes into
its checkout's chiprun_out/ and builds into its canu_tpu_torch/_build/.
Runs
chip_smoke.correct_drive in a fresh process per run, each checkout
building its own kernels, in the order other, this, this, other, other,
this, ... (--pairs pairs), each run holding every gate of phase 10.
Prints the card's name and power limit, each run's correction_phase wall,
stage walls and correction parts, then one JSON line of them all.
Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))

RUN = """
import json, os, sys, subprocess
sys.modules["jax"] = None
sys.modules["canu_tpu"] = None
sys.path.insert(0, {root!r})
import torch
import chip_smoke as CS
from canu_tpu_torch.ops.kernels import _nvcc
from canu_tpu_torch.ops.kernels import extend_cuda as EX
from canu_tpu_torch.ops.kernels import myers_cuda as K1
from canu_tpu_torch.ops.kernels import trace_cuda as K4
_nvcc.build(K1.SOURCE, EX.SOURCE, K4.SOURCE)
os.makedirs(CS.OUT_DIR, exist_ok=True)
card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                      capture_output=True, text=True).stdout.strip()
r = CS.correct_drive(torch.device("cuda:0"), card)
print("RESULT " + json.dumps({{k: r[k] for k in ("run_s", "stage_walls_s", "parts_s")}}), flush=True)
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other")
    ap.add_argument("--pairs", type=int, default=3)
    opts = ap.parse_args()
    other = os.path.realpath(opts.other)
    if os.path.commonpath([other, ROOT]) != ROOT or other == ROOT:
        print(f"{other} is not a checkout inside {ROOT}", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    order = []
    for p in range(opts.pairs):
        order += [("other", other), ("this", ROOT)] if p % 2 == 0 else [("this", ROOT),
                                                                        ("other", other)]
    runs = []
    for name, root in order:
        proc = subprocess.run([sys.executable, "-c", RUN.format(root=root)], cwd=root,
                              capture_output=True, text=True)
        res = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not res:
            print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
            print(f"{name} run failed (rc {proc.returncode})", flush=True)
            return 1
        r = json.loads(res[-1][len("RESULT "):])
        runs.append({"checkout": name, **r})
        print(f"{name}: correction_phase {r['run_s']:.3f} s; stage walls {r['stage_walls_s']}; "
              "parts " + ", ".join(f"{k} {v:.3f}" for k, v in r["parts_s"].items()), flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
