"""Verify's wall split on one card: the profile of every verify_overlaps
call of chip_smoke.py's phase 5 bench passes (one cold, WARM_PASSES warm),
phase 9 and phase 15.

    python3 scripts/torch_verify_split.py [--tree DIR] [--out FILE]

--tree is the root of the checkout whose canu_tpu_torch and chip_smoke.py
run (default: this one), so that a copy of an earlier tree can be measured
with this script: ops.align.LAST_PROFILE's pre_s (the anchor-and-inputs
step; host clock, so on the card K7's launch), pre_device_s (K7's device
seconds by CUDA events, where the tree has them), extend_s (the
extension), post_s, index_s (the read index build), device_wait_s,
consume_s and dispatch_s of each call, with its wall after a synchronize.
The tree's chip_smoke.py gates hold as in a run of it: a gate that fails
ends the measurement with its message and no split.  Prints the card's
name and power limit and writes the calls as JSON to --out (default:
verify_split.json in the output directory of the tree's chip_smoke.py).
Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None
sys.modules["canu_tpu"] = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    out = os.path.abspath(args.out) if args.out else None
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke as CS

    out = out or os.path.join(CS.OUT_DIR, "verify_split.json")
    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops.kernels import _nvcc
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    if not torch.cuda.is_available():
        print("torch_verify_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kernels = [m for m in os.listdir(os.path.join(tree, "canu_tpu_torch", "csrc"))
               if m.endswith(".cu")]
    _nvcc.build(*(_nvcc.CSRC / m for m in sorted(kernels)))

    calls: list = []
    tag = {"now": ""}
    real = AL.verify_overlaps

    def metered(*a, **kw):
        t = time.time()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        calls.append({"tag": tag["now"], "wall_s": round(time.time() - t, 3), **AL.LAST_PROFILE})
        return out

    AL.verify_overlaps = metered
    tag["now"] = "5 bench pass"
    rs = CS.bench_reads()
    cfg = Config()
    cfg.set("genomeSize", "300k")
    ctx = make_ctx(tempfile.mkdtemp(prefix="verify_split_"), "bench", cfg)
    fk = stages.meryl(ctx, "cor", rs, device=dev)
    for rep in range(1 + CS.WARM_PASSES):
        walls: dict = {}
        CS.run_pass(rs, fk, dev, CS.timed(walls))
        print(f"[5] pass {rep} ({'cold' if rep == 0 else 'warm'}): {calls[-1]}", flush=True)
    tag["now"] = "9 ecoli"
    CS.ecoli_drive(dev, card)
    print(f"[9] {calls[-1]}", flush=True)
    tag["now"] = "15 ecolicor"
    CS.ecolicor_drive(dev, card)
    print(f"[15] {[c for c in calls if c['tag'] == tag['now']]}", flush=True)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump({"card": card, "tree": tree, "verify_calls": calls}, fh, indent=1)
    print(json.dumps({"card": card, "verify_calls": calls}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
