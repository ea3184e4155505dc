"""Phase 14 of chip_smoke.py alone, one rank a card over NCCL where the
machine has several cards.

    python3 scripts/torch_grid_check.py

Builds the kernels, writes the bench read set's FASTA (chip_smoke.py
bench_reads) and runs chip_smoke.grid_drive: 14a's world of one, then
correction_phase across the ranks with every gate of 14b (the cor store
under both exchanges, the candidates, blocks 0, 3, 6, 8 against the
references, K1 on every rank, the INF-walled sharded verify against the
world of one's).  grid_drive runs one rank a card over NCCL on a
machine of several cards, and two ranks over gloo on one card (NCCL
cannot take two ranks on one card).  Prints the cards' names and power
limits, then one JSON line of what it measured; exits non-zero on any
failed gate.  Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None
sys.modules["canu_tpu"] = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as CS
    from canu_tpu_torch.io.fastx import write_fasta
    from canu_tpu_torch.ops.kernels import _nvcc
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        print("torch_grid_check: needs an NVIDIA GPU, found none", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = "; ".join(sorted(set(smi.stdout.strip().splitlines())))
    CS.log(f"[grid check] {cards} x {torch.cuda.get_device_name(0)}; torch {torch.__version__}")
    CS.log(card)
    t = time.time()
    _nvcc.build(K1.SOURCE, EX.SOURCE)
    CS.log(f"[grid check] kernels built in {time.time() - t:.1f} s")
    raw = CS.bench_reads()
    work = tempfile.mkdtemp(prefix="grid_check_")
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    rec = CS.grid_drive(torch.device("cuda:0"), card, {"fasta": fasta, "run_s": float("nan")})
    print(json.dumps({"cards": cards, "ranks": rec["n"], "backend": rec["backend"], "card": card,
                      "phase_s": rec["phase_s"],
                      "ranks_wall_s": rec["b_wall_s"],
                      "correction_phase_s": [x["correction_phase_s"] for x in rec["b"]],
                      "dp_s": [x["dp_s"] for x in rec["b"]],
                      "collectives": [x["collectives"] for x in rec["b"]],
                      "peak_bytes": [x["peak_bytes"] for x in rec["b"]],
                      "cards_memory_peak_mb": max(rec["card_memory_mb"], default=None),
                      "k1_launches": rec["k1_launches"], "k2_launches": rec["k2_launches"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
