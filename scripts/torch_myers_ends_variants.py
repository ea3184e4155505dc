"""Kernel K10 (the Myers band schedule and row-0 state) of this tree
against an earlier myers_tile.cu, on one card, in one call.

    python3 scripts/torch_myers_ends_variants.py --earlier PATH/myers_tile.cu

Both sources are built by ops/kernels/_nvcc.py and loaded with ctypes; each
canu_myers_prologue runs on the same inputs made from a seed, at the
shapes the main path gives it: a verify group of 16,384 extensions x
8,192 rows (the centres drifting at ~0.9 a row, as an overlap's anchor
chain does) and the judge's launch of 3 extensions x 3,430,380 rows.  An
earlier design may size its scratch differently, so each gets a scratch
of 8 bytes a 32 rows, the most either needs.  Prints, beside the card's
name and power limit, each source's mean milliseconds over 10 launches by
CUDA events, after checking that the two write the same shift bits and
planes.  Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.modules["jax"] = None
sys.modules["canu_tpu"] = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = {"verify group": (16_384, 8_192), "judge": (3, 3_430_380)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", required=True, help="an earlier csrc/myers_tile.cu")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    from canu_tpu_torch.ops.kernels import _nvcc
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    if not torch.cuda.is_available():
        print("torch_myers_ends_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = {}
    for name, (path, _s, _log) in zip(("this", "earlier"),
                                       _nvcc.build(K1.SOURCE, Path(args.earlier).resolve())):
        lib = ctypes.CDLL(str(path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.canu_myers_prologue.argtypes = [p, ll, i, p, ll, i, p, p, i, i, i, p, p, p, p]
        lib.canu_myers_prologue.restype = ctypes.c_int
        libs[name] = lib
    g = torch.Generator(device=dev).manual_seed(7)
    out: dict = {"card": card}
    for shape, (B, n_rows) in SHAPES.items():
        steps = (torch.rand((B, n_rows + 1), generator=g, device=dev) < 0.9).to(torch.int32)
        centers = torch.cumsum(steps, dim=1, dtype=torch.int32) + 64
        b = torch.randint(0, 4, (B, n_rows + 256), generator=g, device=dev, dtype=torch.uint8)
        a_len = torch.full((B,), n_rows, dtype=torch.int32, device=dev)
        b_len = torch.full((B,), n_rows + 128, dtype=torch.int32, device=dev)
        res = {}
        for name, lib in libs.items():
            planes = torch.empty((K1.NC, B), dtype=torch.int32, device=dev)
            s_bits = torch.empty((-(-n_rows // 32), B), dtype=torch.int32, device=dev)
            scratch = torch.empty((B, -(-(n_rows + 1) // 32), 2), dtype=torch.int32, device=dev)

            def launch():
                rc = lib.canu_myers_prologue(
                    centers.data_ptr(), centers.stride(0), centers.shape[1], b.data_ptr(),
                    b.stride(0), b.shape[1], a_len.data_ptr(), b_len.data_ptr(), B, n_rows,
                    n_rows, s_bits.data_ptr(), planes.data_ptr(), scratch.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: canu_myers_prologue returned {rc}")

            launch()
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(args.reps):
                launch()
            e1.record()
            torch.cuda.synchronize()
            res[name] = {"ms": e0.elapsed_time(e1) / args.reps,
                         "out": (planes.clone(), s_bits.clone())}
        same = all(torch.equal(x, y) for x, y in zip(res["this"]["out"], res["earlier"]["out"]))
        out[shape] = {"B": B, "n_rows": n_rows, "same": same,
                      **{f"{n}_ms": r["ms"] for n, r in res.items()}}
        print(f"{card}: K10 on the {shape} ({B} x {n_rows} rows): this {res['this']['ms']:.4f} "
              f"ms, earlier {res['earlier']['ms']:.4f} ms; outputs equal: {same}", flush=True)
    print(json.dumps(out))
    return 0 if all(out[s]["same"] for s in SHAPES) else 1


if __name__ == "__main__":
    sys.exit(main())
