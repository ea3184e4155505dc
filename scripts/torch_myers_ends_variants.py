"""Kernels K10, K1 with K11's end pick, and K7's centre store of this tree
against an earlier tree's csrc/myers_tile.cu and csrc/verify.cu, on one
card, in one call.

    python3 scripts/torch_myers_ends_variants.py --earlier TREE

TREE is the root of an earlier checkout (``git archive <rev> | tar -x -C
TREE``); its two sources and this tree's are built by ops/kernels/_nvcc.py
(the compiler's register and spill report of each kernel is printed) and
loaded with ctypes.  The earlier tree holds the design before K10's and
K11's redesign, whose interface the script binds: K10 reads the centres
as rows, one warp an extension, with a device scratch; K1 writes the 43
carry planes and K11 picks the end from them in a launch of its own; K7
stores the centres as rows.  On inputs made from a seed at the
shapes the main path gives the kernels:

  * the verify group, 16,384 extensions x 8,192 rows (the centres on a
    16-row grid drifting at ~0.9 a row, as an overlap's anchor chain
    does): K10 of both trees on the rows, this tree's on the grid; K1 of
    both trees, then the earlier K11, against this tree's K1 with the pick;
  * the judge's launch, 3 extensions x 3,430,380 rows: K10 as above (this
    tree's split over clusters of blocks);
  * K7 on a group of 8,192 true overlapping pairs (16 chunks of 512) of
    bench.py's read set: the earlier tree's rows, this tree's rows and grid.

Every pair of kernels that computes the same thing is checked equal first.
Each is timed by CUDA events over --reps launches, in the order earlier,
this, this, earlier where two trees compete, and by torch.profiler's kernel
times (CUPTI) over 5 launches: the device time of the kernel alone, for
launches shorter than their host call.  Prints the card's name and power
limit beside every number and one JSON line at the end, also written to
myers_ends_variants.json in chip_smoke.py's output directory.  Imports
nothing of jax or canu_tpu.
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
K7_PAIRS, K7_CHUNK = 8_192, 512
BENCH_GENOME = 300_000  # bench.py's genome, as chip_smoke.py's phases 4-8 simulate it


def bind(lib, earlier: bool):
    """Set the argument types of the library's entry points: the earlier
    tree's ABI (K10 with a scratch, K1 with planes out only, K7 without the
    grid flag) or this tree's."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if earlier:
        lib.canu_myers_prologue.argtypes = [p, ll, i, p, ll, i, p, p, i, i, i, p, p, p, p]
        lib.canu_myers_rows.argtypes = [p, p, p, i, p, p, i, i, p, p, i, i, i, p]
    else:
        lib.canu_myers_prologue.argtypes = [p, ll, i, i, i, p, ll, i, p, p, i, i, i, i, p, p, p]
        lib.canu_myers_rows.argtypes = [p, p, p, p, i, p, p, i, i, p, p, i, i, i, p]
    lib.canu_myers_epilogue.argtypes = [p, p, p, i, p, p]
    for f in (lib.canu_myers_prologue, lib.canu_myers_rows, lib.canu_myers_epilogue):
        f.restype = ctypes.c_int


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} returned {rc}")


def events_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs by CUDA events, after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def profiler_ms(fn, n: int = 5) -> dict:
    """{kernel name: mean device milliseconds a launch} of n runs of fn()
    by torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.count:
            out[ev.key] = t / 1e3 / ev.count
    return out


def kernel_ms(prof: dict, part: str) -> float | None:
    """The profiler's time of the kernel whose name holds `part`."""
    hits = [ms for name, ms in prof.items() if part in name]
    return sum(hits) if hits else None


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--earlier", required=True, help="root of an earlier checkout")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    import torch

    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import _nvcc
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.ops.kernels import verify_cuda as VC

    if not torch.cuda.is_available():
        print("torch_myers_ends_variants: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    earlier = Path(args.earlier).resolve() / "canu_tpu_torch" / "csrc"
    built = _nvcc.build(K1.SOURCE, earlier / "myers_tile.cu", VC.SOURCE, earlier / "verify.cu")
    names = ("this myers_tile.cu", "earlier myers_tile.cu", "this verify.cu",
             "earlier verify.cu")
    out: dict = {"card": card, "ptxas": {}}
    for name, (_path, _s, log) in zip(names, built):
        lines = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln
                 or "Compiling entry" in ln]
        out["ptxas"][name] = lines
        print(f"{name}:\n  " + "\n  ".join(lines), flush=True)
    libs = {"this": ctypes.CDLL(str(built[0][0])), "earlier": ctypes.CDLL(str(built[1][0]))}
    bind(libs["this"], False)
    bind(libs["earlier"], True)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(7)

    for shape, (B, n_rows) in SHAPES.items():
        ns = n_rows // 16 + 1
        steps = (torch.rand((B, ns), generator=g, device=dev) < 0.9).to(torch.int32) * 16
        grid = (torch.cumsum(steps, dim=1, dtype=torch.int32) + 64).contiguous()
        rows = MY.expand_centers(grid, n_rows).contiguous()
        LB = n_rows + 256
        b = torch.randint(0, 4, (B, LB), generator=g, device=dev, dtype=torch.uint8)
        a_len = torch.full((B,), n_rows - 264, dtype=torch.int32, device=dev)
        b_len = torch.full((B,), n_rows + 128, dtype=torch.int32, device=dev)
        n_run = n_rows
        nw = -(-n_run // 32)
        outs = {v: (torch.empty((K1.NC, B), dtype=torch.int32, device=dev),
                    torch.empty((nw, B), dtype=torch.int32, device=dev))
                for v in ("earlier", "this rows", "this grid")}
        scratch = torch.empty((B, -(-(n_rows + 1) // 128), 2), dtype=torch.int32, device=dev)
        nb = K1.prologue_blocks(B, n_rows, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)

        def k10(v):
            planes, s_bits = outs[v]
            if v == "earlier":
                rc = libs["earlier"].canu_myers_prologue(
                    rows.data_ptr(), rows.stride(0), rows.shape[1], b.data_ptr(), b.stride(0),
                    LB, a_len.data_ptr(), b_len.data_ptr(), B, n_rows, n_run, s_bits.data_ptr(),
                    planes.data_ptr(), scratch.data_ptr(), stream)
            else:
                c, stride = (grid, 16) if v == "this grid" else (rows, 1)
                rc = libs["this"].canu_myers_prologue(
                    c.data_ptr(), c.stride(0), c.shape[1], n_rows + 1, stride, b.data_ptr(),
                    b.stride(0), LB, a_len.data_ptr(), b_len.data_ptr(), B, n_rows, n_run, nb,
                    s_bits.data_ptr(), planes.data_ptr(), stream)
            check(rc, f"K10 ({v})")

        for v in outs:
            k10(v)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for v in ("this rows", "this grid")
                   for x, y in zip(outs[v], outs["earlier"]))
        res = {"B": B, "n_rows": n_rows, "blocks_an_extension": nb, "k10_outputs_equal": same}
        for v in ("earlier", "this rows", "this grid", "this grid", "this rows", "earlier"):
            res.setdefault(f"k10 {v} ms", []).append(events_ms(lambda: k10(v), args.reps))
        for v in outs:
            res[f"k10 {v} profiler ms"] = kernel_ms(profiler_ms(lambda: k10(v)), "prologue")
        print(f"{card}: K10 on the {shape} ({B} x {n_rows} rows, this tree's split {nb} blocks "
              f"an extension): " + "; ".join(
                  f"{v} {res[f'k10 {v} ms']} ms by events, {res[f'k10 {v} profiler ms']} by the "
                  f"profiler" for v in outs) + f"; outputs equal: {same}", flush=True)

        if shape == "verify group":
            # K1 + K11 (earlier) against K1 with the pick (this), from the same planes
            planes, s_bits = outs["this grid"]
            a = torch.randint(0, 4, (B, n_rows), generator=g, device=dev, dtype=torch.uint8)
            b16 = torch.nn.functional.pad(b, (0, (-LB) % 16))
            fin = {v: torch.empty((K1.NC, B), dtype=torch.int32, device=dev)
                   for v in ("earlier", "this")}
            picks = {v: torch.empty((6, B), dtype=torch.int32, device=dev)
                     for v in ("earlier", "this", "this K11")}

            def k1(v, pick=False):
                lib = libs["earlier" if v == "earlier" else "this"]
                head = ((planes.data_ptr(), fin[v].data_ptr()) if v == "earlier" else
                        (planes.data_ptr(), None if pick else fin[v].data_ptr(),
                         picks["this"].data_ptr() if pick else None))
                check(lib.canu_myers_rows(*head, a.data_ptr(), a.shape[1], s_bits.data_ptr(),
                                          b16.data_ptr(), b16.shape[1], LB, a_len.data_ptr(),
                                          b_len.data_ptr(), B, n_run, 2400, stream),
                      f"K1 ({v})")

            def k11(v):
                dst = picks["earlier" if v == "earlier" else "this K11"]
                check(libs[v].canu_myers_epilogue(fin[v].data_ptr(), a_len.data_ptr(),
                                                  b_len.data_ptr(), B, dst.data_ptr(), stream),
                      f"K11 ({v})")

            k1("earlier"), k11("earlier"), k1("this"), k11("this"), k1("this", True)
            torch.cuda.synchronize()
            res["k1_pick_equal"] = (torch.equal(fin["earlier"], fin["this"])
                                    and torch.equal(picks["earlier"], picks["this"])
                                    and torch.equal(picks["earlier"], picks["this K11"]))
            for v in ("earlier", "this", "this", "earlier"):
                res.setdefault(f"k1 {v} planes ms", []).append(events_ms(lambda: k1(v), args.reps))
                if v == "earlier":
                    res.setdefault("k1 + k11 earlier ms", []).append(
                        events_ms(lambda: (k1("earlier"), k11("earlier")), args.reps))
                else:
                    res.setdefault("k1 with the pick this ms", []).append(
                        events_ms(lambda: k1("this", True), args.reps))
            prof = profiler_ms(lambda: (k1("earlier"), k11("earlier"), k1("this", True)))
            res["profiler"] = prof
            res["k11 earlier profiler ms"] = kernel_ms(prof, "epilogue")
            res["k11 earlier events ms"] = events_ms(lambda: k11("earlier"), 100)
            # K11 by the wrapper on the main path's device: its events behind a K1 launch
            K1.myers_epilogue_cuda(fin["earlier"], a_len, b_len)  # the library loaded
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            k1("earlier")
            ev[1].record()
            K1.myers_epilogue_cuda(fin["earlier"], a_len, b_len)
            ev[2].record()
            torch.cuda.synchronize()
            res["k11 wrapper behind k1 events ms"] = ev[1].elapsed_time(ev[2])
            # and on an idle device: the events then hold the wrapper's host part too
            res["k11 wrapper idle events ms"] = events_ms(
                lambda: K1.myers_epilogue_cuda(fin["earlier"], a_len, b_len), args.reps)
            print(f"{card}: K1 at {B} x {n_run} rows: earlier (planes) "
                  f"{res['k1 earlier planes ms']} ms, this (planes) {res['k1 this planes ms']} ms; "
                  f"earlier K1 + K11 {res['k1 + k11 earlier ms']} ms against this K1 with the "
                  f"pick {res['k1 with the pick this ms']} ms; K11 alone "
                  f"{res['k11 earlier events ms']:.4f} ms "
                  f"by events, {res['k11 earlier profiler ms']} ms by the profiler; the wrapper's "
                  f"call behind K1 {res['k11 wrapper behind k1 events ms']:.4f} ms, on an idle "
                  f"device {res['k11 wrapper idle events ms']:.4f} ms; outputs equal: "
                  f"{res['k1_pick_equal']}", flush=True)
        out[shape] = res
        del outs, scratch

    # K7's centre store on a verify group of true overlapping pairs
    from canu_tpu_torch.ops.minimizers import get_read_index
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads, true_overlaps

    genome = random_genome(BENCH_GENOME, seed=42)
    rs, truth = simulate_reads(genome, coverage=12, mean_len=3500, min_len=1500, max_len=7800,
                               error_rate=0.10, seed=43)
    pairs = true_overlaps(truth)[:K7_PAIRS]
    index = get_read_index(rs, k=16, device=dev)
    n_rows = index.words.shape[1] * 16
    a_idx = torch.from_numpy(pairs[:, 0] - 1).to(dev)
    b_idx = torch.from_numpy(pairs[:, 1] - 1).to(dev)
    fl = torch.zeros(len(pairs), dtype=torch.bool, device=dev)
    n = len(pairs) // K7_CHUNK * K7_CHUNK
    a_idx, b_idx, fl = a_idx[:n], b_idx[:n], fl[:n]
    lib7 = ctypes.CDLL(str(built[3][0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib7.canu_verify_pre.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, i, i, i,
                                     p, p, p, p, p, p, p, p, p, p, p]
    lib7.canu_verify_pre.restype = ctypes.c_int
    i32 = dict(dtype=torch.int32, device=dev)
    eo = [torch.empty((2 * n, n_rows), dtype=torch.uint8, device=dev), torch.empty(2 * n, **i32),
          torch.empty((2 * n, n_rows + 128), dtype=torch.uint8, device=dev),
          torch.empty(2 * n, **i32), torch.empty((2 * n, n_rows + 1), **i32),
          torch.empty(n, **i32), torch.empty(n, dtype=torch.bool, device=dev),
          torch.empty(n, **i32), torch.empty(n, **i32), torch.empty(n, **i32)]

    def k7(v):
        if v == "earlier":
            W, Pm = index.words.shape[1], index.mker.shape[1]
            check(lib7.canu_verify_pre(
                index.words.data_ptr(), W, index.length.data_ptr(), index.mker.data_ptr(),
                index.mpos.data_ptr(), index.mstr.data_ptr(), Pm, a_idx.data_ptr(),
                b_idx.data_ptr(), fl.data_ptr(), n, K7_CHUNK, 16, 128, n_rows, 1,
                *(t.data_ptr() for t in eo), stream), "K7 (earlier)")
            return eo
        return VC.verify_pre(index, a_idx, b_idx, fl, 16, 128, n_rows, True, K7_CHUNK,
                             16 if v == "this grid" else 1)

    ref = [t.clone() for t in k7("earlier")]
    rows_out, grid_out = k7("this rows"), k7("this grid")
    torch.cuda.synchronize()
    flat = lambda o: (*o[0], *o[1:])  # noqa: E731
    same = all(torch.equal(x, y) for x, y in zip(ref, flat(rows_out)))
    gref = ref[4][:, ::16]
    same_grid = (torch.equal(flat(grid_out)[4], gref)
                 and all(torch.equal(x, y) for j, (x, y) in enumerate(zip(ref, flat(grid_out)))
                         if j != 4))
    res = {"pairs": n, "n_rows": n_rows, "rows_equal": same, "grid_equal": same_grid}
    for v in ("earlier", "this rows", "this grid", "this grid", "this rows", "earlier"):
        res.setdefault(f"k7 {v} ms", []).append(events_ms(lambda: k7(v), args.reps))
    for v in ("earlier", "this rows", "this grid"):
        res[f"k7 {v} profiler ms"] = kernel_ms(profiler_ms(lambda: k7(v)), "verify_pre")
    print(f"{card}: K7 on {n} pairs ({n // K7_CHUNK} chunks, {n_rows} rows): " + "; ".join(
        f"{v} {res[f'k7 {v} ms']} ms by events, {res[f'k7 {v} profiler ms']} by the profiler"
        for v in ("earlier", "this rows", "this grid"))
        + f"; rows equal {same}, grid equal {same_grid}", flush=True)
    out["K7 group"] = res
    ok = (all(out[s]["k10_outputs_equal"] for s in SHAPES) and out["verify group"]["k1_pick_equal"]
          and same and same_grid)
    from chip_smoke import OUT_DIR

    line = json.dumps(out, default=str)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "myers_ends_variants.json"), "w") as fh:
        fh.write(line)
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
