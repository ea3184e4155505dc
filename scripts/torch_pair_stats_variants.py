"""K12, stage C's pair statistics, at a few launch plans on one card:
chip_smoke.py's phase 4d, then a sweep of the plan.

    python3 scripts/torch_pair_stats_variants.py [--reps N] [--earlier FILE]

Builds the kernels, counts phase 4's frequent table (the cor meryl on
chip_smoke.py's bench read set), runs chip_smoke.placed_drive (phase 4d,
every gate: one K12 launch a place_candidates call, the placed candidates
and verified rows against placed_overlap_reference.json, K12 bit for bit
against the plain statistics on every chunk), then, for each plan of PLANS
(threads a block, table slots a block, hits kept in shared memory; the
first is verify_cuda's K12_* constants; a plan at other threads runs on a
copy of csrc/verify.cu built with -DK12_NT): what the card gives it (resident
blocks an SM, registers), and K12 on the first k 16 chunk through the
chunk entry and on each whole call at k 16 and k 22 (the kernel alone),
by CUDA events, mean of N, the plans in turn and then in reverse, each
held bit for bit to the constants' plan.  With --earlier, FILE is a
verify.cu whose canu_pair_stats takes a chunk with a device scratch (the
first design: git show c9a7e0f:canu_tpu_torch/csrc/verify.cu): it is
built too, held bit for bit to this K12 on every chunk of both calls, and
timed on the first chunk and on each call's chunks one launch each (the
sum), earlier, this, this, earlier.  Writes chiprun_out/k12/sweep.json.
Imports nothing of jax or canu_tpu.
"""
import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.modules["jax"] = None
sys.modules["canu_tpu"] = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from canu_tpu_torch.config import Config  # noqa: E402
from canu_tpu_torch.ops import minhash as MH  # noqa: E402
from canu_tpu_torch.ops.kernels import _nvcc  # noqa: E402
from canu_tpu_torch.ops.kernels import verify_cuda as VC  # noqa: E402
from canu_tpu_torch.ops.votepile import device_words  # noqa: E402
from canu_tpu_torch.pipeline import stages  # noqa: E402
from canu_tpu_torch.pipeline.driver import make_ctx  # noqa: E402

PLANS = ((VC.K12_THREADS, VC.K12_SLOTS, VC.K12_HITS), (256, 4096, 768), (512, 4096, 768),
         (512, 16384, 1024))


def earlier_k12(path: str, out_dir: str):
    """The earlier design's chunk call: fn(wordsA, lenA, wordsB, lenB, fk, k)
    -> int32[7, C], its scratch sized as that design's wrapper sized it (a
    table of pow2(4 P) slots and P hits a block, as many blocks as 1 GB
    holds)."""
    lib_path = os.path.join(out_dir, "libverify_earlier.so")
    subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", lib_path, path], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.canu_pair_stats.argtypes = [p, p, p, p, i, i, p, i, i, i, i, i, p, p, p, p, p, p]
    lib.canu_pair_stats.restype = i

    def fn(wA, lA, wB, lB, fk, k):
        C, W = wA.shape
        P = 16 * W - k + 1
        S = 1 << max(0, (4 * P - 1).bit_length())
        blocks = max(1, min(C, (1 << 30) // (12 * S + 8 * P)))
        keys = torch.empty((3, blocks, S), dtype=torch.int32, device=wA.device)
        hits = torch.empty((blocks, P, 2), dtype=torch.int32, device=wA.device)
        out = torch.empty((7, C), dtype=torch.int32, device=wA.device)
        rc = lib.canu_pair_stats(wA.data_ptr(), lA.data_ptr(), wB.data_ptr(), lB.data_ptr(), W, C,
                                 fk.data_ptr(), fk.shape[0], k, blocks, S, P, keys[0].data_ptr(),
                                 keys[1].data_ptr(), keys[2].data_ptr(), hits.data_ptr(),
                                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        CS.check(rc == 0, f"the earlier K12 refused its launch ({rc})")
        return out

    return fn


def plan_libraries(out_dir: str) -> dict:
    """threads -> verify_cuda's library built at that many threads a K12
    block (-DK12_NT; the K12_THREADS one is verify_cuda's own), the others
    built in parallel."""
    libs = {VC.K12_THREADS: VC._load()}
    procs = {}
    for nt in {plan[0] for plan in PLANS} - set(libs):
        path = os.path.join(out_dir, f"libverify_nt{nt}.so")
        procs[nt] = (path, subprocess.Popen([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, f"-DK12_NT={nt}",
                                             "-o", path, str(VC.SOURCE)],
                                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                            text=True))
    for nt, (path, proc) in procs.items():
        _, err = proc.communicate()
        CS.check(proc.returncode == 0, f"verify.cu at K12_NT {nt} failed to build: {err[-2000:]}")
        libs[nt] = VC.bind(path)
    return libs


@contextlib.contextmanager
def at_plan(plan, libs):
    """K12's library and K12_THREADS, K12_SLOTS and K12_HITS set to plan
    inside."""
    names = ("_lib", "K12_THREADS", "K12_SLOTS", "K12_HITS")
    old = [getattr(VC, n) for n in names]
    for n, v in zip(names, (libs[plan[0]], *plan)):
        setattr(VC, n, v)
    try:
        yield
    finally:
        for n, v in zip(names, old):
            setattr(VC, n, v)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--earlier", help="an earlier verify.cu with the chunk-and-scratch K12")
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_pair_stats_variants: needs a CUDA card", file=sys.stderr)
        return 1
    out_dir = os.path.join(ROOT, "chiprun_out", "k12")
    os.makedirs(out_dir, exist_ok=True)
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    from canu_tpu_torch.ops.kernels import minhash_cuda as MK
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    for src, (lib, secs, ptxas) in zip((K1.SOURCE, MK.SOURCE, VC.SOURCE),
                                       _nvcc.build(K1.SOURCE, MK.SOURCE, VC.SOURCE)):
        print(f"built {os.path.relpath(lib, ROOT)} in {secs:.1f} s", flush=True)
        if src == VC.SOURCE:
            for line in ptxas.splitlines():
                if "pair_stats" in line or ("registers" in line and "_Z" not in line):
                    print("  ptxas:", line.strip())

    work = tempfile.mkdtemp(prefix="k12_variants_")
    cfg = Config()
    cfg.set("genomeSize", "300k")
    ctx = make_ctx(work, "bench", cfg)
    fk = stages.meryl(ctx, "cor", CS.bench_reads(), device=dev)
    placed = CS.placed_drive(dev, card, fk)
    record = {"card": card, "phase_4d": {k: v for k, v in placed.items() if k != "launches"}}

    rs, pairs, _ = CS.placed_pairs(dev, fk)
    words, lengths = device_words(rs, dev)
    rows = torch.from_numpy(np.stack([pairs[:, 0] - 1, pairs[:, 1] - 1]).astype(np.int32))
    a_idx, b_idx = rows[0].contiguous().to(dev), rows[1].contiguous().to(dev)
    fk_t = {16: torch.from_numpy(MH._fk_array(fk).astype(np.int64)).to(dev),
            22: torch.from_numpy(MH._fk_array(None).astype(np.int64)).to(dev)}
    calls = {k: (words, lengths, a_idx, b_idx, fk_t[k], k) for k in (16, 22)}
    chunk = CS.placed_chunks(rs, pairs[:256], fk_t[16], 16, dev)[0]
    ref = {k: VC.pair_stats_rows(*c) for k, c in calls.items()}
    ref_chunk = VC.pair_stats(*chunk)
    libs = plan_libraries(out_dir)
    sweep = {}
    for plan in PLANS:
        with at_plan(plan, libs):
            res = VC.pair_stats_resources()
            CS.check(res["threads"] == plan[0], f"K12 at plan {plan} built at {res['threads']}")
            for k, c in calls.items():
                CS.check(torch.equal(VC.pair_stats_rows(*c), ref[k]),
                         f"K12 at plan {plan}, k {k}: rows differ")
            CS.check(all(torch.equal(a, b) for a, b in zip(VC.pair_stats(*chunk), ref_chunk)),
                     f"K12 at plan {plan}: the first chunk differs")
        sweep[str(plan)] = {"resources": res, "chunk_ms": [], "call16_ms": [], "call22_ms": []}
        print(f"plan {plan}: {res}", flush=True)
    for order in (PLANS, PLANS[::-1]):
        for plan in order:
            s = sweep[str(plan)]
            with at_plan(plan, libs):
                s["chunk_ms"].append(CS.cuda_ms(lambda: VC.pair_stats(*chunk), cli.reps))
                for k in (16, 22):
                    s[f"call{k}_ms"].append(CS.time_pair_stats_call(calls[k], cli.reps))
    for plan in PLANS:
        s = sweep[str(plan)]
        print(f"{card}: plan {plan} ({s['resources']['blocks_per_sm']} blocks an SM, "
              f"{s['resources']['registers']} registers): first k 16 chunk "
              f"{s['chunk_ms'][0]:.4f} / {s['chunk_ms'][1]:.4f} ms; the call at k 16 "
              f"{s['call16_ms'][0]:.4f} / {s['call16_ms'][1]:.4f} ms, at k 22 "
              f"{s['call22_ms'][0]:.4f} / {s['call22_ms'][1]:.4f} ms", flush=True)
    record["sweep"] = sweep
    if cli.earlier:
        old = earlier_k12(cli.earlier, out_dir)
        chunks = {k: CS.placed_chunks(rs, pairs, fk_t[k], k, dev) for k in (16, 22)}
        for k, cs in chunks.items():
            for i, args in enumerate(cs):
                C = min(256, len(pairs) - 256 * i)
                CS.check(torch.equal(old(*args)[:, :C], ref[k][:, 256 * i:256 * i + C]),
                         f"the earlier K12 differs from this one: k {k} chunk {i}")
        cmp = {"first_chunk": {"earlier": [], "this": []}, "call16": {"earlier": [], "this": []},
               "call22": {"earlier": [], "this": []}}
        for who in ("earlier", "this", "this", "earlier"):
            one = old if who == "earlier" else (lambda *a: VC.pair_stats(*a))
            cmp["first_chunk"][who].append(CS.cuda_ms(lambda: one(*chunks[16][0]), cli.reps))
            for k in (16, 22):
                if who == "earlier":
                    ms = sum(CS.cuda_ms(lambda: old(*a), cli.reps) for a in chunks[k])
                else:
                    ms = CS.time_pair_stats_call(calls[k], cli.reps)
                cmp[f"call{k}"][who].append(ms)
        print(f"{card}: the earlier K12 bit-equal to this one on all {len(chunks[16])} + "
              f"{len(chunks[22])} chunks; " + "; ".join(
                  f"{n}: earlier {v['earlier'][0]:.4f} / {v['earlier'][1]:.4f} ms, this "
                  f"{v['this'][0]:.4f} / {v['this'][1]:.4f} ms" for n, v in cmp.items())
              + " (a call: the earlier design's one launch a chunk, summed; this one launch)",
              flush=True)
        record["earlier"] = cmp
    with open(os.path.join(out_dir, "sweep.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
