"""Run canu_tpu_torch's overlap paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1 device    require CUDA; print the card's name and power limit
  2 build     compile kernels K1 (csrc/myers_tile.cu) and K2/K3
              (csrc/banded_extend.cu) from this checkout, one nvcc each,
              in parallel
  3 kernel    each kernel against its plain PyTorch loop on the card, bit
              for bit: (a) K1's six outputs on edge cases (every window
              edge of its A, B and shift streams), (b) K1 on 256 real
              extensions sampled from the first verify group of phase 4,
              (c) K2 and K3's three outputs on edge cases at bands 128 and
              256 and on 256 real extensions sampled from the first K2
              call of phase 7
  4 slice     meryl + overlap ("cor") stages on the bench.py read set
              (1,025 reads, 3.64 Mb) in a temporary directory; K1 must
              have launched and the plain loop must not have run on the
              card; the store must be non-empty, symmetric and equal to
              the JAX package's (cor_overlap_reference.json); every K1
              launch of the stage is captured with its inputs
  5 timing    warm passes of sketch, match and verify as bench.py times
              them, one more pass under torch.profiler (device busy share
              of each sub-stage; tables in chiprun_out/profile.txt); K1
              with CUDA events on every group the cor stage launched it
              on, and their sum (K1 ms per cor stage), beside its bound;
              the same extensions cut into the launches of 4 chunks
              that MYERS_GROUP 4 made before (lane slices; the first is
              the earlier first group); K1 against the plain loop on the
              phase-3b sample and on the whole first verify group
  6 obt       meryl + overlap ("obt", k=22 two-lane k-mers, band 128:
              K1 with partial and palindromic pairs) on the corrected
              read set (1,004 reads, 3.61 Mb, 3% error)
  7 utg       meryl + overlap ("utg") on the same reads at
              utgOvlBandWidth=256 (the INF-walled engine, kernel K2) and
              at 1024 (kernel K3, which carries the bands above K2's 512)
              Phases 6 and 7 each run in a directory of their own with
              every launch count set to 0 first: the path's kernel must
              have launched, no other kernel and no plain loop on the
              card; frequent table, candidates and store must equal the
              JAX package's (corrected_overlap_reference.json)
  8 timing    K2 and K3 against the plain loop at the shape of the first
              K2 call of phase 7 (1,024 extensions), and K3 at its own
              path's first call, with CUDA events, beside their bounds

Each kernel's bound is the larger of its operations over the card's
32-bit integer rate and its bytes over the memory rate (INT32_OPS_S,
HBM_BYTES_S).  The operations are the least the function needs on this
run's data (K1_*_OPS, INF_*_OPS; k1_work and extend_bound count the live
rows, shifted rows, rows with b_len in the window and band cells up to
b_len).  The bytes are each input the kernel needs read once and each
output written once.  The plain loops' own per-row counts
(plain_row_ops) are printed beside, as a second figure.

The line before the last is the JSON kernel record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WARM_PASSES = 3
OUT_DIR = os.path.join(ROOT, "chiprun_out")
OLD_GROUP_LANES = 4 * 2 * 512  # a K1 launch at MYERS_GROUP 4: 4 chunks of 512 pairs, both ways

# H100 SXM peaks at its 1.98 GHz boost clock and 700 W: 132 SMs x 64 INT32
# lanes (NVIDIA's Hopper white paper), and HBM3 at 3.35 TB/s
INT32_OPS_S = 132 * 64 * 1.98e9
HBM_BYTES_S = 3.35e12

# The least 32-bit integer operations of the kernels' work, the bound's
# count: a two-input operation, a not, a funnel shift, a popcount, a byte
# extract and a conditional move count one each; loads and stores none.
# K1 (the Myers row of ops.myers._myers_row):
K1_ROW_OPS = 95  # each live row: A char 1, Eq word select 4, the 4-word
#   column update 4 x 16 (edlib's block update; the carries between words
#   ride in 2 funnel shifts a word), sf + 1 1, b_len-in-window test 2,
#   band-centre capture 23 (4 popcounts, 4 add/sub, 1 + 1 for jc and the
#   extent, 2 clamps, 2 multiplies, 3 compares, 2 ands, 4 moves)
K1_SHIFT_OPS = 34  # each row that shifts the band: sf 4, one funnel shift
#   for each of the 24 chained words (VP, VN, 16 Peq), the entering char 5
#   (extract 1, its 4 one-hot bits), o + 1 1
K1_BX_OPS = 21  # each live row with b_len inside the window: the prefix
#   score up to b_len (word index 1, mask 3, word select 2, 2 ands, 2
#   popcounts, 2 add/sub, the whole words below it 5) and the capture
#   (compare 1, 3 moves)
# K2/K3 (the INF-walled row of ops.align.banded_extend_plain):
INF_CELL_OPS = 6  # each band cell up to b_len of a live row: mismatch 1,
#   diagonal + it 1, up + 1 1, min 1, the closure D = min(m, left + 1) 2
INF_ROW_OPS = 8  # each live row: its shift 1, b_len-in-band test 2,
#   capture compare 1 and 3 moves, the a_len test 1


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def frequent_digest(path: str) -> str:
    import numpy as np

    h = hashlib.sha256()
    with np.load(path) as z:
        for n in ("kmers", "fraction", "threshold", "total", "k"):
            h.update(np.ascontiguousarray(z[n]).tobytes())
    return h.hexdigest()


def bench_reads(error_rate: float = 0.10, seed: int = 43):
    """bench.py's read set; error_rate=0.03, seed=44 gives the corrected
    read set of the obt/utg drives."""
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(300_000, seed=42)
    rs, _ = simulate_reads(g, coverage=12, mean_len=3500, min_len=1500, max_len=7800,
                           error_rate=error_rate, seed=seed)
    return rs


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn):
    """(fn()'s result, its device milliseconds in one run by CUDA events)."""
    import torch

    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def compare(name: str, ref, got) -> int:
    """Assert the outputs (six of K1, three of K2/K3) bit-equal; returns
    the max |difference| (0)."""
    import torch

    err = 0
    check(len(ref) == len(got), f"{name}: {len(got)} outputs, expected {len(ref)}")
    for field, r, g in zip(("edits", "a_used", "b_used", "p_edits", "p_a", "p_b"), ref, got):
        d = int((r.to(torch.int64) - g.to(torch.int64)).abs().max()) if r.numel() else 0
        check(d == 0, f"{name}: kernel and plain loop differ in {field} (max |diff| {d})")
        err = max(err, d)
    return err


def kernel_cases(dev):
    """K1's edge cases (tests/torch_cases.py, as the kernel tests use
    them): {name: (args on dev, n_rows, keyword arguments)}."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import myers_edge_cases

    return {name: ([torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in args], n, kw)
            for name, (args, n, kw) in myers_edge_cases().items()}


def plain_row_ops() -> dict:
    """Operations per live row and lane of the plain loops' rows (a second
    figure beside the bounds' least counts; not used by them), counted on
    the CPU: every elementwise torch operation of the row on one lane counts
    its elements (an op on the 4 band words counts 4, one on a band of
    cells counts the band), a popcount counts one, and the & 0xFFFFFFFF
    masks and int64 wrap helpers that only emulate 32-bit arithmetic count
    none; views, casts, concatenations and constants are free.  The Myers
    row is ops.myers._myers_segment's per-row work (the row plus its
    entering-char gather); the INF-walled row is banded_extend_plain's,
    the difference between 3 and 2 rows.  Returns {"K1": ops,
    ("K2", band): ops, ...}, ops per live row and lane."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import myers as MY

    free = {"view", "_unsafe_view", "reshape", "expand", "transpose", "t", "unsqueeze",
            "squeeze", "slice", "select", "permute", "as_strided", "alias", "detach",
            "_to_copy", "clone", "copy_", "cat", "stack", "arange", "full", "full_like",
            "zeros", "zeros_like", "ones", "ones_like", "empty", "empty_like",
            "scalar_tensor", "lift_fresh", "lift_fresh_copy", "split", "unbind", "flip",
            "_local_scalar_dense", "fill_", "resize_"}

    def is_mask(x) -> bool:
        if isinstance(x, torch.Tensor):
            return x.numel() == 1 and int(x) == MY.MASK32
        return x == MY.MASK32

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name not in free and not (name.startswith("bitwise_and") and is_mask(args[1])):
                self.n += sum(t.numel() for t in tree_leaves(out) if isinstance(t, torch.Tensor))
            return out

    def count(fn) -> int:
        with Count() as c:
            fn()
        return c.n

    B, n = 8, 64
    g = torch.Generator().manual_seed(0)
    a = torch.randint(0, 4, (B, n), dtype=torch.uint8, generator=g)
    b = torch.randint(0, 4, (B, n + 1024), dtype=torch.uint8, generator=g)
    lens = torch.full((B,), n, dtype=torch.int32)
    centers = torch.arange(n + 1, dtype=torch.int32)[None].expand(B, -1).contiguous()
    s_rows, ent, o0 = MY._myers_prep(lens, centers, 128, n)
    carry = MY._myers_init(b, lens, lens, o0, 128)
    seg_ops = [0, 0]
    real = MY._wrap32, MY._popcount
    MY._wrap32, MY._popcount = (lambda x: x.to(torch.int32)), (lambda x: x & 1)
    try:
        for seg in (1, 2):
            seg_ops[seg - 1] = count(lambda: MY._myers_segment(
                carry, a, b, s_rows[:seg], ent[:seg], lens, lens, 0, 1500, 128, seg))
    finally:
        MY._wrap32, MY._popcount = real
    out = {"K1": (seg_ops[1] - seg_ops[0]) / B}
    for band in (256, 1024):
        r2, r3 = (count(lambda: AL.banded_extend_plain(a, lens, b, lens, centers, band, r))
                  for r in (2, 3))
        out["INF", band] = (r3 - r2) / B
    return out


def bound(ops: float, nbytes: float) -> dict:
    """The least time of a kernel's work on the card: the larger of its
    operations over the 32-bit integer rate and its bytes over the memory
    rate (INT32_OPS_S, HBM_BYTES_S)."""
    t_ops, t_bytes = ops / INT32_OPS_S, nbytes / HBM_BYTES_S
    return {"ops": ops, "bytes": nbytes, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_call(call):
    """A captured ops.myers._rows_kernel call as kernel K1's inputs, and
    each extension's live rows (one K1 launch of the stage)."""
    import torch

    from canu_tpu_torch.ops import myers as MY

    (carry, a, b, s_bits, a_len, b_len, cap_q, n_run), _ = call
    planes = MY._carry_pack(carry)
    args = (planes, a, s_bits, b, a_len.contiguous(), b_len.contiguous(), n_run, cap_q)
    live = torch.clamp(a_len.to(torch.int64), 0, n_run)
    return args, live


def k1_lanes(launch, lo: int, hi: int):
    """A K1 launch's inputs and live rows cut to extensions lo:hi: the
    launch a smaller group of the same chunks makes (its lanes stop at
    their own a_len, whatever the launch's n_run)."""
    (planes, a, s_bits, b, a_len, b_len, n_run, cap_q), live = launch
    return ((planes[:, lo:hi].contiguous(), a[lo:hi], s_bits[:, lo:hi].contiguous(), b[lo:hi],
             a_len[lo:hi], b_len[lo:hi], n_run, cap_q), live[lo:hi])


def k1_work(args, live) -> dict:
    """What one K1 launch's data needs: live rows (each extension's rows
    1..min(a_len, n_run)), the live rows that shift the band, and the live
    rows with b_len inside the 128-column window, from o(i) = o0 + the
    shifts of rows 1..i."""
    import torch

    from canu_tpu_torch.ops import myers as MY

    planes, _, s_bits, _, _, b_len, n_run, _ = args
    dev = planes.device
    p_o = (2 + 4) * MY.NW + 1  # the carried window start o, after VP, VN, Peq and sf
    sh = torch.arange(MY.WORD, dtype=torch.int64, device=dev)
    rows = torch.arange(1, n_run + 1, device=dev)[None]
    shifts = bx = 0
    for lo in range(0, planes.shape[1], 2048):
        hi = min(planes.shape[1], lo + 2048)
        w = s_bits[:, lo:hi].T.to(torch.int64)
        on = rows <= live[lo:hi, None]
        bits = ((w[:, :, None] >> sh) & 1).reshape(hi - lo, -1)[:, :n_run] * on
        o = planes[p_o, lo:hi, None].to(torch.int64) + torch.cumsum(bits, dim=1)
        wb = b_len[lo:hi, None].to(torch.int64) - o
        shifts += int(bits.sum())
        bx += int(((wb >= 0) & (wb < MY.NW * MY.WORD) & on).sum())
    return {"live_rows": int(live.sum()), "shift_rows": shifts, "bx_rows": bx}


def k1_bound(args, live) -> dict:
    """K1's bound on one launch: K1_ROW_OPS a live row, K1_SHIFT_OPS a
    shifted row, K1_BX_OPS a row with b_len in the window; bytes = the
    carry in and out, a_len and b_len, each live row's A char and shift
    bit (whole 32-bit words), and each shift's entering B char."""
    wk = k1_work(args, live)
    planes = args[0]
    nbytes = planes.shape[1] * (2 * 4 * planes.shape[0] + 8) + wk["live_rows"] \
        + 4 * int(((live + 31) // 32).sum()) + wk["shift_rows"]
    ops = (K1_ROW_OPS * wk["live_rows"] + K1_SHIFT_OPS * wk["shift_rows"]
           + K1_BX_OPS * wk["bx_rows"])
    return {**bound(ops, nbytes), **wk}


def time_k1(launches, reps: int = 5):
    """K1 with CUDA events on each (inputs, live rows) launch: ([ms],
    [bound])."""
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    ms, bounds = [], []
    for args, live in launches:
        ms.append(cuda_ms(lambda: K1.myers_rows_cuda(*args), reps))
        bounds.append(k1_bound(args, live))
    return ms, bounds


def extend_bound(args, band: int, n_rows: int) -> dict:
    """K2/K3's bound on one call: INF_ROW_OPS a live row and INF_CELL_OPS
    a band cell up to b_len of it; bytes = each live row's A char and
    centre, the B chars up to the last live row's band end, a_len, b_len
    and the three outputs."""
    import torch

    from canu_tpu_torch.ops import align as AL

    a, a_len, b, b_len, centers = args
    live = torch.clamp(a_len.to(torch.int64), 0, n_rows)
    o = AL._band_starts(centers, b_len.to(torch.int32), band, n_rows).to(torch.int64)
    b_cols = torch.clamp(torch.gather(o, 1, live[:, None])[:, 0] + band, 0, b.shape[1])
    nbytes = int(live.sum()) * 5 + 4 * a.shape[0] + int(b_cols.sum()) + 20 * a.shape[0]
    on = torch.arange(1, n_rows + 1, device=o.device)[None] <= live[:, None]
    cells = int((torch.clamp(b_len.to(torch.int64)[:, None] - o[:, 1:] + 1, 0, band) * on).sum())
    return {**bound(INF_ROW_OPS * int(live.sum()) + INF_CELL_OPS * cells, nbytes),
            "live_rows": int(live.sum()), "cells": cells}


def capture_calls(module, name: str, first_only: bool = False):
    """Wrap module.<name> so each call's (args, kwargs) (or the first
    call's) are kept in the returned list; the caller restores the
    original afterwards."""
    real = getattr(module, name)
    seen: list = []

    def wrapper(*args, **kw):
        if not (first_only and seen):
            seen.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, wrapper)
    return real, seen


def run_pass(rs, fk, dev, step):
    """bench.py's overlap pass: sketch -> block match -> verify.  Each
    sub-stage runs as step(name, fn), which returns fn()'s result."""
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import minhash as MH

    sk = step("sketch", lambda: MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk,
                                                  block_size=128, device=dev))
    pairs = step("match", lambda: MH.find_candidates(sk, min_matches=2, block_size=1024,
                                                     device=dev))
    ov = step("verify", lambda: AL.verify_overlaps(rs, pairs, band=128, max_erate=0.35,
                                                   min_overlap=500, chunk=512, min_shared=4,
                                                   device=dev))
    return ov, pairs


def timed(walls: dict):
    """run_pass step that records each sub-stage's wall seconds."""
    import torch

    def step(name, fn):
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.time() - t
        return out

    return step


def profiled(busy: dict, tables: list):
    """run_pass step that runs each sub-stage under torch.profiler and
    records (wall s, device busy s): the sum of the CUDA kernels' time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def step(name, fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
            t = time.time()
            out = fn()
            torch.cuda.synchronize()
            wall = time.time() - t
        ev = p.key_averages()
        dev_us = sum(e.self_device_time_total for e in ev
                     if getattr(getattr(e, "device_type", None), "name", "") == "CUDA")
        busy[name] = (wall, dev_us / 1e6)
        tables.append(f"== {name}: wall {wall:.3f} s under the profiler, device busy "
                      f"{dev_us / 1e6:.3f} s\n"
                      + ev.table(sort_by="self_device_time_total", row_limit=20))
        return out

    return step


def reset_counts() -> None:
    """Set every kernel's launch count and the plain loops' CUDA counts to 0."""
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    K1.LAUNCHES = EX.WARP_LAUNCHES = EX.BLOCK_LAUNCHES = 0
    MY.PLAIN_CUDA_SEGMENTS = AL.PLAIN_CUDA_ROWS = 0


def read_counts() -> dict:
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    return {"K1": K1.LAUNCHES, "K2": EX.WARP_LAUNCHES, "K3": EX.BLOCK_LAUNCHES,
            "plain_myers_segments": MY.PLAIN_CUDA_SEGMENTS,
            "plain_extend_rows": AL.PLAIN_CUDA_ROWS}


def check_store(phase: str, st, prof: dict, fdig: str, ref: dict) -> None:
    """The store is symmetric and equals the JAX package's reference entry."""
    import numpy as np

    from canu_tpu_torch.stores.overlaps import store_digest

    check(len(st) > 0, f"{phase}: empty overlap store")
    fwd = set(zip(np.asarray(st.a_id).tolist(), np.asarray(st.b_id).tolist()))
    check(fwd == {(b, a) for a, b in fwd}, f"{phase}: overlap store is not symmetric")
    sdig = store_digest(st)
    log(f"[{phase}] store rows {len(st)} (reference {ref['rows']}); candidates "
        f"{prof.get('n_candidates')} (reference {ref['n_candidates']})")
    log(f"[{phase}] store sha256 {sdig}; frequent sha256 {fdig}")
    check(fdig == ref["frequent_sha256"], f"{phase}: frequent-mer table differs from the JAX package's")
    check(prof.get("n_candidates") == ref["n_candidates"], f"{phase}: candidate count differs")
    check(len(st) == ref["rows"] and sdig == ref["store_sha256"],
          f"{phase}: overlap store differs from the JAX package's")
    log(f"[{phase}] store equals the JAX package's row for row")


def drive_corrected(phase: str, tag: str, band: int, rs, dev, ref: dict, kernel: str):
    """meryl + overlap for `tag` at {tag}OvlBandWidth=band on the corrected
    read set, in a directory of its own, with the launch counts set to 0
    just before and read just after.  Only `kernel` may have launched and
    no plain loop may have run on the card; the store must equal `ref`.
    Returns (stage record, the first banded_extend call's (args, kwargs)
    or None)."""
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    work = tempfile.mkdtemp(prefix=f"chip_smoke_{tag}{band}_")
    cfg = Config()
    cfg.set("genomeSize", "300k")
    cfg.set(f"{tag}OvlBandWidth", band)
    ctx = make_ctx(work, "bench", cfg)
    k = int(cfg.get(f"{tag}MerSize"))
    real_extend, calls = capture_calls(AL, "banded_extend", first_only=True)
    try:
        reset_counts()
        t = time.time()
        fk = stages.meryl(ctx, tag, rs, device=dev)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, tag, rs, fk, device=dev)
        torch.cuda.synchronize()
        t_stage = time.time() - t
        counts = read_counts()
    finally:
        AL.banded_extend = real_extend
    prof = dict(AL.LAST_PROFILE)
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        sub = [json.loads(ln) for ln in fh if f'"{tag}-overlap.sub"' in ln][-1]["sub_walls_s"]
    log(f"[{phase}] {tag} k={k} band {band}: meryl {t_meryl:.2f} s; meryl+overlap "
        f"{t_stage:.2f} s; overlap sub-walls {sub}; verify profile {prof}")
    log(f"[{phase}] launch counts {counts}")
    for name in ("K1", "K2", "K3"):
        if name == kernel:
            check(counts[name] > 0, f"{phase}: kernel {name} never launched during the stage")
        else:
            check(counts[name] == 0, f"{phase}: kernel {name} launched off its path")
    check(counts["plain_myers_segments"] == 0 and counts["plain_extend_rows"] == 0,
          f"{phase}: a plain loop ran on the card during the stage")
    fdig = frequent_digest(os.path.join(work, stages.TAG_DIR[tag], f"bench.ms{k}.frequent.npz"))
    check_store(phase, st, prof, fdig, ref)
    rec = {"meryl_s": t_meryl, "stage_s": t_stage, "sub_walls_s": sub, "verify_profile": prof,
           "rows": len(st), "launches": counts}
    return rec, (calls[0] if calls else None)


def extend_edge_cases(band: int, dev):
    """The INF-walled extension's edge cases (tests/torch_cases.py, as the
    kernel tests use them): canu_tpu's x8 test pairs plus INF-range
    failures, o(0) > 0, empty A/B."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import edge_cases as cases

    args, n_rows = cases(band)
    return [torch.from_numpy(x).to(dev) for x in args], n_rows


def check_extend_kernels(name: str, args, band: int, n_rows: int) -> int:
    """K2 (where its band fits) and K3 against the plain loop, bit for bit."""
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops.kernels import extend_cuda as EX

    ref = AL.banded_extend_plain(*args, band, n_rows)
    err = compare(f"{name} K3", ref, EX.banded_extend_block(*args, band, n_rows))
    if band in EX.WARP_BANDS:
        err = max(err, compare(f"{name} K2", ref, EX.banded_extend_warp(*args, band, n_rows)))
    return err


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "canu_tpu_torch")):
        print("chip_smoke: canu_tpu_torch/ is not beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the port must run without jax and without the JAX package: make any
    # import of either fail
    sys.modules["jax"] = None
    sys.modules["canu_tpu"] = None
    import numpy as np
    import torch

    # ---- 1: device ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    log(f"[1 device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; python {sys.version.split()[0]}")
    log(card)
    record: dict = {"card": card, "torch": torch.__version__}
    ops_row = plain_row_ops()
    log("[1 device] the plain loops' own operations per live row and lane (plain_row_ops; "
        f"the bounds count the least: K1 {K1_ROW_OPS} a row + {K1_SHIFT_OPS} a shift + "
        f"{K1_BX_OPS} a row with b_len in the window, INF-walled {INF_ROW_OPS} a row + "
        f"{INF_CELL_OPS} a cell): "
        + ", ".join(f"{k if isinstance(k, str) else f'{k[0]} band {k[1]}'} {v:.1f}"
                    for k, v in ops_row.items()))
    record["plain_row_ops"] = {str(k): v for k, v in ops_row.items()}

    # ---- 2: build ----------------------------------------------------------
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import _nvcc
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    t = time.time()
    built = _nvcc.build(K1.SOURCE, EX.SOURCE)
    log(f"[2 build] both libraries in {time.time() - t:.1f} s (one nvcc each, in parallel)")
    record["build_s"] = {}
    for src, (lib, build_s, ptxas) in zip((K1.SOURCE, EX.SOURCE), built):
        log(f"[2 build] {os.path.relpath(lib, ROOT)}: nvcc {build_s:.1f} s")
        for line in ptxas.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[2 build] ptxas: {line.strip()}")
        record["build_s"][src.name] = build_s

    # ---- 3a: kernel vs plain, edge cases -----------------------------------
    err = 0
    for name, (args, n_rows, kw) in kernel_cases(dev).items():
        err = max(err, compare(f"K1 edge case {name}",
                               MY.banded_extend_myers_plain(*args, 128, n_rows, **kw),
                               MY.banded_extend_myers(*args, 128, n_rows, **kw)))
        log(f"[3a kernel] K1 edge case {name}: {args[0].shape[0]} extensions x {n_rows} rows "
            f"bit-equal")
    err_ext = 0
    for band in (128, 256):
        e_args, e_rows = extend_edge_cases(band, dev)
        err_ext = max(err_ext, check_extend_kernels(f"extend edge cases, band {band}",
                                                    e_args, band, e_rows))
        log(f"[3c kernel] band {band}: K2 and K3 bit-equal to the plain loop on "
            f"{e_args[0].shape[0]} edge-case extensions x {e_rows} rows")

    # ---- 4: the slice ------------------------------------------------------
    from canu_tpu_torch.config import Config
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    with open(os.path.join(ROOT, "canu_tpu_torch", "cor_overlap_reference.json")) as fh:
        ref = json.load(fh)
    t = time.time()
    rs = bench_reads()
    log(f"[4 slice] read set: {rs.n_reads} reads, {rs.total_bases} bases "
        f"(simulated in {time.time() - t:.1f} s)")
    check(rs.n_reads == ref["n_reads"] and rs.total_bases == ref["total_bases"],
          "bench read set differs from the reference's")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg = Config()
    cfg.set("genomeSize", "300k")
    ctx = make_ctx(work, "bench", cfg)
    # keep the stage's first verify group's extension inputs (phases 3b
    # and 5) and every K1 launch's inputs (phase 5)
    real_extend, groups = capture_calls(MY, "banded_extend_myers", first_only=True)
    real_rows, k1_calls = capture_calls(MY, "_rows_kernel")
    try:
        reset_counts()
        t = time.time()
        fk = stages.meryl(ctx, "cor", rs, device=dev)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, "cor", rs, fk, device=dev)
        torch.cuda.synchronize()
        t_stage = time.time() - t
        counts = read_counts()
        launches, plain_segments = counts["K1"], counts["plain_myers_segments"]
    finally:
        MY.banded_extend_myers, MY._rows_kernel = real_extend, real_rows
    check(counts["K2"] == counts["K3"] == 0 and counts["plain_extend_rows"] == 0,
          f"the cor stage ran the INF-walled engine: {counts}")
    prof = dict(AL.LAST_PROFILE)
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        sub = [json.loads(ln) for ln in fh if '"cor-overlap.sub"' in ln][-1]["sub_walls_s"]
    log(f"[4 slice] meryl {t_meryl:.2f} s; meryl+overlap {t_stage:.2f} s; overlap sub-walls "
        f"{sub}; verify profile {prof}")
    log(f"[4 slice] K1 launches {launches} (MYERS_GROUP {AL.MYERS_GROUP}); plain-loop "
        f"segments on the card {plain_segments}")
    check(launches > 0, "kernel K1 never launched during the overlap stage")
    check(plain_segments == 0, "the plain Myers loop ran on the card during the stage")
    check(len(k1_calls) == launches, f"{len(k1_calls)} K1 calls captured, {launches} launched")
    fdig = frequent_digest(os.path.join(work, "correction", "bench.ms16.frequent.npz"))
    check_store("4 slice", st, prof, fdig, ref)
    record.update(stage_s=t_stage, meryl_s=t_meryl, sub_walls_s=sub, verify_profile=prof,
                  rows=len(st), launches=launches, myers_group=AL.MYERS_GROUP)

    # ---- 3b: kernel vs plain on real extensions of the first group ----------
    check(len(groups) == 1, "the overlap stage never called banded_extend_myers")
    g_args, g_kw = groups[0]
    ext, (band, n_rows) = g_args[:5], g_args[5:7]
    B, rows = ext[0].shape[0], g_kw["max_rows"]
    pick = torch.arange(0, B, max(1, B // 256), device=dev)
    sample = tuple(x[pick] for x in ext)
    ref_s, plain_sample_ms = once_ms(
        lambda: MY.banded_extend_myers_plain(*sample, band, n_rows, **g_kw))
    err = max(err, compare("first-group sample", ref_s,
                           MY.banded_extend_myers(*sample, band, n_rows, **g_kw)))
    k1_sample_ms = cuda_ms(lambda: MY.banded_extend_myers(*sample, band, n_rows, **g_kw), 10)
    log(f"[3b kernel] {len(pick)} of the {B} extensions of the stage's first verify group "
        f"({rows} rows, cap_q {g_kw['partial_cap_q']}) bit-equal; {card}: "
        f"banded_extend_myers {k1_sample_ms:.3f} ms with K1 vs {plain_sample_ms:.1f} ms plain")
    record.update(k1_sample_ms=k1_sample_ms, plain_sample_ms=plain_sample_ms)

    # ---- 5: warm passes, as bench.py times them -----------------------------
    cold: dict = {}
    t = time.time()
    run_pass(rs, fk, dev, timed(cold))
    cold_s = time.time() - t
    walls, splits = [], []
    for rep in range(WARM_PASSES):
        warm: dict = {}
        t = time.time()
        ov, pairs = run_pass(rs, fk, dev, timed(warm))
        walls.append(time.time() - t)
        splits.append(warm)
        log(f"[5 timing] {card}: warm pass {rep + 1}: {walls[-1]:.3f} s -> {len(ov)} "
            f"overlaps, {len(ov) / walls[-1]:.1f} overlaps/s; split "
            + ", ".join(f"{k} {v:.3f} s" for k, v in warm.items())
            + f"; verify profile {dict(AL.LAST_PROFILE)}")
    wall = float(np.median(walls))
    log(f"[5 timing] {card}: cold pass {cold_s:.3f} s; warm pass median {wall:.3f} s -> "
        f"{len(ov) / wall:.1f} overlaps/s")
    record.update(cold_pass_s=cold_s, warm_pass_s=walls, warm_split_s=splits,
                  warm_overlaps=len(ov), overlaps_per_s_median=len(ov) / wall,
                  warm_verify_profile=dict(AL.LAST_PROFILE))

    busy: dict = {}
    tables: list = []
    run_pass(rs, fk, dev, profiled(busy, tables))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as fh:
        fh.write(f"{card}\n" + "\n".join(tables) + "\n")
    log(f"[5 profile] {card}: " + "; ".join(
        f"{k} wall {w:.3f} s, device busy {d:.3f} s ({100 * d / w:.0f}%)"
        for k, (w, d) in busy.items()) + " (tables in chiprun_out/profile.txt)")
    record["profile_wall_busy_s"] = busy

    # K1 on every launch of the cor stage, and the stage's sum
    k1_launches = [k1_call(c) for c in k1_calls]
    del k1_calls
    k1_group_ms, k1_bounds = time_k1(k1_launches)
    for gi, (ms_g, bd) in enumerate(zip(k1_group_ms, k1_bounds)):
        log(f"[5 timing] {card}: cor K1 launch {gi + 1}/{len(k1_launches)}: "
            f"{k1_launches[gi][0][1].shape[0]} extensions x {k1_launches[gi][0][6]} rows: "
            f"{ms_g:.3f} ms; bound {bd['bound_ms']:.3f} ms ({bd['ops']:.3e} operations: "
            f"{bd['live_rows']} live rows, {bd['shift_rows']} shifted, {bd['bx_rows']} with "
            f"b_len in the window; {bd['bytes']:.3e} bytes; bound by {bd['bound_by']}; "
            f"{100 * bd['bound_ms'] / ms_g:.1f}% of it)")
    ms, bd1 = k1_group_ms[0], k1_bounds[0]
    log(f"[5 timing] {card}: K1 ms per cor stage (MYERS_GROUP {AL.MYERS_GROUP}, "
        f"{len(k1_launches)} launches): {sum(k1_group_ms):.3f} ms; bound "
        f"{sum(b['bound_ms'] for b in k1_bounds):.3f} ms")
    # the same extensions in the launches of 4 chunks that MYERS_GROUP 4 made
    old = [k1_lanes(lc, lo, lo + OLD_GROUP_LANES) for lc in k1_launches
           for lo in range(0, lc[0][0].shape[1], OLD_GROUP_LANES)]
    old_ms, old_bounds = time_k1(old)
    del old
    b0 = old_bounds[0]
    log(f"[5 timing] {card}: the same extensions as MYERS_GROUP 4 launched them: "
        f"{len(old_ms)} launches, {sum(old_ms):.3f} ms per cor stage; the first "
        f"({OLD_GROUP_LANES} extensions, the earlier first group) {old_ms[0]:.3f} ms, bound "
        f"{b0['bound_ms']:.3f} ms ({b0['ops']:.3e} operations, {b0['bytes']:.3e} bytes; "
        f"{100 * b0['bound_ms'] / old_ms[0]:.1f}% of it)")
    record.update(k1_group_ms=k1_group_ms, k1_bounds=k1_bounds,
                  k1_ms_per_cor_stage=sum(k1_group_ms), k1_group4_ms=old_ms,
                  k1_group4_bounds=old_bounds, k1_ms_per_cor_stage_group4=sum(old_ms))
    del k1_launches

    ref_g, plain_ms = once_ms(lambda: MY.banded_extend_myers_plain(*g_args, **g_kw))
    err = max(err, compare("first group", ref_g, MY.banded_extend_myers(*g_args, **g_kw)))
    log(f"[5 timing] {card}: K1 {ms:.3f} ms (bound {bd1['bound_ms']:.3f} ms, "
        f"{100 * bd1['bound_ms'] / ms:.1f}% of it) vs plain loop {plain_ms:.1f} ms for {B} "
        f"extensions x {rows} rows (the stage's first verify group), bit-equal")
    record.update(k1_ms=ms, plain_ms=plain_ms, group_B=B, group_rows=rows)

    # ---- 6, 7: the corrected-read stages -----------------------------------
    with open(os.path.join(ROOT, "canu_tpu_torch", "corrected_overlap_reference.json")) as fh:
        cref = json.load(fh)
    t = time.time()
    crs = bench_reads(error_rate=0.03, seed=44)
    log(f"[6 obt] corrected read set: {crs.n_reads} reads, {crs.total_bases} bases "
        f"(simulated in {time.time() - t:.1f} s)")
    check(crs.n_reads == cref["n_reads"] and crs.total_bases == cref["total_bases"],
          "corrected read set differs from the reference's")
    drives = {}
    drives["obt"], _ = drive_corrected("6 obt", "obt", 128, crs, dev, cref["obt"], "K1")
    drives["utg256"], k2_call = drive_corrected("7 utg256", "utg", 256, crs, dev,
                                                cref["utg256"], "K2")
    drives["utg1024"], k3_call = drive_corrected("7 utg1024", "utg", 1024, crs, dev,
                                                 cref["utg1024"], "K3")
    record["corrected"] = drives

    # ---- 3c: K2 and K3 vs plain on real extensions of the first K2 call ---
    check(k2_call is not None and k3_call is not None,
          "a utg stage never called banded_extend")
    x_args, (x_band, x_rows) = k2_call[0][:5], k2_call[0][5:7]
    XB = x_args[0].shape[0]
    pick = torch.arange(0, XB, max(1, XB // 256), device=dev)
    err_ext = max(err_ext, check_extend_kernels(
        "first K2 call sample", tuple(x[pick] for x in x_args), x_band, x_rows))
    log(f"[3c kernel] {len(pick)} of the {XB} extensions of the utg stage's first K2 call "
        f"(band {x_band}, {x_rows} rows) bit-equal in K2 and K3")

    # ---- 8: K2 and K3 against the plain loop at the main path's shape -------
    ext_ms = {}
    for name, call in (("utg256", k2_call), ("utg1024", k3_call)):
        c_args, (c_band, c_rows) = call[0][:5], call[0][5:7]
        ref_c, p_ms = once_ms(lambda: AL.banded_extend_plain(*c_args, c_band, c_rows))
        live_rows = min(c_rows, int(c_args[1].max()))
        bd = extend_bound(c_args, c_band, c_rows)
        row = {"B": c_args[0].shape[0], "band": c_band, "n_rows": c_rows,
               "rows_run": live_rows, "plain_ms": p_ms, "bound": bd}
        kernels = [("K3", EX.banded_extend_block)]
        if c_band in EX.WARP_BANDS:
            kernels.insert(0, ("K2", EX.banded_extend_warp))
        for kname, fn in kernels:
            err_ext = max(err_ext, compare(f"{name} first call {kname}", ref_c,
                                           fn(*c_args, c_band, c_rows)))
            row[f"{kname}_ms"] = cuda_ms(lambda: fn(*c_args, c_band, c_rows), 10)
        ext_ms[name] = row
        log(f"[8 timing] {card}: {name} first banded_extend call ({row['B']} extensions, "
            f"band {c_band}, {live_rows} rows run): "
            + ", ".join(f"{kn} {row[f'{kn}_ms']:.3f} ms "
                        f"({100 * bd['bound_ms'] / row[f'{kn}_ms']:.1f}% of the bound)"
                        for kn, _ in kernels)
            + f" vs plain loop {p_ms:.1f} ms, bit-equal; bound {bd['bound_ms']:.3f} ms "
            f"({bd['ops']:.3e} operations, {bd['bytes']:.3e} bytes, bound by {bd['bound_by']})")
    log(f"[8 timing] {card}: stage walls (meryl+overlap) "
        + ", ".join(f"{n} {d['stage_s']:.2f} s" for n, d in drives.items()))
    record["extend_ms"] = ext_ms

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    check(all(sys.modules.get(m) is None for m in ("jax", "canu_tpu")),
          "jax or canu_tpu was imported")

    src = "canu_tpu_torch/csrc/banded_extend.cu"
    k2b, k3b = ext_ms["utg256"]["bound"], ext_ms["utg1024"]["bound"]
    print(json.dumps({"kernels": [
        {"name": "myers_rows (K1)", "route": "cuda",
         "source": "canu_tpu_torch/csrc/myers_tile.cu",
         "replaces": "canu_tpu/ops/pallas/myers_pallas.py:77",
         "launches": launches + drives["obt"]["launches"]["K1"], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bd1["bound_ms"],
         "bound_by": bd1["bound_by"], "library_ms": None},
        {"name": "extend_warp (K2)", "route": "cuda", "source": src,
         "replaces": "canu_tpu/ops/pallas/extend_x8.py:72",
         "launches": drives["utg256"]["launches"]["K2"], "max_abs_err": err_ext,
         "ms": ext_ms["utg256"]["K2_ms"], "plain_ms": ext_ms["utg256"]["plain_ms"],
         "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"], "library_ms": None},
        {"name": "extend_block (K3)", "route": "cuda", "source": src,
         "replaces": "canu_tpu/ops/pallas/extend.py:79",
         "launches": drives["utg1024"]["launches"]["K3"], "max_abs_err": err_ext,
         "ms": ext_ms["utg1024"]["K3_ms"], "plain_ms": ext_ms["utg1024"]["plain_ms"],
         "bound_ms": k3b["bound_ms"], "bound_by": k3b["bound_by"], "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
