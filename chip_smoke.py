"""Run canu_tpu_torch's overlap path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints its results; any failure exits non-zero):
  1 device    require CUDA; print the card's name and power limit
  2 build     compile kernel K1 (csrc/myers_tile.cu) from this checkout
  3 kernel    K1 against its plain PyTorch loop on the card, all six
              outputs bit for bit: (a) edge cases, (b) 256 real
              extensions sampled from the first verify group of phase 4
  4 slice     meryl + overlap ("cor") stages on the bench.py read set
              (1,025 reads, 3.64 Mb) in a temporary directory; K1 must
              have launched and the plain loop must not have run on the
              card; the store must be non-empty, symmetric and equal to
              the JAX package's (cor_overlap_reference.json)
  5 timing    warm passes of sketch, match and verify as bench.py times
              them, one more pass under torch.profiler (device busy share
              of each sub-stage; tables in chiprun_out/profile.txt), and
              K1 against the plain loop on the phase-3b sample and at the
              main path's shape (the whole first verify group)

The line before the last is the JSON kernel record; the last line is
{"ok": true, "device": {...}}.  Imports nothing of jax.
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


def bench_reads():
    from canu_tpu.sim.simulate import random_genome, simulate_reads

    g = random_genome(300_000, seed=42)
    rs, _ = simulate_reads(g, coverage=12, mean_len=3500, min_len=1500, max_len=7800,
                           error_rate=0.10, seed=43)
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


def compare(name: str, ref, got) -> int:
    """Assert six outputs bit-equal; returns the max |difference| (0)."""
    import torch

    err = 0
    for field, r, g in zip(("edits", "a_used", "b_used", "p_edits", "p_a", "p_b"), ref, got):
        d = int((r.to(torch.int64) - g.to(torch.int64)).abs().max()) if r.numel() else 0
        check(d == 0, f"{name}: kernel and plain loop differ in {field} (max |diff| {d})")
        err = max(err, d)
    return err


def edge_cases(dev):
    """Extensions probing the kernel's edge conditions: empty A, empty B,
    b_len on each word boundary and at the band edge, drifting centres."""
    import numpy as np
    import torch

    rng = np.random.default_rng(7)
    B, n_rows = 64, 256
    A = rng.integers(0, 4, (B, n_rows)).astype(np.uint8)
    Bb = np.zeros((B, n_rows + 128), np.uint8)
    a_len = rng.integers(1, n_rows + 1, B).astype(np.int32)
    b_len = rng.integers(1, n_rows + 129, B).astype(np.int32)
    for i in range(B):  # B is A with ~10% substitutions, then random tail
        Bb[i, :n_rows] = np.where(rng.random(n_rows) < 0.1, rng.integers(0, 4, n_rows), A[i])
        Bb[i, n_rows:] = rng.integers(0, 4, 128)
    a_len[:4], b_len[:4] = [0, 0, 5, 0], [0, 9, 0, 300]
    b_len[4:12] = [32, 64, 96, 128, 127, 129, 255, 384]
    centers = np.broadcast_to(np.arange(n_rows + 1, dtype=np.int32), (B, n_rows + 1)).copy()
    for i in range(B // 2, B):  # drifting centres
        centers[i] = np.concatenate([[0], np.cumsum(rng.random(n_rows) < 0.7)])
    return [torch.from_numpy(x).to(dev) for x in (A, a_len, Bb, b_len, centers)], n_rows


def time_group(args, kw):
    """K1's row loop at the main path's shape (a whole verify group, as
    banded_extend_myers got it) against the plain loop on the same carry:
    (kernel ms, plain ms, max |difference| of the six outputs)."""
    import torch

    from canu_tpu_torch.ops import myers as MY

    (a, a_len, b, b_len, centers), (band, n_rows) = args[:5], args[5:7]
    seg = min(MY.SEGMENT, n_rows)
    run_segs = -(-kw["max_rows"] // seg)
    s_rows, ent_rows, o0 = MY._myers_prep(b_len, centers, band, n_rows)
    carry = MY._myers_init(b, b_len, a_len, o0, band)
    rows_args = (a, b, s_rows, ent_rows, a_len, b_len, kw["partial_cap_q"], band, seg,
                 run_segs)
    ms = cuda_ms(lambda: MY._rows_kernel(carry, *rows_args), 10)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    plain = MY._rows_plain(carry, *rows_args)
    t1.record()
    torch.cuda.synchronize()
    plain_ms = t0.elapsed_time(t1)
    got = MY._rows_kernel(carry, *rows_args)
    err = compare("first group", MY._myers_finish(plain, a_len, b_len, band),
                  MY._myers_finish(got, a_len, b_len, band))
    return ms, plain_ms, err


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


def capture_first_call(module, name: str):
    """Wrap module.<name> so the first call's (args, kwargs) are kept in
    the returned list; the caller restores the original afterwards."""
    real = getattr(module, name)
    seen: list = []

    def wrapper(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, wrapper)
    return real, seen


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "canu_tpu_torch")):
        print("chip_smoke: canu_tpu_torch/ is not beside this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.modules["jax"] = None  # the port must run without jax: make any import fail
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

    # ---- 2: build ----------------------------------------------------------
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    lib, build_s, ptxas = K1.build()
    log(f"[2 build] {os.path.relpath(lib, ROOT)} in {build_s:.1f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[2 build] ptxas: {line.strip()}")
    record["build_s"] = build_s

    # ---- 3a: kernel vs plain, edge cases -----------------------------------
    args, n_rows = edge_cases(dev)
    err = compare("edge cases", MY.banded_extend_myers_plain(*args, 128, n_rows, partial_cap_q=3000),
                  MY.banded_extend_myers(*args, 128, n_rows, partial_cap_q=3000))
    log(f"[3a kernel] edge cases: {args[0].shape[0]} extensions x {n_rows} rows bit-equal")

    # ---- 4: the slice ------------------------------------------------------
    from canu_tpu.config import Config
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import store_digest

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
    # keep the first verify group's extension inputs for phases 3b and 5
    real_extend, groups = capture_first_call(MY, "banded_extend_myers")
    try:
        K1.LAUNCHES = 0
        MY.PLAIN_CUDA_SEGMENTS = 0
        t = time.time()
        fk = stages.meryl(ctx, "cor", rs, device=dev)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, "cor", rs, fk, device=dev)
        torch.cuda.synchronize()
        t_stage = time.time() - t
        launches, plain_segments = K1.LAUNCHES, MY.PLAIN_CUDA_SEGMENTS
    finally:
        MY.banded_extend_myers = real_extend
    from canu_tpu_torch.ops import align as AL

    prof = dict(AL.LAST_PROFILE)
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        sub = [json.loads(ln) for ln in fh if '"cor-overlap.sub"' in ln][-1]["sub_walls_s"]
    log(f"[4 slice] meryl {t_meryl:.2f} s; meryl+overlap {t_stage:.2f} s; overlap sub-walls "
        f"{sub}; verify profile {prof}")
    log(f"[4 slice] K1 launches {launches}; plain-loop segments on the card {plain_segments}")
    check(launches > 0, "kernel K1 never launched during the overlap stage")
    check(plain_segments == 0, "the plain Myers loop ran on the card during the stage")
    check(len(st) > 0, "empty overlap store")
    fwd = set(zip(np.asarray(st.a_id).tolist(), np.asarray(st.b_id).tolist()))
    check(fwd == {(b, a) for a, b in fwd}, "overlap store is not symmetric")
    fdig = frequent_digest(os.path.join(work, "correction", "bench.ms16.frequent.npz"))
    sdig = store_digest(st)
    log(f"[4 slice] store rows {len(st)} (reference {ref['rows']}); candidates "
        f"{prof.get('n_candidates')} (reference {ref['n_candidates']})")
    log(f"[4 slice] store sha256 {sdig}; frequent sha256 {fdig}")
    check(fdig == ref["frequent_sha256"], "frequent-mer table differs from the JAX package's")
    check(prof.get("n_candidates") == ref["n_candidates"], "candidate count differs")
    check(len(st) == ref["rows"] and sdig == ref["store_sha256"],
          "overlap store differs from the JAX package's")
    log("[4 slice] store equals the JAX package's row for row")
    record.update(stage_s=t_stage, meryl_s=t_meryl, sub_walls_s=sub, verify_profile=prof,
                  rows=len(st), launches=launches)

    # ---- 3b: kernel vs plain on real extensions of the first group ----------
    check(len(groups) == 1, "the overlap stage never called banded_extend_myers")
    g_args, g_kw = groups[0]
    ext, (band, n_rows) = g_args[:5], g_args[5:7]
    B, rows = ext[0].shape[0], g_kw["max_rows"]
    pick = torch.arange(0, B, max(1, B // 256), device=dev)
    sample = tuple(x[pick] for x in ext)
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    ref_s = MY.banded_extend_myers_plain(*sample, band, n_rows, **g_kw)
    t1.record()
    torch.cuda.synchronize()
    plain_sample_ms = t0.elapsed_time(t1)
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

    ms, plain_ms, e3 = time_group(g_args, g_kw)
    err = max(err, e3)
    log(f"[5 timing] {card}: K1 row loop {ms:.3f} ms vs plain loop {plain_ms:.1f} ms for "
        f"{B} extensions x {rows} rows (the stage's first verify group), bit-equal")
    record.update(k1_ms=ms, plain_ms=plain_ms, group_B=B, group_rows=rows)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    check("jax" not in sys.modules or sys.modules["jax"] is None, "jax was imported")

    print(json.dumps({"kernels": [{
        "name": "myers_rows", "route": "cuda",
        "source": "canu_tpu_torch/csrc/myers_tile.cu",
        "replaces": "canu_tpu/ops/pallas/myers_pallas.py:77",
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
