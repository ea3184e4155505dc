"""Kernels K9 (the vote fold) and K6 (the block matcher) of this checkout
against an earlier checkout's, on one card, and the earlier designs split
by variants.

    python3 scripts/torch_fold_match_variants.py --earlier REV_OR_DIR [--no-ecoli]

REV_OR_DIR is an earlier commit, whose csrc/vote_fold.cu and
csrc/minhash.cu are read with `git show`, or a directory holding an
earlier checkout (`git archive REV | tar -x -C DIR`, where the machine
with the card has no history).  The earlier sources must have the
interfaces of the design before the redesign: canu_vote_fold without the
slot order, and the count (with row_set) and compact (with row_set and
row_start) launches of K6.

It builds, one nvcc each and all at once, this checkout's vote_fold.cu
(and copies at other tile widths and warps a block, FOLD_TILE and
FOLD_WARPS) and minhash.cu, the earlier ones, and variants of the earlier
K9: pass 1 skipped (deletion counts taken as 0), its atomicAdds made
plain stores, and both, and of this K9: no walk past a tile, no
read-add-write of the tile into the votes, plain shared adds for its
shared atomics; it prints each build's registers.  Times are the
card's alone: the launches are queued behind a spin kernel
(torch.cuda._sleep) long enough that the host has queued them all
before the first runs, then timed by CUDA events; the host's own time to
queue a call is printed beside it.  Then, on chip_smoke.py's bench read
set:
  - K6 on phase 5's block pairs (k 16, H 512, blocks of 1,024 reads,
    min_matches 2, max_out 2^17): each design as its match_block runs it
    (the card's time and the host's) and its launches alone on buffers
    allocated beforehand (mean of 20, in turns: earlier, this, this,
    earlier), both held bit for bit to the plain match, and each
    kernel's time under torch.profiler;
  - K9 on phase 10's DP groups (correction_phase from a FASTA of the
    reads): on every group, each variant's launch alone into a copy of
    the group's votes (mean of 3 after one warm-up, the inputs warm in
    L2 as far as they fit), the main path's own fold left as it runs;
    on the first group the earlier and this design's votes held bit for
    bit to each other and to the main path's;
  - the same on phase 15's groups (config 2's raw E. coli reads at 10%
    error, chip_smoke.py's ecolicor configuration; about 3 minutes),
    unless --no-ecoli.
Writes chiprun_out/k69/variants.json.  Imports nothing of jax or
canu_tpu.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time

sys.modules["jax"] = None
sys.modules["canu_tpu"] = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from canu_tpu_torch.ops.kernels import _nvcc  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "k69")
P, I = ctypes.c_void_p, ctypes.c_int
SPIN_HZ = 2.0e9  # cycles a second the spin kernel is sized with (above the H100's boost clock)


def device_ms(fn, reps: int) -> tuple[float, float]:
    """(the card's milliseconds a call of fn, the host's milliseconds to
    queue one), the mean of reps after one warm-up: the calls wait behind a
    spin kernel that outlasts the host's queueing, so the CUDA events
    time the card alone."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_one = time.perf_counter() - t
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_HZ * (3 * reps * host_one + 1e-3)))
    t0.record()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t) / reps
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps, 1e3 * host


def earlier_source(where: str, name: str) -> str:
    path = f"canu_tpu_torch/csrc/{name}"
    if os.path.isdir(where):
        with open(os.path.join(where, path)) as fh:
            return fh.read()
    return subprocess.run(["git", "show", f"{where}:{path}"], cwd=ROOT, check=True,
                          capture_output=True, text=True).stdout


def replaced(src: str, pairs) -> str:
    for a, b in pairs:
        n = len(re.findall(a, src))
        if n == 0:
            raise SystemExit(f"variant edit not found in the earlier source: {a!r}")
        src = re.sub(a, b, src)
    return src


def build_all(sources: dict) -> dict:
    """{name: (source text, extra nvcc flags)} -> {name: ctypes library},
    built in a temporary directory."""
    src_dir = tempfile.mkdtemp(prefix="k69_src_")
    procs = {}
    for name, (text, flags) in sources.items():
        cu = os.path.join(src_dir, f"{name}.cu")
        with open(cu, "w") as fh:
            fh.write(text)
        procs[name] = subprocess.Popen(
            [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *flags, "-o", cu.replace(".cu", ".so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    libs = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err[-4000:]}")
        for line in err.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(os.path.join(src_dir, f"{name}.so"))
    return libs


def fold_launcher(lib, new: bool):
    fn = lib.canu_vote_fold
    fn.argtypes = [P, I, I, P, P, P, I, P, I, I, I] + ([P, P] if new else [P])
    fn.restype = I

    def run(votes, js, t_sub, e_sub, cols, n_rows, t_mask, by_slot):
        extra = (by_slot.data_ptr(),) if new else ()
        rc = fn(votes.data_ptr(), votes.shape[0], votes.shape[2], js.data_ptr(), t_sub.data_ptr(),
                e_sub.data_ptr(), e_sub.shape[1], cols.data_ptr(), js.shape[0], n_rows, t_mask,
                *extra, torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
    return run


def k6_designs(libs):
    """{design: (as match_block runs it, its launches alone on buffers
    allocated beforehand)} for a block pair (SA, SB, mm, self_block,
    max_out)."""
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops.kernels import minhash_cuda as MK

    old = libs["old_minhash"]
    old.canu_slot_match_count.argtypes = [P, I, P, I, I, I, I, P, P, P]
    old.canu_slot_match_compact.argtypes = [P, I, I, I, I, P, P, I, P, P, P, P]
    new = libs["new_minhash"]
    new.canu_slot_match_count.argtypes = [P, I, P, I, I, I, I, P, P, P, I, P]
    new.canu_slot_match_compact.argtypes = [P, P, I, I, I, I, P, I, P, P, P, P, P]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def old_call(SA, SB, mm, sb, max_out):
        # the earlier match_block: zeros, the count, a cumsum, a subtraction,
        # a sum, three fills, the compact
        Na, H = SA.shape
        Nb = SB.shape[0]
        cnt = torch.empty((Na, Nb), dtype=torch.int32, device=SA.device)
        row_set = torch.zeros(Na, dtype=torch.int32, device=SA.device)
        assert old.canu_slot_match_count(SA.data_ptr(), Na, SB.data_ptr(), Nb, H, mm, int(sb),
                                         cnt.data_ptr(), row_set.data_ptr(), stream()) == 0
        row_start = torch.cumsum(row_set, 0, dtype=torch.int64) - row_set
        n_found = row_set.sum(dtype=torch.int64)
        ii = torch.full((max_out,), Na, dtype=torch.int64, device=SA.device)
        jj = torch.full((max_out,), Na, dtype=torch.int64, device=SA.device)
        c = torch.zeros(max_out, dtype=torch.int32, device=SA.device)
        assert old.canu_slot_match_compact(cnt.data_ptr(), Na, Nb, mm, int(sb), row_set.data_ptr(),
                                           row_start.data_ptr(), max_out, ii.data_ptr(),
                                           jj.data_ptr(), c.data_ptr(), stream()) == 0
        return ii, jj, c, n_found

    def old_alone(SA, SB, mm, sb, max_out):
        Na, H = SA.shape
        Nb = SB.shape[0]
        cnt = torch.empty((Na, Nb), dtype=torch.int32, device=SA.device)
        row_set = torch.zeros(Na, dtype=torch.int32, device=SA.device)
        old.canu_slot_match_count(SA.data_ptr(), Na, SB.data_ptr(), Nb, H, mm, int(sb),
                                  cnt.data_ptr(), row_set.data_ptr(), stream())
        row_start = torch.cumsum(row_set, 0, dtype=torch.int64) - row_set
        outs = [torch.empty(max_out, dtype=d, device=SA.device)
                for d in (torch.int64, torch.int64, torch.int32)]

        def run():  # row_set only grows where it was not 0: the compact visits the same rows
            old.canu_slot_match_count(SA.data_ptr(), Na, SB.data_ptr(), Nb, H, mm, int(sb),
                                      cnt.data_ptr(), row_set.data_ptr(), stream())
            old.canu_slot_match_compact(cnt.data_ptr(), Na, Nb, mm, int(sb), row_set.data_ptr(),
                                        row_start.data_ptr(), max_out,
                                        *(o.data_ptr() for o in outs), stream())
        return run

    def new_alone(SA, SB, mm, sb, max_out):
        Na, H = SA.shape
        Nb = SB.shape[0]
        n_tiles = -(-Nb // MK.TILE)
        n_scan = -(-Na * n_tiles // MK.SCAN_BLOCK) + 1
        scan = torch.empty(n_scan, dtype=torch.int64, device=SA.device)
        tile = torch.empty((Na, n_tiles), dtype=torch.int32, device=SA.device)
        cnt = torch.empty((Na, Nb), dtype=torch.int32, device=SA.device)
        outs = [torch.empty(max_out, dtype=d, device=SA.device)
                for d in (torch.int64, torch.int64, torch.int32)]
        nf = torch.empty((), dtype=torch.int64, device=SA.device)

        def run():
            new.canu_slot_match_count(SA.data_ptr(), Na, SB.data_ptr(), Nb, H, mm, int(sb),
                                      cnt.data_ptr(), tile.data_ptr(), scan.data_ptr(), n_scan,
                                      stream())
            new.canu_slot_match_compact(cnt.data_ptr(), tile.data_ptr(), Na, Nb, mm, int(sb),
                                        scan.data_ptr(), max_out, *(o.data_ptr() for o in outs),
                                        nf.data_ptr(), stream())
        return run

    return {"earlier": (old_call, old_alone), "this": (MH._match_kernel, new_alone)}


def k6_pairs(dev, card: str, libs) -> dict:
    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops.hashing import u32_tensor
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    rs = CS.bench_reads()
    cfg = Config()
    cfg.set("genomeSize", "300k")
    ctx = make_ctx(tempfile.mkdtemp(prefix="k69_"), "bench", cfg)
    fk = stages.meryl(ctx, "cor", rs, device=dev)
    sk = MH.build_sketches(rs, k=16, n_hashes=512, frequent=fk, block_size=128, device=dev)
    S = u32_tensor(sk, dev)
    N, bs, max_out = len(sk), 1024, 1 << 17
    pairs = [(S[a : a + bs], S[b : b + bs], 2, a == b, max_out)
             for a in range(0, N, bs) for b in range(a, N, bs)]
    designs = k6_designs(libs)
    res: dict = {}
    for k, pair in enumerate(pairs):
        ref = MH._match_kernel_plain(*pair)
        for design, (call, alone) in designs.items():
            got = call(*pair)
            torch.cuda.synchronize()
            ok = all(torch.equal(g, r) for g, r in zip(got, ref))
            if not ok:
                raise SystemExit(f"K6 {design} differs from the plain match on pair {k}")
        runs = {d: alone(*pair) for d, (_, alone) in designs.items()}
        for order in (("earlier", "this"), ("this", "earlier")):
            for design in order:
                call = designs[design][0]
                card_ms, host_ms = device_ms(lambda: call(*pair), 20)
                res.setdefault(f"{design} call", {}).setdefault(k, []).append(card_ms)
                res.setdefault(f"{design} call, host", {}).setdefault(k, []).append(host_ms)
                res.setdefault(f"{design} launches alone", {}).setdefault(k, []).append(
                    device_ms(runs[design], 20)[0])
        shape = f"{pair[0].shape[0]} x {pair[1].shape[0]}{' self' if pair[3] else ''}"
        print(f"[K6] {card}: pair {k} ({shape}, n_found {int(ref[3])}): " + "; ".join(
            f"{name} {' / '.join(f'{x:.4f}' for x in v[k])} ms" for name, v in res.items()),
            flush=True)
    out = {name: {"pairs_ms": {str(k): v for k, v in per.items()},
                  "sum_ms": [sum(per[k][r] for k in per) for r in range(2)]}
           for name, per in res.items()}
    out["profile"] = {}
    for design, (call, _) in designs.items():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                for pair in pairs:
                    call(*pair)
            torch.cuda.synchronize()
        rows = [(e.key, e.device_time_total / 5, e.count // 5)
                for e in prof.key_averages() if e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        out["profile"][design] = rows
        print(f"[K6 profile] {card}: {design}'s match_block on the {len(pairs)} pairs, a pass "
              "(device us, calls): " + "; ".join(f"{n[:60]} {t:.1f} us x{c}" for n, t, c in rows),
              flush=True)
    bound = CS.sum_bounds([CS.match_bound(p[0], p[1], p[3], p[4]) for p in pairs])
    out["bound_ms"] = bound["bound_ms"]
    print(f"[K6] {card}: phase 5's {len(pairs)} block pairs, summed (two rounds): " + "; ".join(
        f"{name} {' / '.join(f'{x:.4f}' for x in v['sum_ms'])} ms"
        for name, v in out.items() if name not in ("bound_ms", "profile"))
        + f"; bound {bound['bound_ms']:.4f} ms",
        flush=True)
    return out


# this design at (FOLD_TILE, FOLD_WARPS) other than the source's
THIS_SHAPES = {"this_t64_w8": (64, 8), "this_t128_w4": (128, 4), "this_t256_w8": (256, 8),
               "this_t512_w16": (512, 16)}
# this design's split: no walk past the tile, no read-add-write of the
# tile into the votes, plain (racy) shared adds for the shared atomics
THIS_SPLIT = {
    "this_nowalk": [(r"if \(r0 \+ TILE < T && last >= 0 && last < lim\) \{", "if (false) {")],
    "this_nowrite": [(r"if \(col < Lt\) vs\[", "if (col < 0) vs[")],
    "this_noatomic": [(r"atomicAdd\(&acc\[([^;]*?)\]\[x\], ([^;]*?)\);", r"acc[\1][x] += \2;")],
}
FOLD_VARIANTS = ("earlier", "this", *THIS_SHAPES, *THIS_SPLIT, "earlier_nopass1",
                 "earlier_noatomic", "earlier_both")


def fold_groups(tag: str, drive, card: str, libs) -> dict:
    """K9's variants on every DP group a correction_phase run folds (drive
    runs it), each launch alone by CUDA events."""
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import votepile_cuda as K9

    runs = {name: fold_launcher(libs[name], name.startswith("this")) for name in FOLD_VARIANTS}
    per: dict = {name: [] for name in FOLD_VARIANTS}
    groups: list = []
    real = VP._fold_group

    def fold(votes, js, t_sub, e_sub, cols, host_cols, n_rows, Lt, G, B, load):
        mask = (1 << VP._log_rounds(Lt)) - 1
        cols_c = cols.contiguous()
        by_slot = torch.from_numpy(K9.slot_order(host_cols, G)).to(votes.device)
        args = (js, t_sub, e_sub, cols_c, n_rows, mask, by_slot)
        first = None
        if not groups:  # the earlier design and this one agree on the first group
            a, first = votes.clone(), votes.clone()
            runs["earlier"](a, *args)
            runs["this"](first, *args)
            torch.cuda.synchronize()
            if not torch.equal(a, first):
                raise SystemExit(f"{tag}: the earlier K9 and this one differ on the first group")
        scratch = votes.clone()
        for name in FOLD_VARIANTS:
            per[name].append(device_ms(lambda name=name: runs[name](scratch, *args), 3)[0])
        groups.append(CS.fold_bound(G, Lt, n_rows, e_sub.shape[1], host_cols))
        out = real(votes, js, t_sub, e_sub, cols, host_cols, n_rows, Lt, G, B, load)
        if first is not None and not torch.equal(first, out):
            raise SystemExit(f"{tag}: K9 differs from the main path's fold on the first group")
        return out

    VP._fold_group = fold
    try:
        drive()
    finally:
        VP._fold_group = real
    bound = sum(b["bound_ms"] for b in groups)
    out = {"groups": len(groups), "bound_ms": bound, "first_bound_ms": groups[0]["bound_ms"],
           "first_ms": {n: v[0] for n, v in per.items()},
           "sum_ms": {n: sum(v) for n, v in per.items()}}
    print(f"[K9 {tag}] {card}: {len(groups)} groups; bound {bound:.4f} ms summed, the first "
          f"group {groups[0]['bound_ms']:.4f} ms; each launch alone, mean of 3: " + "; ".join(
              f"{n} {out['sum_ms'][n]:.3f} ms (first group {out['first_ms'][n]:.4f})"
              for n in FOLD_VARIANTS), flush=True)
    return out


def correction_run(dev, raw, genome, ecoli: bool):
    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io.fastx import write_fasta
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.configure import configure_resources
    from canu_tpu_torch.pipeline.driver import make_ctx

    work = tempfile.mkdtemp(prefix="k69_cor_")
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    cfg = Config()
    cfg.set("genomeSize", genome)
    if ecoli:  # phase 15's configuration of -pacbio-raw reads
        cfg.apply_read_type_profile()
        cfg.validate()
    ctx = make_ctx(work, "ecoli" if ecoli else "bench", cfg)
    if ecoli:
        configure_resources(cfg, ctx.log)
    return lambda: stages.correction_phase(ctx, [fasta], device=dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", required=True, help="an earlier commit, or a directory "
                    "holding an earlier checkout")
    ap.add_argument("--no-ecoli", action="store_true", help="skip phase 15's groups")
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fold_match_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    csrc = os.path.join(ROOT, "canu_tpu_torch", "csrc")
    with open(os.path.join(csrc, "vote_fold.cu")) as fh:
        new_fold = fh.read()
    with open(os.path.join(csrc, "minhash.cu")) as fh:
        new_mh = fh.read()
    old_fold = earlier_source(cli.earlier, "vote_fold.cu")
    old_mh = earlier_source(cli.earlier, "minhash.cu")
    # the earlier K9's split: pass 1 skipped (no rows walked, deletion
    # counts 0), its atomicAdds plain stores, both
    nopass1 = [(r"for \(int i = lo; i < hi; \+\+i\) \{", "for (int i = lo; i < lo; ++i) {"),
               (r"\? del_at\[i\] : 0;", "? 0 : 0;")]
    noatomic = [(r"atomicAdd\(([^;]*?), ((?:static_cast<float>\(d_cnt\) \* )?w)\);",
                 r"*(\1) = \2;")]
    t0 = time.time()
    libs = build_all({
        "this": (new_fold, []),
        **{name: (new_fold, [f"-DFOLD_TILE={t}", f"-DFOLD_WARPS={w}"])
           for name, (t, w) in THIS_SHAPES.items()},
        **{name: (replaced(new_fold, edits), []) for name, edits in THIS_SPLIT.items()},
        "earlier": (old_fold, []), "earlier_nopass1": (replaced(old_fold, nopass1), []),
        "earlier_noatomic": (replaced(old_fold, noatomic), []),
        "earlier_both": (replaced(old_fold, nopass1 + noatomic), []),
        "new_minhash": (new_mh, []), "old_minhash": (old_mh, []),
    })
    print(f"built {len(libs)} libraries in {time.time() - t0:.1f} s", flush=True)
    _nvcc.build(*(_nvcc.CSRC / f for f in ("myers_tile.cu", "banded_extend.cu", "vote_dp.cu",
                                            "minhash.cu", "verify.cu", "vote_fold.cu")))
    res = {"card": card, "earlier": cli.earlier}
    res["K6"] = k6_pairs(dev, card, libs)
    res["K9_phase10"] = fold_groups("phase 10", correction_run(dev, CS.bench_reads(),
                                                               CS.BENCH_GENOME, False), card, libs)
    if not cli.no_ecoli:
        res["K9_phase15"] = fold_groups("phase 15", correction_run(
            dev, CS.ecoli_reads(error_rate=0.10), CS.ECOLI_GENOME, True), card, libs)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "variants.json"), "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"wrote {os.path.join(OUT, 'variants.json')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
