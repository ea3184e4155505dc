"""Run canu_tpu_torch's overlap, correction, trimming and assembly paths,
the dag consensus, the tools and the sharded path once on one NVIDIA GPU
and check them.

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
              (c) K2 and K3's three outputs on edge cases at bands 128,
              256 (K2), 640 and 1024 (K3) and on 256 real extensions
              sampled from the first call of each utg drive of phase 7
  4 slice     meryl + overlap ("cor") stages on the bench.py read set
              (1,025 reads, 3.64 Mb) in a temporary directory; K1 must
              have launched and the plain loop must not have run on the
              card; the store must be non-empty, symmetric and equal to
              the JAX package's (cor_overlap_reference.json); every K1
              launch of the stage is captured with its inputs
  4b cor256   the same stages at corOvlBandWidth=256 (K2, partial
              overlaps, on reads whose extensions really fail), store
              equal to the JAX package's (the "cor256" entry) and its
              rows against the band-128 store's
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
              Every drive of the INF-walled engine keeps every
              banded_extend call it made (one per group of up to
              MYERS_GROUP chunks)
  8 timing    per drive (cor256 and utg256: K2; utg1024: K3): each
              extension's exit row by the plain recurrence
              (tests/torch_cases.py extend_exit_rows, the whole drive at
              once; the outputs at the exit row must be the end's), the
              kernel bit-equal to it on every call, each call with CUDA
              events and the drive's sum, beside the bounds of every live
              row and of the rows up to the exit rows; the first call's
              first 1,024 extensions (the shape of one call per chunk);
              the whole first call against banded_extend_plain
  9 ecoli     meryl + overlap ("obt", band 128) at E. coli scale: the
              JAX package's config 2, random_genome(4.6 Mb, seed=7) at 25x
              (32,994 corrected reads, 115.3 Mb), ovsMethod=spill: the
              host k-mer counter (115 M k=22 instances, above the device
              budget of 2^26), the hash-join (above 5,000 reads), K1 and
              the spill store with the native external sort, each counted
              (once each; K1 launched; no other kernel or plain loop on
              the card); frequent table and candidates equal to the JAX
              package's (ecoli_overlap_reference.json); the store's rows
              for a sample of 2,048 candidates equal to the JAX package's
              store of that sample; the spilled store equal to the in-RAM
              build of the tables the spill got; the store symmetric.
              Prints the stage's sub-walls, K1 on each launch (CUDA
              events) beside its bound, and the device memory peak over
              the verify beside _chunk_staging_bytes x the window
  10 correct  correction_phase (gatekeeper, meryl, overlap "cor", the
              falcon-sense vote engine) from a FASTA of the raw bench
              reads, Config() + genomeSize=300k, in a directory of its own:
              K1 must have launched and no other kernel or plain loop run
              on the card; the gatekeeper store's reads and bases, the cor
              store (cor_overlap_reference.json) and the corrected reads of
              every block that correction_reference.json covers (by
              digest) must equal the JAX package's; every corrected record
              is <read>_corrN.  Prints the stage walls, the correction's
              parts (selection, DP, windows + vote fold, finalize, fetch,
              decode), chunks and jobs, one chunk's launches and device
              busy share (torch.profiler; table in
              chiprun_out/profile_correct.txt) and the device memory peak
              over the correction.  The vote engine is PyTorch ops (the
              JAX package's is XLA, with no Pallas kernel): no kernel of
              its own, so no line in the kernel record
  11 assemble run_pipeline from a FASTA of simulated corrected reads (the
              bench shapes at 1.5% error), Config() + genomeSize, twice,
              each in a directory of its own with the counts set to 0
              first: trimming (obt gatekeeper, meryl, overlap, trimming),
              then assembly (utg gatekeeper, meryl, overlap, oea: RED on
              the vote engine and OEA's verify, unitig, consensus: the
              plurality polish, outputs: FASTA, layout.tsv, GFA with
              links re-aligned, HTML).  K1 must have launched in the obt
              overlap, the utg overlap, the OEA adjust and, where the GFA
              keeps a link, align_links; no other kernel and no plain loop
              on the card.  11a: random_genome(100 kb, seed=71) with three
              copies of a 9 kb repeat (cut from the bench's 300 kb so the
              JAX package's CPU reference finishes); the trimmed reads,
              utg store, RED corrections, adjusted erates, unitig and
              contig layouts, contigs/unassembled/unitigs FASTA,
              layout.tsv and the GFA's S and L lines must equal
              assembly_reference.json (scripts/torch_assembly_reference.py),
              with >= 2 contigs and their links re-aligned on K1 (none
              survives the polished ends' clipping, in canu_tpu too, so
              write_gfa then keeps test_gfa.py's surviving link on the
              card, K1 in align_links, its page equal to the CPU's).
              11b: the bench genome, nothing cut: >= 1 contig, every GFA
              L-line naming two S-lines, every layout.tsv read in the utg
              store.  In both, the largest contig's length, identity to
              the simulated genome and misjoins (tests/torch_cases.py
              identity_vs_genome: banded extensions at band 512 between
              exact 32-mer anchors every 5 kb, kernel K2) must equal the
              reference's; whether the identity reaches TRUTH_IDENTITY
              is printed, not gated.  Prints the stage walls, RED's and
              the adjust's walls, the vote chunks and DP time (CUDA
              events) of RED and the polish, K1 on each launch of the
              adjust beside its bound, the device memory peak over the
              assembly phase, the contigs, NG50 and identity.  Then
              python -m canu_tpu_torch on 11b's directory must skip every
              stage by resume and exit 0, and -options must list
              genomeSize
  12 dag      the tag-chain consensus (ops/dagcon.py: the paths on the
              vote engine's DP, PyTorch ops; the chain DP host numpy).
              12a: correction_phase with corConsensus=dag on a copy of
              phase 10's directory without its corrected reads (the
              gatekeeper, meryl and cor overlap stages resume), every
              block; the blocks dag_reference.json covers must equal the
              JAX package's by digest, every record <read>_corrN.  12b:
              run_pipeline with cnsConsensus=dag resumed on a copy of
              11a's directory without the consensus and output stages'
              products: only those two stages may run, and the layouts,
              the contigs/unassembled/unitigs FASTA, layout.tsv and the
              GFA must equal the JAX package's run of 11a with
              cnsConsensus=dag (scripts/torch_dag_reference.py).  No
              kernel and no plain loop on the card, but K1 in 12b's
              align_links.  Prints the walls, the path chunks, the DP by
              CUDA events, the host time of the tag chains and the device
              memory peak
  13 tools    canu_tpu_torch.tools.main in this process on the scripted
              session of tests/torch_cases.py tools_session (simulate at
              the bench shapes, analyze, sample, kmer-count at k=16 and
              k=22, kmer-op's ten ops, map-mers, mask-mers, mer-trim,
              mercy, ov-import of random overlaps, a PAF and a text
              dump, ov-stats, ov-dump, best-edges, dump-reads,
              dump-meta, options, bogus on the genome with 1% point
              errors, a misjoin and a 700-base collapse): every step's
              exit code, stdout, stderr and files must equal
              tools_reference.json (scripts/torch_tools_reference.py;
              the k=22 DB steps against canu_tpu's result on the DB as
              counted).  K1 must launch in bogus (the identity ruler) and
              nowhere else; each launch by CUDA events beside its bound,
              and held bit for bit to the plain loop on every one of its
              rows (k1_held_to_plain: K1's carry at every 4,096th row, the
              plain rows of all segments at once from those carries).
              tig-dump, tig-display and tig-coverage on 11b's tig store,
              and bogus on 11b's contigs, are printed, not gated
  14 grid     the sharded path (canu_tpu_torch.parallel) on the bench read
              set, nothing cut.  14a: a world of one rank over NCCL in
              this process (init_distributed with a FileStore): the cor
              gatekeeper, meryl and overlap stages with
              shardedCompute=true; the hash-range meryl's all_to_all must
              run on NCCL, K1 launch, no other kernel and no plain loop
              run on the card, and the frequent table, candidates and
              store equal cor_overlap_reference.json; the k=22 sharded
              count must equal the single-device counter;
              sharded_verify_candidates (K2, band 128) on every third
              candidate gives the rows 14b holds, held bit for bit to the
              same call with the plain loop in K2's place.  14b: two
              ranks on this one card over gloo (NCCL refuses two ranks on
              one card; one rank a card over NCCL on a machine of several),
              each a process of its own, started after phase 2 built the
              kernels, with jax and canu_tpu blocked as here:
              correction_phase from phase 10's FASTA (gatekeeper on rank 0,
              the hash-range meryl, the ring, a strided half of the verify
              on each rank, the a_id-range exchange into store shards that
              rank 0 merges, correction blocks strided over the ranks):
              the cor frequent table, candidates and store equal the
              reference, rank 0 corrects blocks 0, 2, 4, 6, 8 and rank 1
              blocks 1, 3, 5, 7, blocks 0, 3, 6, 8 equal
              correction_reference.json, every record <read>_corrN, K1
              on each rank, no plain loop on the card; the cor stages again
              under ovsShardExchange=allgather give the same store;
              sharded_verify_candidates' rows on two ranks equal the
              world of one's, K2 launched.  Each rank prints its stage
              walls, the collectives (calls, bytes, seconds), the DP by
              CUDA events, its launches and its device peak; the card's
              memory in use is sampled by nvidia-smi meanwhile; the
              ranks' logs are in chiprun_out/phase14_rank*.log

Each kernel's bound is the larger of its operations over the card's
32-bit integer rate and its bytes over the memory rate (INT32_OPS_S,
HBM_BYTES_S).  The operations are the least the function needs on this
run's data (K1_*_OPS, INF_*_OPS; k1_work and extend_bound count the live
rows, shifted rows, rows with b_len in the window and band cells up to
b_len; for K2 and K3 the rows up to each extension's exit row, after
which its outputs are fixed, and the kernels line gives their bound
under that count).  The bytes are each input the kernel needs read once
and each output written once.  The plain loops' own per-row counts
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
OLD_EXTEND_LANES = 2 * 512  # a K2/K3 launch of one chunk of 512 pairs, both ways
BENCH_GENOME = 300_000  # bench.py's genome (phases 4-8 and 10)
ECOLI_GENOME = 4_600_000  # phase 9's genome, the JAX package's config 2
ECOLI_SAMPLE = 2048  # candidates whose store rows phase 9 holds against the reference
# phase 11: the largest contig's identity to the simulated genome is held
# equal to the JAX package's (assembly_reference.json); the bar that
# tests/test_pipeline.py sets for the raw path is printed beside it, met
# or not (canu_tpu's own 11b contig misses it, ROADMAP §3(f))
TRUTH_IDENTITY = 0.999

# H100 SXM peaks at its 1.98 GHz boost clock and 700 W: 132 SMs x 64 INT32
# lanes (NVIDIA's Hopper white paper), and HBM3 at 3.35 TB/s
INT32_OPS_S = 132 * 64 * 1.98e9
HBM_BYTES_S = 3.35e12

# The least 32-bit integer operations of the kernels' work, the bound's
# count: a two-input operation, a not, a funnel shift, a popcount, a byte
# extract, a conditional move and a fused add-min (Hopper's DPX
# __viaddmin_s32, min(x + y, z)) count one each; loads and stores none.
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
INF_CELL_OPS = 4  # each band cell up to b_len of a live row: mismatch 1,
#   diagonal + it 1, m = min(up + 1, that) 1 add-min, the closure D =
#   min(left + 1, m) 1 add-min
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

    g = random_genome(BENCH_GENOME, seed=42)
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


def k1_held_to_plain(name: str, args, seg: int = 4096):
    """One K1 launch held to the plain rows, every one of them: K1 run on
    the launch's inputs to each seg-th row gives its carry there, the
    plain rows of every segment run at once from K1's carry at its start
    (torch_cases.k1_rows_plain), and each segment's end must equal K1's
    carry at the next start, the last the launch's own output; then the
    two finishes (edits, a_used, b_used, the partial captures).  Returns
    (max |diff| (0), the plain rows' ms by CUDA events, the segments)."""
    import torch

    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import k1_rows_plain

    planes, a, s_bits, b, a_len, b_len, n_run, cap_q = args
    T = -(-n_run // seg)
    starts = [planes] + [K1.myers_rows_cuda(planes, a, s_bits[: t * seg // MY.WORD].contiguous(),
                                            b, a_len, b_len, t * seg, cap_q) for t in range(1, T)]
    ends = starts[1:] + [K1.myers_rows_cuda(*args)]
    got, plain_ms = once_ms(lambda: k1_rows_plain(starts, a, s_bits, b, a_len, b_len, n_run,
                                                  cap_q, seg))
    err = 0
    for t in range(T):
        d = int((got[:, t].to(torch.int64) - ends[t].to(torch.int64)).abs().max())
        check(d == 0, f"{name}: K1's carry after row {min((t + 1) * seg, n_run)} differs from "
              f"the plain rows' (max |diff| {d})")
        err = max(err, d)

    def finish(p):
        return MY._myers_finish(MY._carry_unpack(p), a_len, b_len, MY.NW * MY.WORD)

    return max(err, compare(name, finish(got[:, -1]), finish(ends[-1]))), plain_ms, T


def time_k1(launches, reps: int = 5):
    """K1 with CUDA events on each (inputs, live rows) launch: ([ms],
    [bound])."""
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    ms, bounds = [], []
    for args, live in launches:
        ms.append(cuda_ms(lambda: K1.myers_rows_cuda(*args), reps))
        bounds.append(k1_bound(args, live))
    return ms, bounds


def extend_bound(args, band: int, n_rows: int, exit_rows=None) -> dict:
    """K2/K3's bound on one call: INF_ROW_OPS a live row and INF_CELL_OPS
    a band cell up to b_len of it; bytes = each live row's A char and
    centre, the B chars up to the last live row's band end, a_len, b_len
    and the three outputs.  A live row is one of rows 1..min(a_len,
    n_rows); with exit_rows (int64[B], -1 for none), only rows up to each
    extension's exit row, after which its outputs are fixed
    (torch_cases.extend_exit_rows)."""
    import torch

    from canu_tpu_torch.ops import align as AL

    a, a_len, b, b_len, centers = args
    live = torch.clamp(a_len.to(torch.int64), 0, n_rows)
    if exit_rows is not None:
        live = torch.where(exit_rows >= 0, torch.minimum(live, exit_rows), live)
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
    """Set every kernel's launch count, the plain loops' CUDA counts and the
    calls of the host k-mer counter, the hash-join and the spill build to 0."""
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.stores import overlaps as OV

    K1.LAUNCHES = EX.WARP_LAUNCHES = EX.BLOCK_LAUNCHES = 0
    MY.PLAIN_CUDA_SEGMENTS = AL.PLAIN_CUDA_ROWS = 0
    KM.HOST_COUNTS = MH.JOIN_CALLS = OV.SPILL_BUILDS = 0


def read_counts() -> dict:
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import extend_cuda as EX
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.stores import overlaps as OV

    return {"K1": K1.LAUNCHES, "K2": EX.WARP_LAUNCHES, "K3": EX.BLOCK_LAUNCHES,
            "plain_myers_segments": MY.PLAIN_CUDA_SEGMENTS,
            "plain_extend_rows": AL.PLAIN_CUDA_ROWS, "host_kmer_counts": KM.HOST_COUNTS,
            "join_calls": MH.JOIN_CALLS, "spill_builds": OV.SPILL_BUILDS}


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


def drive_stage(phase: str, tag: str, band: int, rs, dev, ref: dict, kernel: str):
    """meryl + overlap for `tag` at {tag}OvlBandWidth=band on the read set
    rs, in a directory of its own, with the launch counts set to 0
    just before and read just after.  Only `kernel` may have launched and
    no plain loop may have run on the card; the store must equal `ref`.
    Returns (stage record, every banded_extend call's (args, kwargs), the
    store)."""
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
    real_extend, calls = capture_calls(AL, "banded_extend")
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
    return rec, calls, st


def extend_edge_cases(band: int, dev):
    """The INF-walled extension's edge cases (tests/torch_cases.py, as the
    kernel tests use them): canu_tpu's x8 test pairs plus INF-range
    failures, o(0) > 0, empty A/B."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import edge_cases as cases

    args, n_rows = cases(band)
    return [torch.from_numpy(x).to(dev) for x in args], n_rows


def extend_kernel(band: int):
    """(name, wrapper) of the kernel that ops.align.banded_extend launches
    at this band: K2 up to 512, K3 above."""
    from canu_tpu_torch.ops.kernels import extend_cuda as EX

    if band in EX.WARP_BANDS:
        return "K2", EX.banded_extend_warp
    return "K3", EX.banded_extend_block


def check_extend_kernels(name: str, args, band: int, n_rows: int) -> int:
    """The band's kernel (K2 or K3) against the plain loop, bit for bit."""
    from canu_tpu_torch.ops import align as AL

    kname, fn = extend_kernel(band)
    return compare(f"{name} {kname}", AL.banded_extend_plain(*args, band, n_rows),
                   fn(*args, band, n_rows))


def extend_drive(name: str, calls, card: str, reps: int = 3) -> dict:
    """The band's kernel on every banded_extend call of one drive.

    Runs torch_cases.extend_exit_rows (banded_extend_plain's recurrence,
    every extension of the drive at once) for each extension's exit row
    and outputs; checks that no live row's smallest cell fell below the
    row before's, that the captures at the exit row are the outputs, and
    that the kernel gives those outputs on every call.  Then times each
    call with CUDA events beside its bound under both row counts (every
    live row; rows up to the exit row), the drive's sums, the first
    call's lanes 0..OLD_EXTEND_LANES (the shape of one call per chunk),
    and the whole first call against banded_extend_plain."""
    import torch

    from canu_tpu_torch.ops import align as AL

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import extend_exit_rows

    band, n_rows = calls[0][0][5:7]
    check(all(c[0][5:7] == (band, n_rows) for c in calls), f"{name}: calls differ in band or rows")
    kname, fn = extend_kernel(band)
    sizes = [c[0][0].shape[0] for c in calls]
    t = time.time()
    cat = [torch.cat([c[0][k] for c in calls]) for k in range(5)]
    exit_rows, at_exit, final, fell = extend_exit_rows(*cat, band, n_rows)
    del cat
    check(not bool(fell.any()), f"{name}: a live row's smallest cell fell below the row before's")
    ex = exit_rows >= 0
    for f, x, y in zip(("edits", "a_used", "b_used"), at_exit, final):
        check(torch.equal(x[ex], y[ex]), f"{name}: {f} at the exit row differs from the end's")
    live = torch.clamp(torch.cat([c[0][1] for c in calls]).to(torch.int64), 0, n_rows)
    after = int((live - exit_rows)[ex].sum())
    log(f"[8 exit] {name}: {int(ex.sum())} of {len(ex)} extensions have an exit row; the rows "
        f"after it are {after} of {int(live.sum())} live rows ({100 * after / max(1, int(live.sum())):.1f}%)"
        f"; outputs at the exit row equal the end's; plain recurrence {time.time() - t:.1f} s")
    per_call, lo = [], 0
    for ci, (call, B) in enumerate(zip(calls, sizes)):
        args = call[0][:5]
        sl = slice(lo, lo + B)
        lo += B
        compare(f"{name} call {ci + 1} {kname}", tuple(f[sl] for f in final),
                fn(*args, band, n_rows))
        ms = cuda_ms(lambda: fn(*args, band, n_rows), reps)
        full, bx = extend_bound(args, band, n_rows), extend_bound(args, band, n_rows, exit_rows[sl])
        per_call.append({"B": B, "ms": ms, "bound": full, "bound_exit": bx})
        log(f"[8 timing] {card}: {name} {kname} call {ci + 1}/{len(calls)}: {B} extensions: "
            f"{ms:.3f} ms; bound {full['bound_ms']:.4f} ms every live row "
            f"({100 * full['bound_ms'] / ms:.1f}%), {bx['bound_ms']:.4f} ms to the exit rows "
            f"({100 * bx['bound_ms'] / ms:.1f}%)")
    tot = sum(c["ms"] for c in per_call)
    tb = sum(c["bound"]["bound_ms"] for c in per_call)
    tx = sum(c["bound_exit"]["bound_ms"] for c in per_call)
    log(f"[8 timing] {card}: {kname} ms per {name} drive ({len(calls)} launches): {tot:.3f} ms; "
        f"bound {tb:.4f} ms every live row ({100 * tb / tot:.1f}%), {tx:.4f} ms to the exit "
        f"rows ({100 * tx / tot:.1f}%)")
    # the first call's lanes at the shape of one call per chunk
    args0 = calls[0][0][:5]
    n_old = min(OLD_EXTEND_LANES, sizes[0])
    old = tuple(x[:n_old] for x in args0)
    old_ms = cuda_ms(lambda: fn(*old, band, n_rows), 10)
    ob = extend_bound(old, band, n_rows)
    obx = extend_bound(old, band, n_rows, exit_rows[:n_old])
    log(f"[8 timing] {card}: {name} {kname} on the first call's first {n_old} extensions: "
        f"{old_ms:.3f} ms; bound {ob['bound_ms']:.4f} ms every live row "
        f"({100 * ob['bound_ms'] / old_ms:.1f}%), {obx['bound_ms']:.4f} ms to the exit rows "
        f"({100 * obx['bound_ms'] / old_ms:.1f}%)")
    ref, plain_ms = once_ms(lambda: AL.banded_extend_plain(*args0, band, n_rows))
    err = compare(f"{name} first call {kname}", ref, fn(*args0, band, n_rows))
    first = per_call[0]
    log(f"[8 timing] {card}: {name} first call ({sizes[0]} extensions, band {band}, "
        f"{min(n_rows, int(args0[1].max()))} rows): {kname} {first['ms']:.3f} ms vs plain loop "
        f"{plain_ms:.1f} ms, bit-equal")
    return {"kernel": kname, "band": band, "n_rows": n_rows, "calls": per_call,
            "ms_per_drive": tot, "bound_ms_per_drive": tb, "bound_exit_ms_per_drive": tx,
            "exit_rows": int(ex.sum()), "rows_after_exit": after, "live_rows": int(live.sum()),
            "old_shape": {"B": n_old, "ms": old_ms, "bound": ob, "bound_exit": obx},
            "first_ms": first["ms"], "plain_ms": plain_ms, "err": err,
            "first_bound_exit": first["bound_exit"]}


def ecoli_reads():
    """The E. coli-scale corrected read set (the JAX package's config 2,
    scripts/scale_run.py: 4.6 Mb at 25x)."""
    from canu_tpu_torch.sim.simulate import random_genome, simulate_reads

    g = random_genome(ECOLI_GENOME, seed=7)
    rs, _ = simulate_reads(g, coverage=25, mean_len=3500, min_len=1500, max_len=7800,
                           error_rate=0.03, seed=8)
    return rs


def ecoli_drive(dev, card: str) -> dict:
    """Phase 9: obt meryl + overlap on the E. coli-scale read set with
    ovsMethod=spill, in a directory of its own, the counts set to 0 just
    before and read just after.  The path must run the host k-mer counter,
    the hash-join and the spill build once each and K1, and no other kernel
    or plain loop on the card.  Holds the frequent table and candidates
    against ecoli_overlap_reference.json, the store's rows for a sample of
    2,048 candidates against the JAX package's store of that sample, the
    spilled store against the in-RAM build of the tables the spill got, and
    the store's symmetry.  Times K1 on each launch with CUDA events (its
    bound computed after the launch, as in phase 5), and reads the device
    memory peak over the verify beside _chunk_staging_bytes times the
    window _verify_window chose."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.ops import minhash as MH
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores import overlaps as OV

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import candidate_sample, store_rows_of_pairs

    with open(os.path.join(ROOT, "canu_tpu_torch", "ecoli_overlap_reference.json")) as fh:
        ref = json.load(fh)
    t_phase = t = time.time()
    rs = ecoli_reads()
    log(f"[9 ecoli] read set: {rs.n_reads} reads, {rs.total_bases} bases "
        f"(simulated in {time.time() - t:.1f} s)")
    check(rs.n_reads == ref["n_reads"] and rs.total_bases == ref["total_bases"],
          "E. coli read set differs from the reference's")
    work = tempfile.mkdtemp(prefix="chip_smoke_ecoli_")
    cfg = Config()
    cfg.set("genomeSize", ECOLI_GENOME)
    cfg.set("ovsMethod", "spill")
    ctx = make_ctx(work, "ecoli", cfg)

    # instrumentation, each undone below: K1's events and bounds, the
    # verify's memory peak and window, the candidates, the spill's tables
    k1 = {"events": [], "bounds": [], "peak": 0, "bound_s": 0.0}
    mem: dict = {"windows": []}
    pairs_seen, spilled, host_s = [], [], []
    real = {"k1": K1.myers_rows_cuda, "verify": AL.verify_overlaps,
            "window": AL._verify_window, "join": MH.find_candidates_join,
            "host": KM.count_readset_host, "append": OV.OverlapSpill.append}

    def k1_timed(*args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real["k1"](*args)
        e1.record()
        k1["events"].append((e0, e1))
        # the bound's own temporaries stay out of the verify's peak
        k1["peak"] = max(k1["peak"], torch.cuda.max_memory_allocated(dev))
        t0 = time.time()
        k1["bounds"].append(k1_bound(args, torch.clamp(args[4].to(torch.int64), 0, args[6])))
        k1["bound_s"] += time.time() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        return out

    depth = [0]

    def verify_measured(*args, **kw):
        if depth[0] == 0:  # the outer call (the palindromic pass recurses)
            torch.cuda.synchronize()
            mem["start"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            k1["peak"] = 0
        depth[0] += 1
        try:
            return real["verify"](*args, **kw)
        finally:
            depth[0] -= 1
            if depth[0] == 0:
                mem["peak"] = max(k1["peak"], torch.cuda.max_memory_allocated(dev))

    def window(*args):
        out = real["window"](*args)
        mem["windows"].append((args[:3], out))
        return out

    def host_timed(*args, **kw):
        t0 = time.time()
        out = real["host"](*args, **kw)
        host_s.append(time.time() - t0)
        return out

    def append(self, table):
        spilled.append(table)
        return real["append"](self, table)

    K1.myers_rows_cuda, AL.verify_overlaps, AL._verify_window = k1_timed, verify_measured, window
    MH.find_candidates_join = lambda *a, **kw: pairs_seen.append(real["join"](*a, **kw)) or \
        pairs_seen[-1]
    KM.count_readset_host, OV.OverlapSpill.append = host_timed, append
    try:
        reset_counts()
        t = time.time()
        fk = stages.meryl(ctx, "obt", rs, device=dev)
        t_meryl = time.time() - t
        st = stages.overlap(ctx, "obt", rs, fk, device=dev)
        torch.cuda.synchronize()
        t_stage = time.time() - t
        counts = read_counts()
    finally:
        K1.myers_rows_cuda, AL.verify_overlaps = real["k1"], real["verify"]
        AL._verify_window, MH.find_candidates_join = real["window"], real["join"]
        KM.count_readset_host, OV.OverlapSpill.append = real["host"], real["append"]
    prof = dict(AL.LAST_PROFILE)
    with open(ctx.path("ecoli.stage-times.jsonl")) as fh:
        sub = [json.loads(ln) for ln in fh if '"obt-overlap.sub"' in ln][-1]["sub_walls_s"]
    log(f"[9 ecoli] {card}: meryl {t_meryl:.2f} s (host k-mer count {sum(host_s):.2f} s); "
        f"meryl+overlap {t_stage:.2f} s; overlap sub-walls {sub} (sketch, match = the "
        f"hash-join, verify, store = spill sort + store write); verify profile {prof}")
    log(f"[9 ecoli] launch and call counts {counts}")
    check(counts["K1"] > 0, "9 ecoli: kernel K1 never launched during the stage")
    check(counts["K2"] == counts["K3"] == 0, "9 ecoli: kernel K2 or K3 launched off its path")
    check(counts["plain_myers_segments"] == 0 and counts["plain_extend_rows"] == 0,
          "9 ecoli: a plain loop ran on the card during the stage")
    for name in ("host_kmer_counts", "join_calls", "spill_builds"):
        check(counts[name] == 1, f"9 ecoli: {name} is {counts[name]}, expected 1")
    check(len(k1["events"]) == counts["K1"], "9 ecoli: K1 launches and timed calls differ")

    # the frequent table and the candidates equal the JAX package's
    fdig = frequent_digest(os.path.join(work, "trimming", "ecoli.ms22.frequent.npz"))
    (pairs,) = pairs_seen
    cdig = hashlib.sha256(np.ascontiguousarray(pairs.astype("<i8")).tobytes()).hexdigest()
    log(f"[9 ecoli] frequent sha256 {fdig}; {len(pairs)} candidates (reference "
        f"{ref['n_candidates']}), sha256 {cdig}")
    check(fdig == ref["frequent_sha256"], "9 ecoli: frequent-mer table differs from the JAX package's")
    check(len(pairs) == ref["n_candidates"] and cdig == ref["candidates_sha256"],
          "9 ecoli: candidates differ from the JAX package's")
    # the store: non-empty, symmetric, its rows for the sample the JAX
    # package's store of that sample, the spilled build the in-RAM one
    a, b = np.asarray(st.a_id).astype(np.int64), np.asarray(st.b_id).astype(np.int64)
    check(len(st) > 0, "9 ecoli: empty overlap store")
    check(np.array_equal(np.unique(a << 32 | b), np.unique(b << 32 | a)),
          "9 ecoli: overlap store is not symmetric")
    sample = candidate_sample(pairs, ECOLI_SAMPLE)
    sdig = hashlib.sha256(np.ascontiguousarray(sample.astype("<i8")).tobytes()).hexdigest()
    check(sdig == ref["sample"]["candidates_sha256"], "9 ecoli: the candidate sample differs")
    rows = store_rows_of_pairs(st, sample)
    rdig = OV.store_digest(rows)
    log(f"[9 ecoli] store rows {len(st)}; the rows of the {len(sample)} sampled candidates "
        f"{len(rows.a_id)} (reference {ref['sample']['rows']}), sha256 {rdig}")
    check(len(rows.a_id) == ref["sample"]["rows"] and rdig == ref["sample"]["store_sha256"],
          "9 ecoli: the sampled candidates' rows differ from the JAX package's store")
    cat = AL.OverlapTable(**{c: np.concatenate([getattr(x, c) for x in spilled])
                             for c in ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn",
                                       "b_end", "erate_q")})
    in_ram = OV.store_digest(OV.OverlapStore.build(cat, rs.n_reads))
    check(in_ram == OV.store_digest(st), "9 ecoli: the spilled store differs from the in-RAM build")
    log(f"[9 ecoli] store symmetric; sampled rows equal the JAX package's; the spilled store "
        f"equals the in-RAM build of the {len(spilled)} tables the spill got ({len(cat)} rows)")

    # K1 on every launch of the drive, by CUDA events, beside its bound
    k1_ms = [e0.elapsed_time(e1) for e0, e1 in k1["events"]]
    bd = k1["bounds"]
    tb = sum(x["bound_ms"] for x in bd)
    log(f"[9 timing] {card}: K1 per ecoli drive: {len(k1_ms)} launches, {sum(k1_ms):.3f} ms "
        f"(first {k1_ms[0]:.3f} ms, largest {max(k1_ms):.3f} ms); bound {tb:.3f} ms "
        f"({100 * tb / sum(k1_ms):.1f}% of it; {sum(x['ops'] for x in bd):.3e} operations, "
        f"{sum(x['bytes'] for x in bd):.3e} bytes, {sum(x['live_rows'] for x in bd)} live rows; "
        f"computed after each launch, {k1['bound_s']:.2f} s of the verify wall)")
    (w_args, (group, n_window)), *rest = mem["windows"]
    est = AL._chunk_staging_bytes(*w_args) * n_window
    log(f"[9 memory] {card}: verify device peak {mem['peak'] / 1e9:.3f} GB "
        f"(torch.cuda.max_memory_allocated; {(mem['peak'] - mem['start']) / 1e9:.3f} GB above "
        f"the {mem['start'] / 1e9:.3f} GB allocated at its start); _chunk_staging_bytes"
        f"{tuple(w_args)} x the window of {n_window} chunks = {est / 1e9:.3f} GB (groups of "
        f"{group}; {len(rest)} more window calls: {[w[1] for w in rest]})")
    log(f"[9 ecoli] phase wall {time.time() - t_phase:.1f} s")
    return {"meryl_s": t_meryl, "host_count_s": sum(host_s), "stage_s": t_stage,
            "sub_walls_s": sub, "verify_profile": prof, "rows": len(st),
            "n_candidates": len(pairs), "launches": counts, "k1_ms": k1_ms,
            "k1_ms_per_drive": sum(k1_ms), "k1_bounds": bd, "k1_bound_ms_per_drive": tb,
            "k1_bound_s": k1["bound_s"], "verify_peak_bytes": mem["peak"],
            "verify_start_bytes": mem["start"], "window": [list(w_args), group, n_window],
            "staging_estimate_bytes": est, "phase_s": time.time() - t_phase}


def correct_drive(dev, card: str) -> dict:
    """Phase 10: the port's correction_phase from a FASTA of the raw bench
    reads, Config() + genomeSize=300k, in a directory of its own, the
    counts set to 0 just before and read just after.  K1 must have launched
    (the cor overlap stage) and no other kernel and no plain loop on the
    card.  Holds the gatekeeper store, the cor store and each block of
    corrected reads that correction_reference.json covers against the JAX
    package's; the FASTA must be non-empty with every record
    <read>_corrN.  Prints the stage walls and the correction's parts:
    selection and decode on the host clock, the DP, the rest of each vote
    chunk (windows and fold) and the finalize by CUDA events, the fetch of
    the packed rows (host clock; it waits for the device); the chunks and
    jobs; one chunk under torch.profiler (its launches and the device busy
    share); the device memory peak over the correction."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io.fastx import read_fastx, write_fasta
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import OverlapStore, store_digest
    from canu_tpu_torch.stores.readset import ReadSet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import corrected_digest

    with open(os.path.join(ROOT, "canu_tpu_torch", "correction_reference.json")) as fh:
        ref = json.load(fh)
    with open(os.path.join(ROOT, "canu_tpu_torch", "cor_overlap_reference.json")) as fh:
        cor_ref = json.load(fh)
    t_phase = time.time()
    raw = bench_reads()
    work = tempfile.mkdtemp(prefix="chip_smoke_correct_")
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    cfg = Config()
    cfg.set("genomeSize", BENCH_GENOME)
    ctx = make_ctx(work, "bench", cfg)

    # instrumentation, each undone below: every block's reads as the phase
    # gets them, CUDA events around the DP, each vote chunk and each
    # finalize, the first chunk's inputs, the memory peak from the first
    # block on
    blocks: dict = {}
    ev: dict = {"dp": [], "chunk": [], "finalize": []}
    first_chunk: list = []
    mem: dict = {}
    real = {"blocks": F.correct_reads_blocks, "dp": VP.align_positions_lean,
            "chunk": VP._vote_many, "finalize": F._finalize_plurality}

    def timed(name):
        def call(*args, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = real[name](*args, **kw)
            e1.record()
            ev[name].append((e0, e1))
            return out
        return call

    def chunk(*args, **kw):
        if not first_chunk:
            first_chunk.append((args, kw))
        return chunk_timed(*args, **kw)

    def capture(*args, **kw):
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for bi, items in real["blocks"](*args, **kw):
            blocks[bi] = items
            yield bi, items
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated(dev)

    chunk_timed = timed("chunk")
    F.correct_reads_blocks, VP.align_positions_lean = capture, timed("dp")
    VP._vote_many, F._finalize_plurality = chunk, timed("finalize")
    try:
        reset_counts()
        F.PROFILE.clear()
        VP.CHUNKS = VP.JOBS = 0
        t = time.time()
        stages.correction_phase(ctx, [fasta], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        F.correct_reads_blocks, VP.align_positions_lean = real["blocks"], real["dp"]
        VP._vote_many, F._finalize_plurality = real["chunk"], real["finalize"]
    log(f"[10 correct] {card}: correction_phase from a FASTA of {raw.n_reads} reads: "
        f"{t_run:.2f} s; launch counts {counts}")
    check(counts["K1"] > 0, "10 correct: kernel K1 never launched during the phase")
    check(counts["K2"] == counts["K3"] == 0, "10 correct: kernel K2 or K3 launched off its path")
    check(counts["plain_myers_segments"] == 0 and counts["plain_extend_rows"] == 0,
          "10 correct: a plain loop ran on the card during the phase")

    # the gatekeeper store and the cor store equal the JAX package's
    d = os.path.join(work, "correction")
    rs = ReadSet.load(os.path.join(d, "bench.gkpStore"))
    st = OverlapStore.load(os.path.join(d, "bench.ovlStore"))
    sdig = store_digest(st)
    log(f"[10 correct] gatekeeper store {rs.n_reads} reads, {rs.total_bases} bases (reference "
        f"{ref['gatekeeper_reads']}, {ref['gatekeeper_bases']}); cor store {len(st)} rows, "
        f"sha256 {sdig}")
    check(rs.n_reads == ref["gatekeeper_reads"] and rs.total_bases == ref["gatekeeper_bases"],
          "10 correct: the gatekeeper store differs from the JAX package's")
    check(len(st) == cor_ref["rows"] and sdig == cor_ref["store_sha256"] == ref["cor_store_sha256"],
          "10 correct: the cor store differs from the JAX package's")
    # every reference block's corrected reads equal the JAX package's
    check(sorted(blocks) == list(range(ref["n_blocks"])),
          f"10 correct: blocks {sorted(blocks)}, the reference has {ref['n_blocks']}")
    for rb in ref["blocks"]:
        items = blocks[rb["index"]]
        dig = corrected_digest(items)
        log(f"[10 correct] block {rb['index']}: {len(items)} reads, "
            f"{sum(len(s) for _, s in items)} bases, sha256 {dig} (reference {rb['reads']}, "
            f"{rb['bases']}, {rb['sha256']})")
        check(dig == rb["sha256"], f"10 correct: block {rb['index']}'s corrected reads differ "
              "from the JAX package's")
    recs = list(read_fastx(os.path.join(d, "bench.correctedReads.fasta.gz")))
    names = {rs.name(i) for i in range(1, rs.n_reads + 1)}
    check(len(recs) > 0 and len(recs) == sum(len(v) for v in blocks.values()),
          "10 correct: the corrected FASTA is empty or misses reads")
    check(all(r.name.rsplit("_corr", 1)[0] in names and r.name.rsplit("_corr", 1)[1].isdigit()
              for r in recs), "10 correct: a corrected read is not named <read>_corrN")
    log(f"[10 correct] {len(recs)} corrected reads, {sum(len(r.seq) for r in recs)} bases in "
        f"{len(blocks)} blocks; blocks {ref['blocks_covered']} equal the JAX package's")

    # where the time went
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        walls = {r["stage"]: r["wall_s"] for r in map(json.loads, fh) if "wall_s" in r}
    dev_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in ev.items()}
    prof = dict(F.PROFILE)
    n_chunks, n_jobs = VP.CHUNKS, VP.JOBS
    parts = {"select_s": prof.get("select", 0.0), "dp_s": dev_s["dp"],
             "windows_and_fold_s": dev_s["chunk"] - dev_s["dp"],
             "finalize_s": dev_s["finalize"], "fetch_s": prof.get("fetch", 0.0),
             "decode_s": prof.get("decode", 0.0), "enqueue_votes_s": prof.get("votes", 0.0)}
    log(f"[10 timing] {card}: stage walls {walls}; correction parts " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f" (DP, windows+fold and finalize: CUDA "
        f"events; the rest host clock); {n_jobs} vote jobs in {n_chunks} chunks of "
        f"{VP.chunk_jobs(F.VOTE_SEG)}")

    # one chunk: its launches and the device's busy share
    args, kw = first_chunk[0]
    torch.cuda.synchronize()
    t = time.time()
    real["chunk"](*args, **kw)
    torch.cuda.synchronize()
    wall1 = time.time() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t = time.time()
        real["chunk"](*args, **kw)
        torch.cuda.synchronize()
        wall_p = time.time() - t
    cuda_ev = [e for e in p.key_averages()
               if getattr(getattr(e, "device_type", None), "name", "") == "CUDA"]
    launches = sum(e.count for e in cuda_ev)
    busy = sum(e.self_device_time_total for e in cuda_ev) / 1e6
    with open(os.path.join(OUT_DIR, "profile_correct.txt"), "w") as fh:
        fh.write(f"{card}\none vote chunk: wall {wall_p:.3f} s under the profiler, device busy "
                 f"{busy:.3f} s\n" + p.key_averages().table(sort_by="self_device_time_total",
                                                           row_limit=25) + "\n")
    log(f"[10 profile] {card}: one vote chunk: wall {wall1:.3f} s ({wall_p:.3f} s under the "
        f"profiler); {launches} device launches (kernels, copies and fills); device busy "
        f"{busy:.3f} s = {100 * busy / wall1:.1f}% of the chunk's wall "
        f"({100 * busy / wall_p:.1f}% under the profiler); table in "
        "chiprun_out/profile_correct.txt")
    log(f"[10 memory] {card}: device peak over the correction "
        f"{mem['peak'] / 1e9:.3f} GB ({(mem['peak'] - mem['start']) / 1e9:.3f} GB above the "
        f"{mem['start'] / 1e9:.3f} GB allocated at its start)")
    log(f"[10 correct] phase wall {time.time() - t_phase:.1f} s")
    return {"run_s": t_run, "stage_walls_s": walls, "parts_s": parts, "chunks": n_chunks,
            "jobs": n_jobs,
            "launches": counts, "chunk_wall_s": wall1, "chunk_wall_profiled_s": wall_p,
            "chunk_launches": launches, "chunk_busy_s": busy, "peak_bytes": mem["peak"],
            "start_bytes": mem["start"], "corrected_reads": len(recs), "work": work,
            "fasta": fasta, "phase_s": time.time() - t_phase}


def ng50(lengths, genome_size: int) -> int:
    """The contig length at which the longest contigs first reach half the
    genome size (0 when they never do)."""
    acc = 0
    for n in sorted(lengths, reverse=True):
        acc += n
        if acc >= genome_size / 2:
            return n
    return 0


def assemble_run(name: str, dev, card: str, genome_len: int, genome_seed: int, repeats,
                 ref: dict | None) -> dict:
    """One run of phase 11: run_pipeline from a FASTA of simulated corrected
    reads, Config() + genomeSize, in a directory of its own, the counts set
    to 0 just before and read just after.  K1 must have launched in the obt
    overlap, the utg overlap and the OEA adjust (and in align_links where
    the GFA keeps a link); no other kernel and no plain loop on the card.
    With ``ref`` every gate of assembly_digests must equal the JAX
    package's.  Returns the run's record (walls, launches, K1 in the
    adjust with its bound, memory peak, contigs, identity)."""
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io import gfa as GFA
    from canu_tpu_torch.io.fastx import read_fastx
    from canu_tpu_torch.ops import consensus as CNS
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops import oea as OEA
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import run_pipeline

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import assembly_digests, largest_contig_identity, write_assembly_reads

    tag = f"11{name}"
    t_phase = time.time()
    work = tempfile.mkdtemp(prefix=f"chip_smoke_assemble_{name}_")
    fasta = os.path.join(work, "reads.fasta")
    genome, n_reads, n_bases, fasta_sha = write_assembly_reads(fasta, genome_len, genome_seed,
                                                               repeats)
    log(f"[{tag} assemble] read set: random_genome({genome_len}, seed={genome_seed}, "
        f"repeat_spec={repeats}): {n_reads} corrected reads, {n_bases} bases, FASTA sha256 "
        f"{fasta_sha}")
    if ref is not None:
        check(fasta_sha == ref["input_fasta_sha256"],
              f"{tag}: the read set differs from the reference's")
    wd = os.path.join(work, "asm")
    cfg = Config()
    cfg.set("genomeSize", genome_len)

    # instrumentation, each undone below: K1 launches within each overlap
    # stage, RED, the OEA adjust and align_links; RED's corrections; the
    # vote chunks and the DP (CUDA events) of RED and the polish; every K1
    # launch of the adjust with its inputs; the memory peak over assembly
    k1_in: dict = {}
    chunks_in: dict = {}
    step_peak: dict = {}  # device bytes above each step's start, its peak
    dp_ev: dict = {"red": [], "polish": []}
    where = [None]
    mem: dict = {}
    n_links = [0]
    corr: dict = {}
    real = {"overlap": stages.overlap, "red": OEA.detect_read_errors,
            "adjust": OEA.adjust_overlap_erates, "polish": CNS.polish_tig,
            "links": GFA.align_links, "dp": VP.align_positions_lean,
            "assembly": stages.assembly_phase, "rows": MY._rows_kernel}
    adjust_calls: list = []

    def counted(key, fn):
        def call(*args, **kw):
            k0, c0, prev = K1.LAUNCHES, VP.CHUNKS, where[0]
            where[0] = key
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                step_peak[key] = max(step_peak.get(key, 0),
                                     torch.cuda.max_memory_allocated(dev) - m0)
                where[0] = prev
                k1_in[key] = k1_in.get(key, 0) + K1.LAUNCHES - k0
                chunks_in[key] = chunks_in.get(key, 0) + VP.CHUNKS - c0
        return call

    def overlap(ctx, tg, *args, **kw):
        return counted(f"{tg}-overlap", real["overlap"])(ctx, tg, *args, **kw)

    def red(*args, **kw):
        out = counted("red", real["red"])(*args, **kw)
        corr.update(out)
        return out

    def links(tigs, lk, *args, **kw):
        n_links[0] += len(lk)
        return counted("align_links", real["links"])(tigs, lk, *args, **kw)

    def dp(*args, **kw):
        if where[0] not in dp_ev:
            return real["dp"](*args, **kw)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real["dp"](*args, **kw)
        e1.record()
        dp_ev[where[0]].append((e0, e1))
        return out

    def rows(*args, **kw):
        if where[0] == "adjust":
            adjust_calls.append((args, kw))
        return real["rows"](*args, **kw)

    def assembly(*args, **kw):
        # the steps' peaks (each step resets the peak) and the phase's own
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        step_peak.clear()
        real["assembly"](*args, **kw)
        torch.cuda.synchronize()
        mem["peak"] = max([torch.cuda.max_memory_allocated(dev)]
                          + [mem["start"] + v for v in step_peak.values()])

    stages.overlap, stages.assembly_phase = overlap, assembly
    OEA.detect_read_errors, OEA.adjust_overlap_erates = red, counted("adjust", real["adjust"])
    CNS.polish_tig, GFA.align_links = counted("polish", real["polish"]), links
    VP.align_positions_lean, MY._rows_kernel = dp, rows
    try:
        reset_counts()
        t = time.time()
        run_pipeline(wd, "asm", cfg, corrected_reads=[fasta], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        stages.overlap, stages.assembly_phase = real["overlap"], real["assembly"]
        OEA.detect_read_errors, OEA.adjust_overlap_erates = real["red"], real["adjust"]
        CNS.polish_tig, GFA.align_links = real["polish"], real["links"]
        VP.align_positions_lean, MY._rows_kernel = real["dp"], real["rows"]
    log(f"[{tag} assemble] {card}: run_pipeline from corrected reads: {t_run:.2f} s; launch "
        f"counts {counts}; K1 launches by step {k1_in}")
    check(counts["K2"] == counts["K3"] == 0, f"{tag}: kernel K2 or K3 launched off its path")
    check(counts["plain_myers_segments"] == 0 and counts["plain_extend_rows"] == 0,
          f"{tag}: a plain loop ran on the card during the run")
    for step in ("obt-overlap", "utg-overlap", "adjust"):
        check(k1_in.get(step, 0) > 0, f"{tag}: kernel K1 never launched in {step}")
    if n_links[0]:
        check(k1_in.get("align_links", 0) > 0, f"{tag}: align_links never launched K1")
    check(os.path.exists(os.path.join(wd, "asm.contigs.fasta")), f"{tag}: no contigs FASTA")

    # where the time went
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        lines = [json.loads(ln) for ln in fh]
    walls = {r["stage"]: r["wall_s"] for r in lines if "wall_s" in r}
    oea_sub = [r for r in lines if r["stage"] == "oea.sub"][-1]
    dp_s = {k: sum(a.elapsed_time(b) for a, b in v) / 1e3 for k, v in dp_ev.items()}
    log(f"[{tag} timing] {card}: stage walls {walls}")
    log(f"[{tag} timing] {card}: oea.sub {oea_sub['sub_walls_s']} ({oea_sub['changed_reads']} "
        f"reads changed); RED {chunks_in.get('red', 0)} vote chunks, DP {dp_s['red']:.3f} s; "
        f"polish {chunks_in.get('polish', 0)} vote chunks, DP {dp_s['polish']:.3f} s (DP by "
        f"CUDA events)")
    # K1 in the OEA adjust: every launch with CUDA events beside its bound
    k1_launches = [k1_call(c) for c in adjust_calls]
    del adjust_calls
    k1_ms, k1_bounds = time_k1(k1_launches)
    del k1_launches
    for i, (ms, bd) in enumerate(zip(k1_ms, k1_bounds)):
        log(f"[{tag} timing] {card}: OEA adjust K1 launch {i + 1}/{len(k1_ms)}: {ms:.3f} ms; "
            f"bound {bd['bound_ms']:.3f} ms ({bd['ops']:.3e} operations, {bd['bytes']:.3e} "
            f"bytes; bound by {bd['bound_by']}; {100 * bd['bound_ms'] / ms:.1f}% of it)")
    log(f"[{tag} timing] {card}: OEA adjust K1 {len(k1_ms)} launches, {sum(k1_ms):.3f} ms; "
        f"bound {sum(b['bound_ms'] for b in k1_bounds):.3f} ms")
    log(f"[{tag} memory] {card}: device peak over the assembly phase "
        f"{mem['peak'] / 1e9:.3f} GB ({(mem['peak'] - mem['start']) / 1e9:.3f} GB above the "
        f"{mem['start'] / 1e9:.3f} GB allocated at its start); by step, above its start: "
        + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in step_peak.items()))

    # what came out
    contigs = list(read_fastx(os.path.join(wd, "asm.contigs.fasta")))
    lens = sorted((len(r.seq) for r in contigs), reverse=True)
    check(len(contigs) >= 1, f"{tag}: no contig")
    lc = largest_contig_identity(wd, "asm", genome, dev)
    ident, breaks = lc["identity"], lc["misjoins"]
    digests = assembly_digests(wd, "asm", corr)
    n_l = digests["gfa"]["l_lines"]
    log(f"[{tag} assemble] {len(contigs)} contigs, largest {lens[0]}, NG50 "
        f"{ng50(lens, genome_len)} (genome {genome_len}); largest contig's identity to the "
        f"simulated genome {ident:.6f} ({breaks} misjoins between its 5 kb anchors); "
        f"{digests['unassembled']['n']} unassembled; GFA "
        f"{digests['gfa']['n'] - n_l} S-lines, {n_l} L-lines ({n_links[0]} links re-aligned); "
        f"RED corrected {digests['red']['n']} bases in {len(corr)} reads")
    log(f"[{tag} assemble] truth: the largest contig's identity {ident:.6f} is "
        + ("at or above" if ident >= TRUTH_IDENTITY else "BELOW")
        + f" tests/test_pipeline.py's {TRUTH_IDENTITY} (reported, not gated)")
    if ref is not None:
        want = ref["largest_contig"]
        log(f"[{tag} assemble] largest contig {lc} (reference {want})")
        check(lc == want, f"{tag}: the largest contig's length, identity or misjoins differ "
                          "from the JAX package's")
        for key, want in ref["gates"].items():
            got = digests.get(key)
            log(f"[{tag} assemble] {key}: {got} (reference {want})")
            check(got == want, f"{tag}: {key} differs from the JAX package's")
        log(f"[{tag} assemble] every gate equals the JAX package's: "
            + ", ".join(ref["gates"]))
    log(f"[{tag} assemble] phase wall {time.time() - t_phase:.1f} s")
    return {"run_s": t_run, "stage_walls_s": walls, "oea_sub": oea_sub, "launches": counts,
            "k1_by_step": k1_in, "vote_chunks": chunks_in, "dp_s": dp_s,
            "adjust_k1_ms": k1_ms, "adjust_k1_bounds": k1_bounds, "peak_bytes": mem["peak"],
            "start_bytes": mem["start"], "step_peak_bytes": dict(step_peak), "contigs": lens,
            "ng50": ng50(lens, genome_len), "identity": ident, "misjoins": breaks,
            "truth_met": ident >= TRUTH_IDENTITY,
            "digests": digests, "links_aligned": n_links[0], "work": wd, "fasta": fasta,
            "genome_len": genome_len, "phase_s": time.time() - t_phase}


def gfa_link_check(dev) -> dict:
    """write_gfa with verify_edges on the card, on test_gfa.py's case where
    a link between tig end reads survives align_links (the assemble runs
    keep no L-line, in canu_tpu too: ROADMAP §3(g)): K1 must launch in
    align_links, at least one L-line must survive, and the page must equal
    the port's on the CPU (the plain loop; tests/test_torch_gfa.py holds
    that to canu_tpu's)."""
    import torch

    import canu_tpu_torch.io.gfa as GFA
    import canu_tpu_torch.ops.align as AL
    import canu_tpu_torch.stores.overlaps as OV
    import canu_tpu_torch.stores.tigs as TG
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import GFA_STORE_ROWS, gfa_cases, gfa_store, gfa_tigs

    seqs, _ = gfa_cases()[0]
    pages, launches = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gfa_") as tmp:
        for d in (dev, torch.device("cpu")):
            k0 = K1.LAUNCHES
            path = os.path.join(tmp, f"{d.type}.gfa")
            GFA.write_gfa(path, gfa_tigs(TG, seqs), None, store=gfa_store(AL, OV, GFA_STORE_ROWS, 40),
                          verify_edges=True, device=d)
            launches[d.type] = K1.LAUNCHES - k0
            with open(path) as fh:
                pages[d.type] = fh.read()
    n_l = pages["cuda"].count("\nL\t")
    log(f"[11 gfa] write_gfa(verify_edges=True) on the card: {n_l} L-lines kept, "
        f"{launches['cuda']} K1 launches in align_links; page equals the CPU's: "
        f"{pages['cuda'] == pages['cpu']}")
    check(launches["cuda"] > 0, "11 gfa: align_links launched no K1 on the card")
    check(n_l >= 1, "11 gfa: no L-line survived the re-alignment")
    check(pages["cuda"] == pages["cpu"], "11 gfa: the card's GFA differs from the CPU's")
    return {"l_lines": n_l, "k1_launches": launches["cuda"]}


def assemble_drive(dev, card: str) -> dict:
    """Phase 11: run_pipeline from corrected reads to contigs, twice, each
    run's every gate held against its entry of assembly_reference.json.
    11a: the reduced genome with planted repeats, at
    least 2 contigs, and links between them re-aligned by align_links on
    K1; then gfa_link_check.  11b: the bench genome at full size, held
    also by well-formed outputs.  Then python -m canu_tpu_torch on 11b's
    directory, where every stage must skip by resume, and -options."""
    import numpy as np

    from canu_tpu_torch.stores.overlaps import OverlapStore

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import ASSEMBLY_RUNS

    with open(os.path.join(ROOT, "canu_tpu_torch", "assembly_reference.json")) as fh:
        ref = json.load(fh)
    check(all(ref[r]["genome"] == ASSEMBLY_RUNS[r][0] for r in ASSEMBLY_RUNS),
          "11: the references are of other genome sizes")
    check(ASSEMBLY_RUNS["b"][:2] == (BENCH_GENOME, 42), "11b is not the bench genome")
    a = assemble_run("a", dev, card, *ASSEMBLY_RUNS["a"], ref["a"])
    check(len(a["contigs"]) >= 2, "11a: the repeats did not break the assembly into contigs")
    # the links between contig ends go through align_links and K1; none
    # re-aligns on the polished contigs (PERF.md §6), in canu_tpu too:
    # the GFA gate above holds the L-lines to the reference's
    check(a["links_aligned"] >= 1 and a["k1_by_step"].get("align_links", 0) > 0,
          "11a: the GFA found no link between contigs, or align_links never launched K1")
    gfa = gfa_link_check(dev)

    b = assemble_run("b", dev, card, *ASSEMBLY_RUNS["b"], ref["b"])
    wd = b["work"]
    with open(os.path.join(wd, "asm.contigs.gfa")) as fh:
        gl = [ln.split("\t") for ln in fh.read().splitlines()]
    s_names = {f[1] for f in gl if f[0] == "S"}
    check(all(f[1] in s_names and f[3] in s_names for f in gl if f[0] == "L"),
          "11b: a GFA L-line names a segment that is not an S-line")
    st = OverlapStore.load(os.path.join(wd, "unitigging", "asm.ovlStore"))
    with open(os.path.join(wd, "asm.layout.tsv")) as fh:
        ids = np.array([int(ln.split("\t")[1]) for ln in fh.read().splitlines()], np.int64)
    check(len(ids) > 0 and ids.min() >= 1 and ids.max() <= st.n_reads,
          "11b: a layout.tsv read id is not in the utg store")
    log(f"[11b assemble] GFA: {len(s_names)} S-lines, every L-line names two of them; "
        f"layout.tsv: {len(ids)} placements of reads 1..{st.n_reads} of the utg store")

    # the CLI on 11b's directory: every stage skips by resume
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        n_lines = len(fh.readlines())
    t = time.time()
    r = subprocess.run([sys.executable, "-m", "canu_tpu_torch", "-p", "asm", "-d", wd,
                        f"genomeSize={BENCH_GENOME}", "-corrected", b["fasta"]],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    t_cli = time.time() - t
    out = r.stdout + r.stderr
    skipped = out.count("already done, skipping") + out.count("phase complete, skipping")
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        n_after = len(fh.readlines())
    log(f"[11 cli] python -m canu_tpu_torch on 11b's directory: rc {r.returncode} in "
        f"{t_cli:.1f} s; {skipped} skips; stage starts {out.count(': start (attempt')}")
    check(r.returncode == 0, f"11 cli: exit {r.returncode}: {out[-2000:]}")
    check(": start (attempt" not in out and n_after == n_lines and skipped > 0,
          "11 cli: a stage ran again on a finished directory")
    r = subprocess.run([sys.executable, "-m", "canu_tpu_torch", "-options"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    check(r.returncode == 0 and "genomeSize" in r.stdout, "11 cli: -options lacks genomeSize")
    log("[11 cli] -options lists genomeSize")
    return {"a": a, "b": b, "gfa": gfa, "cli_s": t_cli}


def dag_correct(dev, card: str, correct: dict, ref: dict) -> dict:
    """Phase 12a: correction_phase with corConsensus=dag on a copy of phase
    10's directory without its corrected reads, so the gatekeeper, meryl
    and cor overlap stages resume as done and every block runs through
    the tag-chain consensus; the counts set to 0 just before and read
    just after.  No kernel and no plain loop may run on the card (the
    paths are the vote engine's DP, PyTorch ops, counted by
    dagcon.CHUNKS).  The blocks dag_reference.json covers must equal the
    JAX package's by digest; every record is <read>_corrN."""
    import shutil

    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io.fastx import read_fastx
    from canu_tpu_torch.ops import dagcon as DG
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.readset import ReadSet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import corrected_digest

    t_phase = time.time()
    work = tempfile.mkdtemp(prefix="chip_smoke_dag_correct_")
    shutil.copytree(os.path.join(correct["work"], "correction"), os.path.join(work, "correction"))
    d = os.path.join(work, "correction")
    out = os.path.join(d, "bench.correctedReads.fasta.gz")
    os.remove(out)
    shutil.rmtree(os.path.join(d, "blocks"), ignore_errors=True)
    cfg = Config()
    cfg.set("genomeSize", BENCH_GENOME)
    cfg.set("corConsensus", "dag")
    ctx = make_ctx(work, "bench", cfg)

    blocks: dict = {}
    dp_ev: list = []
    mem: dict = {}
    real = {"blocks": F.correct_reads_blocks, "dp": DG.align_positions_lean}

    def capture(*args, **kw):
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for bi, items in real["blocks"](*args, **kw):
            blocks[bi] = items
            yield bi, items
        torch.cuda.synchronize()
        mem["peak"] = torch.cuda.max_memory_allocated(dev)

    def dp(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real["dp"](*args, **kw)
        e1.record()
        dp_ev.append((e0, e1))
        return res

    F.correct_reads_blocks, DG.align_positions_lean = capture, dp
    try:
        reset_counts()
        DG.PROFILE.clear()
        DG.CHUNKS = DG.JOBS = 0
        t = time.time()
        stages.correction_phase(ctx, [correct["fasta"]], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
    finally:
        F.correct_reads_blocks, DG.align_positions_lean = real["blocks"], real["dp"]
    n_chunks, n_jobs = DG.CHUNKS, DG.JOBS
    log(f"[12a dag correct] {card}: correction_phase with corConsensus=dag on phase 10's "
        f"stores: {t_run:.2f} s; launch counts {counts}")
    check(all(v == 0 for k, v in counts.items() if k in ("K1", "K2", "K3")),
          "12a: a kernel launched during the dag correction (the stages before it resume)")
    check(counts["plain_myers_segments"] == 0 and counts["plain_extend_rows"] == 0,
          "12a: a plain loop ran on the card during the dag correction")
    check(n_chunks > 0, "12a: the dag consensus ran no path chunk")
    check(sorted(blocks) == list(range(ref["n_blocks"])),
          f"12a: blocks {sorted(blocks)}, the reference's phase has {ref['n_blocks']}")
    for rb in ref["blocks"]:
        items = blocks[rb["index"]]
        dig = corrected_digest(items)
        log(f"[12a dag correct] block {rb['index']}: {len(items)} reads, "
            f"{sum(len(x) for _, x in items)} bases, sha256 {dig} (reference {rb['reads']}, "
            f"{rb['bases']}, {rb['sha256']})")
        check(dig == rb["sha256"], f"12a: block {rb['index']}'s dag-corrected reads differ from "
              "the JAX package's")
    rs = ReadSet.load(os.path.join(d, "bench.gkpStore"))
    names = {rs.name(i) for i in range(1, rs.n_reads + 1)}
    recs = list(read_fastx(out))
    check(len(recs) > 0 and len(recs) == sum(len(v) for v in blocks.values()),
          "12a: the corrected FASTA is empty or misses reads")
    check(all(r.name.rsplit("_corr", 1)[0] in names and r.name.rsplit("_corr", 1)[1].isdigit()
              for r in recs), "12a: a corrected read is not named <read>_corrN")
    with open(ctx.path("bench.stage-times.jsonl")) as fh:
        walls = {r["stage"]: r["wall_s"] for r in map(json.loads, fh) if "wall_s" in r}
    dp_s = sum(a.elapsed_time(b) for a, b in dp_ev) / 1e3
    prof = {k: round(v, 3) for k, v in DG.PROFILE.items()}
    log(f"[12a timing] {card}: stage walls {walls}; {n_jobs} path jobs in {n_chunks} chunks of "
        f"{DG.votepile.chunk_jobs(F.VOTE_SEG)}; DP {dp_s:.3f} s (CUDA events); host parts "
        f"{prof} (dagcon.PROFILE: paths, enqueue and fetch, waiting for the device; tags and "
        f"chain, the tags and the tag-chain DP of every segment); {len(recs)} reads, "
        f"{sum(len(r.seq) for r in recs)} bases in {len(blocks)} blocks; blocks "
        f"{ref['blocks_covered']} equal the JAX package's")
    log(f"[12a memory] {card}: device peak over the dag correction {mem['peak'] / 1e9:.3f} GB "
        f"({(mem['peak'] - mem['start']) / 1e9:.3f} GB above its start)")
    return {"run_s": t_run, "stage_walls_s": walls, "launches": counts, "chunks": n_chunks,
            "jobs": n_jobs, "dp_s": dp_s, "host_s": prof, "peak_bytes": mem["peak"],
            "start_bytes": mem["start"], "corrected_reads": len(recs),
            "phase_s": time.time() - t_phase}


def dag_polish(dev, card: str, run_a: dict, ref: dict) -> dict:
    """Phase 12b: run_pipeline with cnsConsensus=dag resumed on a copy of
    11a's directory without the consensus and output stages' products:
    only those two stages may run (the stage-times lines and the log say
    which ran).  K1 may launch only in the GFA's align_links; no other
    kernel and no plain loop on the card.  Every gate of
    dag_reference.json's polish entry (the JAX package's run of 11a with
    cnsConsensus=dag) must be equal."""
    import shutil

    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.io import gfa as GFA
    from canu_tpu_torch.ops import dagcon as DG
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.pipeline.driver import run_pipeline

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import assembly_digests

    t_phase = time.time()
    wd = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dag_polish_"), "asm")
    shutil.copytree(run_a["work"], wd)
    ctg = os.path.join(wd, "unitigging", "asm.ctgStore")
    removed = [f for f in os.listdir(ctg) if f.startswith("v002")]
    removed += [f for f in ("asm.contigs.fasta", "asm.unassembled.fasta", "asm.unitigs.fasta",
                            "asm.layout.tsv", "asm.contigs.gfa") if os.path.exists(
                                os.path.join(wd, f))]
    for f in removed:
        os.remove(os.path.join(ctg if f.startswith("v002") else wd, f))
    check(len(removed) == 7, f"12b: 11a's directory lacks a consensus or output product: "
          f"{removed}")
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        n_lines = len(fh.readlines())
    cfg = Config()
    cfg.set("genomeSize", run_a["genome_len"])
    cfg.set("cnsConsensus", "dag")

    dp_ev: list = []
    mem: dict = {}
    k1_links = [0]
    real = {"dp": DG.align_positions_lean, "links": GFA.align_links}

    def dp(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real["dp"](*args, **kw)
        e1.record()
        dp_ev.append((e0, e1))
        return res

    def links(*args, **kw):
        k0 = K1.LAUNCHES
        try:
            return real["links"](*args, **kw)
        finally:
            k1_links[0] += K1.LAUNCHES - k0

    DG.align_positions_lean, GFA.align_links = dp, links
    try:
        reset_counts()
        DG.CHUNKS = DG.JOBS = 0
        DG.PROFILE.clear()
        torch.cuda.synchronize()
        mem["start"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.time()
        run_pipeline(wd, "asm", cfg, corrected_reads=[run_a["fasta"]], device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        mem["peak"] = torch.cuda.max_memory_allocated(dev)
        counts = read_counts()
    finally:
        DG.align_positions_lean, GFA.align_links = real["dp"], real["links"]
    with open(os.path.join(wd, "asm.stage-times.jsonl")) as fh:
        new = [json.loads(ln) for ln in fh.readlines()[n_lines:]]
    ran = [r["stage"] for r in new if "wall_s" in r]
    log(f"[12b dag polish] {card}: run_pipeline with cnsConsensus=dag resumed on 11a's "
        f"directory: {t_run:.2f} s; stages run {ran}; launch counts {counts}, K1 in "
        f"align_links {k1_links[0]}")
    check(ran == ["consensus", "outputs"], f"12b: the resume ran {ran}, not the consensus and "
          "the outputs alone")
    check(counts["K1"] == k1_links[0] and counts["K2"] == counts["K3"] == 0,
          "12b: a kernel launched off align_links during the dag polish")
    check(counts["plain_myers_segments"] == 0 and counts["plain_extend_rows"] == 0,
          "12b: a plain loop ran on the card during the dag polish")
    check(DG.CHUNKS > 0, "12b: the dag consensus ran no path chunk")
    digests = assembly_digests(wd, "asm")
    for key, want in ref["gates"].items():
        got = digests.get(key)
        log(f"[12b dag polish] {key}: {got} (reference {want})")
        check(got == want, f"12b: {key} differs from the JAX package's dag run of 11a")
    walls = {r["stage"]: r["wall_s"] for r in new if "wall_s" in r}
    dp_s = sum(a.elapsed_time(b) for a, b in dp_ev) / 1e3
    prof = {k: round(v, 3) for k, v in DG.PROFILE.items()}
    log(f"[12b timing] {card}: stage walls {walls}; {DG.JOBS} path jobs in {DG.CHUNKS} chunks; "
        f"DP {dp_s:.3f} s (CUDA events); host {prof} (dagcon.PROFILE, as in 12a); every gate "
        f"equals the JAX package's: " + ", ".join(ref["gates"]))
    log(f"[12b memory] {card}: device peak over the resumed run {mem['peak'] / 1e9:.3f} GB "
        f"({(mem['peak'] - mem['start']) / 1e9:.3f} GB above its start)")
    return {"run_s": t_run, "stages_run": ran, "stage_walls_s": walls, "launches": counts,
            "k1_align_links": k1_links[0], "chunks": DG.CHUNKS, "jobs": DG.JOBS, "dp_s": dp_s,
            "host_s": prof, "peak_bytes": mem["peak"], "start_bytes": mem["start"],
            "digests": digests, "phase_s": time.time() - t_phase}


def dag_drive(dev, card: str, correct: dict, assemble: dict) -> dict:
    """Phase 12: the tag-chain consensus, for correction (12a) and for the
    polish (12b), held against dag_reference.json."""
    with open(os.path.join(ROOT, "canu_tpu_torch", "dag_reference.json")) as fh:
        ref = json.load(fh)
    return {"correct": dag_correct(dev, card, correct, ref["correction"]),
            "polish": dag_polish(dev, card, assemble["a"], ref["polish"])}


def tools_drive(dev, card: str, run_b: dict) -> dict:
    """Phase 13: canu_tpu_torch.tools.main in this process on the scripted
    session of tests/torch_cases.py tools_session (the bench genome's
    size), the counts set to 0 just before and read just after each step:
    every step's exit code, stdout, stderr and files must equal
    tools_reference.json; K1 must launch in bogus and nowhere else, no
    other kernel and no plain loop on the card.  Prints bogus's verdict,
    each K1 launch of it by CUDA events beside its bound (k1_bound), then
    tig-dump, tig-display and tig-coverage on 11b's tig store and bogus
    on 11b's contigs against its genome (printed, not gated)."""
    import contextlib

    import torch

    from canu_tpu_torch.io.fastx import write_fasta
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import myers_cuda as K1
    from canu_tpu_torch.sim.simulate import random_genome
    from canu_tpu_torch.stores.readset import ReadSet
    from canu_tpu_torch.tools.__main__ import main as tools_main
    from canu_tpu_torch.utils.bitpack import codes_to_seq

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import TOOLS_DB22_STEPS, TOOLS_GENOME, run_tools_session, tools_run

    with open(os.path.join(ROOT, "canu_tpu_torch", "tools_reference.json")) as fh:
        ref = json.load(fh)
    check(ref["genome"] == TOOLS_GENOME, "13: the reference is of another genome size")
    t_phase = time.time()
    work = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    per_step: dict = {}
    bogus_calls: list = []
    real_rows = MY._rows_kernel

    def rows(*args, **kw):
        bogus_calls.append((args, kw))
        return real_rows(*args, **kw)

    @contextlib.contextmanager
    def counted(name):
        reset_counts()
        MY._rows_kernel = rows if name == "bogus" else real_rows
        try:
            yield
        finally:
            torch.cuda.synchronize()
            MY._rows_kernel = real_rows
            per_step[name] = read_counts()

    t = time.time()
    recs, secs, outs = run_tools_session(work, TOOLS_GENOME, tools_main, ReadSet, counted,
                                         device=dev)
    t_run = time.time() - t
    n_bad = 0
    for name, rec in recs.items():
        want = ref["steps"][name]
        same = rec == want
        n_bad += not same
        log(f"[13 tools] {name}: rc {rec['rc']}, {secs[name]:.2f} s, "
            f"{len(rec['files'])} files; " + ("equal to the JAX package's" if same else
                                             f"DIFFERS: {rec} against {want}")
            + (" (its k=22 DB as saved: canu_tpu's in-memory result)"
               if name in TOOLS_DB22_STEPS else ""))
    check(n_bad == 0, f"13: {n_bad} tools steps differ from the JAX package's")
    k1_steps = {n: c["K1"] for n, c in per_step.items() if c["K1"]}
    others = {n: c for n, c in per_step.items()
              if c["K2"] or c["K3"] or c["plain_myers_segments"] or c["plain_extend_rows"]}
    log(f"[13 tools] {card}: {len(recs)} steps in {t_run:.1f} s, every one equal to the JAX "
        f"package's; K1 launches by step {k1_steps}")
    check(k1_steps.get("bogus", 0) > 0 and set(k1_steps) == {"bogus"},
          "13: K1 did not launch in bogus, or launched in another step")
    check(not others, f"13: another kernel or a plain loop ran on the card: {others}")
    log("[13 tools] bogus: " + outs["bogus"].splitlines()[0])
    k1_launches = [k1_call(c) for c in bogus_calls]
    del bogus_calls
    k1_ms, k1_bounds = time_k1(k1_launches)
    k1_err, k1_plain_ms = 0, []
    for i, ((args, live), ms, bd) in enumerate(zip(k1_launches, k1_ms, k1_bounds)):
        log(f"[13 timing] {card}: bogus K1 launch {i + 1}/{len(k1_ms)}: {args[1].shape[0]} "
            f"pieces x {args[6]} rows: {ms:.3f} ms; bound {bd['bound_ms']:.3f} ms "
            f"({bd['ops']:.3e} operations: {bd['live_rows']} live rows, {bd['shift_rows']} "
            f"shifted, {bd['bx_rows']} with b_len in the window; {bd['bytes']:.3e} bytes; "
            f"bound by {bd['bound_by']}; {100 * bd['bound_ms'] / ms:.1f}% of it)")
        t = time.time()
        err, plain_ms, n_seg = k1_held_to_plain(f"13 bogus K1 launch {i + 1}", args)
        k1_err = max(k1_err, err)
        k1_plain_ms.append(plain_ms)
        log(f"[13 kernel] {card}: bogus K1 launch {i + 1}: every one of its {args[6]} rows held "
            f"to the plain loop, in {n_seg} segments of 4,096 rows run at once from K1's carry "
            f"at each segment start: every carry, edits, a_used and b_used bit-equal (max |diff| "
            f"{err}); plain rows {plain_ms:.1f} ms (CUDA events) vs K1 {ms:.3f} ms; "
            f"{time.time() - t:.1f} s with K1's {n_seg} launches to the segment starts")
    del k1_launches

    # 11b's tig store and contigs: printed, not gated
    ctg = os.path.join(run_b["work"], "unitigging", "asm.ctgStore")
    for argv in (["tig-dump", ctg, "sizes"], ["tig-display", ctg, "1"],
                 ["tig-coverage", ctg]):
        rc, out, err = tools_run(tools_main, argv, device=dev)
        log(f"[13 tools] {' '.join(argv[:1] + argv[2:])} on 11b's tig store: rc {rc}; "
            f"{(out + err).strip()[:600]}")
    genome = os.path.join(work, "bench_genome.fasta")
    write_fasta(genome, [("genome", codes_to_seq(random_genome(BENCH_GENOME, seed=42)))])
    k0 = K1.LAUNCHES
    t = time.time()
    rc, out, err = tools_run(tools_main, ["bogus", "-genome", genome, "-assembly",
                                          os.path.join(run_b["work"], "asm.contigs.fasta"),
                                          "-circular", "-verbose"], device=dev)
    torch.cuda.synchronize()
    k1_11b = K1.LAUNCHES - k0
    log(f"[13 tools] bogus on 11b's contigs against the bench genome (not gated): rc {rc} in "
        f"{time.time() - t:.1f} s, K1 {k1_11b} launches; {out.strip()[:800]}")
    return {"run_s": t_run, "step_s": secs, "k1_by_step": k1_steps, "k1_ms": k1_ms,
            "k1_bounds": k1_bounds, "k1_err": k1_err, "k1_plain_ms": k1_plain_ms,
            "bogus": outs["bogus"], "bogus_11b": out,
            "k1_launches": sum(k1_steps.values()) + k1_11b, "phase_s": time.time() - t_phase}


def capture_results(module, name: str):
    """Wrap module.<name> so each call's result is kept in the returned
    list; the caller restores the original afterwards."""
    real = getattr(module, name)
    seen: list = []

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        seen.append(out)
        return out

    setattr(module, name, wrapper)
    return real, seen


def stage_walls():
    """Wrap stages.run_stage to time each stage this process runs (host
    clock, barriers included): returns (real run_stage, {stage: seconds})."""
    from canu_tpu_torch.pipeline import stages

    real, walls = stages.run_stage, {}

    def timed_stage(ctx, name, done, fn, **kw):
        t = time.time()
        try:
            return real(ctx, name, done, fn, **kw)
        finally:
            walls[name] = walls.get(name, 0.0) + time.time() - t

    stages.run_stage = timed_stage
    return real, walls


def collective_stats() -> dict:
    """parallel.launch.STATS as {collective: {calls, bytes, s}}."""
    from canu_tpu_torch.parallel import launch

    return {k: {"calls": v[0], "bytes": v[1], "s": v[2]} for k, v in launch.STATS.items()}


def grid_world_of_one(dev, card: str, fasta: str, ref: dict, work: str) -> dict:
    """Phase 14a: a world of one rank over NCCL on this card
    (parallel.launch.init_distributed with a FileStore), the cor
    gatekeeper, meryl and overlap stages with shardedCompute=true, the
    counts set to 0 just before and read just after: the hash-range
    meryl's all_to_all on NCCL, the ring (one step), K1 in the verify and
    no other kernel, no plain loop on the card; the frequent table,
    candidates and store equal cor_overlap_reference.json.  Then the k=22
    sharded count against the single-device counter, and one
    sharded_verify_candidates (K2 at band 128) on every third candidate,
    held bit for bit to the same call with the plain INF-walled loop in
    K2's place (ops.align.banded_extend_plain on the card, on the same
    inputs), whose rows 14b's ranks must give too (saved to
    work/sample.npz)."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import kmer as KM
    from canu_tpu_torch.parallel import launch
    from canu_tpu_torch.parallel import shard_overlap as SO
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx

    t_phase = time.time()
    got = launch.init_distributed("file://" + os.path.join(work, "store14a"), 1, 0, device=dev)
    check(got == (0, 1) and launch.backend() == "nccl",
          f"14a: the world of one did not join over NCCL: {got}, {launch.backend()}")
    cfg = Config()
    cfg.set("genomeSize", "300k")
    cfg.set("shardedCompute", "true")
    ctx = make_ctx(os.path.join(work, "one"), "bench", cfg)
    real_ring, rings = capture_results(SO, "sharded_find_candidates")
    real_stage, walls = stage_walls()
    try:
        reset_counts()
        launch.STATS.clear()
        t = time.time()
        rs = stages.gatekeeper(ctx, "cor", [fasta])
        fk = stages.meryl(ctx, "cor", rs, device=dev)
        meryl_stats = collective_stats()
        st = stages.overlap(ctx, "cor", rs, fk, device=dev)
        torch.cuda.synchronize()
        t_run = time.time() - t
        counts = read_counts()
        stats = collective_stats()
    finally:
        SO.sharded_find_candidates, stages.run_stage = real_ring, real_stage
    prof = dict(AL.LAST_PROFILE)
    log(f"[14a grid] {card}: a world of one over {launch.backend()}: gatekeeper + meryl + "
        f"overlap (cor, shardedCompute=true) {t_run:.2f} s; stage walls "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; launch counts {counts}; collectives {stats}")
    check(meryl_stats.get("all_to_all", {}).get("calls", 0) >= 1,
          "14a: the sharded meryl never ran its all_to_all on NCCL")
    check(len(rings) == 1, "14a: the overlap stage never ran the ring")
    check(counts["K1"] > 0, "14a: kernel K1 never launched during the stages")
    check(counts["K2"] == counts["K3"] == 0, "14a: kernel K2 or K3 launched off its path")
    check(counts["plain_myers_segments"] == 0 and counts["plain_extend_rows"] == 0,
          "14a: a plain loop ran on the card during the stages")
    fdig = frequent_digest(os.path.join(ctx.work_dir, "correction", "bench.ms16.frequent.npz"))
    check_store("14a grid", st, prof, fdig, ref)
    pairs = rings[0]

    # the two-lane sharded count against the single-device counter
    t = time.time()
    kc22 = SO.sharded_count_readset(rs, k=22, device=dev)
    t22 = time.time() - t
    one = KM.count_readset_device(rs, k=22, device=dev).to_host()
    order = np.argsort(one.unique, kind="stable")
    check(np.array_equal(kc22.unique, one.unique[order])
          and np.array_equal(kc22.counts, one.counts[order]),
          "14a: the k=22 sharded count differs from the single-device counter")
    log(f"[14a grid] sharded k=22 count: {len(kc22.unique)} distinct k-mers, {t22:.2f} s, "
        "equal to the single-device counter")

    # the INF-walled sharded verify in a world of one: the rows 14b holds
    sample = np.ascontiguousarray(pairs[::3, :2])
    reset_counts()
    rows, verify_ms = once_ms(lambda: SO.sharded_verify_candidates(rs, sample, k=16, band=128,
                                                                   device=dev))
    k2 = read_counts()["K2"]
    check(k2 > 0, "14a: sharded_verify_candidates never launched K2")
    # the same call with the plain loop in K2's place (not counted)
    real_extend, AL.banded_extend = AL.banded_extend, AL.banded_extend_plain
    try:
        plain, plain_ms = once_ms(lambda: SO.sharded_verify_candidates(rs, sample, k=16,
                                                                       band=128, device=dev))
    finally:
        AL.banded_extend = real_extend
    check(plain.shape == rows.shape == (len(sample), 13),
          f"14a: sharded verify rows {rows.shape}, plain {plain.shape}")
    k2_err = int(np.abs(rows.astype(np.int64) - plain.astype(np.int64)).max(initial=0))
    check(k2_err == 0, f"14a: the sharded verify's rows on K2 differ from the plain loop's "
          f"(max |diff| {k2_err})")
    np.savez(os.path.join(work, "sample.npz"), pairs=sample, rows=rows, all_pairs=pairs)
    log(f"[14a grid] sharded_verify_candidates on {len(sample)} of the {len(pairs)} "
        f"candidates: {verify_ms:.1f} ms (CUDA events), K2 launches {k2}; the plain loop in "
        f"its place {plain_ms:.1f} ms, rows equal (max |diff| {k2_err}, tolerance 0)")
    launch.shutdown()
    return {"run_s": t_run, "stage_walls_s": walls, "launches": counts, "collectives": stats,
            "k22_distinct": len(kc22.unique), "k22_s": t22, "sample": len(sample),
            "verify_ms": verify_ms, "verify_plain_ms": plain_ms, "k2_err": k2_err,
            "k2_launches": k2, "phase_s": time.time() - t_phase}


def grid_rank(rank: str, world: str, url: str, work: str, fasta: str, backend: str) -> int:
    """Phase 14b, one rank (a process of its own, jax and canu_tpu blocked):
    joins the world over ``backend`` on card rank % cards (cuda:0 for
    every rank of a one-card machine), runs correction_phase from the FASTA
    (Config() + genomeSize=300k) in work/range, then the cor meryl and
    overlap stages under ovsShardExchange=allgather in work/allgather,
    then sharded_verify_candidates on 14a's sample; writes what it saw to
    work/rank<r>.json."""
    import numpy as np
    import torch

    from canu_tpu_torch.config import Config
    from canu_tpu_torch.ops import falcon as F
    from canu_tpu_torch.ops import votepile as VP
    from canu_tpu_torch.parallel import launch
    from canu_tpu_torch.parallel import shard_overlap as SO
    from canu_tpu_torch.pipeline import stages
    from canu_tpu_torch.pipeline.driver import make_ctx
    from canu_tpu_torch.stores.overlaps import OverlapStore, store_digest
    from canu_tpu_torch.stores.readset import ReadSet

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_cases import corrected_digest

    r, n = int(rank), int(world)
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // n))
    dev = torch.device("cuda", r % torch.cuda.device_count())
    t = time.time()
    got = launch.init_distributed(url, n, r, backend=backend, device=dev)
    check(got == (r, n), f"14b rank {r}: joined as {got}")
    out: dict = {"rank": r, "join_s": time.time() - t}
    log(f"[14b rank {r}] joined a world of {n} over {launch.backend()} on {dev} in "
        f"{out['join_s']:.2f} s")

    # correction_phase: blocks this rank corrected, the DP by CUDA events,
    # the memory peak, the stage walls and the collectives
    blocks: dict = {}
    dp: list = []
    real = {"blocks": F.correct_reads_blocks, "dp": VP.align_positions_lean,
            "ring": SO.sharded_find_candidates}

    def capture(*args, **kw):
        for bi, items in real["blocks"](*args, **kw):
            blocks[bi] = items
            yield bi, items

    def timed_dp(*args, **kw):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        res = real["dp"](*args, **kw)
        e1.record()
        dp.append((e0, e1))
        return res

    cfg = Config()
    cfg.set("genomeSize", BENCH_GENOME)
    ctx = make_ctx(os.path.join(work, "range"), "bench", cfg)
    F.correct_reads_blocks, VP.align_positions_lean = capture, timed_dp
    real_ring, rings = capture_results(SO, "sharded_find_candidates")
    real_stage, walls = stage_walls()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        launch.STATS.clear()
        t = time.time()
        stages.correction_phase(ctx, [fasta], device=dev)
        torch.cuda.synchronize()
        out["correction_phase_s"] = time.time() - t
        out["launches"] = read_counts()
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["collectives"] = collective_stats()
    finally:
        F.correct_reads_blocks, VP.align_positions_lean = real["blocks"], real["dp"]
        SO.sharded_find_candidates, stages.run_stage = real["ring"], real_stage
    out["stage_walls_s"] = walls
    out["dp_s"] = sum(a.elapsed_time(b) for a, b in dp) / 1e3
    out["blocks"] = {bi: {"reads": len(items), "bases": sum(len(s) for _, s in items),
                          "sha256": corrected_digest(items)} for bi, items in blocks.items()}
    d = os.path.join(ctx.work_dir, "correction")
    st = OverlapStore.load(os.path.join(d, "bench.ovlStore"))
    out["store"] = {"rows": len(st), "sha256": store_digest(st),
                    "frequent_sha256": frequent_digest(os.path.join(d, "bench.ms16.frequent.npz"))}
    sample = np.load(os.path.join(work, "sample.npz"))
    check(len(rings) == 1 and np.array_equal(rings[0], sample["all_pairs"]),
          f"14b rank {r}: the ring's candidates differ from the world of one's")
    out["n_candidates"] = len(rings[0])
    if r == 0:
        from canu_tpu_torch.io.fastx import read_fastx

        rs0 = ReadSet.load(os.path.join(d, "bench.gkpStore"))
        names = {rs0.name(i) for i in range(1, rs0.n_reads + 1)}
        recs = list(read_fastx(os.path.join(d, "bench.correctedReads.fasta.gz")))
        out["corrected_reads"] = len(recs)
        out["names_ok"] = all(x.name.rsplit("_corr", 1)[0] in names
                              and x.name.rsplit("_corr", 1)[1].isdigit() for x in recs)
    log(f"[14b rank {r}] correction_phase {out['correction_phase_s']:.2f} s; stage walls "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; DP {out['dp_s']:.3f} s (CUDA events); blocks {sorted(blocks)}; launch counts "
        f"{out['launches']}; device peak {out['peak_bytes'] / 1e9:.3f} GB "
        f"(this process); collectives {out['collectives']}")

    # the cor overlap stage again, every rank holding the whole table
    rs = ReadSet.load(os.path.join(d, "bench.gkpStore"))
    cfg2 = Config()
    cfg2.set("genomeSize", BENCH_GENOME)
    cfg2.set("ovsShardExchange", "allgather")
    ctx2 = make_ctx(os.path.join(work, "allgather"), "bench", cfg2)
    reset_counts()
    t = time.time()
    st2 = stages.overlap(ctx2, "cor", rs, stages.meryl(ctx2, "cor", rs, device=dev), device=dev)
    torch.cuda.synchronize()
    out["allgather"] = {"stage_s": time.time() - t, "launches": read_counts(), "rows": len(st2),
                        "sha256": store_digest(st2)}
    log(f"[14b rank {r}] meryl + overlap under ovsShardExchange=allgather "
        f"{out['allgather']['stage_s']:.2f} s; launch counts {out['allgather']['launches']}")

    # the INF-walled sharded verify on 14a's sample
    reset_counts()
    launch.barrier("verify")
    rows, ms = once_ms(lambda: SO.sharded_verify_candidates(rs, sample["pairs"], k=16, band=128,
                                                            device=dev))
    out["verify"] = {"ms": ms, "launches": read_counts(),
                     "equal": bool(np.array_equal(rows, sample["rows"]))}
    log(f"[14b rank {r}] sharded_verify_candidates on {len(sample['pairs'])} pairs: "
        f"{ms:.1f} ms (CUDA events, its half and the gather); launch counts "
        f"{out['verify']['launches']}; rows equal to the world of one's: {out['verify']['equal']}")
    launch.shutdown()
    with open(os.path.join(work, f"rank{r}.json"), "w") as fh:
        json.dump(out, fh, default=str)
    return 0


# a 14b rank: jax and the JAX package blocked, as main() blocks them
GRID_RANK = ('import sys; sys.modules["jax"] = None; sys.modules["canu_tpu"] = None; '
             'sys.path.insert(0, sys.argv[1]); import chip_smoke; '
             'sys.exit(chip_smoke.grid_rank(*sys.argv[2:]))')


def card_memory_used_mb():
    """The memory in use on every card together (nvidia-smi), MB; None if
    it cannot say."""
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=10)
        return sum(float(x) for x in q.stdout.split()) if q.returncode == 0 else None
    except (OSError, ValueError, subprocess.TimeoutExpired):
        return None


def grid_drive(dev, card: str, correct: dict) -> dict:
    """Phase 14: the sharded path (canu_tpu_torch.parallel).  14a: a world of
    one rank over NCCL in this process (grid_world_of_one).  14b: one rank
    a card over NCCL on a machine of several cards, else two ranks on the
    one card over gloo (NCCL refuses two ranks on one card), each a process
    of its own started after the kernels were built (grid_rank):
    correction_phase from phase 10's FASTA, the gatekeeper
    writer-only, the hash-range meryl, the ring, each rank verifying a
    strided half of the candidates, the a_id-range exchange into store
    shards merged by rank 0 (save_from_row_shards), the correction blocks
    strided over the ranks.  Gates: the cor frequent table, candidates and
    store equal cor_overlap_reference.json; rank r corrects blocks r,
    r + n, ... (two ranks: 0, 2, 4, 6, 8 and 1, 3, 5, 7), blocks 0, 3, 6, 8 equal
    correction_reference.json; every record <read>_corrN; K1 on each rank;
    no plain loop on the card; the allgather exchange's store equal too;
    sharded_verify_candidates' rows on both ranks equal the world of
    one's, with K2 launched.  The cards' memory in use is sampled
    (nvidia-smi) while the ranks run."""
    import threading

    import torch

    with open(os.path.join(ROOT, "canu_tpu_torch", "cor_overlap_reference.json")) as fh:
        ref = json.load(fh)
    with open(os.path.join(ROOT, "canu_tpu_torch", "correction_reference.json")) as fh:
        cref = json.load(fh)
    t_phase = time.time()
    cards = torch.cuda.device_count()
    n, backend = (cards, "nccl") if cards > 1 else (2, "gloo")
    work = tempfile.mkdtemp(prefix="chip_smoke_grid_")
    one = grid_world_of_one(dev, card, correct["fasta"], ref, work)

    url = "file://" + os.path.join(work, "store14b")
    logs = [os.path.join(OUT_DIR, f"phase14_rank{r}.log") for r in range(n)]
    os.makedirs(OUT_DIR, exist_ok=True)
    samples: list = []
    stop = threading.Event()

    def sample_memory():
        while not stop.is_set():
            samples.append(card_memory_used_mb())
            stop.wait(1.0)

    sampler = threading.Thread(target=sample_memory, daemon=True)
    t = time.time()
    files = [open(p, "w") for p in logs]
    procs = [subprocess.Popen([sys.executable, "-c", GRID_RANK, ROOT, str(r), str(n), url, work,
                               correct["fasta"], backend], stdout=files[r],
                              stderr=subprocess.STDOUT, cwd=ROOT) for r in range(n)]
    sampler.start()
    rcs = []
    try:
        deadline = time.time() + 900
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0, deadline - time.time())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        stop.set()
        sampler.join()
        for f in files:
            f.close()
    wall = time.time() - t
    for r, p in enumerate(logs):
        with open(p) as fh:
            for line in fh:
                if line.startswith("[14b") or "FAILED" in line or "Error" in line:
                    log(line.rstrip())
    check(all(rc == 0 for rc in rcs), f"14b: a rank failed or timed out (exit codes {rcs}); "
          f"its log is in chiprun_out/phase14_rank*.log")
    ranks = []
    for r in range(n):
        with open(os.path.join(work, f"rank{r}.json")) as fh:
            ranks.append(json.load(fh))
    mem = [s for s in samples if s is not None]
    log(f"[14b grid] {card}: {n} ranks over {backend} on "
        f"{min(n, torch.cuda.device_count())} card(s): {wall:.1f} s from the spawn to "
        f"every rank's exit; correction_phase {[round(x['correction_phase_s'], 2) for x in ranks]} s "
        f"(phase 10, one rank: {correct['run_s']:.2f} s); DP "
        f"{[round(x['dp_s'], 3) for x in ranks]} s; per-process device peaks "
        f"{[round(x['peak_bytes'] / 1e9, 3) for x in ranks]} GB; the cards' memory in use "
        f"(nvidia-smi, {len(mem)} samples) peaked at {max(mem) if mem else 'not measured'} MB")

    for x in ranks:
        r = x["rank"]
        c = x["launches"]
        check(c["K1"] > 0, f"14b: kernel K1 never launched on rank {r}")
        check(c["plain_myers_segments"] == 0 and c["plain_extend_rows"] == 0,
              f"14b: a plain loop ran on the card on rank {r}")
        c = x["allgather"]["launches"]
        check(c["K1"] > 0 and c["plain_myers_segments"] == 0 and c["plain_extend_rows"] == 0,
              f"14b: rank {r}'s allgather stage missed K1 or ran a plain loop")
        check(x["store"]["sha256"] == ref["store_sha256"] and x["store"]["rows"] == ref["rows"],
              f"14b: the range exchange's cor store differs from the JAX package's (rank {r})")
        check(x["store"]["frequent_sha256"] == ref["frequent_sha256"],
              "14b: the frequent-mer table differs from the JAX package's")
        check(x["n_candidates"] == ref["n_candidates"], "14b: the candidate count differs")
        check(x["allgather"]["sha256"] == ref["store_sha256"],
              f"14b: the allgather exchange's store differs from the JAX package's (rank {r})")
        v = x["verify"]
        check(v["equal"] and v["launches"]["K2"] > 0 and v["launches"]["plain_extend_rows"] == 0,
              f"14b: sharded_verify_candidates on rank {r} differs from the world of one's "
              "or missed K2")
        check(sorted(int(b) for b in x["blocks"]) == list(range(r, cref["n_blocks"], n)),
              f"14b: rank {r} corrected blocks {sorted(x['blocks'])}")
    blocks = {int(b): v for x in ranks for b, v in x["blocks"].items()}
    for rb in cref["blocks"]:
        got = blocks[rb["index"]]
        log(f"[14b grid] block {rb['index']} (rank {rb['index'] % n}): {got['reads']} reads, "
            f"{got['bases']} bases, sha256 {got['sha256']} (reference {rb['sha256']})")
        check(got["sha256"] == rb["sha256"], f"14b: block {rb['index']}'s corrected reads differ "
              "from the JAX package's")
    check(ranks[0]["names_ok"] and ranks[0]["corrected_reads"]
          == sum(v["reads"] for v in blocks.values()),
          "14b: the corrected FASTA misses reads or a record is not <read>_corrN")
    log(f"[14b grid] the cor store (range and allgather exchanges), the frequent table and "
        f"{ref['n_candidates']} candidates equal the JAX package's; blocks "
        f"{[b['index'] for b in cref['blocks']]} equal; {ranks[0]['corrected_reads']} corrected "
        f"reads; K1 launches {[x['launches']['K1'] for x in ranks]}")
    log(f"[14 grid] phase wall {time.time() - t_phase:.1f} s")
    return {"a": one, "b": ranks, "n": n, "backend": backend, "b_wall_s": wall,
            "card_memory_mb": mem,
            "k1_launches": one["launches"]["K1"] + sum(
                x["launches"]["K1"] + x["allgather"]["launches"]["K1"] for x in ranks),
            "k2_launches": one["k2_launches"] + sum(x["verify"]["launches"]["K2"]
                                                    for x in ranks),
            "phase_s": time.time() - t_phase}


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
    for band in (128, 256, 640, 1024):
        e_args, e_rows = extend_edge_cases(band, dev)
        err_ext = max(err_ext, check_extend_kernels(f"extend edge cases, band {band}",
                                                    e_args, band, e_rows))
        log(f"[3c kernel] band {band}: {extend_kernel(band)[0]} bit-equal to the plain loop on "
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

    # ---- 4b: the cor stage at corOvlBandWidth=256 (K2, with partial overlaps,
    # on reads whose extensions really fail) -----------------------------------
    cor256, cor256_calls, st256 = drive_stage("4b cor256", "cor", 256, rs, dev,
                                                  ref["cor256"], "K2")

    def row_set(store):
        cols = [np.asarray(getattr(store, c)).tolist() for c in
                ("a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")]
        return set(zip(*cols))

    r128, r256 = row_set(st), row_set(st256)
    cor256["rows_only_band128"], cor256["rows_only_band256"] = len(r128 - r256), len(r256 - r128)
    log(f"[4b cor256] against the band-128 cor store: {len(r128 - r256)} rows only at band "
        f"128, {len(r256 - r128)} only at band 256, {len(r128 & r256)} in both")
    del r128, r256, st256

    # ---- 6, 7: the corrected-read stages -----------------------------------
    with open(os.path.join(ROOT, "canu_tpu_torch", "corrected_overlap_reference.json")) as fh:
        cref = json.load(fh)
    t = time.time()
    crs = bench_reads(error_rate=0.03, seed=44)
    log(f"[6 obt] corrected read set: {crs.n_reads} reads, {crs.total_bases} bases "
        f"(simulated in {time.time() - t:.1f} s)")
    check(crs.n_reads == cref["n_reads"] and crs.total_bases == cref["total_bases"],
          "corrected read set differs from the reference's")
    drives, calls = {}, {}
    drives["obt"] = drive_stage("6 obt", "obt", 128, crs, dev, cref["obt"], "K1")[0]
    for name, band, kname in (("utg256", 256, "K2"), ("utg1024", 1024, "K3")):
        drives[name], calls[name], _ = drive_stage(f"7 {name}", "utg", band, crs, dev,
                                                       cref[name], kname)
    record["corrected"] = drives
    drives["cor256"] = cor256
    calls["cor256"] = cor256_calls

    # ---- 3c: K2 and K3 vs plain on real extensions of each drive's first call
    for name in ("utg256", "utg1024"):
        check(len(calls[name]) > 0, f"the {name} stage never called banded_extend")
        x_args, (x_band, x_rows) = calls[name][0][0][:5], calls[name][0][0][5:7]
        XB = x_args[0].shape[0]
        pick = torch.arange(0, XB, max(1, XB // 256), device=dev)
        err_ext = max(err_ext, check_extend_kernels(
            f"{name} first call sample", tuple(x[pick] for x in x_args), x_band, x_rows))
        log(f"[3c kernel] {len(pick)} of the {XB} extensions of the {name} stage's first "
            f"banded_extend call (band {x_band}, {x_rows} rows) bit-equal in "
            f"{extend_kernel(x_band)[0]}")

    # ---- 8: K2 and K3 on every call of their drives, and the plain loop -----
    ext = {}
    for name in ("cor256", "utg256", "utg1024"):
        ext[name] = extend_drive(name, calls[name], card)
        err_ext = max(err_ext, ext[name]["err"])
    del calls
    log(f"[8 timing] {card}: stage walls (meryl+overlap) "
        + ", ".join(f"{n} {d['stage_s']:.2f} s" for n, d in drives.items()))
    record["extend"] = ext

    # ---- 9: the E. coli-scale obt path -------------------------------------
    record["ecoli"] = ecoli = ecoli_drive(dev, card)

    # ---- 10: read correction from a FASTA ----------------------------------
    record["correct"] = correct = correct_drive(dev, card)

    # ---- 11: trimming and assembly, corrected reads to contigs ---------------
    record["assemble"] = assemble = assemble_drive(dev, card)

    # ---- 12: the tag-chain (dag) consensus, correction and polish ----------
    record["dag"] = dag_drive(dev, card, correct, assemble)

    # ---- 13: the tools CLI ---------------------------------------------------
    record["tools"] = tools = tools_drive(dev, card, assemble["b"])

    # ---- 14: the sharded path: a world of one over NCCL, two ranks over gloo
    record["grid"] = grid = grid_drive(dev, card, correct)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    check(all(sys.modules.get(m) is None for m in ("jax", "canu_tpu")),
          "jax or canu_tpu was imported")

    src = "canu_tpu_torch/csrc/banded_extend.cu"
    k2, k3 = ext["utg256"], ext["utg1024"]
    k2b, k3b = k2["first_bound_exit"], k3["first_bound_exit"]
    print(json.dumps({"kernels": [
        {"name": "myers_rows (K1)", "route": "cuda",
         "source": "canu_tpu_torch/csrc/myers_tile.cu",
         "replaces": "canu_tpu/ops/pallas/myers_pallas.py:77",
         "launches": launches + drives["obt"]["launches"]["K1"] + ecoli["launches"]["K1"]
         + correct["launches"]["K1"] + assemble["a"]["launches"]["K1"]
         + assemble["b"]["launches"]["K1"] + record["dag"]["polish"]["launches"]["K1"]
         + tools["k1_launches"] + grid["k1_launches"],
         "max_abs_err": max(err, tools["k1_err"]),
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bd1["bound_ms"],
         "bound_by": bd1["bound_by"], "library_ms": None},
        {"name": "extend_warp (K2)", "route": "cuda", "source": src,
         "replaces": "canu_tpu/ops/pallas/extend_x8.py:72",
         "launches": drives["utg256"]["launches"]["K2"] + grid["k2_launches"],
         "max_abs_err": max(err_ext, grid["a"]["k2_err"]),
         "ms": k2["first_ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2b["bound_ms"], "bound_by": k2b["bound_by"], "library_ms": None},
        {"name": "extend_block (K3)", "route": "cuda", "source": src,
         "replaces": "canu_tpu/ops/pallas/extend.py:79",
         "launches": drives["utg1024"]["launches"]["K3"], "max_abs_err": err_ext,
         "ms": k3["first_ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3b["bound_ms"], "bound_by": k3b["bound_by"], "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
