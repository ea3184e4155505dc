"""K7 and K8 against an earlier csrc/verify.cu on one card, and K7's split
by variants that skip one step.

    python3 scripts/torch_verify_variants.py --earlier FILE

FILE is an earlier verify.cu with the same canu_verify_pre interface and
the (words, B, W, lengths, k, s, t, pm, scratch, cap, mker, mpos, mstr,
n_sel, stream) canu_syncmer of a block (for example the block-by-block design:
git show 9e0fbf0:canu_tpu_torch/csrc/verify.cu).  Builds this checkout's
verify.cu, the earlier one and variants of each that skip a step (the
sorts, the median, the centres, the base rows), prints each build's
registers and spills and the resources at Pm 2,048, checks this
checkout's K7 and K8 bit-equal to the plain versions on phase 4's first
verify group and index (chip_smoke.py's bench read set), and times every
variant on that group (CUDA events, mean of 10, two rounds) and K8's one
launch against the earlier K8's launch a block.  Writes
chiprun_out/k78/k78_quick.json.  Imports nothing of jax or canu_tpu.
"""
import argparse, ctypes, json, os, subprocess, sys, time
sys.modules["jax"] = None; sys.modules["canu_tpu"] = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT); sys.path.insert(0, ROOT + "/tests")
ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--earlier", required=True)
cli = ap.parse_args()
import numpy as np, torch
import chip_smoke as CS
from canu_tpu_torch.ops.kernels import _nvcc, verify_cuda as VC
from canu_tpu_torch.ops import align as AL, minimizers as MZ, minhash as MH
from canu_tpu_torch.ops.kmer import length_bucketed_blocks, block_tensors, bucket_widths
OUT = ROOT + "/chiprun_out/k78"; os.makedirs(OUT, exist_ok=True)
dev = torch.device("cuda:0")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(), flush=True)
new_src = open(ROOT + "/canu_tpu_torch/csrc/verify.cu").read()
old_src = open(cli.earlier).read()
def rep(src, pairs):
    for a, b in pairs:
        assert src.count(a) >= 1, a
        src = src.replace(a, b)
    return src
variants = {
  "new": new_src,
  "new_nosort": rep(new_src, [("  block_sort(comp, pay, n_ins, ni);", "")]),
  "new_nomedian": rep(new_src, [("  if (n2 > 0) {\n    // the (n2 - 1) / 2-th", "  if (false) {\n    // the (n2 - 1) / 2-th")]),
  "new_nocentre": rep(new_src, [("for (int j0 = 0; j0 < ns; j0 += tile_half) {", "for (int j0 = 0; j0 < 0; j0 += tile_half) {")]),
  "new_nobases": rep(new_src, [("  store_row(out_a + row_f", "  if (n_rows < 0) store_row(out_a + row_f"), ("  store_row(out_a + row_b", "  if (n_rows < 0) store_row(out_a + row_b"), ("  store_row(out_b + row_f", "  if (n_rows < 0) store_row(out_b + row_f"), ("  store_row(out_b + row_b", "  if (n_rows < 0) store_row(out_b + row_b")]),
  "old": old_src,
  "old_nosort": rep(old_src, [("bitonic_sort(s_join, n_sort);", ""), ("bitonic_sort(s_medv, n_med);", ""), ("bitonic_sort(s_ins, n_ins);", "")]),
  "old_nocentre": rep(old_src, [("for (int r = tid; r < wc; r += THREADS) {", "for (int r = tid; r < 0; r += THREADS) {")]),
  "old_nobases": rep(old_src, [("for (int i4 = 4 * tid; i4 < n_rows; i4 += 4 * THREADS) {", "for (int i4 = 4 * tid; i4 < 0; i4 += 4 * THREADS) {"), ("for (int i4 = 4 * tid; i4 < wb; i4 += 4 * THREADS) {", "for (int i4 = 4 * tid; i4 < 0; i4 += 4 * THREADS) {")]),
}
os.makedirs(OUT + "/src", exist_ok=True)
procs = {}
t0 = time.time()
for name, src in variants.items():
    path = f"{OUT}/src/{name}.cu"
    open(path, "w").write(src)
    procs[name] = subprocess.Popen([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", f"{OUT}/src/lib{name}.so", path], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
libs = {}
for name, pr in procs.items():
    _, err = pr.communicate()
    if pr.returncode:
        print(f"BUILD FAIL {name}:\n{err[-4000:]}", flush=True); sys.exit(1)
    for line in err.splitlines():
        if name in ("new", "old") and ("registers" in line or "spill" in line or "Compiling entry" in line):
            print(f"[ptxas {name}] {line.strip()}", flush=True)
    libs[name] = ctypes.CDLL(f"{OUT}/src/lib{name}.so")
print(f"built {len(libs)} variants in {time.time() - t0:.1f} s", flush=True)
_nvcc.build(VC.SOURCE)
print("resources Pm 2048:", VC.resources(2048, 2048), flush=True)
p, i = ctypes.c_void_p, ctypes.c_int
for lib in libs.values():
    lib.canu_verify_pre.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, i, i, i, p, p, p, p, p, p, p, p, p, p, p]
    lib.canu_verify_pre.restype = ctypes.c_int

rs = CS.bench_reads()
# index: the new one-launch build, and the parent's K8 bucket by bucket
ev = lambda: torch.cuda.Event(enable_timing=True)
torch.cuda.synchronize()
idx = MZ.build_read_index(rs, k=16, device=dev)
torch.cuda.synchronize()
ids, wbs = bucket_widths(rs, 128)
s_, t_ = MZ.syncmer_params(16)
args = (idx.words, idx.length, torch.from_numpy(ids - 1).to(dev), torch.from_numpy(wbs).to(dev), int(wbs.min()), 16, s_, t_)
planes = [x.clone() for x in (idx.mker, idx.mpos, idx.mstr)]
k8_ms = CS.cuda_ms(lambda: VC.syncmer_index(*args, *planes), 5)
cpu_idx = None
err8 = 0
for bids, Wb in length_bucketed_blocks(rs, 128):
    w, l = block_tensors(rs, bids, Wb, dev)
    ref = MZ._syncmer_kernel_plain(w, l, 16, idx.pm)
    rows = torch.from_numpy(bids.astype(np.int64) - 1).to(dev)
    for r, g in zip(ref[:3], (idx.mker[rows], idx.mpos[rows], idx.mstr[rows])):
        err8 = max(err8, int((r.long() - g.long()).abs().max()))
print(f"K8 new: one launch, {rs.n_reads} reads: {k8_ms:.3f} ms; bit-equal to plain: {err8 == 0}", flush=True)
oldk8 = libs["old"]
oldk8.canu_syncmer.argtypes = [p, i, i, p, i, i, i, i, p, i, p, p, p, p, p]
oldk8.canu_syncmer.restype = ctypes.c_int
blocks = []
for bids, Wb in length_bucketed_blocks(rs, 128):
    w, l = block_tensors(rs, bids, Wb, dev)
    B = w.shape[0]; Pk = 16 * Wb - 16 + 1; cap = 1 << max(0, (Pk - 1).bit_length())
    outs = (torch.empty((B, idx.pm), dtype=torch.int64, device=dev), torch.empty((B, idx.pm), dtype=torch.int32, device=dev), torch.empty((B, idx.pm), dtype=torch.int32, device=dev), torch.empty(B, dtype=torch.int32, device=dev))
    blocks.append((w, l, B, Wb, torch.empty((B, cap), dtype=torch.int64, device=dev), cap, outs))
def old_k8():
    for w, l, B, Wb, scr, cap, o in blocks:
        rc = oldk8.canu_syncmer(w.data_ptr(), B, Wb, l.data_ptr(), 16, s_, t_, idx.pm, scr.data_ptr(), cap, o[0].data_ptr(), o[1].data_ptr(), o[2].data_ptr(), o[3].data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
old8_ms = CS.cuda_ms(old_k8, 5)
print(f"K8 parent: {len(blocks)} launches: {old8_ms:.3f} ms (same call, same card)", flush=True)

# phase 4's first verify group: the bench candidates, longest pairs first, 16 chunks of 512
sk = MH.build_sketches(rs, k=16, n_hashes=512, block_size=128, device=dev)
pairs = MH.find_candidates(sk, min_matches=2, device=dev)
a_id, b_id = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)
ln = np.maximum(rs.length[a_id - 1], rs.length[b_id - 1]); o = np.argsort(-ln, kind="stable")
n = min(16 * 512, len(o) // 512 * 512)
a = torch.from_numpy(a_id[o][:n] - 1).to(dev); b = torch.from_numpy(b_id[o][:n] - 1).to(dev)
fl = torch.zeros(n, dtype=torch.bool, device=dev)
n_rows = 16 * idx.words.shape[1]
d = {"index": idx, "a_idx": a, "b_idx": b, "flipped": fl, "k": 16, "band": 128, "n_rows": n_rows, "orient": True, "chunk": 512}
got = AL._verify_pre(**d); ref = AL._verify_pre_plain(**d); torch.cuda.synchronize()
err7 = max(int((g.long() - r.long()).abs().max()) for g, r in zip((*got[0], *got[1:]), (*ref[0], *ref[1:])))
bd = CS.pre_bound(d, got[2])
print(f"K7 group: {n} pairs, n_rows {n_rows}; bit-equal to plain: {err7 == 0}; bound {bd['bound_ms']:.3f} ms ({bd['bytes']:.3e} B)", flush=True)
outs = [torch.empty_like(x) for x in (*got[0], *got[1:])]
fl_in = fl.to(torch.uint8)
def run(lib):
    rc = lib.canu_verify_pre(idx.words.data_ptr(), idx.words.shape[1], idx.length.data_ptr(), idx.mker.data_ptr(), idx.mpos.data_ptr(), idx.mstr.data_ptr(), idx.mker.shape[1], a.data_ptr(), b.data_ptr(), fl_in.data_ptr(), n, 512, 16, 128, n_rows, 1, *(x.data_ptr() for x in outs[:5]), outs[5].data_ptr(), outs[6].data_ptr(), outs[7].data_ptr(), outs[8].data_ptr(), outs[9].data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
res = {"k8_new_ms": k8_ms, "k8_old_ms": old8_ms, "k7_bound_ms": bd["bound_ms"]}
for rnd in range(2):
    for name in ("old", "new", "old_nosort", "old_nocentre", "old_nobases", "new_nosort", "new_nomedian", "new_nocentre", "new_nobases"):
        ms = CS.cuda_ms(lambda: run(libs[name]), 10)
        res.setdefault(name, []).append(ms)
        print(f"K7 {name}: {ms:.3f} ms (mean of 10), round {rnd}", flush=True)
# the new K7 via the variant lib equals the plain?
run(libs["new"]); torch.cuda.synchronize()
print("variant 'new' equals plain:", all(torch.equal(x.cpu(), r.cpu()) for x, r in zip(outs, (*ref[0], *ref[1:]))), flush=True)
json.dump(res, open(OUT + "/k78_quick.json", "w"), indent=1)
