"""The Myers extension's device time split by CUDA events, on one card:
the parts before kernel K1, K1 itself and the parts after it, over every
banded_extend_myers call of chip_smoke.py's phases 9, 15 and 16.

    python3 scripts/torch_myers_split.py [--design eager|tree] [--phases 9,15,16]

--design picks the extension step measured:

  eager  the step as the port ran it before kernels K10 and K11: the band
         schedule (ops.myers._schedule) on the centres as rows (expanded
         from their 16-row grid where the caller hands the grid over), the
         shift bits (_shift_bits), the row-0 state and its planes
         (_myers_init, _carry_pack), K1, then _carry_unpack and the end
         pick (_myers_finish), each a run of PyTorch ops on the card, with
         a CUDA event between the parts;
  tree   the tree's own ops.myers._extend, timed by the events it records
         when given an events list: K10, K1 with the end pick, and after
         it (pre, k1, post; post is empty where the pick runs inside K1).

The eager design's parts are also summed as the tree's three: pre (the
schedule, the shift bits and the row-0 planes), k1 and post.

Per phase it prints, beside the card's name and power limit: every verify
call's wall (after a synchronize), its host extend_s and the device
seconds of each part; the extension calls outside verify (the judge, the
GFA's links) likewise; the host synchronisations the eager step made
(torch.cuda.set_sync_debug_mode), and the allocator's retries and device
allocations over the phase (torch.cuda.memory_stats).  chip_smoke.py's
gates print instead of ending the run (the eager design fails the tree's
K10 / K11 gates by design); each failed gate is listed.  Writes the
numbers as JSON to myers_split_<design>.json in chip_smoke.py's output
directory.  Imports nothing of jax or canu_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

sys.modules["jax"] = None
sys.modules["canu_tpu"] = None
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EAGER_PARTS = ("schedule", "shift_bits", "init_pack", "k1", "unpack_finish")
TREE_PARTS = ("pre", "k1", "post")  # K10, K1 (with the end pick), after K1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--design", choices=("eager", "tree"), default="tree")
    ap.add_argument("--phases", default="9,15,16")
    args = ap.parse_args()
    phases = [p.strip() for p in args.phases.split(",") if p.strip()]
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    import chip_smoke as CS

    out_path = os.path.join(CS.OUT_DIR, f"myers_split_{args.design}.json")
    from canu_tpu_torch.ops import align as AL
    from canu_tpu_torch.ops import myers as MY
    from canu_tpu_torch.ops.kernels import _nvcc
    from canu_tpu_torch.ops.kernels import myers_cuda as K1

    if not torch.cuda.is_available():
        print("torch_myers_split: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    kernels = sorted(m for m in os.listdir(os.path.join(ROOT, "canu_tpu_torch", "csrc"))
                     if m.endswith(".cu"))
    t = time.time()
    _nvcc.build(*(_nvcc.CSRC / m for m in kernels))
    print(f"built {kernels} in {time.time() - t:.1f} s", flush=True)

    failed: list = []

    def check(cond, msg):
        if not cond:
            failed.append(msg)
            print(f"GATE (not ended): {msg}", flush=True)

    CS.check = check

    # the eager design: the parent's kernel path of ops.myers._extend, with
    # an event between its parts; the plain (CPU) path stays the tree's
    real_extend = MY._extend
    eager_events: list = []  # the current verify call's (or, between calls, the phase's)
    outside: list = []  # the phase's extension calls outside verify
    syncs = {"n": 0}

    def eager_extend(kernel, a, a_len, b, b_len, centers, band, n_rows, segment, max_rows,
                     partial_cap_q, events=None, center_stride=1):
        if not kernel:
            return real_extend(kernel, a, a_len, b, b_len, centers, band, n_rows, segment,
                               max_rows, partial_cap_q, events, center_stride)
        if center_stride > 1:
            centers = MY.expand_centers(centers, n_rows, center_stride)
        seg = min(segment, n_rows) if n_rows else segment
        n_seg = max(1, -(-n_rows // seg))
        a_len = a_len.to(torch.int32)
        b_len = b_len.to(torch.int32)
        need = n_seg * seg
        if a.shape[1] < need:
            a = torch.nn.functional.pad(a, (0, need - a.shape[1]))
        run_segs = n_seg
        if max_rows is not None:
            run_segs = max(1, min(n_seg, -(-int(max_rows) // seg)))
        cap_q = 0 if partial_cap_q is None else int(partial_cap_q)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(EAGER_PARTS) + 1)]
        # host synchronisations counted in the eager parts only: a phase's
        # K1 stand-in may synchronise to compute its bound
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                torch.cuda.set_sync_debug_mode("warn")
                ev[0].record()
                o_all = MY._schedule(b_len, centers, band, n_seg * seg)
                ev[1].record()
                s_bits = MY._shift_bits(o_all, run_segs * seg)
                ev[2].record()
                planes = MY._carry_pack(MY._myers_init(b, b_len, a_len,
                                                       o_all[:, 0].contiguous(), band))
                del o_all
                ev[3].record()
                torch.cuda.set_sync_debug_mode(0)
                planes = K1.myers_rows_cuda(planes, a.contiguous(), s_bits, b.contiguous(),
                                            a_len.contiguous(), b_len.contiguous(),
                                            run_segs * seg, cap_q)
                ev[4].record()
                torch.cuda.set_sync_debug_mode("warn")
                out = MY._myers_finish(MY._carry_unpack(planes), a_len, b_len, band)
                ev[5].record()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs["n"] += sum("synchroniz" in str(w.message).lower() for w in caught)
        eager_events.append(ev)
        return out if partial_cap_q is not None else out[:3]

    def tree_extend(kernel, *a):
        if kernel:  # a: a, a_len, b, b_len, centers, band, n_rows, segment, max_rows,
            a = (*a[:10], eager_events, *a[11:])  # partial_cap_q, events, center_stride
        return real_extend(kernel, *a)

    MY._extend = eager_extend if args.design == "eager" else tree_extend
    names = EAGER_PARTS if args.design == "eager" else TREE_PARTS

    def eager_sums(evs) -> dict:
        out = {p: round(sum(e[q].elapsed_time(e[q + 1]) for e in evs) / 1e3, 4)
               for q, p in enumerate(names)}
        if args.design == "eager":  # the same three sums as the tree's
            out["pre"] = round(out["schedule"] + out["shift_bits"] + out["init_pack"], 4)
            out["post"] = out["unpack_finish"]
        return out

    calls: list = []
    tag = {"now": ""}
    real_verify = AL.verify_overlaps
    depth = [0]

    def metered(*a, **kw):
        outer = depth[0] == 0
        if outer:
            torch.cuda.synchronize()
            outside.extend(eager_events)
            del eager_events[:]
        depth[0] += 1
        t0 = time.time()
        try:
            res = real_verify(*a, **kw)
        finally:
            depth[0] -= 1
        if outer:
            torch.cuda.synchronize()
            rec = {"tag": tag["now"], "wall_s": round(time.time() - t0, 3),
                   **{k: v for k, v in AL.LAST_PROFILE.items()}}
            rec["extend_device_s"] = eager_sums(eager_events)
            rec["extend_calls"] = len(eager_events)
            del eager_events[:]
            calls.append(rec)
        return res

    AL.verify_overlaps = metered
    record: dict = {"card": card, "design": args.design, "phases": {}}

    def phase(name: str, fn):
        tag["now"] = name
        torch.cuda.synchronize()
        del eager_events[:], outside[:]
        syncs["n"] = 0
        m0 = torch.cuda.memory_stats(dev)
        n0 = len(calls)
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        m1 = torch.cuda.memory_stats(dev)
        mine = calls[n0:]
        rec = {"wall_s": round(wall, 3), "verify_calls": mine,
               "extend_s": round(sum(c.get("extend_s", 0.0) for c in mine), 3),
               "alloc_retries": m1.get("num_alloc_retries", 0) - m0.get("num_alloc_retries", 0),
               "device_allocs": m1.get("num_device_alloc", 0) - m0.get("num_device_alloc", 0),
               "device_frees": m1.get("num_device_free", 0) - m0.get("num_device_free", 0)}
        keys = mine[0]["extend_device_s"].keys() if mine else ()
        rec["verify_device_s"] = {p: round(sum(c["extend_device_s"][p] for c in mine), 4)
                                  for p in keys}
        rec["verify_extend_calls"] = sum(c["extend_calls"] for c in mine)
        outside.extend(eager_events)
        rec["outside_verify_device_s"] = eager_sums(outside)
        rec["outside_verify_calls"] = len(outside)
        if args.design == "eager":
            rec["host_syncs_in_extend"] = syncs["n"]
        for key in ("verify_peak_bytes", "staging_estimate_bytes", "window"):
            if isinstance(res, dict) and key in res:
                rec[key] = res[key]
        record["phases"][name] = rec
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        with open(out_path, "w") as fh:  # after each phase, so a later failure keeps it
            json.dump(record, fh, indent=1, default=str)
        print(f"[{name}] {card}: " + json.dumps({k: v for k, v in rec.items()
                                                if k != "verify_calls"}), flush=True)
        return res

    cor = None
    if "9" in phases:
        phase("9", lambda: CS.ecoli_drive(dev, card))
    if "15" in phases or "16" in phases:
        cor = phase("15", lambda: CS.ecolicor_drive(dev, card))
    if "16" in phases:
        phase("16", lambda: CS.ecoliasm_drive(dev, card, cor))
    record["failed_gates"] = failed
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(record, fh, indent=1, default=str)
    print(json.dumps({"card": card, "design": args.design, "failed_gates": len(failed),
                      "phases": {n: {k: v for k, v in r.items() if k != "verify_calls"}
                                 for n, r in record["phases"].items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
