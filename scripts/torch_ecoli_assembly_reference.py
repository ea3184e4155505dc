"""Make canu_tpu_torch/ecoli_assembly_reference.json: the JAX package's
trimming and assembly stages at E. coli scale, each run on the input the
card gave the port's stage, for chip_smoke.py's "ecoliasm" phase (16).

    JAX_PLATFORMS=cpu python scripts/torch_ecoli_assembly_reference.py \
        [--inputs chiprun_out/ecoli_asm] [--genome 4600000] [--out <file>]

The inputs are what phase 16 writes to chiprun_out/ecoli_asm/ when it
has no reference: the corrected reads (2 bits a base), the trimmed
reads' names (cut from the corrected reads by the coordinates in them),
the autoerate gate the obt store fed to the utg overlap, RED's
corrections of every read, the OEA-adjusted utg store (its a_id < b_id
rows and every row's erate) and spec.used, with the card's digest of
each (inputs.json).  Each input is rebuilt and held to its digest first.
Then canu_tpu on the CPU (the JAX package is the reference), with
Config() + genomeSize + the pacbio read-type profile, as run_pipeline
configures -pacbio-raw reads (held to spec.used):
  obt      gatekeeper on the corrected reads, meryl (k=22), build_sketches
           + find_candidates_join with the obt preset; the store rows of a
           256-read sample (tests/torch_cases.py template_sample: the
           candidates with a sampled read on either side, verified with
           the obt arguments, built into a store, of which the rows whose
           a_id is sampled are kept: store_of_templates);
  trimming trimming_phase on that restricted store: the sampled reads'
           trimmed records (a read's records depend only on its a_id rows);
  utg      with the card's autoerate gate: gatekeeper on the trimmed reads,
           meryl, the candidates, a 256-read sample's store rows as for obt;
  red      detect_read_errors on the sample's restricted store: the sampled
           templates' corrections (every read is a template, with its
           a_id rows as evidence);
  adjust   adjust_overlap_erates of every row with a sampled read on either
           side (rows_of_reads), given the card's corrections of every read:
           those rows' adjusted erates (a row's erate depends on its pair's
           two corrected reads only);
  unitig   assembly_phase up to its unitig stage on the card's adjusted
           store and the trimmed reads: every unitig and contig layout.
A CPU run cannot verify every candidate or vote every read (hours a
stage); test_torch_ecoli_assembly_sample.py shows each sample rule sound
on a small read set in both packages.  Each step's CPU wall seconds go
into the file beside its result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def frequent_digest(path: str) -> str:
    h = hashlib.sha256()
    with np.load(path) as z:
        for n in ("kmers", "fraction", "threshold", "total", "k"):
            h.update(np.ascontiguousarray(z[n]).tobytes())
    return h.hexdigest()


def array_digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a.astype("<i8")).tobytes()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", default=os.path.join(ROOT, "chiprun_out", "ecoli_asm"))
    ap.add_argument("--genome", type=int, default=4_600_000)
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "ecoli_assembly_reference.json"))
    args = ap.parse_args()

    from canu_tpu.config import Config
    from canu_tpu.io.fastx import write_fasta
    from canu_tpu.ops import align as AL
    from canu_tpu.ops import minhash as MH
    from canu_tpu.ops import oea as OEA
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import StopPipeline, make_ctx
    from canu_tpu.stores.overlaps import OverlapStore
    from canu_tpu_torch.stores.overlaps import store_digest
    from torch_cases import (
        _sha_of,
        adjust_kwargs,
        corrected_digest,
        corrections_from_arrays,
        corrections_records,
        pairs_of_reads,
        red_kwargs,
        rows_of_reads,
        store_from_halves,
        store_of_templates,
        template_sample,
        trim_with_store,
        trimmed_from_names,
        trimmed_of,
        unitig_layouts,
        unpack_records,
        verify_kwargs,
    )

    secs: dict[str, float] = {}

    def lap(name: str, t0: float) -> None:
        secs[name] = round(time.time() - t0, 1)
        print(f"{name}: {secs[name]} s", flush=True)

    def make_cfg():
        cfg = Config()
        cfg.set("genomeSize", args.genome)
        cfg.apply_read_type_profile()
        cfg.validate()
        return cfg

    def held(name: str, got, want) -> None:
        if got != want:
            raise SystemExit(f"{name}: the rebuilt input {got} differs from the card's {want}")
        print(f"{name}: {got}", flush=True)

    # the inputs, each held to the card's digest
    t = time.time()
    with open(os.path.join(args.inputs, "inputs.json")) as fh:
        inputs = json.load(fh)
    with np.load(os.path.join(args.inputs, "corrected.npz")) as z:
        cor = unpack_records(z)
    held("corrected", {"n": len(cor), "bases": sum(len(s) for _, s in cor),
                       "sha256": corrected_digest(cor)}, inputs["corrected"])
    with open(os.path.join(args.inputs, "trimmed_names.txt")) as fh:
        trim = trimmed_from_names(cor, fh.read().split())
    held("trimmed", {"n": len(trim), "bases": sum(len(s) for _, s in trim),
                     "sha256": corrected_digest(trim)}, inputs["trimmed"])
    with open(os.path.join(args.inputs, "autoerate.json"), "rb") as fh:
        auto_raw = fh.read()
    auto = json.loads(auto_raw)
    held("autoerate", {"value": auto, "sha256": hashlib.sha256(auto_raw).hexdigest()},
         inputs["autoerate"])
    with np.load(os.path.join(args.inputs, "red.npz")) as z:
        corr = corrections_from_arrays(z)
    held("red", {"reads": len(corr), "n": sum(len(v) for v in corr.values()),
                 "sha256": _sha_of(corrections_records(corr))}, inputs["red"])
    with np.load(os.path.join(args.inputs, "adjusted_store.npz")) as z:
        adjusted = store_from_halves(OverlapStore, z)
    held("adjusted_store", {"n": len(adjusted), "sha256": store_digest(adjusted)},
         inputs["adjusted_store"])
    with open(os.path.join(args.inputs, "ecoli.spec.used"), "rb") as fh:
        spec_raw = fh.read()
    held("spec_used", {"sha256": hashlib.sha256(spec_raw).hexdigest()}, inputs["spec_used"])
    mine = json.loads(json.dumps(make_cfg().to_dict(), default=str))
    spec = json.loads(spec_raw)
    differ = {k: (spec.get(k), v) for k, v in mine.items() if spec.get(k) != v}
    if differ or set(spec) != set(mine):
        raise SystemExit(f"spec.used differs from the reference's configuration: {differ}")
    work = tempfile.mkdtemp(prefix="ecoli_asm_ref_")
    cor_fa = os.path.join(work, "corrected.fasta")
    trim_fa = os.path.join(work, "trimmed.fasta")
    write_fasta(cor_fa, cor)
    write_fasta(trim_fa, trim)
    del cor, trim
    lap("inputs", t)

    gates: dict = {}

    def overlap_sample(tag: str, ctx, fasta: str):
        """gatekeeper, meryl, candidates and the sample's restricted store."""
        cfg = ctx.cfg
        t = time.time()
        rs = stages.gatekeeper(ctx, tag, [fasta])
        lap(f"{tag}_gatekeeper", t)
        t = time.time()
        fk = stages.meryl(ctx, tag, rs)
        lap(f"{tag}_meryl", t)
        k = int(cfg.get(tag + "MerSize"))
        fpath = os.path.join(ctx.work_dir, stages.TAG_DIR[tag], f"ecoli.ms{k}.frequent.npz")
        n_hashes, min_matches = cfg.sketch_preset(tag, rs.total_bases
                                                  / max(1.0, cfg.get("genomeSize")))
        t = time.time()
        sk = np.asarray(MH.build_sketches(rs, k=k, n_hashes=n_hashes, frequent=fk,
                                          block_size=int(cfg.get("mhapBlockSize"))))
        lap(f"{tag}_sketch", t)
        t = time.time()
        pairs = MH.find_candidates_join(sk, min_matches=min_matches)
        lap(f"{tag}_join", t)
        del sk
        sample = template_sample(np.arange(1, rs.n_reads + 1))
        sp = pairs_of_reads(pairs, sample)
        print(f"{tag}: {rs.n_reads} reads, {rs.total_bases} bases, {len(pairs)} candidates; "
              f"{len(sample)} sampled, {len(sp)} of their candidates", flush=True)
        t = time.time()
        sub = OverlapStore.build(AL.verify_overlaps(rs, sp, **verify_kwargs(cfg, tag)),
                                 rs.n_reads)
        rows = store_of_templates(sub, sample, OverlapStore)
        lap(f"{tag}_sample_verify_store", t)
        gates[tag] = {"gatekeeper_reads": int(rs.n_reads),
                      "gatekeeper_bases": int(rs.total_bases),
                      "frequent_sha256": frequent_digest(fpath),
                      "n_candidates": int(len(pairs)), "candidates_sha256": array_digest(pairs),
                      "sample_rows": int(len(rows)), "sample_store_sha256": store_digest(rows)}
        print(f"{tag}: {gates[tag]}", flush=True)
        return rs, sample, sub, rows

    # obt and the trimming of the sample
    ctx = make_ctx(os.path.join(work, "obt"), "ecoli", make_cfg())
    rs, sample, _sub, rows = overlap_sample("obt", ctx, cor_fa)
    t = time.time()
    tctx = make_ctx(os.path.join(work, "trim"), "ecoli", make_cfg())
    recs = trimmed_of(trim_with_store(stages, tctx, rs, rows),
                      {rs.name(int(i)) for i in sample})
    gates["trimmed_sample"] = {"n": len(recs), "sha256": corrected_digest(recs)}
    lap("trimming_sample", t)
    print(f"trimmed_sample: {gates['trimmed_sample']}", flush=True)
    del rs, rows, recs

    # utg with the card's autoerate gate, RED and the adjust of the sample
    ucfg = make_cfg()
    if auto["key"] not in ucfg.explicit:
        ucfg.values[auto["key"]] = float(auto["gate"])
    ctx = make_ctx(os.path.join(work, "utg"), "ecoli", ucfg)
    rs, sample, sub, rows = overlap_sample("utg", ctx, trim_fa)
    t = time.time()
    red = OEA.detect_read_errors(rs, rows, **red_kwargs(ucfg))
    gates["red_sample"] = {"reads": len(red), "n": sum(len(v) for v in red.values()),
                           "sha256": _sha_of(corrections_records(red))}
    lap("red_sample", t)
    print(f"red_sample: {gates['red_sample']}", flush=True)
    t = time.time()
    touch = rows_of_reads(sub, sample, OverlapStore)
    touch.update_erates(OEA.adjust_overlap_erates(rs, touch, corr, **adjust_kwargs(ucfg)))
    gates["adjusted_sample"] = {"n": len(touch), "sha256": store_digest(touch)}
    lap("adjust_sample", t)
    print(f"adjusted_sample: {gates['adjusted_sample']}", flush=True)

    # unitig on the card's adjusted store
    t = time.time()
    gates.update(unitig_layouts(stages, StopPipeline,
                                make_ctx(os.path.join(work, "unitig"), "ecoli", ucfg),
                                rs, adjusted))
    lap("unitig", t)
    print(f"layouts: utg {gates['utg_layouts']}, ctg {gates['ctg_layouts']}", flush=True)

    ref = {
        "what": "canu_tpu (JAX, CPU) trimming and assembly stages at E. coli scale, each on "
                "the input the card gave the port's stage in chip_smoke.py's ecoliasm phase: "
                "obt and utg gatekeeper, meryl and candidates, a 256-read sample's store rows "
                "of each, the sampled reads' trimmed records and RED corrections, the "
                "adjusted erates of the utg sample's rows, every unitig and contig layout",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_ecoli_assembly_reference.py"
                   + (f" --genome {args.genome}" if args.genome != 4_600_000 else ""),
        "read_set": f"random_genome({args.genome}, seed=7); simulate_reads(coverage=25, "
                    "mean_len=3500, min_len=1500, max_len=7800, error_rate=0.10, seed=8); "
                    "corrected by the port on the card (chip_smoke.py phase 15)",
        "config": f"Config() + genomeSize={args.genome}, then apply_read_type_profile() "
                  "(readType pacbio), as run_pipeline configures it; the utg stages with the "
                  "card's autoerate gate",
        "inputs": inputs,
        "inputs_of": "chip_smoke.py phase 16's digests of its stage-boundary inputs, each "
                     "rebuilt from chiprun_out/ecoli_asm/ and held to it here",
        "sample_rule": "tests/torch_cases.py template_sample of the gatekeeper's read ids "
                       "(256); store_of_templates of the verified candidates with a sampled "
                       "read on either side (pairs_of_reads); rows_of_reads for the adjust",
        "gates": gates,
        "cpu_seconds": secs,
    }
    shutil.rmtree(work)
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    print(json.dumps({k: v for k, v in ref.items() if k != "inputs"}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
