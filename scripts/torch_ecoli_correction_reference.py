"""Make canu_tpu_torch/ecoli_correction_reference.json: the JAX package's
cor meryl + candidates of raw reads at E. coli scale, and its corrected
reads of a sample of 256 templates, for chip_smoke.py's "ecolicor" phase
to hold the port's whole correction_phase against.

    JAX_PLATFORMS=cpu python scripts/torch_ecoli_correction_reference.py [--genome 4600000]

Runs canu_tpu on the CPU (the JAX package is the reference):
  reads      the JAX package's config 2 (scripts/scale_run.py: 4.6 Mb at
             25x) at raw-read error: random_genome(4.6 Mb, seed=7) +
             simulate_reads(coverage=25, mean_len=3500, min_len=1500,
             max_len=7800, error_rate=0.10, seed=8), written to a FASTA
             file (no QVs: every vote weighs 1.0);
  stages     gatekeeper and meryl ("cor", k=16) with Config() + genomeSize
             and the pacbio read-type profile, as run_pipeline sets them;
  candidates build_sketches + find_candidates_join with the cor sketch
             preset, as the overlap stage runs them above 5,000 reads;
  sample     every floor(T/256)-th id of select_templates' sorted output,
             256 templates (tests/torch_cases.py template_sample); the
             candidates with a sampled read on either side, verified with
             the cor arguments (band 128, partial) and built into an
             OverlapStore, of which only the rows whose a_id is sampled
             are kept (store_of_templates);
  correct    correct_reads_blocks with correction_phase's arguments on the
             read set and that store: only the sampled templates have
             evidence, so only they are corrected.
A CPU run cannot verify every candidate or correct every template (hours
and ~13 s a vote chunk); a template's corrected read depends only on the
store rows whose a_id is that template and on the read set, and with
weights of 1.0 the votes are integer counts that do not depend on the
chunks' order, so the sample's records equal the full run's for those
templates (tests/test_torch_ecoli_correction_sample.py shows it on a
small set, and that the mirror rows would change them).  Each step's CPU
wall seconds go into the file beside its result.
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
    ap.add_argument("--genome", type=int, default=4_600_000)
    ap.add_argument("--out", default=os.path.join(ROOT, "canu_tpu_torch",
                                                  "ecoli_correction_reference.json"))
    args = ap.parse_args()

    from canu_tpu.config import Config
    from canu_tpu.io.fastx import write_fasta
    from canu_tpu.ops import align as AL
    from canu_tpu.ops import falcon as F
    from canu_tpu.ops import minhash as MH
    from canu_tpu.pipeline import stages
    from canu_tpu.pipeline.driver import make_ctx
    from canu_tpu.sim.simulate import random_genome, simulate_reads
    from canu_tpu.stores.overlaps import OverlapStore
    from canu_tpu_torch.stores.overlaps import store_digest
    from torch_cases import (
        corrected_digest,
        pairs_of_reads,
        store_of_templates,
        template_sample,
    )

    secs: dict[str, float] = {}

    def lap(name: str, t0: float) -> None:
        secs[name] = round(time.time() - t0, 1)
        print(f"{name}: {secs[name]} s", flush=True)

    work = tempfile.mkdtemp(prefix="ecoli_cor_ref_")
    t = time.time()
    g = random_genome(args.genome, seed=7)
    raw, _ = simulate_reads(g, coverage=25, mean_len=3500, min_len=1500, max_len=7800,
                            error_rate=0.10, seed=8)
    fasta = os.path.join(work, "reads.fasta")
    write_fasta(fasta, ((raw.name(i), raw.get_seq(i)) for i in range(1, raw.n_reads + 1)))
    del raw
    lap("simulate", t)
    cfg = Config()
    cfg.set("genomeSize", args.genome)
    # run_pipeline's configuration: -pacbio-raw's read-type profile
    # (corOvlErrorRate 0.24 among others)
    cfg.apply_read_type_profile()
    cfg.validate()
    ctx = make_ctx(work, "ecoli", cfg)
    tag = "cor"
    k = int(cfg.get(tag + "MerSize"))

    t = time.time()
    rs = stages.gatekeeper(ctx, tag, [fasta])
    lap("gatekeeper", t)
    print(f"{rs.n_reads} reads, {rs.total_bases} bases", flush=True)
    t = time.time()
    fk = stages.meryl(ctx, tag, rs)
    lap("meryl", t)
    fpath = os.path.join(work, stages.TAG_DIR[tag], f"ecoli.ms{k}.frequent.npz")

    coverage = rs.total_bases / max(1.0, cfg.get("genomeSize"))
    n_hashes, min_matches = cfg.sketch_preset(tag, coverage)
    t = time.time()
    sk = np.asarray(MH.build_sketches(rs, k=k, n_hashes=n_hashes, frequent=fk,
                                      block_size=int(cfg.get("mhapBlockSize"))))
    lap("sketch", t)
    t = time.time()
    pairs = MH.find_candidates_join(sk, min_matches=min_matches)
    lap("join", t)
    del sk
    print(f"{len(pairs)} candidates", flush=True)

    tids = F.select_templates(rs, float(cfg.get("genomeSize")), int(cfg.get("corOutCoverage")))
    sample = template_sample(tids)
    sp = pairs_of_reads(pairs, sample)
    print(f"{len(tids)} templates; {len(sample)} sampled; {len(sp)} of their candidates",
          flush=True)
    t = time.time()
    ov = AL.verify_overlaps(rs, sp, k=k, band=int(cfg.get(tag + "OvlBandWidth")),
                            max_erate=float(cfg.get(tag + "OvlErrorRate")),
                            min_overlap=int(cfg.get("minOverlapLength")), chunk=512,
                            min_shared=int(cfg.get(tag + "MinShared")), partial=True)
    st = store_of_templates(OverlapStore.build(ov, rs.n_reads), sample, OverlapStore)
    lap("sample_verify_store", t)

    t = time.time()
    items = [it for _bi, block in F.correct_reads_blocks(
        rs, st,
        genome_size=float(cfg.get("genomeSize")),
        out_coverage=int(cfg.get("corOutCoverage")),
        max_evidence_coverage=stages._cor_evidence_budget(ctx, rs),
        min_evidence_length=int(cfg.get("corMinEvidenceLength")),
        band=int(cfg.get("corBandWidth")),
        min_cov=int(cfg.get("corMinCoverage")),
        qv_weight=bool(cfg.get("qvEvidenceWeight")),
        max_evidence_erate=float(cfg.get("corMaxEvidenceErate")),
        mode="dag" if str(cfg.get("corConsensus")).lower() == "dag" else "falcon",
        template_filter=str(cfg.get("corFilter")),
    ) for it in block]
    lap("sample_correct", t)
    names = {rs.name(int(i)) for i in sample}
    assert all(n.rsplit("_corr", 1)[0] in names for n, _ in items)

    ref = {
        "what": "canu_tpu (JAX, CPU) cor gatekeeper, meryl and hash-join candidates of raw "
                "reads at E. coli scale, and its verify, store and correct_reads_blocks on "
                "a sample of the templates, for chip_smoke.py's ecolicor phase",
        "made_by": "JAX_PLATFORMS=cpu python scripts/torch_ecoli_correction_reference.py"
                   + (f" --genome {args.genome}" if args.genome != 4_600_000 else ""),
        "read_set": f"random_genome({args.genome}, seed=7); simulate_reads(coverage=25, "
                    "mean_len=3500, min_len=1500, max_len=7800, error_rate=0.10, seed=8); "
                    "written to a FASTA file",
        "config": f"Config() + genomeSize={args.genome}, then apply_read_type_profile() "
                  "(readType pacbio), as run_pipeline configures it",
        "gatekeeper_reads": int(rs.n_reads),
        "gatekeeper_bases": int(rs.total_bases),
        "k": k,
        "n_hashes": int(n_hashes),
        "min_matches": int(min_matches),
        "frequent_sha256_of": "sha256 over the bytes of the .frequent.npz arrays kmers, "
                              "fraction, threshold, total, k (in that order)",
        "frequent_n": int(fk.n),
        "frequent_threshold": int(fk.threshold),
        "frequent_sha256": frequent_digest(fpath),
        "candidates_sha256_of": "sha256 of the int64 little-endian bytes of the [M, 3] "
                                "(a_id, b_id, slot_matches) rows, C order",
        "n_candidates": int(len(pairs)),
        "candidates_sha256": array_digest(pairs),
        "n_templates": int(len(tids)),
        "sample": {
            "rule": "tests/torch_cases.py template_sample: every floor(T/256)-th id of "
                    "select_templates' sorted output, 256 of them; the candidates with a "
                    "sampled read on either side (pairs_of_reads), verified and built into "
                    "an OverlapStore, of which the rows whose a_id is sampled are kept "
                    "(store_of_templates)",
            "ids": [int(i) for i in sample],
            "n_candidates": int(len(sp)),
            "candidates_sha256": array_digest(sp),
            "rows": int(len(st)),
            "store_sha256_of": "canu_tpu_torch.stores.overlaps.store_digest",
            "store_sha256": store_digest(st),
            "corrected_templates": len({n.rsplit("_corr", 1)[0] for n, _ in items}),
            "corrected_reads": len(items),
            "corrected_bases": int(sum(len(s) for _, s in items)),
            "corrected_sha256_of": "tests/torch_cases.py corrected_digest of every record "
                                   "<read>_corrN of a sampled template",
            "corrected_sha256": corrected_digest(items),
        },
        "cpu_seconds": secs,
    }
    shutil.rmtree(work)
    with open(args.out, "w") as fh:
        json.dump(ref, fh, indent=1)
        fh.write("\n")
    print(json.dumps({k: v for k, v in ref.items() if k != "sample"}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
