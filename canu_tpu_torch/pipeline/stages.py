"""gatekeeper, meryl and overlap pipeline stages and the correction phase
(counterpart of canu_tpu.pipeline.stages.gatekeeper / meryl / overlap /
correction_phase).

Same signatures, outputs, file names, resume contract and
stage-times.jsonl lines as canu_tpu, so either package's stage output can
feed the other; the device stages and the phase take ``device=``.  The
configurations outside the port raise NotImplementedError naming their
ROADMAP item: shardedCompute (the multi-device path) and
corConsensus=dag.  The correction phase runs as one process.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import shutil
import time

import numpy as np

from ..convert import frequent_from_npz
from ..device import resolve_device
from ..ops.errorest import estimate_error_rates
from ..stores.readset import ReadSet
from ..stores.overlaps import OverlapStore
from .driver import AssemblyCtx, PipelineError, run_stage

TAG_DIR = {"cor": "correction", "obt": "trimming", "utg": "unitigging"}


def gatekeeper(ctx: AssemblyCtx, tag: str, inputs: list[str]) -> ReadSet:
    """Load reads into the phase store (gatekeeperCreate equivalent)."""
    d = ctx.phase_dir(TAG_DIR[tag])
    store = os.path.join(d, f"{ctx.prefix}.gkpStore")

    def done() -> bool:
        return os.path.isdir(store)

    def fn() -> None:
        min_len = int(ctx.cfg.get("minReadLength"))
        rs, stats = ReadSet.from_fastx(inputs, min_read_length=min_len)
        if rs.n_reads == 0:
            raise RuntimeError(f"gatekeeper[{tag}]: no reads loaded from {inputs}")
        if (bool(ctx.cfg.get("stopOnReadQuality")) and stats.n_input > 0
                and stats.n_skipped_short > stats.n_loaded):
            # Gatekeeper.pm:302-312 stopOnReadQuality: most of the input
            # was discarded — almost always wrong minReadLength/wrong file
            raise RuntimeError(
                f"gatekeeper[{tag}]: {stats.n_skipped_short} of "
                f"{stats.n_input} input reads discarded as shorter than "
                f"minReadLength={min_len}; fix the input or set "
                f"stopOnReadQuality=false to continue anyway"
            )
        qv_line = ""
        if rs.has_quals:
            from ..utils.quality import quality_clear_ranges, read_quality_histogram

            qhist = read_quality_histogram(rs.mean_quals())
            qv_line = f"\nmean-QV histogram (bin 2): {qhist.tolist()}"
            if bool(ctx.cfg.get("qvTrim")):
                # initial QV clear ranges (trimReads-quality role), applied
                # before any overlap work
                b, e = quality_clear_ranges(
                    rs.length, rs.quals, rs.qual_off,
                    min_qv=float(ctx.cfg.get("qvTrimMinQuality")),
                    window=int(ctx.cfg.get("qvTrimWindow")),
                )
                n_trim = int(np.sum((b > 0) | (e < rs.length)))
                if n_trim:
                    before = rs.n_reads
                    keep = (e - b) >= min_len
                    rs = rs.sliced(np.where(keep, b, 0), np.where(keep, e, 0))
                    qv_line += (f"\nQV trim: {n_trim} reads trimmed, "
                                f"{before - rs.n_reads} dropped below minReadLength")
        rs.save(store)
        hist = rs.length_histogram(1000)
        ctx.report.add(
            f"{tag}.gatekeeper",
            f"reads loaded {stats.n_loaded} / input {stats.n_input}; "
            f"bases {stats.bases_loaded}; split-at-N {stats.n_split_at_n}; "
            f"short discards {stats.n_skipped_short}\n"
            f"length histogram (kb): {hist.tolist()}" + qv_line,
        )

    run_stage(ctx, f"{tag}-gatekeeper", done, fn)
    return ReadSet.load(store)


def _check_single_device(cfg) -> None:
    """shardedCompute=auto runs on one device (the sharded path gives the
    same counts and candidates); an explicit request for it raises."""
    if str(cfg.get("shardedCompute")).strip().lower() in ("1", "true", "yes", "on"):
        raise NotImplementedError("shardedCompute (the multi-device path) is not ported to "
                                  "canu_tpu_torch yet (ROADMAP: sharding)")


def meryl(ctx: AssemblyCtx, tag: str, rs: ReadSet, device=None):
    """k-mer counting + frequent-mer table (Meryl.pm equivalent)."""
    from ..ops import kmer as K

    d = ctx.phase_dir(TAG_DIR[tag])
    k = int(ctx.cfg.get(tag + "MerSize"))
    out = os.path.join(d, f"{ctx.prefix}.ms{k}.frequent.npz")

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        _check_single_device(ctx.cfg)
        # merylMemory scales the device instance budget before the host
        # counter takes over
        mm = int(ctx.cfg.get("merylMemory"))
        kc = K.count_readset_device(rs, k=k, block_size=256,
                                    max_instances=mm * (1 << 26) if mm > 0 else None,
                                    device=device)
        hist = kc.histogram(1000)
        n_distinct = int(hist[1:].sum())
        mode = str(ctx.cfg.get(tag + "MerThreshold"))
        how = mode
        if mode.isdigit():
            fk = K.frequent_kmers(kc, threshold=int(mode))
        elif mode == "auto":
            # the reference's MHAP ignore rule (Meryl.pm:672-695), floored
            # by the distinct-fraction rule so the ignore set stays a
            # repeat tail (canu_tpu's stages.meryl explains why)
            thr = int(float(ctx.cfg.get("mhapFilterThreshold")) * 2 * n_distinct)
            thr_floor = K.threshold_from_distinct_fraction(
                kc, float(ctx.cfg.get(tag + "MerDistinct")))
            if thr >= max(2, thr_floor):
                fk = K.frequent_kmers(kc, threshold=thr)
                how = "auto(mhap total-fraction)"
            else:
                fk = K.frequent_kmers(kc, threshold=max(2, int(thr_floor)))
                how = "auto->distinct-floor"
        elif mode == "estimate":
            fk = K.frequent_kmers(kc, threshold=K.estimate_coverage_threshold(kc))
            how = "estimate(valley/peak)"
        else:
            fk = K.frequent_kmers(kc, distinct_fraction=float(ctx.cfg.get(tag + "MerDistinct")))
        custom = str(ctx.cfg.get(tag + "OvlFrequentMers")).strip()
        if custom:
            # user-supplied always-ignore mers (reference OvlFrequentMers)
            fk = K.union_frequent(fk, K.frequent_from_fasta(custom, k))
        np.savez(out + ".WORKING.npz", kmers=fk.kmers, fraction=fk.fraction,
                 threshold=np.array([fk.threshold]), total=np.array([fk.total_kmers]),
                 k=np.array([k]))
        os.replace(out + ".WORKING.npz", out)
        if bool(ctx.cfg.get("saveMerCounts")):
            kh = kc.to_host() if hasattr(kc, "to_host") else kc  # host counts: a KmerCounts
            cp = os.path.join(d, f"{ctx.prefix}.ms{k}.counts.npz")
            np.savez_compressed(cp + ".WORKING.npz", kmers=kh.unique, counts=kh.counts,
                                k=np.array([k]))
            os.replace(cp + ".WORKING.npz", cp)
        ctx.report.add(
            f"{tag}.meryl",
            f"k={k} threshold {fk.threshold} ({how}); "
            f"{fk.n} frequent mers of {n_distinct} distinct",
        )

    run_stage(ctx, f"{tag}-meryl", done, fn)
    return frequent_from_npz(out)


def _minimap_candidates(ctx: AssemblyCtx, tag: str, rs: ReadSet, d: str) -> np.ndarray:
    """{tag}Overlapper=minimap: the external minimap2 binary all-vs-all,
    its PAF hits as candidate pairs for the verification (the reference's
    OverlapMMap.pm; its ReAlign step is the verify pass).  minimap2 must be
    on PATH, or minimap2Path must name it."""
    import shutil
    import subprocess

    from ..io.fastx import write_fasta

    mm2 = str(ctx.cfg.get("minimap2Path"))
    if shutil.which(mm2) is None:
        raise PipelineError(f"{tag}Overlapper=minimap but {mm2!r} is not executable; "
                            "install minimap2 or set minimap2Path=")
    fa = os.path.join(d, f"{ctx.prefix}.mmap-reads.fasta")
    if not os.path.exists(fa):
        write_fasta(fa + ".WORKING", ((f"{i}", rs.get_seq(i)) for i in range(1, rs.n_reads + 1)))
        os.replace(fa + ".WORKING", fa)
    preset = "ava-ont" if str(ctx.cfg.get("readType")) == "nanopore" else "ava-pb"
    mmap_k = int(ctx.cfg.get(tag + "MMapMerSize"))
    paf = os.path.join(d, f"{ctx.prefix}.mmap.paf")
    with open(paf + ".WORKING", "w") as oh:
        r = subprocess.run([mm2, "-x", preset, "-k", str(mmap_k), fa, fa],
                           stdout=oh, stderr=subprocess.PIPE, text=True)
    if r.returncode != 0:
        raise PipelineError(f"minimap2 failed rc={r.returncode}: {r.stderr[-500:]}")
    os.replace(paf + ".WORKING", paf)
    pairs = set()
    with open(paf) as fh:
        for line in fh:
            f = line.split("\t", 6)
            if len(f) < 6:
                continue
            try:
                a, b = int(f[0]), int(f[5])
            except ValueError:
                continue
            if a != b and 1 <= a <= rs.n_reads and 1 <= b <= rs.n_reads:
                pairs.add((min(a, b), max(a, b)))
    ctx.log.info(f"{tag}-overlap: minimap2 produced {len(pairs)} candidate pairs "
                 f"({preset}, k={mmap_k})")
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.array(sorted(pairs), np.int64)


def overlap(ctx: AssemblyCtx, tag: str, rs: ReadSet, fk, device=None) -> OverlapStore:
    """Sketch -> candidates -> anchored banded verify -> OverlapStore.

    Candidates come from minimap2 ({tag}Overlapper=minimap), the block
    matcher, or the hash-join (mhapMatchEngine=join, or auto above 5,000
    reads).  {tag}OvlBandWidth 128 verifies on the Myers engine (kernel K1
    on CUDA); any other band on the INF-walled engine (K2 or K3).  The
    store is built in RAM, or through the spill file and the native
    external sort (ovsMethod=spill, or auto from ovlSpillPairs
    candidates)."""
    from ..ops import align as AL
    from ..ops import minhash as MH
    from ..stores.overlaps import OverlapSpill

    d = ctx.phase_dir(TAG_DIR[tag])
    store = os.path.join(d, f"{ctx.prefix}.ovlStore")

    def done() -> bool:
        return os.path.isdir(store)

    def fn() -> None:
        cfg = ctx.cfg
        dev = resolve_device(device)
        _check_single_device(cfg)
        band = int(cfg.get(tag + "OvlBandWidth"))

        sub: dict[str, float] = {}  # sub-stage wall breakdown
        t_mark = time.monotonic()

        def _lap(name: str) -> None:
            nonlocal t_mark
            now = time.monotonic()
            sub[name] = round(sub.get(name, 0.0) + (now - t_mark), 1)
            t_mark = now

        k = int(cfg.get(tag + "MerSize"))
        coverage = rs.total_bases / max(1.0, cfg.get("genomeSize"))
        n_hashes, min_matches = cfg.sketch_preset(tag, coverage)
        # the candidate list is a sub-stage checkpoint: a retry resumes
        # at verification instead of replaying sketch + match
        pairs_ckpt = os.path.join(d, f"{ctx.prefix}.candidates.npy")
        if os.path.exists(pairs_ckpt):
            pairs = np.load(pairs_ckpt)
            ctx.log.info(f"{tag}-overlap: resuming from checkpointed candidates "
                         f"({len(pairs)} pairs, {pairs_ckpt})")
        else:
            if str(cfg.get(tag + "Overlapper")) == "minimap":
                pairs = _minimap_candidates(ctx, tag, rs, d)
            else:
                sk = MH.build_sketches(rs, k=k, n_hashes=n_hashes, frequent=fk,
                                       block_size=int(cfg.get("mhapBlockSize")), device=dev)
                _lap("sketch")
                me = str(cfg.get("mhapMatchEngine")).lower()
                # the block matrix is O(N^2) in block pairs: above 5,000
                # reads the hash-join's O(N H) sort wins
                if me == "join" or (me == "auto" and rs.n_reads > 5_000):
                    pairs = MH.find_candidates_join(sk, min_matches=min_matches, device=dev)
                else:
                    pairs = MH.find_candidates(sk, min_matches=min_matches, block_size=1024,
                                               device=dev)
                del sk
            np.save(pairs_ckpt + ".WORKING.npy", pairs)
            os.replace(pairs_ckpt + ".WORKING.npy", pairs_ckpt)
            _lap("match")
        from .configure import configure_resources

        res = configure_resources(cfg, ctx.log)
        # ovsMethod: memory forces the in-RAM build, spill the external
        # sort; auto spills from res.spill_pairs candidates on
        ovs = str(cfg.get("ovsMethod")).lower()
        spill = None
        if (len(pairs) >= res.spill_pairs) if ovs == "auto" else ovs == "spill":
            spill = OverlapSpill(os.path.join(d, f"{ctx.prefix}.ovl.spill"))
            ctx.log.info(f"{tag}-overlap: store via spill + external sort "
                         f"(ovsMethod={ovs}, {len(pairs)} candidate pairs)")
        ov = AL.verify_overlaps(
            rs, pairs, k=k, band=band,
            max_erate=float(cfg.get(tag + "OvlErrorRate")),
            min_overlap=int(cfg.get("minOverlapLength")),
            chunk=512,
            min_shared=int(cfg.get(tag + "MinShared")),
            # cor/obt keep partial (forOBT-style) overlaps; utg wants
            # pure dovetails for the best-overlap graph
            partial=tag in ("cor", "obt"),
            # obt also verifies palindromic pairs in both orientations
            palindromic_min=int(cfg.get(tag + "MinShared")) if tag == "obt" else 0,
            sink=spill.append if spill is not None else None,
            device=dev,
        )
        _lap("verify")
        verify_prof = dict(AL.LAST_PROFILE)
        if spill is not None:
            st = OverlapStore.build_spilled(spill, rs.n_reads, mem_budget=res.sort_mem_bytes,
                                            n_threads=res.sort_threads)
        else:
            st = OverlapStore.build(ov, rs.n_reads)
        st.save(store)
        _lap("store")
        try:
            with open(ctx.path(f"{ctx.prefix}.stage-times.jsonl"), "a") as fh:
                json.dump({"stage": f"{tag}-overlap.sub", "sub_walls_s": sub,
                           "verify_profile": verify_prof, "t_end": round(time.time(), 1)}, fh)
                fh.write("\n")
        except OSError:
            pass
        ctx.log.info(f"{tag}-overlap sub-walls: {sub}; verify: {verify_prof}")
        if os.path.exists(pairs_ckpt):
            os.remove(pairs_ckpt)  # checkpoint superseded by the store
        per_read = st.n_overlaps_per_read()
        est = estimate_error_rates(st.erate)
        ctx.report.add(
            f"{tag}.overlap",
            f"sketch H={n_hashes} mm={min_matches}; candidate pairs {len(pairs)}; "
            f"verified {st.n_overlaps}; "
            f"median overlaps/read {int(np.median(per_read))}; "
            f"median erate {est.median_erate:.4f}; est read error "
            f"{est.read_error:.4f}; suggested gate {est.suggested_ovl_erate:.3f}",
        )

    run_stage(ctx, f"{tag}-overlap", done, fn)
    return OverlapStore.load(store)


# ---- correction phase -------------------------------------------------------


def _cor_evidence_budget(ctx: AssemblyCtx, rs: ReadSet) -> int:
    """Effective per-template evidence coverage: corMaxEvidenceCoverage
    capped by the corMaxEvidenceCoverageLocal '<N.N>x' coverage multiple
    (CorrectReads.pm:83-117)."""
    base = int(ctx.cfg.get("corMaxEvidenceCoverage"))
    est = rs.total_bases / max(1.0, float(ctx.cfg.get("genomeSize")))
    lo = ctx.cfg.coverage_multiple("corMaxEvidenceCoverageLocal", est)
    return max(1, min(base, int(round(lo))))


def correction_phase(ctx: AssemblyCtx, raw_inputs: list[str], device=None) -> None:
    """Raw reads -> corrected reads (CorrectReads.pm + falconsense).

    Correction runs as resumable template blocks: each block's corrected
    reads land in ``correction/blocks/block_NNNNN.fasta.gz`` (atomic
    ``.WORKING`` rename), and a re-run skips completed blocks — the
    reference's per-jobid batch arrays with only-failed-indices retry
    (CorrectReads.pm:122-141).  One process runs every block.
    """
    from ..ops.falcon import correct_reads_blocks

    d = ctx.phase_dir("correction")
    out = os.path.join(d, f"{ctx.prefix}.correctedReads.fasta.gz")
    blocks_dir = os.path.join(d, "blocks")
    if os.path.exists(out):
        # phase-level short-circuit: with saveOverlaps=false the
        # intermediate stores are gone, so the sub-stages must not be
        # consulted (they would rebuild them)
        ctx.log.info("correction phase complete, skipping")
        _cleanup_phase_stores(ctx, d)
        return
    if str(ctx.cfg.get("corConsensus")).lower() == "dag":
        raise NotImplementedError(
            "corConsensus=dag (the tag-chain consensus) is not ported to canu_tpu_torch yet "
            "(ROADMAP item 8(e))")
    dev = resolve_device(device)
    rs = gatekeeper(ctx, "cor", raw_inputs)
    fk = meryl(ctx, "cor", rs, device=dev)
    st = overlap(ctx, "cor", rs, fk, device=dev)

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        from ..io.fastx import write_fasta

        os.makedirs(blocks_dir, exist_ok=True)
        done_blocks = {int(f[6:11]) for f in os.listdir(blocks_dir)
                       if f.startswith("block_") and f.endswith(".fasta.gz")}
        n_blocks = len(done_blocks)
        for bi, items in correct_reads_blocks(
            rs, st,
            genome_size=float(ctx.cfg.get("genomeSize")),
            out_coverage=int(ctx.cfg.get("corOutCoverage")),
            max_evidence_coverage=_cor_evidence_budget(ctx, rs),
            min_evidence_length=int(ctx.cfg.get("corMinEvidenceLength")),
            band=int(ctx.cfg.get("corBandWidth")),
            min_cov=int(ctx.cfg.get("corMinCoverage")),
            qv_weight=bool(ctx.cfg.get("qvEvidenceWeight")),
            done_blocks=done_blocks,
            max_evidence_erate=float(ctx.cfg.get("corMaxEvidenceErate")),
            template_filter=str(ctx.cfg.get("corFilter")),
            device=dev,
        ):
            p = os.path.join(blocks_dir, f"block_{bi:05d}.fasta.gz")
            write_fasta(p + ".WORKING.gz", items)
            os.replace(p + ".WORKING.gz", p)
            n_blocks += 1
            ctx.log.info("correction block %d done (%d reads, %d blocks total)",
                         bi, len(items), n_blocks)
        # concatenate block gzips (gzip members concatenate legally)
        with open(out + ".WORKING.gz", "wb") as oh:
            for f in sorted(os.listdir(blocks_dir)):
                if f.startswith("block_") and f.endswith(".fasta.gz"):
                    with open(os.path.join(blocks_dir, f), "rb") as ih:
                        oh.write(ih.read())
        with gzip.open(out + ".WORKING.gz", "rt") as fh:
            n = sum(1 for line in fh if line.startswith(">"))
        os.replace(out + ".WORKING.gz", out)
        if not bool(ctx.cfg.get("saveReadCorrections")):
            shutil.rmtree(blocks_dir, ignore_errors=True)  # concatenated
        ctx.report.add("cor.correct", f"corrected {n} reads in {n_blocks} blocks -> {out}")

    run_stage(ctx, "correction", done, fn)
    _cleanup_phase_stores(ctx, d)


def _cleanup_phase_stores(ctx: AssemblyCtx, phase_dir: str) -> None:
    """saveOverlaps=false: drop the phase's overlap store and spill once
    the phase output exists (Defaults.pm saveOverlaps)."""
    if bool(ctx.cfg.get("saveOverlaps")):
        return
    for p in (glob.glob(os.path.join(phase_dir, f"{ctx.prefix}.ovlStore*"))
              + glob.glob(os.path.join(phase_dir, f"{ctx.prefix}.ovl.spill*"))):
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        else:
            try:
                os.unlink(p)
            except OSError:
                pass
        ctx.log.info("saveOverlaps=false: removed %s", p)
