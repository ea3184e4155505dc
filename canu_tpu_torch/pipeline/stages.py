"""Pipeline stages and phases (counterpart of canu_tpu.pipeline.stages):
gatekeeper, meryl and overlap, and the correction, trimming and
assembly phases.

Same signatures, outputs, file names, resume contract and
stage-times.jsonl lines as canu_tpu, so either package's stage output can
feed the other; the device stages and the phases take ``device=``.
With shardedCompute on (auto: in a world of more than one rank) meryl
counts by hash range across the ranks, the overlap stage finds
candidates on the ring and verifies a strided slice on each rank, and
the correction strides its blocks over the ranks (canu_tpu.parallel's
roles, in canu_tpu_torch.parallel); only rank 0 writes shared files.
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
from ..parallel.launch import barrier, is_distributed, is_writer, rank_world
from ..stores.overlaps import OverlapStore
from ..stores.readset import ReadSet
from ..stores.tigs import CLASS_CONTIG, CLASS_UNASSEMBLED, TigStore
from ..utils import bitpack
from .driver import AssemblyCtx, PipelineError, run_stage

TAG_DIR = {"cor": "correction", "obt": "trimming", "utg": "unitigging"}


def sharded_enabled(cfg) -> bool:
    """True when the meryl and candidate stages run across the ranks
    (shardedCompute: auto = in a world of more than one rank, one card
    each; true runs the sharded path in a world of any size, one rank
    included)."""
    v = str(cfg.get("shardedCompute")).strip().lower()
    if v == "auto":
        return is_distributed()
    return v in ("1", "true", "yes", "on")


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


def meryl(ctx: AssemblyCtx, tag: str, rs: ReadSet, device=None):
    """k-mer counting + frequent-mer table (Meryl.pm equivalent)."""
    from ..ops import kmer as K

    d = ctx.phase_dir(TAG_DIR[tag])
    k = int(ctx.cfg.get(tag + "MerSize"))
    out = os.path.join(d, f"{ctx.prefix}.ms{k}.frequent.npz")

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        if sharded_enabled(ctx.cfg):
            # distributed meryl: the hash-range all_to_all across the ranks
            # (the same counts: every k-mer lands on one owner); k <= 16
            # routes one lane, k <= 32 two
            from ..parallel.shard_overlap import sharded_count_readset

            kc = sharded_count_readset(rs, k=k, device=device)
        else:
            # merylMemory scales the device instance budget before the
            # host counter takes over
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
        if not is_writer():
            return  # every rank counted (collectives); rank 0 writes
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

    run_stage(ctx, f"{tag}-meryl", done, fn, collective=sharded_enabled(ctx.cfg))
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
    candidates).  Sharded (shardedCompute), the candidates come from the
    ring across the ranks, and in a world of several ranks each verifies a
    strided slice: ovsShardExchange=range exchanges the rows by a_id range
    into per-rank shards that rank 0 merges, allgather gives every rank
    the whole table."""
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
                if sharded_enabled(cfg):
                    # the ring all-vs-all across the ranks: the block
                    # matcher's pair set, O(N/n) memory a rank
                    from ..parallel.shard_overlap import sharded_find_candidates

                    pairs = sharded_find_candidates(sk, min_matches=min_matches, device=dev)
                # the block matrix is O(N^2) in block pairs: above 5,000
                # reads the hash-join's O(N H) sort wins
                elif me == "join" or (me == "auto" and rs.n_reads > 5_000):
                    pairs = MH.find_candidates_join(sk, min_matches=min_matches, device=dev)
                else:
                    pairs = MH.find_candidates(sk, min_matches=min_matches, block_size=1024,
                                               device=dev)
                del sk
            if is_writer():
                np.save(pairs_ckpt + ".WORKING.npy", pairs)
                os.replace(pairs_ckpt + ".WORKING.npy", pairs_ckpt)
            _lap("match")
        from .configure import configure_resources

        res = configure_resources(cfg, ctx.log)
        # ovsMethod: memory forces the in-RAM build, spill the external
        # sort; auto spills from res.spill_pairs candidates on
        ovs = str(cfg.get("ovsMethod")).lower()
        want_spill = (len(pairs) >= res.spill_pairs) if ovs == "auto" else ovs == "spill"
        split = sharded_enabled(cfg) and is_distributed()  # each rank verifies a slice
        by_range = split and str(cfg.get("ovsShardExchange")).lower() == "range"
        if by_range:
            # the range exchange streams per-rank shards and merges them
            # through memmaps: a spill would be a second copy on disk
            want_spill = False
        spill = None
        if want_spill and is_writer():
            # rank 0 alone: in a collective run every rank gets here, and a
            # second open('wb') would truncate its spill file
            spill = OverlapSpill(os.path.join(d, f"{ctx.prefix}.ovl.spill"))
            ctx.log.info(f"{tag}-overlap: store via spill + external sort "
                         f"(ovsMethod={ovs}, {len(pairs)} candidate pairs)")
        verify_kwargs = dict(
            k=k, band=band,
            max_erate=float(cfg.get(tag + "OvlErrorRate")),
            min_overlap=int(cfg.get("minOverlapLength")),
            chunk=512,
            min_shared=int(cfg.get(tag + "MinShared")),
            # cor/obt keep partial (forOBT-style) overlaps; utg wants
            # pure dovetails for the best-overlap graph
            partial=tag in ("cor", "obt"),
            # obt also verifies palindromic pairs in both orientations
            palindromic_min=int(cfg.get(tag + "MinShared")) if tag == "obt" else 0,
            device=dev,
        )
        ov = None
        if by_range:
            # each rank verifies its slice and keeps the rows of its a_id
            # range (no rank holds the whole table: the reference's
            # bucketize/sort/index build, SURVEY.md §3.3); the shards go to
            # disk and rank 0 merges them column by column
            from ..parallel.shard_overlap import process_sharded_store_rows

            rank = rank_world()[0]
            rows = process_sharded_store_rows(rs, pairs, **verify_kwargs)
            shard = store + f".shard{rank:04d}.npy"
            np.save(shard + ".WORKING.npy", rows)
            os.replace(shard + ".WORKING.npy", shard)
            ctx.log.info(f"{tag}-overlap: range exchange -> {len(rows)} rows held on rank "
                         f"{rank} (no whole-table gather)")
            del rows
            barrier(f"{tag}-ovl-shards")
            if is_writer():
                shards = sorted(glob.glob(store + ".shard*.npy"))
                OverlapStore.save_from_row_shards(shards, rs.n_reads, store)
                for sp in shards:
                    os.remove(sp)
        elif split:  # allgather: every rank gets the whole table
            from ..parallel.shard_overlap import process_sharded_verify

            ov = process_sharded_verify(rs, pairs, **verify_kwargs)
            if spill is not None:
                spill.append(ov)
        else:
            ov = AL.verify_overlaps(rs, pairs, sink=spill.append if spill is not None else None,
                                    **verify_kwargs)
        _lap("verify")
        verify_prof = dict(AL.LAST_PROFILE)
        if not is_writer():
            return  # the other ranks load rank 0's store after the barrier
        if by_range:
            st = OverlapStore.load(store)
        else:
            if spill is not None:
                st = OverlapStore.build_spilled(spill, rs.n_reads,
                                                mem_budget=res.sort_mem_bytes,
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

    run_stage(ctx, f"{tag}-overlap", done, fn, collective=sharded_enabled(ctx.cfg))
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
    (CorrectReads.pm:122-141).  In a world of several ranks the blocks are
    strided over the ranks (block b on rank b % n, each writing only its
    own block files) and rank 0 concatenates them after a barrier.
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
    dev = resolve_device(device)
    rs = gatekeeper(ctx, "cor", raw_inputs)
    fk = meryl(ctx, "cor", rs, device=dev)
    st = overlap(ctx, "cor", rs, fk, device=dev)

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        from ..io.fastx import write_fasta
        from ..ops.falcon import _lap

        os.makedirs(blocks_dir, exist_ok=True)
        done_blocks = {int(f[6:11]) for f in os.listdir(blocks_dir)
                       if f.startswith("block_") and f.endswith(".fasta.gz")}
        rank, n_ranks = rank_world()

        class _SkipSet:
            """Done blocks and blocks of other ranks: correction blocks are
            independent jobs, strided over the ranks (the reference's
            job-array partitioning, CorrectReads.pm:122-141)."""

            def __contains__(self, bi: int) -> bool:
                return bi in done_blocks or bi % n_ranks != rank

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
            done_blocks=_SkipSet() if n_ranks > 1 else done_blocks,
            max_evidence_erate=float(ctx.cfg.get("corMaxEvidenceErate")),
            mode="dag" if str(ctx.cfg.get("corConsensus")).lower() == "dag" else "falcon",
            template_filter=str(ctx.cfg.get("corFilter")),
            device=dev,
        ):
            t0 = time.perf_counter()
            p = os.path.join(blocks_dir, f"block_{bi:05d}.fasta.gz")
            write_fasta(p + ".WORKING.gz", items)
            os.replace(p + ".WORKING.gz", p)
            _lap("write", t0)  # the block file's gzip FASTA
            n_blocks += 1
            ctx.log.info("correction block %d done (%d reads, %d blocks total)",
                         bi, len(items), n_blocks)
        barrier("correction-blocks")  # every rank's block files landed
        if not is_writer():
            return  # rank 0 concatenates; the others re-check done()
        # concatenate block gzips (gzip members concatenate legally)
        t0 = time.perf_counter()
        n_blocks = 0
        with open(out + ".WORKING.gz", "wb") as oh:
            for f in sorted(os.listdir(blocks_dir)):
                if f.startswith("block_") and f.endswith(".fasta.gz"):
                    with open(os.path.join(blocks_dir, f), "rb") as ih:
                        oh.write(ih.read())
                    n_blocks += 1
        t0 = _lap("concat", t0)
        with gzip.open(out + ".WORKING.gz", "rt") as fh:
            n = sum(1 for line in fh if line.startswith(">"))
        _lap("count", t0)  # the re-read of the whole gzip that counts its records
        os.replace(out + ".WORKING.gz", out)
        if not bool(ctx.cfg.get("saveReadCorrections")):
            shutil.rmtree(blocks_dir, ignore_errors=True)  # concatenated
        ctx.report.add("cor.correct", f"corrected {n} reads in {n_blocks} blocks -> {out}")

    run_stage(ctx, "correction", done, fn, collective=is_distributed())
    _cleanup_phase_stores(ctx, d)


def _cleanup_phase_stores(ctx: AssemblyCtx, phase_dir: str) -> None:
    """saveOverlaps=false: drop the phase's overlap store and spill once
    the phase output exists (Defaults.pm saveOverlaps); rank 0 deletes,
    the other ranks leave the shared directory alone."""
    if bool(ctx.cfg.get("saveOverlaps")) or not is_writer():
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


def _auto_erate_feedback(ctx: AssemblyCtx, st: OverlapStore, target_tag: str,
                         phase_dir: str) -> None:
    """Feed the measured corrected-read error distribution into the next
    phase's overlap gate (the reference's auto error-rate loop:
    ErrorEstimate.pm + Meryl.pm auto thresholds), unless the user set the
    gate.  The decision is saved so a resumed run (whose store may be
    gone) applies the same gate."""
    key = f"{target_tag}ovlerrorrate"
    if key in ctx.cfg.explicit or len(st) == 0:
        return
    est = estimate_error_rates(st.erate)
    gate = float(np.clip(est.suggested_ovl_erate, 0.03, 0.30))
    with open(os.path.join(phase_dir, "autoerate.json"), "w") as fh:
        json.dump({"key": key, "gate": gate}, fh)
    before = float(ctx.cfg.get(key))
    if abs(gate - before) < 1e-9:
        return
    ctx.cfg.values[key] = gate
    ctx.report.add(
        f"{target_tag}.autoerate",
        f"{target_tag}OvlErrorRate auto-set {before:.3f} -> {gate:.3f} "
        f"(median obt erate {est.median_erate:.4f}, est read error "
        f"{est.read_error:.4f})",
    )


def _apply_saved_autoerate(ctx: AssemblyCtx, phase_dir: str) -> None:
    p = os.path.join(phase_dir, "autoerate.json")
    if not os.path.exists(p):
        return
    with open(p) as fh:
        saved = json.load(fh)
    if saved["key"] not in ctx.cfg.explicit:
        ctx.cfg.values[saved["key"]] = float(saved["gate"])


# ---- trimming phase ---------------------------------------------------------


def trimming_phase(ctx: AssemblyCtx, corrected_inputs: list[str], device=None) -> None:
    """Corrected reads -> trimmed reads (OverlapBasedTrimming.pm: every
    well-covered interval of a read becomes a read, cut at confirmed
    subread junctions)."""
    d = ctx.phase_dir("trimming")
    out = os.path.join(d, f"{ctx.prefix}.trimmedReads.fasta.gz")
    if os.path.exists(out):
        ctx.log.info("trimming phase complete, skipping")
        _apply_saved_autoerate(ctx, d)
        _cleanup_phase_stores(ctx, d)
        return
    dev = resolve_device(device)
    rs = gatekeeper(ctx, "obt", corrected_inputs)
    fk = meryl(ctx, "obt", rs, device=dev)
    st = overlap(ctx, "obt", rs, fk, device=dev)
    _auto_erate_feedback(ctx, st, "utg", d)

    def done() -> bool:
        return os.path.exists(out)

    def fn() -> None:
        from ..io.fastx import write_fasta
        from ..utils.intervals import covered_intervals_all
        from .splitreads import detect_bad_regions, subtract_regions

        # Defaults.pm:881-882: coverage 1 keeps any read a single good
        # overlap covers
        min_cov = int(ctx.cfg.get("trimReadsCoverage"))
        min_len = int(ctx.cfg.get("minReadLength"))
        min_ovl = max(int(ctx.cfg.get("minOverlapLength")),
                      int(ctx.cfg.get("trimReadsOverlap")))
        # subread-loop junctions from opposite-orientation duplicate
        # overlap pairs (splitReads-subReads.C semantics)
        bad_regions = detect_bad_regions(st)
        # every well-covered interval becomes a read: coverage gaps inside
        # a read mark chimeric junctions or unsplit subreads (splitReads.H:50)
        long_enough = (st.a_end - st.a_bgn) >= min_ovl
        iv_rid, iv_bgn, iv_end = covered_intervals_all(
            st.a_id[long_enough], st.a_bgn[long_enough], st.a_end[long_enough], min_cov)
        if bad_regions:
            # junction subtraction touches only the flagged reads
            touched = np.isin(iv_rid, np.fromiter(bad_regions, np.int64))
            keep_rows = [(iv_rid[~touched], iv_bgn[~touched], iv_end[~touched])]
            for rid in sorted(bad_regions):
                m = iv_rid == rid
                iv = subtract_regions(list(zip(iv_bgn[m].tolist(), iv_end[m].tolist())),
                                      bad_regions[rid])
                if iv:
                    b = np.array([x[0] for x in iv], np.int64)
                    e = np.array([x[1] for x in iv], np.int64)
                    keep_rows.append((np.full(len(iv), rid, np.int64), b, e))
            iv_rid = np.concatenate([r[0] for r in keep_rows])
            iv_bgn = np.concatenate([r[1] for r in keep_rows])
            iv_end = np.concatenate([r[2] for r in keep_rows])
            order = np.lexsort((iv_bgn, iv_rid))
            iv_rid, iv_bgn, iv_end = iv_rid[order], iv_bgn[order], iv_end[order]
        ok = (iv_end - iv_bgn) >= min_len
        iv_rid, iv_bgn, iv_end = iv_rid[ok], iv_bgn[ok], iv_end[ok]

        pieces_of = np.bincount(iv_rid, minlength=rs.n_reads + 1)
        n_dropped = int(np.sum(pieces_of[1:] == 0))
        n_split = int(np.sum(pieces_of[1:] > 1))
        n_trimmed = int(np.sum((iv_end - iv_bgn) < rs.length[iv_rid - 1]))

        def records():
            last_rid, codes, pi = 0, None, 0
            for i in range(len(iv_rid)):
                rid = int(iv_rid[i])
                if rid != last_rid:
                    codes = rs.get_codes(rid)
                    last_rid, pi = rid, 0
                bgn, end = int(iv_bgn[i]), int(iv_end[i])
                suffix = f"_s{pi}" if pieces_of[rid] > 1 else ""
                pi += 1
                yield (f"{rs.name(rid)}_trim_{bgn}_{end}{suffix}",
                       bitpack.codes_to_seq(codes[bgn:end]))

        n_kept = write_fasta(out + ".WORKING.gz", records())
        os.replace(out + ".WORKING.gz", out)
        ctx.report.add(
            "obt.trim",
            f"kept {n_kept} reads ({n_trimmed} trimmed, {n_split} split, "
            f"{len(bad_regions)} subread junctions), dropped {n_dropped}",
        )

    run_stage(ctx, "trimming", done, fn)
    _cleanup_phase_stores(ctx, d)


# ---- assembly phase ---------------------------------------------------------


def _append_stage_times(ctx: AssemblyCtx, rec: dict) -> None:
    try:
        with open(ctx.path(f"{ctx.prefix}.stage-times.jsonl"), "a") as fh:
            json.dump(rec, fh)
            fh.write("\n")
    except OSError:
        pass


def _contig_filter(ctx: AssemblyCtx, tigs: TigStore) -> None:
    """contigFilter's length and low-coverage classification (the
    reference's 5-tuple "minReads minLength singleReadSpan lowCovFraction
    lowCovDepth" beyond minReads, which build_unitigs applies)."""
    min_len_f = int(ctx.cfg.get("contigFilterMinLength"))
    srs = float(ctx.cfg.get("contigFilterSingleReadSpan"))
    lc_frac = float(ctx.cfg.get("contigFilterLowCovFraction"))
    lc_depth = int(ctx.cfg.get("contigFilterLowCovDepth"))
    for t in tigs:
        if t.tig_class != CLASS_CONTIG:
            continue
        L = max(t.length, 1)
        if min_len_f and L < min_len_f:
            t.tig_class = CLASS_UNASSEMBLED
            continue
        # a tig mostly spanned by one read is that read, not assembly
        if 0 < srs <= 1.0 and t.n_reads >= 1:
            if int((t.end - t.bgn).max()) >= srs * L and t.n_reads <= 2:
                t.tig_class = CLASS_UNASSEMBLED
                continue
        if lc_depth > 0 and 0 < lc_frac < 1:
            depth = np.zeros(L + 1, np.int32)
            np.add.at(depth, t.bgn, 1)
            np.add.at(depth, t.end, -1)
            if float((np.cumsum(depth[:L]) < lc_depth).mean()) > lc_frac:
                t.tig_class = CLASS_UNASSEMBLED


def assembly_phase(ctx: AssemblyCtx, trimmed_inputs: list[str], device=None) -> None:
    """Trimmed reads -> contigs: utg gatekeeper, meryl and overlap, then
    oea (RED + OEA), unitig (best-overlap graph, repeat breaking,
    contigFilter), consensus (plurality polish or quick mosaic) and the
    outputs (contigs, unassembled and unitigs FASTA, layout.tsv, GFA with
    re-aligned links, HTML)."""
    from ..graph import build_unitigs
    from ..ops.consensus import quick_mosaic

    dev = resolve_device(device)
    d = ctx.phase_dir("unitigging")
    rs = gatekeeper(ctx, "utg", trimmed_inputs)
    fk = meryl(ctx, "utg", rs, device=dev)
    st = overlap(ctx, "utg", rs, fk, device=dev)

    # overlap error adjustment (OverlapErrorAdjustment.pm): vote read
    # errors from the overlap pile, verify the overlaps again between
    # the corrected reads, install the adjusted erates
    if bool(ctx.cfg.get("enableOEA")):
        oea_store = os.path.join(d, f"{ctx.prefix}.ovlStore.adjusted")

        def oea_done() -> bool:
            return os.path.isdir(oea_store)

        def oea_fn() -> None:
            from ..ops.oea import adjust_overlap_erates, detect_read_errors

            t0 = time.monotonic()
            corr = detect_read_errors(
                rs, st,
                min_alt_votes=int(ctx.cfg.get("oeaMinAltVotes")),
                max_own_votes=int(ctx.cfg.get("oeaMaxOwnVotes")),
                band=int(ctx.cfg.get("utgBandWidth")) * 2,
                device=dev,
            )
            t_red = time.monotonic() - t0
            t0 = time.monotonic()
            new_q = adjust_overlap_erates(
                rs, st, corr, band=int(ctx.cfg.get("utgBandWidth")),
                chunk=int(ctx.cfg.get("oeaBatchSize")),
                only_changed=bool(ctx.cfg.get("oeaOnlyChanged")),
                device=dev,
            )
            t_adj = time.monotonic() - t0
            _append_stage_times(ctx, {"stage": "oea.sub", "sub_walls_s": {
                "red": round(t_red, 1), "adjust": round(t_adj, 1)},
                "changed_reads": len(corr), "t_end": round(time.time(), 1)})
            ctx.log.info(f"oea sub-walls: red={t_red:.1f}s adjust={t_adj:.1f}s "
                         f"changed={len(corr)}")
            n_fix = sum(len(v) for v in corr.values())
            before = float(np.median(st.erate)) if len(st) else 0.0
            st.update_erates(new_q)
            st.save(oea_store)
            ctx.report.add(
                "utg.oea",
                f"RED corrected {n_fix} bases in {len(corr)} reads; "
                f"median erate {before:.4f} -> {float(np.median(st.erate)):.4f}",
            )

        run_stage(ctx, "oea", oea_done, oea_fn)
        st = OverlapStore.load(oea_store)

    ctg_dir = os.path.join(d, f"{ctx.prefix}.ctgStore")
    utg_dir = os.path.join(d, f"{ctx.prefix}.utgStore")

    def tigs_done() -> bool:
        return TigStore.latest_version(ctg_dir) >= 1

    def tigs_fn() -> None:
        bat_gb = int(ctx.cfg.get("batMemory"))
        # flag-gated per-phase graph logs (bogart logFileFlags)
        lf = frozenset(s.strip().lower()
                       for s in str(ctx.cfg.get("logFileFlags")).split(",") if s.strip())
        log_dir = os.path.join(d, "unitigger-logs") if lf else None
        tigs = build_unitigs(
            st, rs.length,
            max_erate=float(ctx.cfg.get("utgOvlErrorRate")),
            min_span=int(ctx.cfg.get("minOverlapLength")),
            min_reads_per_contig=int(ctx.cfg.get("contigFilterMinReads")),
            deviation=float(ctx.cfg.get("utgGraphDeviation")),
            # ~48 B per overlap row across the graph phase's columns
            max_rows=(bat_gb << 30) // 48 if bat_gb > 0 else 0,
            log_dir=log_dir, log_flags=lf,
        )
        # unitigs = the graph's tigs before repeat breaking (the
        # reference's separate utgStore/ctgStore, bogart.C:562-598)
        tigs.save(utg_dir, version=1)
        n_regions = n_broken = 0
        if bool(ctx.cfg.get("repeatDetect")):
            # bogart markRepeatReads + splitDiscontinuous (bogart.C:498-560)
            from ..graph import mark_repeats

            tigs, regions = mark_repeats(
                tigs, st, rs.length,
                min_evidence=int(ctx.cfg.get("repeatMinEvidence")),
                confused_absolute=float(ctx.cfg.get("repeatConfusedAbsolute")),
                confused_percent=float(ctx.cfg.get("repeatConfusedPercent")),
                min_reads_per_contig=int(ctx.cfg.get("contigFilterMinReads")),
            )
            n_regions = len(regions)
            n_broken = sum(1 for r in regions if r.broke)
            if log_dir and "repeats" in lf:
                os.makedirs(log_dir, exist_ok=True)
                with open(os.path.join(log_dir, "repeats.log"), "w") as fh:
                    fh.write("#tig\tbgn\tend\tbroke\n")
                    for r in regions:
                        fh.write(f"{r.tig_id}\t{r.bgn}\t{r.end}\t{int(r.broke)}\n")
        _contig_filter(ctx, tigs)
        tigs.save(ctg_dir, version=1)
        n_contig = sum(1 for t in tigs if t.tig_class == CLASS_CONTIG)
        ctx.report.add(
            "utg.unitig",
            f"{len(tigs)} tigs ({n_contig} contigs), N50 {tigs.n50()}; "
            f"repeat regions {n_regions} ({n_broken} broke a contig)",
        )

    run_stage(ctx, "unitig", tigs_done, tigs_fn)

    def cns_done() -> bool:
        return TigStore.latest_version(ctg_dir) >= 2

    def cns_fn() -> None:
        from ..ops.consensus import polish_tig

        tigs = TigStore.load(ctg_dir, version=1)
        # cnsConsensus: plurality (the vote engine) | dag (the tag-chain
        # consensus, ops.dagcon) | quick (mosaic only, utgcns -quick)
        algo = str(ctx.cfg.get("cnsConsensus")).lower()
        polish = bool(ctx.cfg.get("cnsPolish")) and algo != "quick"
        for t in tigs:
            backbone = quick_mosaic(rs, t)
            if polish and t.tig_class == CLASS_CONTIG and t.n_reads >= 2:
                t.consensus = polish_tig(
                    rs, t, backbone,
                    band=int(ctx.cfg.get("utgBandWidth")) * 2,
                    min_cov=int(ctx.cfg.get("cnsMinCoverage")),
                    rounds=int(ctx.cfg.get("cnsPolishRounds")),
                    max_coverage=int(ctx.cfg.get("cnsMaxCoverage")),
                    mode="dag" if algo == "dag" else "plurality",
                    device=dev,
                )
            else:
                t.consensus = backbone
        tigs.save(ctg_dir, version=2)

    run_stage(ctx, "consensus", cns_done, cns_fn)

    # outputs (Output.pm:56-160: contigs/unassembled FASTA and layouts)
    fasta_out = ctx.path(f"{ctx.prefix}.contigs.fasta")

    def out_done() -> bool:
        return os.path.exists(fasta_out)

    def out_fn() -> None:
        from ..io.fastx import write_fasta
        from ..io.gfa import write_gfa
        from .html import build_html

        tigs = TigStore.load(ctg_dir, version=2)
        contigs, unassembled = [], []
        layout_lines = []
        for t in tigs:
            seq = bitpack.codes_to_seq(t.consensus) if t.consensus is not None else ""
            name = f"tig{t.tig_id:08d}"
            rec = (f"{name} len={len(seq)} reads={t.n_reads}", seq)
            (contigs if t.tig_class == CLASS_CONTIG else unassembled).append(rec)
            for i in range(t.n_reads):
                layout_lines.append(f"{name}\t{int(t.read_id[i])}\t{int(t.bgn[i])}\t"
                                    f"{int(t.end[i])}\t{'-' if t.rev[i] else '+'}")
        write_fasta(fasta_out + ".WORKING", contigs)
        os.replace(fasta_out + ".WORKING", fasta_out)
        un = ctx.path(f"{ctx.prefix}.unassembled.fasta")
        write_fasta(un + ".WORKING", unassembled)
        os.replace(un + ".WORKING", un)
        # .unitigs.fasta: the graph's tigs before repeat breaking at mosaic
        # (draft) quality; the polish goes to the contigs
        ut = ctx.path(f"{ctx.prefix}.unitigs.fasta")
        if os.path.isdir(utg_dir):
            urecs = []
            for t in TigStore.load(utg_dir, version=1):
                if t.tig_class != CLASS_CONTIG:
                    continue
                seq = bitpack.codes_to_seq(quick_mosaic(rs, t))
                urecs.append((f"utg{t.tig_id:08d} len={len(seq)} reads={t.n_reads}", seq))
        else:
            urecs = contigs
        write_fasta(ut + ".WORKING", urecs)
        os.replace(ut + ".WORKING", ut)
        lay = ctx.path(f"{ctx.prefix}.layout.tsv")
        with open(lay + ".WORKING", "w") as fh:
            fh.write("\n".join(layout_lines) + ("\n" if layout_lines else ""))
        os.replace(lay + ".WORKING", lay)
        write_gfa(ctx.path(f"{ctx.prefix}.contigs.gfa"), tigs, rs, st, verify_edges=True,
                  device=dev)
        lens = sorted((len(s) for _, s in contigs), reverse=True)
        ctx.report.add("utg.output", f"{len(contigs)} contigs, {len(unassembled)} unassembled; "
                                     f"sizes {lens[:10]}")
        build_html(ctx.work_dir, ctx.prefix)

    run_stage(ctx, "outputs", out_done, out_fn)
