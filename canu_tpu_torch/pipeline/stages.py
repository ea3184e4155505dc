"""meryl and overlap pipeline stages (counterpart of
canu_tpu.pipeline.stages.meryl / overlap).

Same signatures, outputs, file names, resume contract and
stage-times.jsonl lines as canu_tpu, so either package's stage output can
feed the other.  Configurations outside the ported slice raise
NotImplementedError naming the ROADMAP item that will port them; none of
them changes behaviour silently.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from ..convert import frequent_from_npz
from ..device import resolve_device
from ..ops.errorest import estimate_error_rates
from ..stores.readset import ReadSet
from ..stores.overlaps import OverlapStore
from .driver import AssemblyCtx, run_stage

TAG_DIR = {"cor": "correction", "obt": "trimming", "utg": "unitigging"}


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to canu_tpu_torch yet (ROADMAP: {item})")


def _check_single_device(cfg) -> None:
    """shardedCompute=auto runs on one device (the sharded path gives the
    same counts and candidates); an explicit request for it raises."""
    if str(cfg.get("shardedCompute")).strip().lower() in ("1", "true", "yes", "on"):
        raise _not_ported("shardedCompute (the multi-device path)", "sharding")


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
        custom = str(ctx.cfg.get(tag + "OvlFrequentMers")).strip()
        if custom:
            raise _not_ported(f"{tag}OvlFrequentMers", "host k-mer counter")
        # merylMemory scales the device instance budget
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
        np.savez(out + ".WORKING.npz", kmers=fk.kmers, fraction=fk.fraction,
                 threshold=np.array([fk.threshold]), total=np.array([fk.total_kmers]),
                 k=np.array([k]))
        os.replace(out + ".WORKING.npz", out)
        if bool(ctx.cfg.get("saveMerCounts")):
            kh = kc.to_host()
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


def overlap(ctx: AssemblyCtx, tag: str, rs: ReadSet, fk, device=None) -> OverlapStore:
    """Sketch -> candidates -> anchored banded verify -> OverlapStore.

    {tag}OvlBandWidth 128 verifies on the Myers engine (kernel K1 on
    CUDA); any other band on the INF-walled engine (kernel K2)."""
    from ..ops import align as AL
    from ..ops import minhash as MH

    d = ctx.phase_dir(TAG_DIR[tag])
    store = os.path.join(d, f"{ctx.prefix}.ovlStore")

    def done() -> bool:
        return os.path.isdir(store)

    def fn() -> None:
        cfg = ctx.cfg
        dev = resolve_device(device)
        _check_single_device(cfg)
        if str(cfg.get(tag + "Overlapper")) == "minimap":
            raise _not_ported(f"{tag}Overlapper=minimap", "minimap overlapper")
        me = str(cfg.get("mhapMatchEngine")).lower()
        if me == "join" or (me == "auto" and rs.n_reads > 5_000):
            raise _not_ported(
                f"mhapMatchEngine={me} with {rs.n_reads} reads (the host hash-join)",
                "find_candidates_join")
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
            sk = MH.build_sketches(rs, k=k, n_hashes=n_hashes, frequent=fk,
                                   block_size=int(cfg.get("mhapBlockSize")), device=dev)
            _lap("sketch")
            pairs = MH.find_candidates(sk, min_matches=min_matches, block_size=1024,
                                       device=dev)
            del sk
            np.save(pairs_ckpt + ".WORKING.npy", pairs)
            os.replace(pairs_ckpt + ".WORKING.npy", pairs_ckpt)
            _lap("match")
        from .configure import configure_resources

        res = configure_resources(cfg, ctx.log)
        ovs = str(cfg.get("ovsMethod")).lower()
        if (len(pairs) >= res.spill_pairs) if ovs == "auto" else ovs == "spill":
            raise _not_ported(f"ovsMethod={ovs} with {len(pairs)} candidate pairs "
                              "(the spill store)", "spill store")
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
            device=dev,
        )
        _lap("verify")
        verify_prof = dict(AL.LAST_PROFILE)
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
