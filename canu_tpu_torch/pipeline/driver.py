"""Assembly context, stage runner and pipeline (counterpart of
canu_tpu.pipeline.driver: AssemblyCtx, make_ctx, the single-process
branch of run_stage, and run_pipeline).

The same contract as canu_tpu: make_ctx writes the invocation audit and
installs the crash catcher in <work_dir>/canu-logs/ and logs there; a
stage is done when its output files exist, runs up to canuIterationMax
times, honours stopBefore/stopAfter/showNext, and appends one line per
completed attempt to <prefix>.stage-times.jsonl.  A CUDA out-of-memory
attempt drops the device tensors cached on read sets, releases the
allocator's cache and halves the verify in-flight budget before the
retry.  run_pipeline runs the phases correction -> trimming -> assembly
from whichever input it is given, on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import json
import logging
import os
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import Config, ConfigError
from ..device import resolve_device
from ..ops import align as _align
from ..stores.readset import drop_device_caches
from .report import Report


class PipelineError(RuntimeError):
    pass


class StopPipeline(Exception):
    """Raised to honor stopAfter."""


@dataclass
class AssemblyCtx:
    work_dir: str
    prefix: str
    cfg: Config
    report: Report = None  # type: ignore[assignment]
    log: logging.Logger = None  # type: ignore[assignment]

    def path(self, *parts: str) -> str:
        return os.path.join(self.work_dir, *parts)

    def phase_dir(self, phase: str) -> str:
        d = self.path(phase)
        os.makedirs(d, exist_ok=True)
        return d


def make_ctx(work_dir: str, prefix: str, cfg: Config) -> AssemblyCtx:
    os.makedirs(work_dir, exist_ok=True)
    logs = os.path.join(work_dir, "canu-logs")
    os.makedirs(logs, exist_ok=True)
    # AS_global-equivalent process init: invocation audit + crash catcher
    from ..utils.runtime import audit_invocation, install_crash_catcher

    audit_invocation(logs)
    install_crash_catcher(logs)
    logger = logging.getLogger(f"canu_tpu_torch.{prefix}")
    if not logger.handlers:
        logger.setLevel(logging.INFO)
        fh = logging.FileHandler(os.path.join(logs, f"{int(time.time())}_{os.getpid()}.log"))
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("-- %(message)s"))
        logger.addHandler(sh)
    ctx = AssemblyCtx(work_dir, prefix, cfg)
    ctx.report = Report(os.path.join(work_dir, f"{prefix}.report"))
    ctx.log = logger
    return ctx


def run_stage(ctx: AssemblyCtx, name: str, done: Callable[[], bool],
              fn: Callable[[], None]) -> None:
    """Idempotent stage execution with bounded retries + stop points."""
    if ctx.cfg.get("stopBefore").lower() == name.lower() and not done():
        ctx.log.info(f"stopBefore={name}: halting")
        raise StopPipeline(name)
    if bool(ctx.cfg.get("showNext")) and not done():
        ctx.log.info(f"showNext: next stage is '{name}'")
        print(f"next stage: {name}", flush=True)
        raise StopPipeline(name)
    if done():
        ctx.log.info(f"{name}: already done, skipping")
    else:
        max_iter = int(ctx.cfg.get("canuIterationMax"))
        for attempt in range(1, max_iter + 1):
            t0 = time.time()
            ctx.log.info(f"{name}: start (attempt {attempt}/{max_iter})")
            try:
                fn()
                if not done():
                    raise PipelineError(f"{name}: ran but outputs missing")
            except (StopPipeline, KeyboardInterrupt, NotImplementedError):
                raise
            except Exception as e:
                ctx.log.error(f"{name}: attempt {attempt} failed: {e}\n{traceback.format_exc()}")
                if attempt == max_iter:
                    raise PipelineError(f"{name} failed after {max_iter} attempts") from e
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    # free what the failed attempt left cached on the card
                    # (canu_tpu deletes every live device array here)
                    n_sets = drop_device_caches()
                    torch.cuda.empty_cache()
                    _align._INFLIGHT_BACKOFF = max(0.05, _align._INFLIGHT_BACKOFF * 0.5)
                    ctx.log.info(f"{name}: CUDA OOM; dropped the device caches of {n_sets} "
                                 f"read sets; verify in-flight budget "
                                 f"x{_align._INFLIGHT_BACKOFF:g}")
                continue
            wall = time.time() - t0
            ctx.log.info(f"{name}: done in {wall:.1f}s")
            try:
                with open(ctx.path(f"{ctx.prefix}.stage-times.jsonl"), "a") as fh:
                    json.dump({"stage": name, "wall_s": round(wall, 1), "attempt": attempt,
                               "t_end": round(time.time(), 1)}, fh)
                    fh.write("\n")
            except OSError:
                pass
            break
    if ctx.cfg.get("stopAfter").lower() == name.lower():
        ctx.log.info(f"stopAfter={name}: halting")
        raise StopPipeline(name)


# ---- pipeline --------------------------------------------------------------


def _check_pipeline_config(cfg: Config) -> None:
    """The configuration the port does not run, refused before any stage."""
    if bool(cfg.get("useGrid")):
        raise NotImplementedError(
            "useGrid (the multi-host launcher) is not ported to canu_tpu_torch yet: it has no "
            "torch.distributed launcher (ROADMAP item 13)")


def run_pipeline(
    work_dir: str,
    prefix: str,
    cfg: Config,
    raw_reads: Optional[list[str]] = None,
    corrected_reads: Optional[list[str]] = None,
    trimmed_reads: Optional[list[str]] = None,
    device=None,
) -> AssemblyCtx:
    """Full pipeline: correct -> trim -> assemble, from the reference's
    -pacbio-raw / -pacbio-corrected / -trimmed entry points (canu.pl
    mode detection, canu.pl:341-525), on ``device`` (the card unless the
    caller says "cpu").  objectStore fetches finished phase outputs first
    and stashes each one as it lands; onSuccess/onFailure run after."""
    from . import stages

    cfg.apply_read_type_profile()
    cfg.validate()
    _check_pipeline_config(cfg)
    dev = resolve_device(device)
    ctx = make_ctx(work_dir, prefix, cfg)
    with open(ctx.path(f"{prefix}.spec.used"), "w") as fh:
        json.dump(cfg.to_dict(), fh, indent=1, default=str)
    # resource solver (Configure.pm role): host memory and threads and the
    # card's memory set spill thresholds, sort budgets and the vote
    # engine's chunk geometry
    from .configure import configure_resources

    configure_resources(cfg, ctx.log)

    obstore = None
    spec = str(cfg.get("objectStore")).strip()
    if spec:
        from .objectstore import make_object_store

        obstore = make_object_store(spec)

    def _stage_outputs() -> list[tuple[str, str]]:
        # (local path, object key) of the durable phase outputs
        outs = [f"correction/{prefix}.correctedReads.fasta.gz",
                f"trimming/{prefix}.trimmedReads.fasta.gz",
                f"{prefix}.contigs.fasta", f"{prefix}.unitigs.fasta", f"{prefix}.report"]
        return [(ctx.path(p), f"{prefix}/{p}") for p in outs]

    if obstore is not None:
        # fetch finished outputs first: a fresh machine resumes from the
        # bucket as Grid_Cloud fetches stores before a stage
        for local, key in _stage_outputs():
            if not os.path.exists(local) and obstore.exists(key):
                os.makedirs(os.path.dirname(local), exist_ok=True)
                obstore.fetch_file(key, local)
                ctx.log.info("objectStore: fetched %s", key)

    def _hook(name: str) -> None:
        # onSuccess/onFailure user hooks (Defaults.pm:764-765)
        cmd = str(cfg.get(name)).strip()
        if cmd:
            import subprocess

            subprocess.run([cmd, prefix], cwd=work_dir, check=False)

    stashed: set[str] = set()

    def _stash_ready() -> None:
        # stash every durable output that exists now, so a fresh machine
        # can resume mid-pipeline from the bucket
        if obstore is None:
            return
        for local, key in _stage_outputs():
            if key not in stashed and os.path.exists(local):
                obstore.stash_file(local, key)
                stashed.add(key)
                ctx.log.info("objectStore: stashed %s", key)

    try:
        if raw_reads is not None:
            stages.correction_phase(ctx, raw_reads, device=dev)
            corrected_reads = [ctx.path("correction", f"{prefix}.correctedReads.fasta.gz")]
            _stash_ready()
        if corrected_reads is not None:
            stages.trimming_phase(ctx, corrected_reads, device=dev)
            trimmed_reads = [ctx.path("trimming", f"{prefix}.trimmedReads.fasta.gz")]
            _stash_ready()
        if trimmed_reads is None:
            raise ConfigError("no input reads given")
        stages.assembly_phase(ctx, trimmed_reads, device=dev)
    except StopPipeline:
        _stash_ready()
    except Exception:
        _stash_ready()
        _hook("onFailure")
        raise
    _stash_ready()
    from ..utils.runtime import rusage

    ru = rusage()
    ctx.log.info(f"pipeline finished: cpu {ru['utime_s']:.1f}s user / "
                 f"{ru['stime_s']:.1f}s sys, peak rss {ru['max_rss_mb']:.0f} MB")
    _hook("onSuccess")
    return ctx
