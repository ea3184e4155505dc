"""Assembly context and stage runner (counterpart of
canu_tpu.pipeline.driver: AssemblyCtx, make_ctx and the single-process
branch of run_stage).

The same contract as canu_tpu: make_ctx writes the invocation audit and
installs the crash catcher in <work_dir>/canu-logs/ and logs there; a
stage is done when its output files exist, runs up to canuIterationMax
times, honours stopBefore/stopAfter/showNext, and appends one line per
completed attempt to <prefix>.stage-times.jsonl.  A CUDA out-of-memory
attempt releases the allocator's cache and halves the verify in-flight
budget before the retry.
"""

from __future__ import annotations

import json
import logging
import os
import time
import traceback
from dataclasses import dataclass
from typing import Callable

import torch

from ..config import Config
from ..ops import align as _align
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
                    torch.cuda.empty_cache()
                    _align._INFLIGHT_BACKOFF = max(0.05, _align._INFLIGHT_BACKOFF * 0.5)
                    ctx.log.info(f"{name}: CUDA OOM; verify in-flight budget "
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
