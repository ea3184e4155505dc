"""Stage runner (counterpart of canu_tpu.pipeline.driver.run_stage,
single-process branch).

Reuses canu_tpu's AssemblyCtx / make_ctx and its resume contract: a stage
is done when its output files exist, runs up to canuIterationMax times,
honours stopBefore/stopAfter/showNext, and appends one line per completed
attempt to <prefix>.stage-times.jsonl.  A CUDA out-of-memory attempt
releases the allocator's cache and halves the verify in-flight budget
before the retry.
"""

from __future__ import annotations

import json
import time
import traceback
from typing import Callable

import torch

from canu_tpu.pipeline.driver import AssemblyCtx, PipelineError, StopPipeline, make_ctx  # noqa: F401

from ..ops import align as _align


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
