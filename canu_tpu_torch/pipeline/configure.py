"""Resource solver, the part the overlap stage reads (counterpart of
canu_tpu.pipeline.configure.configure_resources).

maxMemory (host GB) bounds the in-RAM overlap build — above the derived
candidate count the store would stream through the spill file — and the
external sort's memory; maxThreads its worker threads.  The vote-engine
device budgets wait for the correction port.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Resources:
    spill_pairs: int
    sort_mem_bytes: int
    sort_threads: int
    decisions: dict


# bytes per overlap row across the build path (REC on disk + columnar
# store copy + mirror), with headroom
_BYTES_PER_PAIR = 120


def configure_resources(cfg, log=None) -> Resources:
    decisions: dict = {}
    mem_gb = int(cfg.get("maxMemory"))
    threads = int(cfg.get("maxThreads"))
    spill_pairs = int(cfg.get("ovlSpillPairs"))
    sort_mem = 1 << 30
    if mem_gb > 0:
        cap = max(1_000_000, (mem_gb << 30) // 4 // _BYTES_PER_PAIR)
        if cap < spill_pairs:
            spill_pairs = cap
            decisions["ovlSpillPairs"] = cap
        sort_mem = max(64 << 20, (mem_gb << 30) // 8)
        decisions["sortMemBytes"] = sort_mem
    sort_threads = max(0, threads)  # 0 = native default (hw concurrency)
    if threads > 0:
        decisions["sortThreads"] = threads
    if log is not None and decisions:
        log.info("configure: %s", decisions)
    return Resources(spill_pairs, sort_mem, sort_threads, decisions)
