"""Resource solver (counterpart of canu_tpu.pipeline.configure.
configure_resources).

maxMemory (host GB) bounds the in-RAM overlap build — from the derived
candidate count on, the store streams through the spill file — and the
external sort's memory; maxThreads its worker threads.  The vote
engine's DP cells per chunk (votepile.CHUNK_CELL_BUDGET) are sized from
the card's memory (torch.cuda.mem_get_info), not from maxMemory.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import votepile as VP
from ..ops.trace import SMAX, SROW


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
    # the vote engine's DP state is its peak: keep a chunk's cells
    # ([n_rows, B, window] bytes, window = band + SMAX*SROW) under ~1/6 of
    # the card; votepile.chunk_jobs caps a chunk at 256 jobs, so at 2,048
    # rows a chunk is 256 jobs on an 80 GB card.  One DP call on the card
    # takes a group of chunks whose kernel K4 scratch fits the same 1/6,
    # which votepile.group_chunks works out from the card it runs on.
    # Votes are exact float32 sums, so neither size changes a corrected
    # base
    card = int(torch.cuda.mem_get_info()[1]) if torch.cuda.is_available() else 0
    if card > 0:
        cells = max(1 << 19, min(1 << 23, (card // 6) // (256 + SMAX * SROW)))
        if cells != VP.CHUNK_CELL_BUDGET:
            VP.CHUNK_CELL_BUDGET = cells
            decisions["chunkCellBudget"] = cells
    if log is not None and decisions:
        log.info("configure: %s", decisions)
    return Resources(spill_pairs, sort_mem, sort_threads, decisions)

