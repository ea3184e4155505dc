"""Distributed overlap-store sort: bucketize -> all_to_all -> local sort
(counterpart of canu_tpu.parallel.storesort, on torch.distributed).

The reference builds its overlap store with a disk-based distributed
sort: ovStoreBucketizer scatters each overlapper output into per-slice
files, ovStoreSorter gathers one slice from every bucket and sorts it,
ovStoreIndexer merges the indexes (ovStoreBucketizer.C:50-71,
ovStoreSorter.C:202-245).  Across ranks the shuffle is ONE all_to_all
and the per-slice sort is a device sort; no filesystem.

The destination of a row is its a_id range slice, the reference's slice
key.  Fixed-capacity buckets of ``cap`` rows per (source, destination)
keep the exchange's shapes known to every rank; rows past a bucket's
capacity are counted as overflow so the caller can run again with a
bigger cap (the reference sizes its buckets by measuring first,
OverlapStore.pm:143-172).  Invalid rows (a_id <= 0) and overflow rows
are dropped, never written into a bucket: their destination and slot
stay out of bounds instead of being clamped into the last bucket, where
they would overwrite real rows.
"""

from __future__ import annotations

import numpy as np
import torch

from .launch import all_gather, all_reduce_sum, all_to_all, host_max, rank_world
from .mesh import _mesh, _world

BIG = np.iinfo(np.int32).max


def make_flat_mesh(n_devices: int | None = None):
    """1-D mesh ('d') over the world's ranks."""
    return _mesh((n_devices or rank_world()[1],), ("d",))


def _buckets(rows: torch.Tensor, n: int, n_reads: int, cap: int):
    """rows int32[B, C] (column 0 the 1-based a_id) into int32[n, cap, C]
    buckets by a_id range, BIG-padded; returns (buckets, overflow rows)."""
    B, C = rows.shape
    a_id = rows[:, 0].to(torch.int64)
    valid = a_id > 0
    dest = torch.clamp(((a_id - 1) * n) // max(1, n_reads), 0, n - 1)
    dest = torch.where(valid, dest, n)  # invalid rows go nowhere
    # slot in the destination bucket: rank among same-destination rows in
    # a stable sort by destination
    dsorted, order = torch.sort(dest, stable=True)
    idx = torch.arange(B, device=rows.device)
    is_start = torch.ones(B, dtype=torch.bool, device=rows.device)
    is_start[1:] = dsorted[1:] != dsorted[:-1]
    run_start = torch.cummax(torch.where(is_start, idx, -1), 0).values
    slot = torch.empty(B, dtype=torch.int64, device=rows.device)
    slot[order] = idx - run_start
    overflow = ((slot >= cap) & valid).sum().reshape(1)
    keep = (dest < n) & (slot < cap)
    buckets = torch.full((n, cap, C), BIG, dtype=torch.int32, device=rows.device)
    buckets[dest[keep], slot[keep]] = rows[keep]
    return buckets, overflow


def sharded_sort_overlaps(mesh, n_reads: int, cap: int):
    """The distributed store sort.

    step(rows int32[B, C]) with column 0 the 1-based a_id, this rank's rows
    -> (int32[n*cap, C] the rows of this rank's a_id range sorted by
    (a_id, b_id), BIG-padded; overflow int64[1] summed over ranks).
    """
    n = _world(mesh)

    def step(rows):
        buckets, overflow = _buckets(rows, n, n_reads, cap)
        # the shuffle: gathered[s] = the bucket rank s filled for this rank
        flat = all_to_all(buckets).reshape(n * cap, rows.shape[1])
        key = flat[:, 0].to(torch.int64) * (n_reads + 2) + flat[:, 1].to(torch.int64)
        return flat[torch.argsort(key, stable=True)], all_reduce_sum(overflow)

    return step


def _exchange_step(n: int, n_reads: int, cap: int):
    """Bucketize + all_to_all without the device sort (the range exchange
    lexsorts on the host on every column, a deterministic store): rows
    int32[B, C] in, int32[n*cap, C] out, every row whose a_id range lands
    on this rank, BIG-padded."""

    def step(rows):
        buckets, _ = _buckets(rows, n, n_reads, cap)
        return all_to_all(buckets).reshape(n * cap, rows.shape[1])

    return step


def process_range_exchange(rows_local: np.ndarray, n_reads: int, device=None) -> np.ndarray:
    """a_id-range exchange of store rows across ranks.

    Each rank passes its locally verified, already symmetrized rows
    int32[m, 8] in stores.overlaps._COLS order and gets back the rows whose
    a_id falls in its contiguous range, lexsorted on (a_id, b_id, then
    every other column): a content order, whatever the arrival order.  No
    rank holds the full table: the shuffle is one all_to_all on ``device``
    (the rank's card unless the caller names one), the reference's
    ovStoreBucketizer/Sorter filesystem shuffle as a collective.  The
    bucket capacity is measured from the data on every rank first (the
    reference's sizing pass, OverlapStore.pm:143-172).
    """
    from ..device import resolve_device

    if rows_local.ndim != 2 or rows_local.shape[1] != 8:
        raise ValueError(f"rows must be [m, 8], got {rows_local.shape}")
    n = rank_world()[1]
    if n == 1:
        order = np.lexsort(tuple(rows_local.T[::-1]))
        return np.ascontiguousarray(rows_local[order])
    dev = resolve_device(device)
    m = len(rows_local)
    per = host_max(max(m, 1))
    padded = np.zeros((per, 8), np.int32)  # a_id = 0 rows are invalid
    padded[:m] = rows_local
    a_id = padded[:, 0].astype(np.int64)
    dest = np.clip(((a_id - 1) * n) // max(1, n_reads), 0, n - 1)
    cap = max(1, host_max(int(np.bincount(dest[a_id > 0], minlength=n).max(initial=0))))
    out = _exchange_step(n, n_reads, cap)(torch.from_numpy(padded).to(dev)).cpu().numpy()
    mine = out[out[:, 0] != BIG]
    order = np.lexsort(tuple(mine.T[::-1]))
    return np.ascontiguousarray(mine[order])


def distributed_store_sort(rows: np.ndarray, n_reads: int, mesh=None, cap: int | None = None,
                           device=None) -> np.ndarray:
    """Every rank passes the same full table and gets it back sorted by
    (a_id, b_id), the contract of OverlapStore.build's lexsort, computed
    with the shuffle: rank r sorts rows r*per .. (r+1)*per into the a_id
    ranges, and the ranges' rows are gathered in rank order.  cap: bucket
    rows per (source, destination), by default every local row (no
    overflow possible); an overflow raises."""
    from ..device import resolve_device

    n = _world(mesh)
    dev = resolve_device(device)
    r = rank_world()[0]
    N, C = rows.shape
    per = (N + n - 1) // n
    if cap is None:
        cap = max(1, per)
    padded = np.zeros((per * n, C), np.int32)
    padded[:N] = rows
    out, overflow = sharded_sort_overlaps(mesh, n_reads, cap)(
        torch.from_numpy(padded[r * per : (r + 1) * per]).to(dev))
    if int(overflow) > 0:
        raise RuntimeError(f"bucket overflow: {int(overflow)} rows; raise cap")
    out = all_gather(out).cpu().numpy()
    return out[out[:, 0] != BIG]
