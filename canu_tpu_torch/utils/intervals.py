"""Interval coverage math (intervalList equivalent).

The port's own copy of canu_tpu.utils.intervals (numpy only), with the
same results.

Replaces the reference's intervalList (Canu src/AS_UTL/
intervalList.H — union/depth computations underlying trimReads,
filterCorrectionLayouts and bogus) with numpy event sweeps.
"""

from __future__ import annotations

import numpy as np


def coverage_depth_events(spans: np.ndarray):
    """spans int[n,2] -> (positions, depth_after_position) event sweep."""
    if len(spans) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ev = np.concatenate([
        np.stack([spans[:, 0], np.ones(len(spans), dtype=spans.dtype)], axis=1),
        np.stack([spans[:, 1], -np.ones(len(spans), dtype=spans.dtype)], axis=1),
    ])
    order = np.lexsort((ev[:, 1], ev[:, 0]))
    ev = ev[order]
    pos = ev[:, 0].astype(np.int64)
    depth = np.cumsum(ev[:, 1]).astype(np.int64)
    return pos, depth


def covered_intervals(spans: np.ndarray, min_cov: int = 1) -> np.ndarray:
    """Maximal intervals with coverage >= min_cov. Returns int64[m, 2]."""
    pos, depth = coverage_depth_events(spans)
    out = []
    start = None
    for p, d in zip(pos, depth):
        if d >= min_cov and start is None:
            start = p
        elif d < min_cov and start is not None:
            if p > start:
                out.append((start, p))
            start = None
    # depth always returns to 0 at the last event, closing any interval
    return np.array(out, dtype=np.int64) if out else np.zeros((0, 2), np.int64)


def covered_intervals_all(
    owner: np.ndarray, bgn: np.ndarray, end: np.ndarray, min_cov: int = 1
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """covered_intervals for MANY owners in one columnar sweep.

    owner int[n] groups spans (e.g. 1-based read id); returns
    (iv_owner, iv_bgn, iv_end) for every maximal interval with coverage
    >= min_cov, ordered by (owner, bgn).  Event-order semantics are
    identical to covered_intervals (at equal positions a close precedes
    an open, so touching spans yield two adjacent intervals).
    """
    n = len(owner)
    if n == 0:
        z = np.zeros(0, np.int64)
        return z, z, z
    pos = np.concatenate([bgn, end]).astype(np.int64)
    delta = np.concatenate([np.ones(n, np.int64), -np.ones(n, np.int64)])
    own = np.concatenate([owner, owner]).astype(np.int64)
    order = np.lexsort((delta, pos, own))
    own, pos, delta = own[order], pos[order], delta[order]
    cum = np.cumsum(delta)
    new_seg = np.concatenate([[True], own[1:] != own[:-1]])
    seg_off = np.maximum.accumulate(np.where(new_seg, cum - delta, np.int64(0)))
    depth = cum - seg_off
    above = depth >= min_cov
    prev_above = np.concatenate([[False], above[:-1]]) & ~new_seg
    s_idx = np.flatnonzero(above & ~prev_above)
    e_idx = np.flatnonzero(~above & prev_above)
    # depth returns to 0 at each owner's last event, so starts/ends
    # alternate within every segment and pair positionally
    assert len(s_idx) == len(e_idx)
    keep = pos[e_idx] > pos[s_idx]
    return own[s_idx[keep]], pos[s_idx[keep]], pos[e_idx[keep]]


def largest_covered(spans: np.ndarray, min_cov: int = 1) -> tuple[int, int]:
    """Largest interval covered >= min_cov (trimReads-largestCovered
    equivalent, Canu src/overlapBasedTrimming/
    trimReads-largestCovered.C). Returns (bgn, end); (0, 0) if none."""
    iv = covered_intervals(spans, min_cov)
    if len(iv) == 0:
        return (0, 0)
    best = int(np.argmax(iv[:, 1] - iv[:, 0]))
    return int(iv[best, 0]), int(iv[best, 1])
