"""Quality-value math: QV-based clear ranges (trimReads-quality role).

The port's own copy of canu_tpu.utils.quality (numpy only), with the same
results.

The reference's quality trimming (Canu src/overlapBasedTrimming/
trimReads-quality.C) finds the largest interval of a read whose windowed
mean error probability stays below a threshold.  Here the sweep is
columnar: reads are processed in padded chunks, windows via cumsum, and
the longest good run per read via one maximum.accumulate — no per-base
Python.
"""

from __future__ import annotations

import numpy as np


def phred_to_error(qv: np.ndarray) -> np.ndarray:
    """Phred QV -> error probability (float32)."""
    return np.power(10.0, -qv.astype(np.float32) / 10.0).astype(np.float32)


def quality_clear_ranges(
    length: np.ndarray,
    quals: np.ndarray,
    qual_off: np.ndarray,
    min_qv: float = 7.0,
    window: int = 100,
    chunk: int = 4096,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-read largest interval with windowed mean error prob <= p(min_qv).

    Positions with QV 0 ("unknown", e.g. FASTA records mixed into a FASTQ
    load) are treated as exactly-threshold quality, so unknown-quality
    reads keep their full span.  Returns (bgn[n], end[n]) int32 clear
    ranges; a read with no good window gets (0, 0).
    """
    n = len(length)
    bgn = np.zeros(n, np.int32)
    end = np.zeros(n, np.int32)
    if n == 0:
        return bgn, end
    p_min = float(np.power(10.0, -float(min_qv) / 10.0))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        ln = length[lo:hi].astype(np.int64)
        L = int(ln.max()) if len(ln) else 1
        C = hi - lo
        # padded error-prob matrix; pad (and unknown QV) = exactly p_min,
        # neutral at window boundaries
        P = np.full((C, L + 1), p_min, np.float32)  # +1 col for cumsum ease
        for r in range(C):
            q = quals[qual_off[lo + r] : qual_off[lo + r] + ln[r]]
            pr = phred_to_error(q)
            pr[q == 0] = p_min
            P[r, 1 : 1 + ln[r]] = pr
        cs = np.cumsum(P, axis=1, dtype=np.float64)
        W = max(1, int(window))
        # windowed sum starting at i (window may run into neutral padding)
        csp = np.pad(cs, ((0, 0), (0, W)), mode="edge")
        wsum = csp[:, W:] - csp[:, :-W]  # [C, L+1] -> use cols 0..L-1
        wsum = wsum[:, :L]
        # padded tail cols beyond cs add nothing (edge pad) -> compensate:
        # windows that overrun the cumsum end lose (overrun * p_min)
        overrun = np.maximum(np.arange(L)[None, :] + W - (cs.shape[1] - 1), 0)
        wsum = wsum + overrun * p_min
        idx = np.arange(L)[None, :]
        good = (wsum <= p_min * W * (1 + 1e-6)) & (idx < ln[:, None])
        last_bad = np.maximum.accumulate(np.where(~good, idx, -1), axis=1)
        runlen = np.where(good, idx - last_bad, 0)
        e_i = np.argmax(runlen, axis=1)
        best = runlen[np.arange(C), e_i]
        has = best > 0
        b = (e_i - best + 1).astype(np.int64)
        e = np.minimum(e_i + W, ln)
        bgn[lo:hi] = np.where(has, b, 0).astype(np.int32)
        end[lo:hi] = np.where(has, e, 0).astype(np.int32)
    return bgn, end


def read_quality_histogram(mean_qv: np.ndarray, bin_size: int = 2) -> np.ndarray:
    """Histogram of per-read mean QV (for the gatekeeper report)."""
    if len(mean_qv) == 0:
        return np.zeros(0, np.int64)
    return np.bincount((mean_qv / bin_size).astype(np.int64))
