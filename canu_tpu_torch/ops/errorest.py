"""Error-rate estimation from overlap evidence (errorEstimate equivalent).

The port's own copy of canu_tpu.ops.errorest (numpy only).

The reference optionally estimates the true raw-read error rate by
fitting the error distribution of a sample of overlaps
(Canu src/erateEstimate/erateEstimate.C, driven by
ErrorEstimate.pm:122-140: mhap on a read sample piped to errorEstimate)
and a Poisson unique-kmer coverage threshold (ErrorEstimate.pm:53-98).

Here the verified overlap table already carries EXACT banded-alignment
edit rates, so the estimate is a robust distribution summary instead of
a curve fit: the per-overlap erate of two reads with per-base error e is
~2e(1-e) (independent errors rarely cancel), inverted to recover e, and
the gate is set past the bulk of the distribution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ErrorEstimate:
    median_erate: float  # median per-overlap alignment error
    p95_erate: float  # 95th percentile
    read_error: float  # inferred per-read error rate
    suggested_ovl_erate: float  # gate covering ~all true overlaps
    n_sampled: int


def estimate_error_rates(erates: np.ndarray, margin: float = 1.25) -> ErrorEstimate:
    """Summarize an overlap-erate sample into suggested pipeline rates.

    erates: float array of per-overlap alignment error rates (e.g.
    OverlapTable.erate or OverlapStore.erate).  The suggested gate is
    margin * p95, clipped to [0.01, 0.5].
    """
    if len(erates) == 0:
        return ErrorEstimate(0.0, 0.0, 0.0, 0.12, 0)
    med = float(np.median(erates))
    p95 = float(np.percentile(erates, 95))
    # per-overlap rate ~ 2e(1-e)  =>  e = (1 - sqrt(1 - 2r)) / 2 for r < .5
    r = min(med, 0.49)
    read_err = (1.0 - np.sqrt(max(0.0, 1.0 - 2.0 * r))) / 2.0
    gate = float(np.clip(margin * p95, 0.01, 0.5))
    return ErrorEstimate(med, p95, float(read_err), gate, len(erates))
