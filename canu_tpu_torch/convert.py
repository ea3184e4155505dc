"""Carry canu_tpu's state across to the port as numpy.

``read_index_from_numpy`` builds the port's ReadIndex from the arrays of a
canu_tpu ReadIndex (np.asarray of each plane), and ``frequent_from_npz``
loads the ``*.ms{k}.frequent.npz`` that either package's meryl stage
writes.  The tests use them to hand identical state to both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.hashing import u32_tensor
from .ops.kmer import FrequentKmers
from .ops.minimizers import ReadIndex


def read_index_from_numpy(words, length, mker, mpos, mstr, n_reads: int, k: int,
                          pm: int, device=None) -> ReadIndex:
    """Port ReadIndex from numpy planes: words/mker uint32, length/mpos/mstr
    int32, row i = read id i+1 plus the trailing padding row."""
    dev = resolve_device(device)

    def i32(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)

    return ReadIndex(
        words=u32_tensor(np.asarray(words), dev), length=i32(length),
        mker=u32_tensor(np.asarray(mker), dev), mpos=i32(mpos), mstr=i32(mstr),
        n_reads=int(n_reads), k=int(k), pm=int(pm),
    )


def frequent_from_npz(path: str) -> FrequentKmers:
    """FrequentKmers from a meryl stage's ``*.frequent.npz``."""
    with np.load(path) as z:
        return FrequentKmers(
            k=int(z["k"][0]),
            kmers=z["kmers"],
            fraction=z["fraction"],
            threshold=int(z["threshold"][0]),
            total_kmers=int(z["total"][0]),
        )
