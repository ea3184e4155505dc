"""Per-read syncmer seed index (counterpart of canu_tpu.ops.minimizers).

One pass over the read set selects OPEN SYNCMERS — a k-mer is selected
iff the minimal canonical s-mer hash inside it sits at the middle offset
t = (k-s)/2 — and compacts the selected (kmer, pos, strand) triples per
read into fixed-width planes that stay on the device.  The verifier
gathers rows of those planes by read id.  Selection depends only on the
k-mer's own content, so a k-mer shared by two noisy reads is selected in
both or neither, and it is strand-symmetric.

The index is cached on its ReadSet (stores.readset.device_cache).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..stores.readset import ReadSet, device_cache
from ..utils.bitpack import n_words
from .hashing import mix32, u32_tensor
from .kmer import INVALID_KMER, block_tensors, extract_kmers, extract_kmers_any, length_bucketed_blocks

UINT32_MAX = 0xFFFFFFFF
# k-mer window over s-mers: s = k - SYNC_DELTA, density 1/(SYNC_DELTA+1).
# SYNC_DELTA must be even so the middle offset is strand-symmetric.
SYNC_DELTA = 4


def syncmer_params(k: int) -> tuple[int, int]:
    """(s, t): s-mer size and middle offset for open-syncmer selection."""
    if k <= 16 + SYNC_DELTA:
        s = k - SYNC_DELTA
    else:
        s = 16 if (k % 2 == 0) else 15
    return s, (k - s) // 2


def _shift_left(x: torch.Tensor, s: int, fill) -> torch.Tensor:
    """x[:, p+s] with `fill` entering on the right."""
    pad = torch.full((x.shape[0], s), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x[:, s:], pad], dim=1)


def _window_min_fwd(x: torch.Tensor, w: int) -> torch.Tensor:
    """m[p] = min(x[p .. p+w-1]) (truncated at the right edge)."""
    cov, m = 1, x
    while cov < w:
        s = min(cov, w - cov)
        m = torch.minimum(m, _shift_left(m, s, UINT32_MAX))
        cov += s
    return m


def _syncmer_kernel(words, lengths, k: int, pm: int):
    """Select + compact open syncmers of one padded read block.

    Returns (mker int64[B, pm], mpos int32[B, pm], mstr int32[B, pm],
    n_sel int32[B]); empty slots have mker == INVALID_KMER, mpos -1.
    The compaction is a STABLE sort by mix32(kmer), the order XLA's sort
    gives on equal keys.
    """
    s, t = syncmer_params(k)
    if s < 2:
        raise ValueError(f"k={k} too small for syncmer selection")
    canon, strand = extract_kmers_any(words, lengths, k)  # [B, Pk]
    valid = canon != INVALID_KMER
    B, Pk = canon.shape

    scanon, _ = extract_kmers(words, lengths, s)  # [B, Pk + (k-s)]
    hs = torch.where(scanon != INVALID_KMER, mix32(scanon), UINT32_MAX)
    wm = _window_min_fwd(hs, k - s + 1)
    hs_t = _shift_left(hs, t, UINT32_MAX) if t else hs
    sel = (hs_t[:, :Pk] == wm[:, :Pk]) & valid

    key = torch.where(sel, mix32(canon), UINT32_MAX)
    _, order = torch.sort(key, dim=1, stable=True)
    n_sel = sel.sum(dim=1, dtype=torch.int32)
    take = min(pm, Pk)
    order = order[:, :take]
    canon_s = torch.gather(canon, 1, order)
    pos_s = order.to(torch.int32)
    str_s = torch.gather(strand, 1, order).to(torch.int32)
    if take < pm:
        canon_s = torch.nn.functional.pad(canon_s, (0, pm - take), value=INVALID_KMER)
        pos_s = torch.nn.functional.pad(pos_s, (0, pm - take), value=-1)
        str_s = torch.nn.functional.pad(str_s, (0, pm - take), value=0)
    col = torch.arange(pm, dtype=torch.int32, device=words.device)[None, :]
    live = col < n_sel[:, None]
    return (
        torch.where(live, canon_s, INVALID_KMER),
        torch.where(live, pos_s, -1),
        torch.where(live, str_s, 0),
        torch.clamp(n_sel, max=pm),
    )


@dataclass
class ReadIndex:
    """Device-resident packed reads + syncmer seeds (verify-path index).

    Row i holds read id i+1; a trailing all-zero row is the padding target
    for short chunks.
      words  int64[Npad, W]   2-bit packed bases (uint32 values)
      length int32[Npad]
      mker   int64[Npad, Pm]  canonical syncmer k-mers (INVALID pad)
      mpos   int32[Npad, Pm]  positions (forward-read coords)
      mstr   int32[Npad, Pm]  1 where the rc form was canonical
    """

    words: torch.Tensor
    length: torch.Tensor
    mker: torch.Tensor
    mpos: torch.Tensor
    mstr: torch.Tensor
    n_reads: int
    k: int
    pm: int

    @property
    def n_rows(self) -> int:
        return self.words.shape[0]


def build_read_index(readset: ReadSet, k: int = 16, pm: int | None = None,
                     block_size: int = 128, device=None) -> ReadIndex:
    """Build the device index of a read set in one pass.

    pm defaults to P/4 (syncmer density 1/5), capped at 2048.
    """
    dev = resolve_device(device)
    N = readset.n_reads
    max_len = int(readset.length.max()) if N else 1
    W = 1 << max(0, int(n_words(max_len) - 1).bit_length())
    if pm is None:
        pm = int(max(128, min(2048, 4 * W)))

    ids_all = np.arange(1, N + 1, dtype=np.int64)
    host_words, host_len = readset.block_words(ids_all, W)
    host_words = np.vstack([host_words, np.zeros((1, W), np.uint32)])
    host_len = np.concatenate([host_len, np.zeros(1, np.int32)])

    mker = torch.full((N + 1, pm), INVALID_KMER, dtype=torch.int64, device=dev)
    mpos = torch.full((N + 1, pm), -1, dtype=torch.int32, device=dev)
    mstr = torch.zeros((N + 1, pm), dtype=torch.int32, device=dev)
    for ids, Wb in length_bucketed_blocks(readset, block_size):
        wb, lb = block_tensors(readset, ids, Wb, dev)
        mk, mp, ms, _ = _syncmer_kernel(wb, lb, k, pm)
        rows = torch.from_numpy(ids.astype(np.int64) - 1).to(dev)
        mker[rows] = mk
        mpos[rows] = mp
        mstr[rows] = ms
    return ReadIndex(
        words=u32_tensor(host_words, dev),
        length=torch.from_numpy(host_len.astype(np.int32)).to(dev),
        mker=mker, mpos=mpos, mstr=mstr, n_reads=N, k=k, pm=pm,
    )


def get_read_index(readset: ReadSet, k: int, device=None) -> ReadIndex:
    """Cached index per (readset, k, device) — ReadSets are immutable."""
    dev = resolve_device(device)
    cache = device_cache(readset, "read_index")
    key = (k, str(dev))
    if key not in cache:
        cache[key] = build_read_index(readset, k=k, device=dev)
    return cache[key]


def corrected_read_index(base: ReadIndex, readset: ReadSet) -> ReadIndex:
    """Index of a substitution-corrected copy of base's read set
    (ops.oea.apply_corrections): lengths and syncmer geometry are
    unchanged, so only the word plane is uploaded again.  The seed k-mer
    values at corrected positions go stale, but seeds only vote the
    orientation and centre the band, and a few stale anchors among
    hundreds do not move either."""
    W = base.words.shape[1]
    ids_all = np.arange(1, readset.n_reads + 1, dtype=np.int64)
    host_words, _ = readset.block_words(ids_all, W)
    host_words = np.vstack([host_words, np.zeros((1, W), np.uint32)])
    return ReadIndex(words=u32_tensor(host_words, base.words.device), length=base.length,
                     mker=base.mker, mpos=base.mpos, mstr=base.mstr, n_reads=base.n_reads,
                     k=base.k, pm=base.pm)

