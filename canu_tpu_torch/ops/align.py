"""Anchored banded overlap verification (counterpart of canu_tpu.ops.align).

Per candidate pair, on the device:
  1. anchors: shared syncmers between the oriented pair (from the
     device-resident ReadIndex, gathered by row id), diagonal-filtered and
     monotonized; the strand vote picks the orientation of raw pairs;
  2. seed: the middle anchor; steps 1-2 and the extension's inputs are
     ``_verify_pre``: kernel K7 on CUDA (ops/kernels/verify_cuda.py, one
     launch a group of chunks), the plain ``_verify_pre_plain`` on the CPU;
  3. extension: forward and backward banded extension from the seed, the
     band centre following the anchor chain by piecewise-linear
     interpolation, on one of two engines:
       - myers (band 128, the default): the Myers bit-vector extension of
         ops.myers, kernel K1 on CUDA, with +1 walls outside the band and
         partial (in-envelope) endpoints;
       - the INF-walled semi-global DP (any other band, a multiple of
         128): ``banded_extend`` runs kernel K2 (ops/kernels/extend_cuda.py;
         K3 above band 512) on CUDA and the plain PyTorch row loop
         ``banded_extend_plain`` on the CPU.  This engine reports the full
         extension as the partial one;
     either engine extends up to MYERS_GROUP chunks in one call
     (``_verify_grouped``);
  4. post: the two directions fold into hangs + edit count -> erate, with
     the best in-envelope partial overlap as the fallback in partial mode.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..stores.readset import ReadSet
from .kmer import INVALID_KMER, unpack_bases
from .kmerjoin import masked_median, pair_matches
from .minhash import OverlapCandidates
from .myers import CENTER_STRIDE, expand_centers

INF = 1 << 28
SMAX = 4  # band-start slope clamp of the INF-walled engine (columns per row)

# rows the plain INF-walled loop ran on CUDA tensors, and chunks the plain
# anchor-and-inputs step did; the pipeline must leave both 0 (kernels K2
# and K7 run there)
PLAIN_CUDA_ROWS = 0
PLAIN_CUDA_PRE = 0

# Wall breakdown of the LAST verify_overlaps call (seconds + counters):
# device_wait (blocking result fetch), consume (host filtering) and
# dispatch (the rest of the loop), which holds the host seconds of
# _verify_pre (pre), the extension (extend) and _verify_post (post);
# index, the read index's build (0 when cached or given); on the card
# pre_device, kernel K7's device seconds by CUDA events (None on the CPU,
# where pre is the whole step).  Read by the overlap stage.
LAST_PROFILE: dict = {}
MAX_ANCHORS = 64


def _shift_rows(x: torch.Tensor, t: torch.Tensor, out_len: int) -> torch.Tensor:
    """out[b, i] = x[b, i + t[b]] (zero-filled past the end), t >= 0.

    canu_tpu builds this from ceil(log2 L) masked shift rounds, which see
    only the low bits of t: a shift of t is a shift of t mod 2**rounds.
    One gather with the same effective shift gives the same rows.
    """
    B, L = x.shape
    if L < out_len:
        x = torch.nn.functional.pad(x, (0, out_len - L))
        L = out_len
    rounds = 0
    while (1 << rounds) < L:
        rounds += 1
    te = t.to(torch.int64) & ((1 << rounds) - 1)
    idx = torch.arange(out_len, device=x.device)[None, :] + te[:, None]
    out = torch.gather(x, 1, torch.clamp(idx, max=L - 1))
    return torch.where(idx < L, out, 0)


def _anchor_compact(mkA, posA, strA, mkB, posB, strB, lenA, lenB, flipped,
                    k: int, orient: bool = False):
    """Monotonic shared-syncmer anchors for read pairs.

    Inputs are gathered rows of the ReadIndex.  Returns (anchorsA int32[B,
    M], anchorsB int32[B, M], n_anchor int32[B], flipped bool[B], n_minor
    int32[B]) — positions in A / oriented-B coordinates, padded with -1,
    M = MAX_ANCHORS.  A match supports forward when the two strand flags
    agree, reverse when they differ; with orient=True the majority decides
    `flipped`.  The posA sort is stable, the order XLA gives on ties.
    """
    validA = mkA != INVALID_KMER
    validB = mkB != INVALID_KMER
    hit, posA_m, posB_m, agree = pair_matches(mkA, validA, strA, posA, mkB, validB, strB, posB)
    n_same = (hit & agree).sum(dim=1, dtype=torch.int32)
    n_opp = (hit & ~agree).sum(dim=1, dtype=torch.int32)
    # minority-orientation support: the palindromic/subread-loop signature
    n_minor = torch.minimum(n_same, n_opp)
    if orient:
        flipped = n_opp > n_same
    # positions on the ORIENTED B: rc flips the k-mer window start
    posB_m = torch.where(flipped[:, None], lenB[:, None] - k - posB_m, posB_m)
    hit = hit & (agree != flipped[:, None])
    W2 = hit.shape[1]

    diag = posA_m - posB_m
    BIG = 2**30
    med = masked_median(diag, hit)
    min_len = torch.minimum(lenA, lenB)
    tol = torch.clamp((min_len.to(torch.float32) * 0.30).to(torch.int32), min=100)
    inl = hit & ((diag - med[:, None]).abs() <= tol[:, None])

    # sort matches by posA (carrying posB), then monotonize posB
    keyA = torch.where(inl, posA_m, BIG)
    keyA_s, order = torch.sort(keyA, dim=1, stable=True)
    posB_s = torch.gather(posB_m, 1, order)
    valid_s = keyA_s != BIG
    pb = torch.where(valid_s, posB_s, -1)
    cm = torch.cummax(pb, dim=1).values
    cm_prev = torch.cat([torch.full_like(pb[:, :1], -1), cm[:, :-1]], dim=1)
    keep = valid_s & (pb > cm_prev)

    n_keep = keep.sum(dim=1, dtype=torch.int32)
    col = torch.arange(W2, dtype=torch.int32, device=keep.device)[None, :]
    kidx_sorted, _ = torch.sort(torch.where(keep, col, W2), dim=1)
    m_ramp = torch.arange(MAX_ANCHORS, dtype=torch.int32, device=keep.device)[None, :]
    # n_keep <= M: identity picks (anchors compacted at the front);
    # n_keep > M: even subsample, strictly increasing
    denom = torch.clamp(n_keep - 1, min=1)[:, None]
    pick_even = (m_ramp * denom) // (MAX_ANCHORS - 1)
    pick = torch.where(n_keep[:, None] <= MAX_ANCHORS, m_ramp, pick_even)
    pick = torch.minimum(pick, torch.clamp(n_keep[:, None] - 1, min=0))
    cols = torch.gather(kidx_sorted, 1, pick.to(torch.int64))
    valid_a = (m_ramp < n_keep[:, None]) & (cols < W2)
    cols_c = torch.clamp(cols, 0, W2 - 1).to(torch.int64)
    aA = torch.where(valid_a, torch.gather(keyA_s, 1, cols_c), -1)
    aB = torch.where(valid_a, torch.gather(posB_s, 1, cols_c), -1)
    n_anchor = torch.clamp(n_keep, max=MAX_ANCHORS)
    return aA, aB, n_anchor, flipped, n_minor


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, as a fused multiply-add: the float64
    sum of the exact product and c, rounded to odd (the two-sum error
    moves an even result one float64 ulp towards it), then to float32,
    which gives the one rounding of the exact value."""
    p = a.double() * b.double()  # exact: 24 + 24 significant bits
    c = c.double()
    s = c + p
    bb = s - c
    err = (c - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((err != 0) & even, torch.nextafter(s, s + err), s).float()


def _interp_grid(sub_xa, sub_xb, n_rows: int) -> torch.Tensor:
    """Piecewise-linear band centres from anchor points (sub_xa -> sub_xb)
    on the CENTER_STRIDE-row grid: int32[B, n_rows // CENTER_STRIDE + 1],
    value j the centre of rows CENTER_STRIDE j .. CENTER_STRIDE j +
    CENTER_STRIDE - 1 (expand_centers gives the rows 0..n_rows).  The
    caller pads past the last anchor with slope-1 points, so the centre
    line continues at slope 1.

    float32 with jnp.interp's operation order, one rounding a step, the
    last step fp[i-1] + (delta / dx) * df a fused multiply-add as XLA's CPU
    backend compiles it, then round-half-to-even, so the integer centres
    equal canu_tpu's (with a separate product and sum some centres of long
    reads differ by 1).
    """
    B, M = sub_xa.shape
    dev = sub_xa.device
    nc = n_rows // CENTER_STRIDE + 1
    x = (torch.arange(nc, dtype=torch.int32, device=dev) * CENTER_STRIDE)
    x = x.to(torch.float32)[None, :].expand(B, nc).contiguous()
    xp = sub_xa.to(torch.float32).contiguous()
    fp = sub_xb.to(torch.float32)
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, M - 1)
    xp_i, xp_im1 = torch.gather(xp, 1, i), torch.gather(xp, 1, i - 1)
    fp_i, fp_im1 = torch.gather(fp, 1, i), torch.gather(fp, 1, i - 1)
    df = fp_i - fp_im1
    dx = xp_i - xp_im1
    delta = x - xp_im1
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp_im1, _fma32(delta / torch.where(dx0, 1.0, dx), df, fp_im1))
    f = torch.where(x < xp[:, :1], fp[:, :1], f)
    f = torch.where(x > xp[:, -1:], fp[:, -1:], f)
    return torch.round(f).to(torch.int32)


def _interp_centers(sub_xa, sub_xb, n_rows: int) -> torch.Tensor:
    """The band centres of rows 0..n_rows, int32[B, n_rows + 1]: the grid
    of _interp_grid expanded by repetition."""
    return expand_centers(_interp_grid(sub_xa, sub_xb, n_rows), n_rows)


# ---- INF-walled banded extension (bands other than 128) -----------------------


def _band_starts(centers: torch.Tensor, b_len: torch.Tensor, band: int, n_rows: int):
    """Band start o(i), rows 0..n_rows: the centre minus band/2 clipped into
    [0, b_len], made monotonic, then slope-clamped to SMAX columns per row
    (o'(i) = min(o(i), o'(i-1) + SMAX) = SMAX*i + cummin(o(j) - SMAX*j))."""
    if centers.shape[1] < n_rows + 1:
        raise ValueError(f"centers has {centers.shape[1]} columns, need n_rows+1 = {n_rows + 1}")
    c = centers[:, : n_rows + 1].to(torch.int32)
    o = torch.minimum(torch.clamp(c - band // 2, min=0), torch.clamp(b_len, min=0)[:, None])
    o = torch.cummax(o, dim=1).values
    ramp = SMAX * torch.arange(n_rows + 1, dtype=torch.int32, device=o.device)[None, :]
    return torch.cummin(o - ramp, dim=1).values + ramp


def banded_extend_plain(a, a_len, b, b_len, centers, band: int, n_rows: int, on_row=None):
    """Semi-global banded extension from (0, 0), plain PyTorch row loop.

    The port of canu_tpu.ops.align.banded_extend, and the reference kernels
    K2 and K3 are checked against.  a uint8[B, LA] (row i reads
    a[:, i-1]), a_len int32[B], b uint8[B, LB], b_len int32[B], centers
    int32[B, >= n_rows+1].  Aligns A[0:a_len] against a prefix of B (A
    exhausted) or a prefix of A against B[0:b_len] (B exhausted),
    whichever costs fewer edits; cells outside the band are INF walls.
    Returns (edits, a_used, b_used) int32[B].

    Cells can hold INF + w (the closure adds w to an INF prefix-min), and
    those values reach the outputs of failed extensions: int32 as in
    canu_tpu, nothing saturates.  Rows past every a_len change nothing,
    so the loop stops at min(n_rows, max a_len).

    on_row, if given, is called after row 0 and after each row i >= 1 as
    on_row(i, D, live, best_bx, aend_bx, bend_bx): the row's cells
    int32[B, band], bool[B] i <= a_len, and the B-exhausted captures so
    far.  It observes and changes nothing (torch_cases.extend_exit_rows
    finds the kernels' exit rows with it).
    """
    global PLAIN_CUDA_ROWS
    B = a.shape[0]
    dev = a.device
    a_len = a_len.to(torch.int32)
    b_len = b_len.to(torch.int32)
    o_all = _band_starts(centers, b_len, band, n_rows)
    w = torch.arange(band, dtype=torch.int32, device=dev)[None, :]
    LA, LB = a.shape[1], b.shape[1]

    o0 = o_all[:, 0]
    j0 = o0[:, None] + w
    D = torch.where(j0 <= b_len[:, None], j0, INF)
    # "B exhausted at row 0" when b_len falls inside the row-0 band
    w_col0 = b_len - o0
    in0 = (w_col0 >= 0) & (w_col0 < band)
    best_bx = torch.where(in0, torch.gather(D, 1, torch.clamp(w_col0, 0, band - 1)[:, None].long())[:, 0], INF)
    aend_bx = torch.zeros(B, dtype=torch.int32, device=dev)
    bend_bx = torch.where(in0, b_len, 0)
    Dfin = torch.where((a_len == 0)[:, None], D, INF)
    ofin = torch.where(a_len == 0, o0, 0)
    if on_row is not None:
        on_row(0, D, a_len >= 0, best_bx, aend_bx, bend_bx)

    last = min(n_rows, int(a_len.max())) if B else 0
    if a.is_cuda:
        PLAIN_CUDA_ROWS += max(0, last)
    inf_l = torch.full((B, 1), INF, dtype=torch.int32, device=dev)
    inf_r = torch.full((B, SMAX), INF, dtype=torch.int32, device=dev)
    for i in range(1, last + 1):
        o_i = o_all[:, i]
        s = (o_i - o_all[:, i - 1]).long()[:, None]  # in [0, SMAX]
        # D_prev at w+s (up) and w+s-1 (diag), INF outside the band
        Dq = torch.cat([inf_l, D, inf_r], dim=1)
        idx = w.long() + s
        up = torch.gather(Dq, 1, idx + 1)
        dg = torch.gather(Dq, 1, idx)
        a_chr = a[:, min(i - 1, LA - 1)]
        j = o_i[:, None] + w
        b_chr = torch.gather(b, 1, torch.clamp(j - 1, 0, LB - 1).long())
        sub = (a_chr[:, None] != b_chr).to(torch.int32)
        valid_dg = (j >= 1) & (j <= b_len[:, None])
        m = torch.minimum(up + 1, torch.where(valid_dg, dg + sub, INF))
        # horizontal closure: D[w] = min_{w' <= w} m[w'] + (w - w')
        r = torch.cummin(torch.clamp(m - w, max=INF), dim=1).values
        D = torch.where(j <= b_len[:, None], r + w, INF)
        live = i <= a_len
        D = torch.where(live[:, None], D, INF)

        w_col = b_len - o_i
        in_band = (w_col >= 0) & (w_col < band) & live
        cost = torch.where(in_band, torch.gather(D, 1, torch.clamp(w_col, 0, band - 1)[:, None].long())[:, 0], INF)
        better = cost < best_bx
        best_bx = torch.where(better, cost, best_bx)
        aend_bx = torch.where(better, i, aend_bx)
        bend_bx = torch.where(better, b_len, bend_bx)

        at_fin = i == a_len
        Dfin = torch.where(at_fin[:, None], D, Dfin)
        ofin = torch.where(at_fin, o_i, ofin)
        if on_row is not None:
            on_row(i, D, live, best_bx, aend_bx, bend_bx)

    # A exhausted: the best cell of the captured final row (first on ties)
    wbest = torch.argmin(Dfin, dim=1, keepdim=True)
    cost_ax = torch.gather(Dfin, 1, wbest)[:, 0]
    bend_ax = ofin + wbest[:, 0].to(torch.int32)
    use_ax = cost_ax <= best_bx
    edits = torch.where(use_ax, cost_ax, best_bx)
    a_used = torch.where(use_ax, a_len, aend_bx)
    b_used = torch.where(use_ax, bend_ax, bend_bx)
    return edits.to(torch.int32), a_used.to(torch.int32), b_used.to(torch.int32)


def banded_extend(a, a_len, b, b_len, centers, band: int, n_rows: int):
    """banded_extend_plain's function: on CUDA tensors kernel K2, or K3
    for the bands above the ones K2 holds in registers (an error beyond
    K3's, no fallback); the plain loop on CPU tensors."""
    if a.is_cuda:
        from .kernels import extend_cuda as EX

        kernel = EX.banded_extend_warp if band in EX.WARP_BANDS else EX.banded_extend_block
        return kernel(a, a_len, b, b_len, centers, band, n_rows)
    return banded_extend_plain(a, a_len, b, b_len, centers, band, n_rows)


# ---- overlap verification ---------------------------------------------------


@dataclass
class OverlapTable:
    """Verified overlaps (host columnar arrays, canu ovOverlap semantics;
    the numpy table of canu_tpu.ops.align.OverlapTable).

    a_bgn/a_end: extent on A (forward coords); b_bgn/b_end: extent on B in
    FORWARD-B coords, `flipped` when B was reverse-complemented; erate_q:
    edit rate in 0.01% fixed-point steps.
    """

    a_id: np.ndarray
    b_id: np.ndarray
    flipped: np.ndarray
    a_bgn: np.ndarray
    a_end: np.ndarray
    b_bgn: np.ndarray
    b_end: np.ndarray
    erate_q: np.ndarray  # uint16

    def __len__(self):
        return len(self.a_id)

    @property
    def erate(self) -> np.ndarray:
        return self.erate_q.astype(np.float32) / 10000.0


def _verify_pre_plain(index, a_idx, b_idx, flipped, k: int, band: int, n_rows: int,
                      orient: bool = False, chunk: int | None = None, center_stride: int = 1):
    """Anchors + seeds + fused fwd/bwd extension inputs, plain PyTorch ops,
    chunk by chunk: the port of canu_tpu.ops.align._verify_pre, and the
    reference kernel K7 is held to.

    a_idx/b_idx are row indices into the device ReadIndex, G chunks of
    `chunk` pairs (None: one chunk of them all).  With orient=True each
    pair's orientation comes from the syncmer strand vote and ``flipped``
    is ignored.  Returns (ext_in, n_anchor, flipped, seedA, seedB,
    n_minor) with ext_in = (a, a_len, b, b_len, centers) for 2 extensions
    a pair: chunk 0's forward rows, its backward rows, chunk 1's forward
    rows, and so on; the per-pair outputs in pair order.  The centres are
    rows int32[., n_rows + 1], or with center_stride=CENTER_STRIDE their
    grid int32[., n_rows // CENTER_STRIDE + 1] (_interp_grid), which the
    Myers engine takes as it is.
    """
    global PLAIN_CUDA_PRE
    chunk = chunk or a_idx.shape[0]
    if center_stride not in (1, CENTER_STRIDE):
        raise ValueError(f"center_stride must be 1 or {CENTER_STRIDE}, got {center_stride}")
    if a_idx.shape[0] > chunk:
        parts = [_verify_pre_plain(index, a_idx[s:s + chunk], b_idx[s:s + chunk],
                                   flipped[s:s + chunk], k, band, n_rows, orient,
                                   center_stride=center_stride)
                 for s in range(0, a_idx.shape[0], chunk)]
        ext_in = tuple(torch.cat(xs) for xs in zip(*(p[0] for p in parts)))
        return (ext_in, *(torch.cat(xs) for xs in zip(*(p[1:] for p in parts))))
    if a_idx.is_cuda:
        PLAIN_CUDA_PRE += 1
    lenA = index.length[a_idx]
    lenB = index.length[b_idx]
    aA, aB, n_anchor, flipped, n_minor = _anchor_compact(
        index.mker[a_idx], index.mpos[a_idx], index.mstr[a_idx],
        index.mker[b_idx], index.mpos[b_idx], index.mstr[b_idx],
        lenA, lenB, flipped, k, orient)
    basesA = unpack_bases(index.words[a_idx])
    rawB = unpack_bases(index.words[b_idx])
    # oriented B: complement + flip, then a per-row shift back to column 0
    L = rawB.shape[1]
    rcB = torch.flip(3 - rawB, dims=[1])
    basesB = _shift_rows(torch.where(flipped[:, None], rcB, rawB),
                         torch.where(flipped, L - lenB, 0), L)
    basesB = torch.where(torch.arange(L, device=rawB.device)[None, :] < lenB[:, None], basesB, 0)

    m_ramp = torch.arange(MAX_ANCHORS, dtype=torch.int32, device=aA.device)[None, :]
    seed_m = torch.clamp(n_anchor - 1, min=0) // 2
    seedA = torch.clamp(torch.gather(aA, 1, seed_m[:, None].to(torch.int64))[:, 0], min=0)
    seedB = torch.clamp(torch.gather(aB, 1, seed_m[:, None].to(torch.int64))[:, 0], min=0)
    BIGF = 1 << 24

    # forward: anchors at indices >= seed_m, coords relative to the seed
    idx_f = torch.clamp(seed_m[:, None] + m_ramp, max=MAX_ANCHORS - 1).to(torch.int64)
    fa = torch.gather(aA, 1, idx_f) - seedA[:, None]
    fb = torch.gather(aB, 1, idx_f) - seedB[:, None]
    valid_f = (seed_m[:, None] + m_ramp < n_anchor[:, None]) & (fa >= 0)
    fa = torch.where(valid_f, fa, BIGF + m_ramp)  # slope-1 continuation
    fb = torch.where(valid_f, fb, BIGF + m_ramp)
    interp = _interp_grid if center_stride > 1 else _interp_centers
    cen_f = interp(fa, fb, n_rows)
    a_f = _shift_rows(basesA, seedA, n_rows)
    b_f = _shift_rows(basesB, seedB, n_rows + band)

    # backward: anchors at indices <= seed_m in reverse order
    idx_b = torch.clamp(seed_m[:, None] - m_ramp, min=0).to(torch.int64)
    aA_b = torch.gather(aA, 1, idx_b)
    ba = seedA[:, None] - aA_b
    bb = seedB[:, None] - torch.gather(aB, 1, idx_b)
    valid_b = (m_ramp <= seed_m[:, None]) & (aA_b >= 0)
    ba = torch.where(valid_b, ba, BIGF + m_ramp)
    bb = torch.where(valid_b, bb, BIGF + m_ramp)
    cen_b = interp(ba, bb, n_rows)
    La = basesA.shape[1]
    a_b = _shift_rows(torch.flip(basesA, dims=[1]), La - seedA, n_rows)
    b_b = _shift_rows(torch.flip(basesB, dims=[1]), L - seedB, n_rows + band)

    ext_in = (
        torch.cat([a_f, a_b]),
        torch.cat([lenA - seedA, seedA]),
        torch.cat([b_f, b_b]),
        torch.cat([lenB - seedB, seedB]),
        torch.cat([cen_f, cen_b]),
    )
    return ext_in, n_anchor, flipped, seedA, seedB, n_minor


def _verify_pre(index, a_idx, b_idx, flipped, k: int, band: int, n_rows: int,
                orient: bool = False, chunk: int | None = None, center_stride: int = 1):
    """_verify_pre_plain's outputs for G chunks of `chunk` pairs at once
    (a_idx, b_idx, flipped [G * chunk]; chunk None: one chunk of them all),
    in its layout, the centres as rows or (center_stride=CENTER_STRIDE) on
    their grid.  On CUDA tensors kernel K7, one launch (no fallback); on
    CPU tensors the plain version."""
    if a_idx.is_cuda:
        from .kernels import verify_cuda as K7

        return K7.verify_pre(index, a_idx, b_idx, flipped, k, band, n_rows, orient,
                             chunk or a_idx.shape[0], center_stride)
    return _verify_pre_plain(index, a_idx, b_idx, flipped, k, band, n_rows, orient, chunk,
                             center_stride)


def _verify_post(n_anchor, flipped, seedA, seedB, n_minor, e, au, bu, pe, pa, pb,
                 chunk: int | None = None):
    """Fold the fused extension results of G chunks of `chunk` pairs (the
    layout _verify_pre gives; chunk None: one chunk) into one int32[G *
    chunk, 13] tile."""
    Bn = n_anchor.shape[0]
    C = chunk or Bn

    def fwd_bwd(x):
        x = x.view(Bn // C, 2, C)
        return x[:, 0].reshape(Bn), x[:, 1].reshape(Bn)

    (ef, eb), (af, ab), (bf, bb) = fwd_bwd(e), fwd_bwd(au), fwd_bwd(bu)
    (pef, peb), (paf, pab), (pbf, pbb) = fwd_bwd(pe), fwd_bwd(pa), fwd_bwd(pb)
    return torch.stack([
        n_anchor, seedA - ab, seedA + af, seedB - bb, seedB + bf,
        torch.clamp(ef + eb, max=INF), flipped.to(torch.int32), n_minor,
        seedA - pab, seedA + paf, seedB - pbb, seedB + pbf,
        torch.clamp(pef + peb, max=INF),
    ], dim=1).to(torch.int32)


# chunks fused per extension launch at most, on either engine: B = 2 *
# chunk * group extensions.  K1 gives each extension a thread, K2/K3 a
# warp, and a launch takes as long as its longest extension, so more
# chunks a launch fill more of the card (16 against 4 cut the cor stage's
# summed K1 time about 2.6x on an H100; PERF.md).  The memory budget may
# make a group smaller (_verify_window).
MYERS_GROUP = 16

# Share of the device memory free at the start of verify that staged but
# unconsumed chunk inputs may hold; CPU runs use CPU_INFLIGHT_BYTES.  The
# driver's OOM recovery halves _INFLIGHT_BACKOFF so a retry runs smaller.
INFLIGHT_FREE_FRACTION = 0.25
CPU_INFLIGHT_BYTES = 2048e6
_INFLIGHT_BACKOFF = 1.0

# peak bytes per extension and row of the Myers band schedule while a
# group is extended.  The plain chain (the CPU path): ops.myers._schedule's
# int32 target, envelopes and o with the int64 indices cummax/cummin
# return, then _shift_bits' int32 shifts; the A/B copies the plain loop
# pads.  On the card kernel K10 holds no scratch, only what it writes for
# K1: the shift bits, 4 bytes a 32 rows, and the 43 row-0 carry planes
# (ops/kernels/myers_cuda.py myers_prologue_cuda).
# The INF-walled engine builds none: its kernels derive the band start
# from the centres.
SCHEDULE_BYTES_PER_ROW = 40

# LAST_PROFILE's device seconds of the Myers extension on the card, by CUDA
# events: before K1 (K10), K1 with the end pick, after K1 (nothing since
# the pick moved into K1: the events meet)
EXTEND_DEVICE_KEYS = ("extend_pre_device_s", "extend_k1_device_s", "extend_post_device_s")


def _center_stride(band: int) -> int:
    """Rows a band centre of the extension inputs holds: the Myers engine
    (band 128) takes the CENTER_STRIDE-row grid, the INF-walled kernels
    rows."""
    return CENTER_STRIDE if band == 128 else 1


def _chunk_staging_bytes(chunk: int, n_rows: int, band: int, on_card: bool = False) -> int:
    """Device bytes held per staged chunk: 2*chunk extensions of A plane
    (uint8), B plane (uint8), int32 centres, the outputs and, on the Myers
    engine (band 128), the band schedule's bytes.  On the card the Myers
    engine holds the centres' grid, 4 bytes a CENTER_STRIDE rows (K7 writes
    it, K10 reads it), and K10's bytes; elsewhere the centres are rows (the
    plain chain expands the grid) and the schedule the plain chain's."""
    centres, sched = 4 * (n_rows + 1), 0
    if band == 128 and on_card:
        centres = 4 * (n_rows // CENTER_STRIDE + 1)
        sched = 4 * (n_rows // 32 + 1) + 4 * 43  # K10's shift words and row-0 planes
    elif band == 128:
        sched = SCHEDULE_BYTES_PER_ROW * (n_rows + 1)
    return 2 * chunk * (n_rows + (n_rows + band) + centres + sched + 64)


def _verify_window(chunk: int, n_rows: int, band: int, device: torch.device) -> tuple[int, int]:
    """(chunks per extension group, chunks in flight), both within the
    memory budget: it holds n chunks' staging (1 to 128); a group takes at
    most half of them, so the next group is staged while one drains, and
    at most MYERS_GROUP."""
    on_card = device.type == "cuda"
    if on_card:
        free, _total = torch.cuda.mem_get_info(device)
        budget = free * INFLIGHT_FREE_FRACTION
    else:
        budget = CPU_INFLIGHT_BYTES
    n = int(budget * _INFLIGHT_BACKOFF
            // max(1, _chunk_staging_bytes(chunk, n_rows, band, on_card)))
    n = max(1, min(128, n))
    return max(1, min(MYERS_GROUP, n // 2)), n


def _verify_grouped(index, a_all, b_all, fl_all, chunks, chunk: int, k: int, band: int,
                    n_rows: int, orient: bool, partial_cap_q: int, group: int, prof: dict):
    """_verify_pre, ONE extension and _verify_post per group of `group`
    chunks (the last group takes the chunks that remain).  The band picks
    the engine: 128 the Myers extension (banded_extend_myers), any other
    the INF-walled one (banded_extend), which has no partial endpoints, so
    its full extension stands in for them.  a_all, b_all, fl_all: every
    chunk's index rows and orientations on the device, chunk after chunk
    (`chunk` pairs each, padded); chunks: list of (sl, chunk_rows).  Adds
    the host seconds of each step to prof (pre_s, extend_s, post_s) and,
    on the card, appends the CUDA events around each _verify_pre to
    prof["pre_events"] and the Myers extension's (around K10 and K1 with
    the end pick) to prof["extend_events"]: K7 runs asynchronously, so pre_s holds its
    launch and its device time shows in whichever later step waits for it.
    Yields (sl, result tile) in order; a generator, so the caller's bounded
    drain caps how many chunks' inputs are staged at once.  (canu_tpu runs
    its remainder chunks singly, to reuse one compiled shape; extensions
    are independent, so a group's results do not depend on its size.)"""
    from .myers import banded_extend_myers

    i = 0
    n = len(chunks)
    while i < n:
        specs = chunks[i : i + group]
        rows_g = slice(i * chunk, (i + len(specs)) * chunk)
        t0 = time.perf_counter()
        if a_all.is_cuda:
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
        wide, *pre = _verify_pre(index, a_all[rows_g], b_all[rows_g], fl_all[rows_g], k, band,
                                 n_rows, orient, chunk, center_stride=_center_stride(band))
        if a_all.is_cuda:
            ev[1].record()
            prof["pre_events"].append(ev)
        t1 = time.perf_counter()
        if band == 128:
            rows = max(r for _sl, r in specs)
            res = banded_extend_myers(*wide, band, n_rows, max_rows=rows,
                                      partial_cap_q=max(1, partial_cap_q),
                                      events=prof["extend_events"] if a_all.is_cuda else None,
                                      center_stride=CENTER_STRIDE)
        else:
            res = banded_extend(*wide, band, n_rows)
            res = res + res
        del wide
        t2 = time.perf_counter()
        tile = _verify_post(*pre, *res, chunk=chunk)
        t3 = time.perf_counter()
        prof["pre_s"] += t1 - t0
        prof["extend_s"] += t2 - t1
        prof["post_s"] += t3 - t2
        for gi, (sl, _rows) in enumerate(specs):
            yield sl, tile[gi * chunk : (gi + 1) * chunk]
        i += len(specs)


def verify_overlaps(readset: ReadSet, cand, k: int = 16, band: int = 128,
                    max_erate: float = 0.32, min_overlap: int = 500, chunk: int = 512,
                    min_shared: int = 4, partial: bool = False, palindromic_min: int = 0,
                    sink=None, index=None, device=None) -> OverlapTable:
    """Verify candidates with the banded extension; returns OverlapTable.

    cand is OverlapCandidates (orientation given) or a raw int array
    [M, >=2] of (a_id, b_id) pairs from find_candidates — then the anchor
    kernel votes the orientation and pairs with fewer than min_shared
    chain anchors are dropped.  max_erate/min_overlap are the reference's
    ovlErrorRate / minOverlapLength gates.  partial=True emits the best
    in-envelope partial overlap where the full extension fails the erate
    gate (overlapInCore -G / forOBT mode).  palindromic_min > 0 (raw
    pairs) verifies pairs with that much minority-orientation support in
    both orientations.  sink: a callable that receives each chunk's kept
    overlaps (an OverlapTable) instead of their being accumulated, the
    scale path (stores.overlaps.OverlapSpill); the returned table is then
    empty.  index: a prebuilt ReadIndex to use instead of
    get_read_index(readset, k).  The band picks the engine, as canu_tpu's
    default does: 128 the Myers engine, any other the INF-walled DP.
    """
    dev = resolve_device(device)
    orient = isinstance(cand, np.ndarray)
    if orient:
        a_id_all = cand[:, 0].astype(np.int64)
        b_id_all = cand[:, 1].astype(np.int64)
        fl_all = np.zeros(len(cand), bool)
    else:
        a_id_all = cand.a_id.astype(np.int64)
        b_id_all = cand.b_id.astype(np.int64)
        fl_all = cand.flipped
    # longest pairs first: each chunk runs only to its longest read
    if len(a_id_all):
        ln = np.maximum(readset.length[a_id_all - 1], readset.length[b_id_all - 1])
        order = np.argsort(-ln, kind="stable")
        a_id_all, b_id_all, fl_all = a_id_all[order], b_id_all[order], fl_all[order]
    cols: dict[str, list] = {n: [] for n in (
        "a_id", "b_id", "flipped", "a_bgn", "a_end", "b_bgn", "b_end", "erate_q")}
    M = len(a_id_all)
    t_index = time.perf_counter()
    if index is None:
        from .minimizers import get_read_index

        index = get_read_index(readset, k=k, device=dev)
    index_s = time.perf_counter() - t_index
    n_rows = index.words.shape[1] * 16
    # every chunk's index rows and orientations, padded to whole chunks with
    # the index's all-zero padding row, uploaded once
    n_pad = -(-M // chunk) * chunk
    a_idx = np.full(n_pad, index.n_reads, np.int64)
    b_idx = np.full(n_pad, index.n_reads, np.int64)
    fl = np.zeros(n_pad, bool)
    a_idx[:M], b_idx[:M], fl[:M] = a_id_all - 1, b_id_all - 1, fl_all
    a_dev, b_dev, fl_dev = (torch.from_numpy(x).to(dev) for x in (a_idx, b_idx, fl))
    chunk_specs = []
    for s in range(0, M, chunk):
        sl = slice(s, min(s + chunk, M))
        chunk_rows = int(max(readset.length[a_id_all[sl] - 1].max(initial=1),
                             readset.length[b_id_all[sl] - 1].max(initial=1)))
        chunk_specs.append((sl, chunk_rows))
    cap_q = int(max_erate * 10000) if partial else 0
    palin: list[np.ndarray] = []

    def _consume(sl, r):
        a_ids = a_id_all[sl]
        b_ids = b_id_all[sl]
        C = len(a_ids)
        n_anchor = r[:C, 0]
        a_bgn, a_end = r[:C, 1], r[:C, 2]
        b_bgn_o, b_end_o = r[:C, 3], r[:C, 4]
        edits = r[:C, 5]
        span_m = ((a_end - a_bgn) + (b_end_o - b_bgn_o)) / 2.0
        ok = (n_anchor >= (min_shared if orient else 1)) & (span_m > 0) & (edits < INF)
        erate = np.where(ok, edits / np.maximum(span_m, 1.0), 1.0)
        flc = r[:C, 6].astype(bool)
        lbv = readset.length[b_ids - 1]
        b_bgn_f = np.where(flc, lbv - b_end_o, b_bgn_o)  # oriented -> forward-B
        b_end_f = np.where(flc, lbv - b_bgn_o, b_end_o)
        span = np.minimum(a_end - a_bgn, b_end_f - b_bgn_f)
        keep = ok & (erate <= max_erate) & (span >= min_overlap)
        if partial:
            pa_bgn, pa_end = r[:C, 8], r[:C, 9]
            pb_bgn_o, pb_end_o = r[:C, 10], r[:C, 11]
            p_edits = r[:C, 12]
            p_span_m = ((pa_end - pa_bgn) + (pb_end_o - pb_bgn_o)) / 2.0
            p_erate = np.where(ok, p_edits / np.maximum(p_span_m, 1.0), 1.0)
            pb_bgn_f = np.where(flc, lbv - pb_end_o, pb_bgn_o)
            pb_end_f = np.where(flc, lbv - pb_bgn_o, pb_end_o)
            p_span = np.minimum(pa_end - pa_bgn, pb_end_f - pb_bgn_f)
            use_p = ok & ~keep & (p_erate <= max_erate) & (p_span >= min_overlap)
            a_bgn = np.where(use_p, pa_bgn, a_bgn)
            a_end = np.where(use_p, pa_end, a_end)
            b_bgn_f = np.where(use_p, pb_bgn_f, b_bgn_f)
            b_end_f = np.where(use_p, pb_end_f, b_end_f)
            erate = np.where(use_p, p_erate, erate)
            keep = keep | use_p
        if orient and palindromic_min > 0:
            pm = (r[:C, 7] >= palindromic_min) & (n_anchor >= min_shared)
            if pm.any():
                palin.append(np.stack([a_ids[pm], b_ids[pm], flc[pm].astype(np.int64)], axis=1))
        chunk_out = OverlapTable(
            a_id=a_ids[keep].astype(np.int32), b_id=b_ids[keep].astype(np.int32),
            flipped=flc[keep], a_bgn=a_bgn[keep].astype(np.int32),
            a_end=a_end[keep].astype(np.int32), b_bgn=b_bgn_f[keep].astype(np.int32),
            b_end=b_end_f[keep].astype(np.int32),
            erate_q=np.minimum(np.round(erate[keep] * 10000), 65535).astype(np.uint16))
        if sink is not None:
            sink(chunk_out)
        else:
            for name in cols:
                cols[name].append(getattr(chunk_out, name))

    # bounded in-flight window: draining a result waits for the device,
    # which retires every buffer dispatched before it
    group, max_in_flight = _verify_window(chunk, n_rows, band, dev)
    fetch_group = max(4, min(32, max_in_flight // 2))
    t_loop0 = time.monotonic()
    prof = {"device_wait_s": 0.0, "consume_s": 0.0, "pre_s": 0.0, "extend_s": 0.0,
            "post_s": 0.0, "n_chunks": len(chunk_specs), "n_candidates": M, "pre_events": [],
            "extend_events": []}
    pending: list = []

    def _drain(n: int) -> None:
        take = pending[:n]
        del pending[:n]
        if not take:
            return
        t0 = time.monotonic()
        batch = torch.stack([res for _sl, res in take]).cpu().numpy()
        t1 = time.monotonic()
        for j, (sl, _res) in enumerate(take):
            _consume(sl, batch[j])
        prof["device_wait_s"] += t1 - t0
        prof["consume_s"] += time.monotonic() - t1

    for sl, res in _verify_grouped(index, a_dev, b_dev, fl_dev, chunk_specs, chunk, k, band,
                                   n_rows, orient, cap_q, group, prof):
        pending.append((sl, res))
        if len(pending) > max_in_flight:
            _drain(fetch_group)
    while pending:
        _drain(fetch_group)
    loop_s = time.monotonic() - t_loop0
    prof["dispatch_s"] = round(loop_s - prof["device_wait_s"] - prof["consume_s"], 3)
    for key in ("device_wait_s", "consume_s", "pre_s", "extend_s", "post_s"):
        prof[key] = round(prof[key], 3)
    prof["index_s"] = round(index_s, 3)
    # every result was fetched, so every event has completed
    events = prof.pop("pre_events")
    prof["pre_device_s"] = (round(sum(e0.elapsed_time(e1) for e0, e1 in events) / 1e3, 4)
                            if dev.type == "cuda" else None)
    # the Myers extension's device seconds: before K1 (K10), K1 with the end
    # pick, after it (0: the pick has no launch of its own)
    ext_events = prof.pop("extend_events")
    for q, name in enumerate(EXTEND_DEVICE_KEYS):
        prof[name] = (round(sum(ev[q].elapsed_time(ev[q + 1]) for ev in ext_events) / 1e3, 4)
                      if dev.type == "cuda" else None)
    LAST_PROFILE.clear()
    LAST_PROFILE.update(prof)

    # second pass: palindromic pairs in the MINORITY orientation, the
    # duplicate opposite-orientation overlaps subread detection keys on
    if palin:
        pp = np.concatenate(palin)
        z = np.zeros(len(pp), np.int32)
        cand2 = OverlapCandidates(
            a_id=pp[:, 0].astype(np.int32), b_id=pp[:, 1].astype(np.int32),
            flipped=~pp[:, 2].astype(bool), diag=z, n_shared=z, a_lo=z, a_hi=z,
            b_lo=z, b_hi=z)
        t2 = verify_overlaps(readset, cand2, k=k, band=band, max_erate=max_erate,
                             min_overlap=min_overlap, chunk=chunk, min_shared=min_shared,
                             partial=partial, sink=sink, device=dev)
        if sink is None:
            for name in cols:
                cols[name].append(getattr(t2, name))
        for key in ("device_wait_s", "consume_s", "dispatch_s", "pre_s", "extend_s", "post_s",
                    "index_s"):
            prof[key] = round(prof[key] + LAST_PROFILE.get(key, 0.0), 3)
        for key in ("pre_device_s", *EXTEND_DEVICE_KEYS):
            if prof[key] is not None:
                prof[key] = round(prof[key] + LAST_PROFILE[key], 4)
        prof["n_chunks"] += LAST_PROFILE.get("n_chunks", 0)
        LAST_PROFILE.clear()
        LAST_PROFILE.update(prof)

    def cat(name, dtype):
        arrs = cols[name]
        return np.concatenate(arrs).astype(dtype) if arrs else np.zeros(0, dtype)

    return OverlapTable(
        a_id=cat("a_id", np.int32), b_id=cat("b_id", np.int32),
        flipped=cat("flipped", bool), a_bgn=cat("a_bgn", np.int32),
        a_end=cat("a_end", np.int32), b_bgn=cat("b_bgn", np.int32),
        b_end=cat("b_end", np.int32), erate_q=cat("erate_q", np.uint16),
    )
