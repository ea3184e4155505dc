"""Myers bit-vector banded extension (counterpart of canu_tpu.ops.myers).

Extends a batch of read pairs from (0, 0) until either read is exhausted,
returning (edits, a_used, b_used) plus the best in-envelope partial
endpoint (p_edits, p_a, p_b).  Myers' bit-parallel algorithm (Myers 1999,
the algorithm family of the reference's vendored edlib) runs one pair per
lane with the 128-column band held as 4 chained 32-bit words; the band
follows the anchor chain at a slope of <= 1 column per row.

Split as in canu_tpu: the band schedule and ``_myers_init`` (row-0
state), then the row loop, then ``_myers_finish``.  On a CUDA tensor
``banded_extend_myers`` runs two hand-written kernels
(ops/kernels/myers_cuda.py, csrc/myers_tile.cu), one launch each: K10 the
schedule's shifts packed one bit a row and the row-0 carry planes, then
K1 the row loop with K11's end pick after its last row.  The centres may
come on the 16-row grid verify interpolates them on (``center_stride=16``):
K10 reads the grid, and the plain chain expands it to rows first
(``expand_centers``).  On a CPU tensor it runs the plain PyTorch
chain below, which is also the reference the kernels are held to:
``_schedule`` and ``_shift_bits`` / ``_myers_prep``, ``_myers_init`` and
``_carry_pack`` (K10), the row loop ``_myers_segment`` on ``_myers_prep``'s
per-row shift and entering-character streams (K1), ``_carry_unpack`` and
``_myers_finish`` (K11).  The schedule moves the band 0 or 1 column a
row, so the shift is one bit and the entering index o(i) + band - 1
follows from the carried o.

Words are uint32 values held in int64 tensors and masked to 32 bits after
every shift, complement and add, so the wrap-around arithmetic of the
original is exact and ``>>`` is a logical shift.  Per-lane integers are
int32, as in canu_tpu.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = 1 << 28
WORD = 32
NW = 4  # words per band: band == 128
MASK32 = 0xFFFFFFFF
SEGMENT = 512  # rows per plain-loop segment (canu_tpu's segment length)
CENTER_STRIDE = 16  # rows per interpolated band-centre sample (the grid's stride)

# plain-loop segments run on CUDA tensors; the pipeline must leave it 0
PLAIN_CUDA_SEGMENTS = 0
# plain band-schedule, row-0 state and end-pick calls (_schedule,
# _myers_init, _myers_finish) on CUDA tensors, where K10 and K11 run; the
# pipeline must leave it 0
PLAIN_CUDA_SCHEDULES = 0


class MyersCarry(NamedTuple):
    """Row-loop state of a batch of B extensions.

    VP/VN/fVP/fVN int64[NW, B] and Peq int64[4, NW, B] hold uint32 words
    (bit u of word k <-> band column 32k+u); the rest are int32[B].
    """

    VP: torch.Tensor
    VN: torch.Tensor
    Peq: torch.Tensor
    sf: torch.Tensor  # D at the window top
    o: torch.Tensor  # window start column
    best_bx: torch.Tensor  # best cost at B exhaustion
    aend_bx: torch.Tensor
    bend_bx: torch.Tensor
    fVP: torch.Tensor  # state captured at A exhaustion
    fVN: torch.Tensor
    fin_sf: torch.Tensor
    fin_o: torch.Tensor
    p_ext: torch.Tensor  # partial tracker: furthest in-envelope a+b
    p_edits: torch.Tensor
    p_a: torch.Tensor
    p_b: torch.Tensor


# carry planes of the kernel, in canu_tpu's Pallas order: the word planes
# VP, VN, Peq (4 chars), fVP, fVN and 11 int32 planes — 43 x uint32[B]
NC = (2 + 4 + 2) * NW + 11


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value a 32-bit two's-complement op would give."""
    return (((x + (1 << 31)) & MASK32) - (1 << 31)).to(torch.int32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each uint32 value of an int64 tensor (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _band_schedule(centers: torch.Tensor, b_len: torch.Tensor, band: int) -> torch.Tensor:
    """Band start o(i) per row: centred on the anchor chain, clamped to
    [0, b_len], monotonic, slope <= 1 column/row.

    The midpoint of the two extreme 1-Lipschitz monotone envelopes of the
    target (forward lower, backward upper) tracks it within half its worst
    drift defect; o(0) stays at the clipped target start.  cummax/cummin
    take the place of canu_tpu's associative scans.
    """
    t = torch.minimum(torch.clamp(centers - band // 2, min=0),
                      torch.clamp(b_len, min=0)[:, None])
    t = torch.cummax(t, dim=1).values
    ramp = torch.arange(t.shape[1], dtype=t.dtype, device=t.device)[None, :]
    lo = torch.cummin(t - ramp, dim=1).values + ramp
    hi = torch.flip(torch.cummax(torch.flip(t - ramp, dims=[1]), dim=1).values, dims=[1]) + ramp
    o = (lo + hi) >> 1
    return torch.minimum(o, t[:, :1] + ramp)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """bool[..., B, NW*32] -> int64[..., NW, B] words (bit u of word k =
    bits[..., 32k+u])."""
    b3 = bits.reshape(*bits.shape[:-1], NW, WORD).to(torch.int64)
    sh = torch.arange(WORD, dtype=torch.int64, device=bits.device)
    return (b3 << sh).sum(dim=-1).transpose(-1, -2).contiguous()


def _unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """int64[NW, B] words -> int32[B, NW*32] bits."""
    sh = torch.arange(WORD, dtype=torch.int64, device=words.device)
    bits = (words.T[:, :, None] >> sh) & 1
    return bits.reshape(words.shape[1], NW * WORD).to(torch.int32)


def _word_mask(w: torch.Tensor) -> torch.Tensor:
    """int64[NW, B]: word k has the low clip(w - 32k, 0, 32) bits set.

    In int64, (1 << 32) - 1 is exactly the all-ones word, so the shift by
    32 that a 32-bit type cannot express needs no special case here."""
    k = torch.arange(NW, dtype=torch.int64, device=w.device)[:, None]
    m = torch.clamp(w.to(torch.int64)[None, :] - WORD * k, 0, WORD)
    return (1 << m) - 1


def _masked_score(VP, VN, sf, w):
    """D(window offset w) = score_first + popcount-prefix over w bits."""
    mask = _word_mask(w)
    d = (_popcount(VP & mask) - _popcount(VN & mask)).sum(dim=0)
    return (sf + d).to(torch.int32)


def _shift_chain(X: torch.Tensor, ins: torch.Tensor) -> torch.Tensor:
    """Word-chain >>1 over dim -2 (the window moves down one column);
    ``ins`` (0/1 per lane) enters bit 127."""
    hi = torch.cat([X[..., 1:, :], ins.unsqueeze(-2)], dim=-2)
    return (X >> 1) | ((hi << 31) & MASK32)


def expand_centers(grid: torch.Tensor, n_rows: int, stride: int = CENTER_STRIDE) -> torch.Tensor:
    """Band centres of rows 0..n_rows, int32[B, n_rows + 1], from their
    grid: row i's centre is grid[:, i // stride].  Raises where the grid
    holds fewer than n_rows // stride + 1 values a row."""
    if grid.shape[1] < n_rows // stride + 1:
        raise ValueError(f"a grid of {grid.shape[1]} centres at stride {stride} covers rows "
                         f"0..{grid.shape[1] * stride - 1}, not 0..{n_rows}")
    return torch.repeat_interleave(grid, stride, dim=1)[:, : n_rows + 1]


def _count_plain(t: torch.Tensor) -> None:
    global PLAIN_CUDA_SCHEDULES
    if t.is_cuda:
        PLAIN_CUDA_SCHEDULES += 1


def _schedule(b_len, centers, band: int, n_rows: int) -> torch.Tensor:
    """o(i) int32[B, n_rows + 1] for rows 0..n_rows, the centres padded
    with their last value past their end."""
    _count_plain(centers)
    pad = n_rows + 1 - centers.shape[1]
    if pad > 0:
        centers = torch.cat([centers, centers[:, -1:].expand(-1, pad)], dim=1)
    return _band_schedule(centers[:, : n_rows + 1].to(torch.int32), b_len, band)


def _myers_prep(b_len, centers, band: int, n_rows: int):
    """Band schedule -> (shift stream uint8[n_rows, B], entering-char
    index int32[n_rows, B], o0 int32[B]) — row-major, so neighbouring
    lanes of one row are adjacent in memory.  The plain loop's inputs."""
    o_all = _schedule(b_len, centers, band, n_rows)
    s_step = ((o_all[:, 1:] - o_all[:, :-1]) & 0xFF).to(torch.uint8).T.contiguous()
    ent_idx = (o_all[:, 1:] + (band - 1)).T.contiguous()
    return s_step, ent_idx, o_all[:, 0].contiguous()


def _shift_bits(o_all: torch.Tensor, n_run: int) -> torch.Tensor:
    """The schedule's shifts of rows 1..n_run, one bit a row: int32[ceil(
    n_run / 32), B] words (uint32 bit patterns), bit r of word w = the
    shift of row 32w + r + 1.  Kernel K1's input in place of the plain
    loop's byte stream.

    The shift o(i) - o(i-1) is 0 or 1 (the schedule is monotonic with
    slope <= 1), so the bits are disjoint and an int32 sum of them is
    their OR, bit 31 included."""
    B = o_all.shape[0]
    nw = -(-n_run // WORD)
    d = o_all[:, 1 : n_run + 1] - o_all[:, :n_run]
    d = torch.nn.functional.pad(d, (0, nw * WORD - n_run)).reshape(B, nw, WORD)
    sh = torch.arange(WORD, dtype=torch.int32, device=o_all.device)
    return (d << sh).sum(dim=2, dtype=torch.int32).T.contiguous()


def _myers_init(b, b_len, a_len, o0, band: int) -> MyersCarry:
    """Initial Myers state at row 0 (window at o0; D(0, j) = j)."""
    _count_plain(b)
    B, LB = b.shape
    dev = b.device
    VP0 = torch.full((NW, B), MASK32, dtype=torch.int64, device=dev)
    VN0 = torch.zeros((NW, B), dtype=torch.int64, device=dev)
    sf0 = o0
    # Peq bit u of word k <-> column j = o + 32k + u + 1, char b[j-1]
    pos0 = o0[:, None].to(torch.int64) + torch.arange(band, device=dev)[None, :]
    bch0 = torch.gather(b, 1, torch.clamp(pos0, 0, LB - 1))
    chars = torch.arange(4, dtype=torch.uint8, device=dev)[:, None, None]
    Peq0 = _pack_bits((bch0[None] == chars) & (pos0 < LB)[None])  # [4, NW, B]

    wb0 = b_len - o0
    in0 = (wb0 >= 0) & (wb0 < band)
    best_bx0 = torch.where(in0, _masked_score(VP0, VN0, sf0, torch.clamp(wb0, min=0)), INF)
    fin0 = a_len == 0
    z32 = torch.zeros(B, dtype=torch.int32, device=dev)
    return MyersCarry(
        VP0, VN0, Peq0, sf0, o0,
        best_bx0.to(torch.int32), z32, torch.where(in0, b_len, 0),
        torch.where(fin0, VP0, 0), torch.where(fin0, VN0, 0),
        torch.where(fin0, sf0, 0), torch.where(fin0, o0, 0),
        z32, z32, z32, z32,
    )


def _myers_row(c: MyersCarry, s, ach, bch, i: int, a_len, b_len, cap_q: int,
               band: int) -> MyersCarry:
    """One DP row (absolute row i) of every lane."""
    (VP, VN, Peq, sf, o, best_bx, aend_bx, bend_bx,
     fVP, fVN, fin_sf, fin_o, p_ext, p_edits, p_a, p_b) = c
    live = i <= a_len
    s = torch.where(live, s.to(torch.int32), 0)
    do_shift = s > 0

    # ---- window shift ----
    sf_sh = sf + (VP[0] & 1).to(torch.int32) - (VN[0] & 1).to(torch.int32)
    VP = torch.where(do_shift, _shift_chain(VP, torch.ones_like(VP[0])), VP)  # wall: +1
    VN = torch.where(do_shift, _shift_chain(VN, torch.zeros_like(VN[0])), VN)
    chars = torch.arange(4, dtype=torch.int64, device=bch.device)[:, None]
    ins = (bch.to(torch.int64)[None, :] == chars).to(torch.int64)  # [4, B]
    Peq = torch.where(do_shift, _shift_chain(Peq, ins), Peq)
    sf = torch.where(do_shift, sf_sh, sf)
    o = o + s

    # ---- Myers column update (edlib calculateBlock, words chained) ----
    ach = ach.to(torch.int64)
    Eq_all = torch.gather(Peq, 0, torch.clamp(ach, max=3).expand(1, NW, -1))[0]
    Eq_all = torch.where(ach < 4, Eq_all, 0)
    hp_in, hm_in = 1, 0  # the window top grows +1 per row
    nVP, nVN = [], []
    for k in range(NW):
        Pv, Mv = VP[k], VN[k]
        Xv = Eq_all[k] | Mv
        Eq = Eq_all[k] | hm_in
        Xh = ((((Eq & Pv) + Pv) & MASK32) ^ Pv) | Eq
        Ph = Mv | (~(Xh | Pv) & MASK32)
        Mh = Pv & Xh
        hp_out, hm_out = Ph >> 31, Mh >> 31
        Ph = ((Ph << 1) & MASK32) | hp_in
        Mh = ((Mh << 1) & MASK32) | hm_in
        nVP.append(Mh | (~(Xv | Ph) & MASK32))
        nVN.append(Ph & Xv)
        hp_in, hm_in = hp_out, hm_out
    VP = torch.where(live, torch.stack(nVP), VP)
    VN = torch.where(live, torch.stack(nVN), VN)
    sf = torch.where(live, sf + 1, sf)

    # ---- B-exhaustion capture: column j == b_len in the window ----
    wb = b_len - o
    inw = (wb >= 0) & (wb < band) & live
    cost = torch.where(inw, _masked_score(VP, VN, sf, torch.clamp(wb, 0, band)), INF)
    better = cost < best_bx
    best_bx = torch.where(better, cost, best_bx)
    aend_bx = torch.where(better, i, aend_bx)
    bend_bx = torch.where(better, b_len, bend_bx)

    # ---- A-exhaustion capture ----
    at_fin = i == a_len
    fVP = torch.where(at_fin, VP, fVP)
    fVN = torch.where(at_fin, VN, fVN)
    fin_sf = torch.where(at_fin, sf, fin_sf)
    fin_o = torch.where(at_fin, o, fin_o)

    # ---- furthest in-envelope endpoint on the band centre (the
    # reference's overlapInCore -G partial-overlap mode) ----
    jc = o + band // 2
    sc = (sf + (_popcount(VP[: NW // 2]) - _popcount(VN[: NW // 2])).sum(dim=0)).to(torch.int32)
    ext = i + jc
    sc_c = torch.clamp(sc, max=80_000).to(torch.int64)
    ext_c = torch.clamp(ext, max=400_000).to(torch.int64)
    ok = ((jc <= b_len) & live & (_wrap32(sc_c * 20000) <= _wrap32(cap_q * ext_c))
          & (ext > p_ext))
    p_ext = torch.where(ok, ext, p_ext)
    p_edits = torch.where(ok, sc, p_edits)
    p_a = torch.where(ok, i, p_a)
    p_b = torch.where(ok, jc, p_b)
    return MyersCarry(VP, VN, Peq, sf, o, best_bx, aend_bx, bend_bx,
                      fVP, fVN, fin_sf, fin_o, p_ext, p_edits, p_a, p_b)


def _myers_segment(carry: MyersCarry, a, b, s_seg, ent_seg, a_len, b_len, i0: int,
                   cap_q: int, band: int, seg: int) -> MyersCarry:
    """Plain PyTorch row loop: rows i0+1 .. i0+seg of every lane.

    a uint8[B, LA] (row i reads a[:, i-1]), b uint8[B, LB]; s_seg/ent_seg
    [seg, B] rows of _myers_prep's streams.  The reference that kernel K1
    (csrc/myers_tile.cu) is checked against.
    """
    global PLAIN_CUDA_SEGMENTS
    if a.is_cuda:
        PLAIN_CUDA_SEGMENTS += 1
    LB = b.shape[1]
    ent = torch.clamp(ent_seg.T, 0, LB - 1).to(torch.int64)
    b_in = torch.gather(b, 1, ent).T  # [seg, B]
    a_seg = a[:, i0 : i0 + seg].T
    for r in range(seg):
        carry = _myers_row(carry, s_seg[r], a_seg[r], b_in[r], i0 + 1 + r,
                           a_len, b_len, cap_q, band)
    return carry


def _myers_finish(carry: MyersCarry, a_len, b_len, band: int):
    """Best extension end from the final carry: the A-exhausted row is
    unpacked once and its best in-window column compared with the best
    B-exhausted cost."""
    _count_plain(carry.fVP)
    dv = _unpack_bits(carry.fVP) - _unpack_bits(carry.fVN)  # [B, 128]
    pref = torch.cumsum(dv, dim=1, dtype=torch.int32)
    w_ramp = torch.arange(band, dtype=torch.int32, device=dv.device)[None, :]
    scores = carry.fin_sf[:, None] + torch.where(w_ramp == 0, 0, torch.roll(pref, 1, dims=1))
    j = carry.fin_o[:, None] + w_ramp
    scores = torch.where(j <= b_len[:, None], scores, INF)
    wbest = torch.argmin(scores, dim=1, keepdim=True)
    cost_ax = torch.gather(scores, 1, wbest)[:, 0]
    bend_ax = carry.fin_o + wbest[:, 0].to(torch.int32)
    use_ax = cost_ax <= carry.best_bx
    edits = torch.where(use_ax, cost_ax, carry.best_bx)
    a_used = torch.where(use_ax, a_len, carry.aend_bx)
    b_used = torch.where(use_ax, bend_ax, carry.bend_bx)
    return (edits, a_used, b_used, carry.p_edits,
            torch.minimum(carry.p_a, a_len), torch.minimum(carry.p_b, b_len))


# ---- carry <-> kernel planes ------------------------------------------------


def _carry_pack(c: MyersCarry) -> torch.Tensor:
    """MyersCarry -> int32[NC, B] planes (uint32 bit patterns) in the
    Pallas kernel's plane order."""
    def words(x):
        return _wrap32(x.reshape(-1, x.shape[-1]))

    planes = [words(c.VP), words(c.VN), words(c.Peq),
              torch.stack([c.sf, c.o, c.best_bx, c.aend_bx, c.bend_bx]).to(torch.int32),
              words(c.fVP), words(c.fVN),
              torch.stack([c.fin_sf, c.fin_o, c.p_ext, c.p_edits, c.p_a, c.p_b]).to(torch.int32)]
    return torch.cat(planes).contiguous()


def _carry_unpack(p: torch.Tensor) -> MyersCarry:
    """int32[NC, B] planes -> MyersCarry."""
    w = p.to(torch.int64) & MASK32
    B = p.shape[1]
    b = 2 * NW + 4 * NW
    return MyersCarry(
        w[0:NW], w[NW:2 * NW], w[2 * NW:b].reshape(4, NW, B),
        p[b], p[b + 1], p[b + 2], p[b + 3], p[b + 4],
        w[b + 5:b + 5 + NW], w[b + 5 + NW:b + 5 + 2 * NW],
        *(p[b + 5 + 2 * NW + q] for q in range(6)),
    )


# ---- orchestration ----------------------------------------------------------


def _rows_plain(carry, a, b, s_rows, ent_rows, a_len, b_len, cap_q, band, seg, run_segs):
    for t in range(run_segs):
        rs = slice(t * seg, (t + 1) * seg)
        carry = _myers_segment(carry, a, b, s_rows[rs], ent_rows[rs], a_len, b_len,
                               t * seg, cap_q, band, seg)
    return carry


def _rows_kernel(planes, a, b, s_bits, a_len, b_len, cap_q, n_run):
    """Rows 1..n_run of every lane in one launch of kernel K1 with K11's end
    pick after the last row: carry planes in, the six results out."""
    from .kernels.myers_cuda import myers_rows_cuda

    return myers_rows_cuda(planes, a, s_bits, b, a_len, b_len, n_run, cap_q, pick=True)


def _extend(kernel: bool, a, a_len, b, b_len, centers, band, n_rows, segment, max_rows,
            partial_cap_q, events=None, center_stride: int = 1):
    if band != NW * WORD:
        raise ValueError(f"the Myers engine is specialised to band={NW * WORD}, got {band}")
    if center_stride not in (1, CENTER_STRIDE):
        raise ValueError(f"center_stride must be 1 or {CENTER_STRIDE}, got {center_stride}")
    seg = min(segment, n_rows) if n_rows else segment
    n_seg = max(1, -(-n_rows // seg))
    a_len = a_len.to(torch.int32).contiguous()
    b_len = b_len.to(torch.int32).contiguous()
    run_segs = n_seg
    if max_rows is not None:
        run_segs = max(1, min(n_seg, -(-int(max_rows) // seg)))
    # the rows run: the plain loop slices whole segments of a, K1 reads
    # rows 1..n_run of it
    need = (run_segs if kernel else n_seg) * seg
    if a.shape[1] < need:
        a = torch.nn.functional.pad(a, (0, need - a.shape[1]))
    # partial condition: edits*20000 <= cap_q*(a+b), i.e. edits within
    # cap_q (0.01% fixed point) of the mean span (a+b)/2
    cap_q = 0 if partial_cap_q is None else int(partial_cap_q)
    if kernel:
        from .kernels.myers_cuda import myers_prologue_cuda

        # K10 -> K1 with the end pick; with an events list, 4 CUDA events
        # (before K10, after K10, after K1, and after K1 again: the pick has
        # no launch of its own) are appended to it as one list
        ev = None
        if events is not None:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            events.append(ev)
            ev[0].record()
        if centers.dtype != torch.int32:
            centers = centers.to(torch.int32)
        planes, s_bits = myers_prologue_cuda(
            centers, b, a_len, b_len, n_seg * seg, run_segs * seg, center_stride=center_stride,
            center_rows=n_rows + 1 if center_stride > 1 else None)
        if ev:
            ev[1].record()
        out = _rows_kernel(planes, a.contiguous(), b.contiguous(), s_bits, a_len, b_len, cap_q,
                           run_segs * seg)
        if ev:
            ev[2].record()
            ev[3].record()
    else:
        if center_stride > 1:
            centers = expand_centers(centers, n_rows, center_stride)
        s_rows, ent_rows, o0 = _myers_prep(b_len, centers, band, n_seg * seg)
        carry = _myers_init(b, b_len, a_len, o0, band)
        carry = _rows_plain(carry, a, b, s_rows, ent_rows, a_len, b_len, cap_q, band, seg,
                            run_segs)
        out = _myers_finish(carry, a_len, b_len, band)
    return out if partial_cap_q is not None else out[:3]


def banded_extend_myers(a, a_len, b, b_len, centers, band: int = 128, n_rows: int = 0,
                        segment: int = SEGMENT, max_rows: int | None = None,
                        partial_cap_q: int | None = None, events: list | None = None,
                        center_stride: int = 1):
    """Banded extension of B pairs from (0, 0) (band must be 128).

    a uint8[B, LA] (row 0 = first char to align), a_len int32[B],
    b uint8[B, LB], b_len int32[B], centers int32[B, n_rows+1] (expected
    column of each row) or, with center_stride=16, their grid int32[B, >=
    n_rows // 16 + 1] (row i's centre at column i // 16).  max_rows (host
    int, e.g. the longest read of the batch) skips row segments past every
    pair's end.  With partial_cap_q (erate in 0.01% fixed point) returns
    the 6-tuple (edits, a_used, b_used, p_edits, p_a, p_b), else the first
    three.

    CUDA tensors run kernels K10 and K1 with K11's end pick, one launch
    each; with an events list, the CUDA events before K10, after K10, after
    K1 and after the pick (K1's end: the same point) are appended to it as
    one list.  CPU tensors run the plain PyTorch chain, the grid expanded
    to rows first.
    """
    return _extend(a.is_cuda, a, a_len, b, b_len, centers, band, n_rows, segment,
                   max_rows, partial_cap_q, events, center_stride)


def banded_extend_myers_plain(a, a_len, b, b_len, centers, band: int = 128,
                              n_rows: int = 0, segment: int = SEGMENT,
                              max_rows: int | None = None,
                              partial_cap_q: int | None = None, center_stride: int = 1):
    """banded_extend_myers through the plain PyTorch chain on any device:
    the reference kernels K10, K1 and K11 are compared with."""
    return _extend(False, a, a_len, b, b_len, centers, band, n_rows, segment,
                   max_rows, partial_cap_q, center_stride=center_stride)
