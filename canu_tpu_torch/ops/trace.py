"""Base-level alignment positions via forward+backward banded DP
(counterpart of canu_tpu.ops.trace: _band_starts, SMAX, SROW and
align_positions_lean).

The vote engine needs, for every evidence read aligned to a template,
the evidence coordinate at every template position.  The DP runs forward
(cost of aligning prefixes) and backward (cost of aligning suffixes); a
cell lies on an optimal path iff fwd + bwd equals the row's minimum, so
the per-row argmin of fwd + bwd gives the evidence position j*(i) of
every template row with no traceback.

The recurrence, band geometry, uint8 normalization of the forward rows
and tie-breaks are canu_tpu's, value for value (int32 throughout, as JAX
runs with x64 off).  ``align_positions_lean`` runs the DP on CUDA tensors
as kernel K4 (csrc/vote_dp.cu, one launch for all the jobs of a call: the
two passes at once, two warps a job, and the combine) and elsewhere as the
plain version ``align_positions_lean_plain``; both share the band starts
before the DP and the positions and edits after it.  What differs in the plain version
is how the rows run as PyTorch ops:

  * everything that does not depend on the previous row (the evidence
    windows, the substitution costs, the row and lane masks, the
    boundary rows) is built once per super-row of SROW rows, so a DP row
    costs 7 small ops forward and 13 backward, and no op reads a value
    back to the host;
  * the backward pass holds its rows with the lanes reversed, so its
    suffix-min closure is a plain ``cummin``;
  * the combine keeps, per row, min over lanes of ``tot * Ww + x``: the
    least total and, among ties, the first lane, as ``argmin`` picks it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

INF16 = 30000
SMAX = 4
# rows per window anchor: every SROW rows the band start is re-based, so
# the rows of a super-row share one evidence window of band + SMAX*SROW
# lanes
SROW = 32
BAD = INF16 * 4  # a combine total outside the band or past either end

# plain DP calls on CUDA tensors; the pipeline must leave it 0
PLAIN_CUDA_CALLS = 0


def _band_starts(centers: torch.Tensor, b_len: torch.Tensor, band: int) -> torch.Tensor:
    """Band start per row: centred on ``centers``, clamped to [0, b_len],
    monotone, rising by at most SMAX a row."""
    o = torch.minimum(torch.clamp(centers - band // 2, min=0),
                      torch.clamp(b_len, min=0)[:, None])
    o = torch.cummax(o, dim=1).values
    ramp = SMAX * torch.arange(o.shape[1], dtype=torch.int32, device=o.device)[None, :]
    return torch.cummin(o - ramp, dim=1).values + ramp


def _shift_lanes_left(x: torch.Tensor, d: torch.Tensor, fill: int) -> torch.Tensor:
    """out[b, k] = x[b, k + d[b]], ``fill`` past the end (d >= 0)."""
    W = x.shape[1]
    idx = torch.arange(W, dtype=torch.int64, device=x.device)[None, :] + d[:, None]
    got = torch.gather(x, 1, torch.clamp(idx, max=W - 1))
    return torch.where(idx < W, got, fill)


def _anchors(t_len: torch.Tensor, e_len: torch.Tensor, band: int, n_rows: int) -> torch.Tensor:
    """int32[B, n_rows // SROW]: the band start a_p of row p * SROW, the
    anchor of super-row p (band centred on the diagonal i * e_len / t_len)."""
    ri = torch.arange(n_rows + 1, dtype=torch.int32, device=t_len.device)
    tl = torch.clamp(t_len, min=1)[:, None]
    centers = torch.minimum((ri[None, :] * e_len[:, None] + tl // 2) // tl, e_len[:, None])
    o_all = _band_starts(centers, e_len, band)  # [B, n_rows+1]
    return o_all[:, ::SROW][:, : n_rows // SROW].contiguous()


def _positions(K: torch.Tensor, A: torch.Tensor, t_len: torch.Tensor, e_len: torch.Tensor,
               n_rows: int, Ww: int):
    """(j_star int32[B, n_rows+1], edits int32[B]) from K int32[B, n_rows+1],
    each row's least combine key tot * Ww + x: x* is the lane in the frame
    of the row's super-row, the least total at row t_len the edits (BAD
    when t_len is not a row)."""
    K = torch.clamp(K, max=BAD * Ww)
    x_star = K % Ww
    row_min = K // Ww
    ri = torch.arange(n_rows + 1, dtype=torch.int32, device=K.device)
    fidx = (torch.clamp(ri - 1, min=0) // SROW).to(torch.int64)  # frame of row i
    el = e_len[:, None]
    j_star = (A[:, fidx] + x_star).to(torch.int32)  # [B, n_rows+1]
    live = ri[None, :] <= t_len[:, None]
    j_star = torch.where(live, j_star, el)
    j_star = torch.cummax(j_star, dim=1).values
    j_star = torch.minimum(torch.clamp(j_star, min=0), el)
    in_rows = (t_len >= 0) & (t_len <= n_rows)
    at_end = torch.gather(row_min, 1, torch.clamp(t_len, 0, n_rows).to(torch.int64)[:, None])
    edits = torch.where(in_rows, at_end[:, 0], BAD).to(torch.int32)
    return j_star, edits


def align_positions_lean(
    t: torch.Tensor,  # uint8[B, >=n_rows] template chars (row 0 = first char)
    t_len: torch.Tensor,  # int32[B]
    e: torch.Tensor,  # uint8[B, LE] evidence chars
    e_len: torch.Tensor,  # int32[B]
    band: int,
    n_rows: int,
    ends_free: bool = False,
):
    """Banded fwd+bwd DP of the vote engine, in canu_tpu's window frame.

    ``ends_free=True`` makes evidence start/end gaps cost 0 (the template
    window aligns as an infix of the evidence window).  Rows run in
    super-rows of SROW rows anchored at the band start of their first
    row; row i (i >= 1) lies in the frame of super-row (i - 1) // SROW.

    On CUDA tensors the DP is one launch of kernel K4 for all B jobs
    (ops/kernels/trace_cuda.py), which raises on what it does not take;
    on any other device it is align_positions_lean_plain.  Each job's DP
    is its own, so the result of a job does not depend on B.

    Returns (j_star int32[B, n_rows+1], edits int32[B]).  Requires
    band <= 256 and n_rows % SROW == 0.
    """
    if not t.is_cuda:
        return align_positions_lean_plain(t, t_len, e, e_len, band, n_rows, ends_free)
    from .kernels import trace_cuda

    t_len = t_len.to(torch.int32).contiguous()
    e_len = e_len.to(torch.int32).contiguous()
    A = _anchors(t_len, e_len, band, n_rows)
    K = trace_cuda.vote_dp_keys(t.contiguous(), t_len, e.contiguous(), e_len, A, band, n_rows,
                                ends_free)
    return _positions(K, A, t_len, e_len, n_rows, band + SMAX * SROW)


def align_positions_lean_plain(
    t: torch.Tensor,
    t_len: torch.Tensor,
    e: torch.Tensor,
    e_len: torch.Tensor,
    band: int,
    n_rows: int,
    ends_free: bool = False,
):
    """align_positions_lean as PyTorch ops, 7 a forward row and 13 a
    backward one: the CPU's DP, and the reference kernel K4 is held to."""
    global PLAIN_CUDA_CALLS
    if t.is_cuda:
        PLAIN_CUDA_CALLS += 1
    assert band <= 256, "uint8 row normalization requires band <= 256"
    assert n_rows % SROW == 0, "n_rows must be a multiple of SROW"
    dev = t.device
    R = SROW
    Q = n_rows // R
    Ww = band + SMAX * R
    B = t.shape[0]
    i32 = torch.int32
    t_len = t_len.to(i32)
    e_len = e_len.to(i32)
    x = torch.arange(Ww, dtype=i32, device=dev)
    xr = torch.flip(x, (0,))  # lane y of a reversed row holds lane Ww - 1 - y
    ri = torch.arange(n_rows + 1, dtype=i32, device=dev)
    A = _anchors(t_len, e_len, band, n_rows)  # a_p, the band start of row p*R
    el = e_len[:, None]

    # every super-row's evidence window, lane k = e[a_p - 1 + k] (0 past
    # either end): one gather for the whole DP
    EW = Ww + 128
    LE1 = e.shape[1] + 1
    e_pad = Fn.pad(e, (1, 0))
    widx = A.to(torch.int64)[:, :, None] + torch.arange(EW, device=dev)[None, None, :]
    ewin = torch.gather(e_pad[:, None, :].expand(B, Q, LE1), 2,
                        torch.clamp(widx, max=LE1 - 1))
    ewin = torch.where(widx < LE1, ewin, 0)  # [B, Q, EW]
    del widx
    t_rows = t[:, :n_rows].T  # [n_rows, B]

    def frame(p: int):
        a = A[:, p]
        j = a[:, None] + x
        return a, j, j <= el

    # ---- forward: F(i) from F(i-1); rows kept uint8-normalized ----
    a0, j0, jm0 = frame(0)
    F0 = torch.where(jm0, torch.zeros_like(j0) if ends_free else j0, INF16)
    Fu = torch.empty((n_rows + 1, B, Ww), dtype=torch.uint8, device=dev)
    Fm = torch.empty((n_rows + 1, B), dtype=i32, device=dev)

    def norm_into(Frows: torch.Tensor, lo: int) -> None:
        fmin = torch.amin(Frows, dim=2)
        d = torch.clamp(Frows - fmin[..., None], 0, 254).to(torch.uint8)
        Fu[lo : lo + Frows.shape[0]] = torch.where(Frows >= INF16, 255, d)
        Fm[lo : lo + Frows.shape[0]] = fmin

    norm_into(F0[None], 0)
    # Fbuf[r, :, 1:] is row r of the super-row (row 0 the carried row in
    # the new frame), Fbuf[r, :, 0] an INF16 wall for the diagonal
    Fbuf = torch.full((R + 1, B, Ww + 1), INF16, dtype=i32, device=dev)
    Fbuf[0, :, 1:] = F0
    one_mx = 1 - x
    inf = torch.tensor(INF16, dtype=i32, device=dev)  # where(..., out=) takes no scalar
    for p in range(Q):
        a_p, j, jm = frame(p)
        if p:
            Fbuf[0, :, 1:] = _shift_lanes_left(Fbuf[R, :, 1:], a_p - A[:, p - 1], INF16)
        valid_dg = (j >= 1) & jm
        sub = (t_rows[p * R : p * R + R, :, None] != ewin[None, :, p, :Ww]).to(i32)
        # diagonal cost minus the lane: m - x = min(F + 1 - x, dg + sub - x);
        # INF16 where the diagonal is invalid (any m >= INF16 ends as INF16)
        dg_mx = torch.where(valid_dg[None], sub, INF16) - x
        live = (ri[p * R + 1 : p * R + R + 1, None] <= t_len[None, :])  # [R, B]
        mask = jm[None] & live[:, :, None]
        for r in range(R):
            a1 = Fbuf[r, :, 1:] + one_mx
            a2 = Fbuf[r, :, :-1] + dg_mx[r]
            torch.minimum(a1, a2, out=a1)
            c = torch.cummin(a1, dim=1).values
            c += x
            c.clamp_(max=INF16)
            torch.where(mask[r], c, inf, out=Fbuf[r + 1, :, 1:])
        norm_into(Fbuf[1:, :, 1:], p * R + 1)

    # ---- backward with the combine folded in ----
    # G rows are held lane-reversed: Gbuf[:, 1:][y] = G[Ww - 1 - y], and
    # Gbuf[:, 0] is the INF16 wall G(i+1, j+1) reads past the band
    Gbuf = torch.full((B, Ww + 1), INF16, dtype=i32, device=dev)
    Gr, Gdg = Gbuf[:, 1:], Gbuf[:, :-1]
    K = torch.empty((n_rows + 1, B), dtype=i32, device=dev)  # min of tot * Ww + x
    one_xr = 1 + xr
    BADK = BAD * Ww
    badk = torch.tensor(BADK, dtype=i32, device=dev)

    def fkey(lo: int, hi: int) -> torch.Tensor:
        """Forward part of the combine key of rows lo..hi-1, lane-reversed:
        (Fm + Fu) * Ww + x, or BADK where F is out of the band."""
        fu, fm = Fu[lo:hi], Fm[lo:hi, :, None]
        k = torch.where((fu == 255) | (fm >= INF16), BADK, (fm + fu.to(i32)) * Ww + x)
        return torch.flip(k, (2,))

    def g_consts(a: torch.Tensor, win: torch.Tensor, lo: int, hi: int):
        """Per-row constants of backward rows lo..hi-1 in frame a, lanes
        reversed: diagonal cost + x, the rows' keep mask and the value
        where not kept (the boundary row at i == t_len, else INF16)."""
        jr = a[:, None] + xr
        jmr = jr <= el
        sub = (t_rows[lo:hi, :, None] != torch.flip(win[:, 1 : Ww + 1], (1,))[None]).to(i32)
        dg_x = torch.where((jr < el)[None], sub, INF16) + xr
        rows = ri[lo:hi, None]
        keep = (rows < t_len[None, :])[:, :, None] & jmr[None]
        tail = torch.zeros_like(jr) if ends_free else el - jr
        bound = torch.where(jmr, tail, INF16)
        alt = torch.where((rows == t_len[None, :])[:, :, None], bound[None], INF16)
        return dg_x, keep, alt

    def g_row(dg_x, keep, alt) -> None:
        s = torch.minimum(Gr + one_xr, Gdg + dg_x)
        s.clamp_(max=INF16)
        sm = torch.cummin(s, dim=1).values
        sm -= xr
        sm.clamp_(max=INF16)
        torch.where(keep, sm, alt, out=Gr)

    def combine(i: int, fk: torch.Tensor) -> None:
        gk = torch.where(Gr >= INF16, badk, Gr * Ww)
        torch.amin(fk + gk, dim=1, out=K[i])

    a_top, j_top, jm_top = frame(Q - 1)
    G_top = torch.where(jm_top, torch.zeros_like(j_top) if ends_free else el - j_top, INF16)
    Gr.copy_(torch.flip(torch.where((t_len == n_rows)[:, None], G_top, INF16), (1,)))
    combine(n_rows, fkey(n_rows, n_rows + 1)[0])
    for p in range(Q - 1, -1, -1):
        a_p = A[:, p]
        a_pm1 = A[:, max(p - 1, 0)]
        lo = p * R
        dg_x, keep, alt = g_consts(a_p, ewin[:, p], lo + 1, lo + R)
        fk = fkey(lo, lo + R)
        for r in range(R - 1, 0, -1):
            g_row(dg_x[r - 1], keep[r - 1], alt[r - 1])
            combine(lo + r, fk[r])
        # row p*R lies in frame a_{p-1}: re-anchor, then compute it
        Gr.copy_(_shift_lanes_left(Gr, a_p - a_pm1, INF16))
        dg_x, keep, alt = g_consts(a_pm1, ewin[:, max(p - 1, 0)], lo, lo + 1)
        g_row(dg_x[0], keep[0], alt[0])
        combine(lo, fk[0])

    return _positions(K.T, A, t_len, e_len, n_rows, Ww)
