"""Device vote-pile engine: batched evidence alignment + on-device voting
(counterpart of canu_tpu.ops.votepile, the one-chunk-a-call path).

Read correction (falcon-sense), read error detection (RED) and consensus
polish reduce to the same step: align many evidence windows onto template
coordinates, accumulate per-column votes (base / deletion / insertion),
then call a per-column plurality.

  * evidence jobs are columnar host arrays of indices into device planes
    of packed words; a chunk uploads a few KB of ids and coordinates,
    never sequence data;
  * alignment positions come from ops.trace.align_positions_lean, one
    call (one launch of kernel K4 on the card) for a group of chunks;
  * each job's votes are packed into one int32 code a template column,
    shifted to template coordinates, expanded to the 15 channels and
    folded into the block's float32 accumulator [G, 15, Lt]: on the card
    by kernel K9, one launch a DP group (a block a slot's tile of columns,
    added in place, ops/kernels/votepile_cuda.py), elsewhere by
    _fold_chunk, a chunk at a time with one product (slot one-hot^T @
    contributions);
  * the plurality / RED decision runs on the device and returns one
    packed value per template column.

Counts are exact: a job's weight is rounded to bfloat16 (as canu_tpu's
cast does), so every term of the fold is a multiple of 2^-7 with at most
12 significant bits, and while a column's sum stays below 2^17 float32
adds them exactly in any order: the votes equal canu_tpu's (K9's wrapper
raises on weights that break this).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .hashing import u32_tensor
from .kmer import unpack_bases
from .kernels import votepile_cuda
from .kernels.trace_cuda import group_jobs, scratch_bytes
from .trace import align_positions_lean

# packed result bit layout (uint16 values; plurality mode — RED packs uint8)
#   bits 0-1: called base (plurality) / alt base (RED)
#   bits 2-3: first insertion base call (plurality) / bit2 = fix flag (RED)
#   bit 4: supported, bit 5: delete, bit 6: insert (before the base)
#   bit 7: second insertion, bits 8-9: second insertion base call
PB_CALL = 0
PB_INS_CALL = 2
PB_SUPPORTED = 4
PB_DELETE = 5
PB_INSERT = 6
PB_INSERT2 = 7
PB_INS2_CALL = 8

# vote channel layout along axis 1 of the [G, 15, Lt] accumulator: two
# insertion slots per template column
CH_BASE = 0  # ..3
CH_DEL = 4
CH_INS = 5
CH_INSBASE = 6  # ..9
CH_INS2 = 10
CH_INS2BASE = 11  # ..14
N_CH = 15


def _log_rounds(n: int) -> int:
    """Number of power-of-two rounds canu_tpu's masked shifts take over n
    lanes: the shift amount's bits 0 .. rounds-1 count, higher bits not."""
    j = 0
    while (1 << j) < n:
        j += 1
    return j


def _shift_rows_left(x: torch.Tensor, t: torch.Tensor, out_len: int) -> torch.Tensor:
    """out[b, i] = x[b, i + t[b]] (zero past the end), t >= 0."""
    B, L = x.shape
    if L < out_len:
        x = torch.nn.functional.pad(x, (0, out_len - L))
        L = out_len
    t = t.to(torch.int64) & ((1 << _log_rounds(L)) - 1)
    idx = torch.arange(out_len, device=x.device)[None, :] + t[:, None]
    got = torch.gather(x, 1, torch.clamp(idx, max=L - 1))
    return torch.where(idx < L, got, torch.zeros((), dtype=x.dtype, device=x.device))


def _shift_rows_right(x: torch.Tensor, t: torch.Tensor, out_len: int) -> torch.Tensor:
    """out[b, i] = x[b, i - t[b]] for i >= t[b], zero before."""
    B, L = x.shape
    if L < out_len:
        x = torch.nn.functional.pad(x, (0, out_len - L))
    x = x[:, :out_len]
    t = t.to(torch.int64) & ((1 << _log_rounds(out_len)) - 1)
    idx = torch.arange(out_len, device=x.device)[None, :] - t[:, None]
    got = torch.gather(x, 1, torch.clamp(idx, min=0))
    return torch.where(idx >= 0, got, torch.zeros((), dtype=x.dtype, device=x.device))


def _gather_window(words, lengths, idx, bgn, flipped, out_len: int) -> torch.Tensor:
    """Unpacked, oriented subsequence rows[idx][bgn : bgn+out_len].

    bgn is in ORIENTED coordinates (for flipped rows: distance from the
    read's 3' end).  flipped=None skips orientation entirely.
    """
    raw = unpack_bases(words[idx])
    L = raw.shape[1]
    if flipped is not None:
        ln = lengths[idx]
        rc = torch.flip(3 - raw, (1,))
        ori = torch.where(flipped[:, None], rc, raw)
        return _shift_rows_left(ori, torch.where(flipped, L - ln, 0) + bgn, out_len)
    return _shift_rows_left(raw, bgn, out_len)


def _group_paths(
    t_words, t_lengths, e_words, e_lengths,
    cols: torch.Tensor,  # int32[>= 7, n]: t_idx, e_idx, t_bgn, t_span, e_lo, e_span, flipped
    band: int, n_rows: int, ends_free: bool = False,
):
    """Windows and alignment paths of a group of chunks' jobs: one DP call
    (one launch of kernel K4 on the card) for all n of them.

    Returns (j_star int32[n, n_rows+1], t_sub uint8[n, n_rows], e_sub
    uint8[n, W_e]) with W_e = n_rows + max(band, n_rows // 2)."""
    W_e = n_rows + max(band, n_rows // 2)
    t_idx, e_idx = cols[0].to(torch.int64), cols[1].to(torch.int64)
    t_sub = _gather_window(t_words, t_lengths, t_idx, cols[2], None, n_rows)
    e_sub = _gather_window(e_words, e_lengths, e_idx, cols[4], cols[6] != 0, W_e)
    e_span = torch.clamp(cols[5], max=W_e - 1)
    js, _ = align_positions_lean(t_sub, cols[3], e_sub, e_span, band, n_rows,
                                 ends_free=ends_free)
    return js, t_sub, e_sub


def _fold_chunk(
    votes: torch.Tensor,  # f32[G, 15, Lt] accumulator
    js, t_sub, e_sub,  # one chunk's slice of _group_paths
    cols: torch.Tensor,  # int32[9, B]: the chunk's job columns, weight bitcast
    n_rows: int, Lt: int, G: int,
) -> torch.Tensor:
    """Fold one chunk's votes into the block: the CPU's fold, and the
    reference kernel K9 is held to."""
    global PLAIN_CUDA_FOLDS
    if votes.is_cuda:
        PLAIN_CUDA_FOLDS += 1
    B = js.shape[0]
    dev = votes.device
    i32 = torch.int32
    W_e = e_sub.shape[1]
    t_bgn, t_span, slot = cols[2], cols[3], cols[7]
    e_span = torch.clamp(cols[5], max=W_e - 1)
    weight = cols[8].contiguous().view(torch.float32)

    dj = js[:, 1:] - js[:, :-1]  # [B, n_rows]
    rowpos = torch.arange(n_rows, dtype=i32, device=dev)[None, :]
    live = rowpos < t_span[:, None]
    active = live & (js[:, 1:] > 0) & (js[:, :-1] < e_span[:, None])

    def chr_at(pos):
        return torch.gather(e_sub, 1, torch.clamp(pos, 0, W_e - 1).to(torch.int64)).to(i32)

    bchr = chr_at(js[:, 1:] - 1)
    ichr = chr_at(js[:, :-1])
    i2chr = chr_at(js[:, :-1] + 1)
    m_base = active & (dj >= 1)
    m_del = active & (dj == 0)
    m_ins = active & (dj >= 2)
    m_ins2 = active & (dj >= 3)

    # deletion votes stack on the first column of each template
    # homopolymer run (the abAbacus mergeRefine role): a surplus base can
    # be deleted at any column of its run
    new_run = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                         t_sub[:, 1:n_rows] != t_sub[:, : n_rows - 1]], dim=1)
    s_del = torch.cumsum(m_del.to(i32), dim=1, dtype=i32)
    nxt = torch.flip(torch.cummin(torch.flip(torch.where(new_run, rowpos, n_rows), (1,)),
                                  dim=1).values, (1,))
    nxt_excl = torch.cat([nxt[:, 1:], torch.full((B, 1), n_rows, dtype=i32, device=dev)], dim=1)
    run_total = (torch.gather(s_del, 1, torch.clamp(nxt_excl - 1, 0, n_rows - 1).to(torch.int64))
                 - torch.cat([torch.zeros((B, 1), dtype=i32, device=dev), s_del[:, :-1]], dim=1))
    del_cnt = torch.where(new_run, torch.clamp(run_total, 0, 15), 0)

    # each position's vote packed into one code (uint16 values held in
    # int32), shifted to template coordinates, then expanded to the
    # channels; deletions carry a 4-bit count (bits 10-13) at run starts
    code = (bchr | (ichr << 2) | (m_base.to(i32) << 4) | (m_ins.to(i32) << 6)
            | (m_ins2.to(i32) << 7) | (i2chr << 8) | (del_cnt << 10))
    code = _shift_rows_right(code, t_bgn, Lt)  # [B, Lt]
    cb = code & 3
    ci = (code >> 2) & 3
    has_b = ((code >> 4) & 1) == 1
    has_i = ((code >> 6) & 1) == 1
    has_i2 = ((code >> 7) & 1) == 1
    ci2 = (code >> 8) & 3
    d_cnt = (code >> 10) & 15
    chans = [has_b & (cb == c) for c in range(4)]
    chans.append(d_cnt)  # CH_DEL carries counts, not a flag
    chans.append(has_i)
    chans += [has_i & (ci == c) for c in range(4)]
    chans.append(has_i2)
    chans += [has_i2 & (ci2 == c) for c in range(4)]
    contrib = torch.stack([c.to(torch.float32) for c in chans], dim=1)  # [B, 15, Lt]
    # the job's weight scales its whole contribution, rounded to bfloat16
    # as canu_tpu's one-hot is; the fold is exact in float32
    w = weight.to(torch.bfloat16).to(torch.float32)
    onehot = (slot[:, None] == torch.arange(G, dtype=i32, device=dev)[None, :]).to(torch.float32)
    delta = (onehot * w[:, None]).T @ contrib.reshape(B, N_CH * Lt)
    return votes + delta.reshape(G, N_CH, Lt)


def _fold_group(votes, js, t_sub, e_sub, cols, host_cols, n_rows: int, Lt: int, G: int, B: int,
                load) -> torch.Tensor:
    """Fold a DP group's votes into the block (its chunks of B jobs in
    order): one launch of kernel K9 on CUDA tensors, into votes in place
    (host_cols the group's columns on the host, load the block's slot
    bounds: ops/kernels/votepile_cuda.py), _fold_chunk chunk by chunk
    elsewhere.  Returns the votes."""
    if votes.is_cuda:
        votepile_cuda.vote_fold(votes, js, t_sub, e_sub, cols.contiguous(), n_rows,
                                (1 << _log_rounds(Lt)) - 1, host_cols, load)
        return votes
    for lo in range(0, cols.shape[1], B):
        votes = _fold_chunk(votes, js[lo : lo + B], t_sub[lo : lo + B], e_sub[lo : lo + B],
                            cols[:, lo : lo + B], n_rows, Lt, G)
    return votes


def _template_codes(t_words, t_lengths, t_idx, Lt: int):
    t_all = unpack_bases(t_words[t_idx.to(torch.int64)])
    LW = t_all.shape[1]
    if LW < Lt:
        t_all = torch.nn.functional.pad(t_all, (0, Lt - LW))
    t_codes = t_all[:, :Lt]
    tl = t_lengths[t_idx.to(torch.int64)]
    pos_live = torch.arange(Lt, dtype=torch.int32, device=t_codes.device)[None, :] < tl[:, None]
    return t_codes, pos_live


def _finalize_plurality(t_words, t_lengths, t_idx, votes, min_cov: float, Lt: int,
                        keep_template: bool):
    """Per-column plurality -> one packed value per template column
    (uint16 values in an int32 tensor), and the column coverage.

    The template does not vote for itself; deletes and inserts need a
    strict majority of coverage.  Ties go to the lowest base code, as
    canu_tpu's argmax gives them.
    """
    i32 = torch.int32
    t_codes, pos_live = _template_codes(t_words, t_lengths, t_idx, Lt)
    bv = votes[:, CH_BASE : CH_BASE + 4, :]  # [G, 4, Lt]
    cov = torch.sum(bv, dim=1) + votes[:, CH_DEL, :]
    call = torch.argmax(bv, dim=1).to(i32)
    delete = votes[:, CH_DEL, :] * 2 > cov
    cov1 = torch.clamp(cov, min=1.0)
    insert_before = votes[:, CH_INS, :] * 2 > cov1
    ins_call = torch.argmax(votes[:, CH_INSBASE : CH_INSBASE + 4, :], dim=1).to(i32)
    insert2 = insert_before & (votes[:, CH_INS2, :] * 2 > cov1)
    ins2_call = torch.argmax(votes[:, CH_INS2BASE : CH_INS2BASE + 4, :], dim=1).to(i32)
    supported = (cov >= min_cov) & pos_live
    if keep_template:
        call = torch.where(supported, call, t_codes.to(i32))
        delete = delete & supported
        insert_before = insert_before & supported
        insert2 = insert2 & supported
        supported = pos_live
    packed = (call | (ins_call << PB_INS_CALL) | (supported.to(i32) << PB_SUPPORTED)
              | (delete.to(i32) << PB_DELETE) | (insert_before.to(i32) << PB_INSERT)
              | (insert2.to(i32) << PB_INSERT2) | (ins2_call << PB_INS2_CALL))
    return packed, cov


def _finalize_red(t_words, t_lengths, t_idx, votes, min_alt: float, max_own: float, Lt: int):
    """findErrors decision: alt base + fix flag per column (uint8 values in
    an int32 tensor).

    A position is corrected when an alternative base gets >= min_alt
    votes while the read's own base keeps <= max_own and no stronger
    deletion vote vetoes it (findErrors.C Vote_Qualify semantics)."""
    t_codes, pos_live = _template_codes(t_words, t_lengths, t_idx, Lt)
    bv = votes[:, CH_BASE : CH_BASE + 4, :]  # [G, 4, Lt]
    alt = torch.argmax(bv, dim=1).to(torch.int32)
    alt_v = torch.amax(bv, dim=1)
    own_v = torch.gather(bv, 1, t_codes[:, None, :].to(torch.int64))[:, 0, :]
    fix = ((alt != t_codes.to(torch.int32)) & (alt_v >= min_alt) & (own_v <= max_own)
           & (votes[:, CH_DEL, :] < alt_v) & pos_live)
    return alt | (fix.to(torch.int32) << 2)


# ---- host-side drivers -------------------------------------------------------


@dataclass
class VoteJobs:
    """Columnar evidence jobs (all int32/bool numpy arrays, same length).

    t_idx/e_idx index rows of the device word planes; t_bgn/t_span is the
    template window; e_lo/e_span the evidence window in ORIENTED
    coordinates (for flipped evidence, e_lo = len - fwd_end); slot is the
    template's row in the block accumulator."""

    t_idx: np.ndarray
    e_idx: np.ndarray
    t_bgn: np.ndarray
    t_span: np.ndarray
    e_lo: np.ndarray
    e_span: np.ndarray
    flipped: np.ndarray
    slot: np.ndarray
    # optional per-job vote weight (evidence quality tie-break); None = 1.0
    weight: np.ndarray | None = None

    def __len__(self):
        return len(self.t_idx)

    def weights(self) -> np.ndarray:
        if self.weight is None:
            return np.ones(len(self), np.float32)
        return self.weight


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


# budget knobs: positions per vote block (G*Lt) and DP cells per chunk
# (B*n_rows), the second sized from the card by
# configure.configure_resources; and the device bytes of kernel K4's
# scratch one DP call (a group of chunks) may take: None sizes it from the
# device of the work (group_chunks), a number holds on every device
BLOCK_POS_BUDGET = 1 << 21
CHUNK_CELL_BUDGET = 1 << 21
GROUP_BYTE_BUDGET: int | None = None


def block_geometry(max_t_len: int) -> tuple[int, int]:
    """(G, Lt) for a template block whose longest template is max_t_len."""
    Lt = _pow2_at_least(max(max_t_len, 256))
    G = max(8, min(256, BLOCK_POS_BUDGET // Lt))
    return G, Lt


def chunk_jobs(n_rows: int) -> int:
    """Jobs a chunk at n_rows DP rows: CHUNK_CELL_BUDGET // n_rows, within
    32-256."""
    return max(32, min(256, CHUNK_CELL_BUDGET // n_rows))


def group_chunks(band: int, n_rows: int, B: int, dev: torch.device) -> int:
    """Chunks of B jobs one DP call on dev takes.  On the card, as many as
    kernel K4's scratch for them fits in a sixth of its memory
    (ops/kernels/trace_cuda.py group_jobs), as CHUNK_CELL_BUDGET is sized.
    On the CPU the plain DP holds no K4 scratch but each chunk's whole DP
    state, which CHUNK_CELL_BUDGET sizes for one chunk: one chunk a call.
    GROUP_BYTE_BUDGET, when set, is the budget on either device (the CPU
    tests group with it).  Raises when not even one chunk fits."""
    budget = GROUP_BYTE_BUDGET
    if budget is None:
        if dev.type != "cuda":
            return 1
        budget = torch.cuda.get_device_properties(dev).total_memory // 6
    k = group_jobs(band, n_rows, budget) // B
    if k < 1:
        raise ValueError(f"a chunk of {B} jobs at {n_rows} rows, band {band}, needs "
                         f"{scratch_bytes(B, band, n_rows)} bytes of DP scratch, over the "
                         f"group budget of {budget} bytes")
    return k


def group_columns(packed: torch.Tensor, c0: int, k: int) -> torch.Tensor:
    """Chunks c0..c0+k-1 of packed int32[C, F, B] as one int32[F, k*B]
    plane, chunk after chunk."""
    grp = packed[c0 : c0 + k]
    return grp.permute(1, 0, 2).reshape(grp.shape[1], -1)


_COL_FIELDS = ("t_idx", "e_idx", "t_bgn", "t_span", "e_lo", "e_span",
               "flipped", "slot", "weight")

# chunks, jobs and DP groups run by pile_votes, and the plain fold's calls
# on CUDA tensors (counters the chip check reads; the last stays 0 on the
# path)
CHUNKS = JOBS = GROUPS = PLAIN_CUDA_FOLDS = 0


def pack_columns(jobs: VoteJobs, B: int) -> np.ndarray:
    """The jobs as one int32[C, 9, B] plane: int columns verbatim, bool as
    0/1, the float weight bit-cast.  Pad jobs have t_span=0 and weight=0:
    they align garbage (masked) and contribute zero votes."""
    n = len(jobs)
    C_total = -(-n // B)
    pad_n = C_total * B - n
    packed = np.zeros((C_total, 9, B), np.int32)
    for fi, f in enumerate(_COL_FIELDS):
        v = jobs.weights() if f == "weight" else getattr(jobs, f)
        if f == "weight":
            v = v.astype(np.float32).view(np.int32)
        else:
            v = v.astype(np.int32)
        if pad_n:
            v = np.concatenate([v, np.zeros(pad_n, np.int32)])
        packed[:, fi, :] = v.reshape(C_total, B)
    return packed


def pile_votes(
    t_words, t_lengths, e_words, e_lengths,
    jobs: VoteJobs, G: int, Lt: int, band: int | None = None,
    ends_free: bool = False,
) -> torch.Tensor:
    """Run all evidence jobs of one template block; returns the device
    votes f32[G, 15, Lt].  Every job runs at n_rows = Lt, in chunks of
    chunk_jobs(Lt) jobs; the chunks' windows and DP run a group of
    group_chunks of them at a time (one DP call), then the group is folded
    in (_fold_group: one launch of kernel K9 on the card, its chunks in
    order elsewhere); the planes' device is the device of the work."""
    global CHUNKS, JOBS, GROUPS
    dev = t_words.device
    votes = torch.zeros((G, N_CH, Lt), dtype=torch.float32, device=dev)
    if len(jobs) == 0:
        return votes
    n_rows = Lt
    B = chunk_jobs(n_rows)
    band_c = min(band if band is not None else 256, 256)
    k = group_chunks(band_c, n_rows, B, dev)
    host = torch.from_numpy(pack_columns(jobs, B))
    packed = host.to(dev)
    load = np.zeros(G)  # K9's bound on each slot's column sums (votepile_cuda.add_load)
    JOBS += len(jobs)
    for c0 in range(0, packed.shape[0], k):
        cols = group_columns(packed, c0, k)
        js, t_sub, e_sub = _group_paths(t_words, t_lengths, e_words, e_lengths, cols, band_c,
                                        n_rows, ends_free)
        GROUPS += 1
        votes = _fold_group(votes, js, t_sub, e_sub, cols, group_columns(host, c0, k).numpy(),
                            n_rows, Lt, G, B, load)
        CHUNKS += cols.shape[1] // B
    return votes


def decode_pieces(row: np.ndarray):
    """Packed row -> list of (start_pos, piece_codes) over supported runs
    (falcon-sense low-coverage splitting)."""
    supported = (row >> PB_SUPPORTED) & 1
    call = row & 3
    delete = ((row >> PB_DELETE) & 1).astype(bool)
    ins = ((row >> PB_INSERT) & 1).astype(bool)
    ins_call = (row >> PB_INS_CALL) & 3
    ins2 = ((row >> PB_INSERT2) & 1).astype(bool) & ins
    ins2_call = (row >> PB_INS2_CALL) & 3
    padded = np.concatenate([[0], supported, [0]])
    starts = np.flatnonzero((padded[:-1] == 0) & (padded[1:] == 1))
    ends = np.flatnonzero((padded[:-1] == 1) & (padded[1:] == 0))
    out = []
    for b, e in zip(starts, ends):
        idx = np.arange(b, e)
        seq = _interleave2(
            call[idx].astype(np.uint8), ~delete[idx],
            ins[idx], ins_call[idx].astype(np.uint8),
            ins2[idx], ins2_call[idx].astype(np.uint8),
        )
        out.append((int(b), seq))
    return out


def _interleave2(bases, keep, ins, ins_call, ins2, ins2_call) -> np.ndarray:
    """Emit [ins1?][ins2?][base?] per position, vectorized (the evidence
    order: inserted chars precede the matched base)."""
    contrib = ins.astype(np.int64) + ins2.astype(np.int64) + keep.astype(np.int64)
    off = np.zeros(len(bases) + 1, np.int64)
    np.cumsum(contrib, out=off[1:])
    out = np.empty(int(off[-1]), np.uint8)
    ii = np.flatnonzero(ins)
    out[off[ii]] = ins_call[ii]
    jj = np.flatnonzero(ins2)
    out[off[jj] + 1] = ins2_call[jj]
    kk = np.flatnonzero(keep)
    out[off[kk] + ins[kk] + ins2[kk]] = bases[kk]
    return out


def segment_codes_plane(seg_codes, S: int, device):
    """Device plane for host code segments (<= S bases each): packed words
    [R(pow2 >= 1024), S/16] (int64 holding uint32) + lengths + pad row
    index; the shape family of falcon._segment_plane."""
    from ..utils.bitpack import BASES_PER_WORD, pack_codes

    SW = S // BASES_PER_WORD
    n = len(seg_codes)
    R = max(1024, 1 << max(0, int(n).bit_length()))  # always > n
    plane = np.zeros((R, SW), np.uint32)
    lens = np.zeros(R, np.int32)
    for i, c in enumerate(seg_codes):
        if len(c):
            w = pack_codes(np.asarray(c, np.uint8))
            plane[i, : len(w)] = w
        lens[i] = len(c)
    return u32_tensor(plane, device), torch.from_numpy(lens).to(device), R - 1


def device_words(rs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Packed words (int64 holding uint32) + lengths of a ReadSet on
    ``device``, both dimensions padded to powers of two with trailing
    all-zero rows (canu_tpu's canonical planes; cached per ReadSet and
    device)."""
    from ..stores.readset import device_cache

    cache = device_cache(rs, "words")
    dev = torch.device(device)
    if dev in cache:
        return cache[dev]
    from ..utils.bitpack import n_words

    N = rs.n_reads
    max_len = int(rs.length.max()) if N else 1
    W = 1 << max(0, int(n_words(max_len) - 1).bit_length())
    # > N so pad rows exist; floor 128 keeps tiny stores on one shape
    R = max(128, 1 << max(0, int(N).bit_length()))
    host_words, host_len = rs.block_words(np.arange(1, N + 1, dtype=np.int64), W)
    host_words = np.vstack([host_words, np.zeros((R + 1 - N, W), np.uint32)])
    host_len = np.concatenate([host_len, np.zeros(R + 1 - N, np.int32)])
    cache[dev] = (u32_tensor(host_words, dev), torch.from_numpy(host_len).to(dev))
    return cache[dev]
