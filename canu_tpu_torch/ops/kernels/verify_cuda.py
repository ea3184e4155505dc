"""Kernels K7, K8 and K12 on Hopper: build, bind and launch csrc/verify.cu.

K7 (``verify_pre``) is verify's anchor-and-inputs step for a group of
chunks in one launch, one block of 256 threads a pair: the syncmer join
of the pair's two index rows (a binary search of each first B entry of a
key in A's row, both rows in mix32 order as K8 writes them, a row out of
that order sorted first), the strand vote, the median diagonal by a radix
select and its inliers, their (posA, key) sort, the running-max chain
and the MAX_ANCHORS picks, the seed, the band centres interpolated once a
16-row group (stored as that grid for the Myers engine, expanded to rows
for the INF-walled one) and the four shifted, oriented base rows 16 bases
a thread,
written straight into the group's wide extension inputs (chunk g's
forward rows, then its backward rows, then chunk g + 1's).
ops.align._verify_pre launches it on CUDA tensors; it is held against
ops.align._verify_pre_plain.

K8 is the open-syncmer selection and compaction, one block of 256
threads a read, its selected (key, position) pairs in shared memory
(sorted there, or cut to pm by a radix select first).  ``syncmer_index``
builds a whole read index in one launch, each read at its length
bucket's width; ops.minimizers.build_read_index calls it on the card.
``syncmer`` runs one padded block (ops.minimizers._syncmer_kernel on CUDA
tensors).  Both are held against ops.minimizers._syncmer_kernel_plain.

K12 is stage C's pair statistics, one block a pair, the join of the two
reads' canonical k-mers in shared memory (a table of A's keys that B
probes, in rounds where A has more positions than the table holds at half
load; the hits in shared memory, a pair with more possible hits than that
spilling to its room in a device list), the strand vote, the two lower
medians by radix selects, the inliers and their spans.
``pair_stats_rows`` takes a whole place_candidates call in one launch
(pairs as rows of the read set's word plane; a call whose device hit list
would pass K12_HIT_LIST is split into launches that stay within it);
``pair_stats`` a chunk of padded pairs, its two blocks stacked into one
plane, through the same kernel.  Both are held against
ops.minhash._pair_stats_kernel.

The library is built by ops/kernels/_nvcc.py and loaded with ctypes;
nothing here falls back to the plain versions: a failed build, a tensor
the kernels do not take, or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "verify.cu"

# launches since the last reset (read by chip_smoke.py): K7, K8, K12
PRE_LAUNCHES = SYNCMER_LAUNCHES = PAIR_STATS_LAUNCHES = 0

# K12's launch plan: threads a block (csrc/verify.cu K12_NT, fixed when
# the library is built), table slots a block (a pair with more than
# K12_SLOTS / 2 positions in A takes rounds) and hits kept in shared memory
# (a pair with more possible hits spills the rest to a device list):
# 106,496 B of dynamic shared memory, 2 blocks an SM.  The fastest of the
# plans scripts/torch_pair_stats_variants.py sweeps on phase 4d.
K12_THREADS = 512
K12_SLOTS = 8192
K12_HITS = 1024
K12_MIN_SLOTS = 64
# the device hit list one K12 launch may take, in int2 entries (1 GiB)
K12_HIT_LIST = 1 << 27

# K7 keeps each hit's two slots in 11 bits each; K8 holds pm (key,
# position) pairs in shared memory
MAX_PM = 2048

_lib = None


def bind(path) -> ctypes.CDLL:
    """The library built from SOURCE at path, its functions typed."""
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    i = ctypes.c_int
    lib.canu_verify_pre.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, i, i, i, i,
                                    p, p, p, p, p, p, p, p, p, p, p]
    lib.canu_syncmer.argtypes = [p, i, p, p, p, i, i, i, i, i, p, p, p, p, p]
    lib.canu_verify_resources.argtypes = [i, i, p]
    lib.canu_pair_stats.argtypes = [p, p, i, p, p, i, p, i, i, i, i, p, p, p, p, p]
    lib.canu_pair_stats_resources.argtypes = [i, i, p]
    for fn in (lib.canu_verify_pre, lib.canu_syncmer, lib.canu_verify_resources,
               lib.canu_pair_stats, lib.canu_pair_stats_resources):
        fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(_nvcc.build(SOURCE)[0][0])
    return _lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"kernel {name} launch failed: "
                           f"{f'refused its arguments ({rc})' if rc < 0 else f'cudaError {rc}'}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _on_card(name: str, dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"kernel {name} needs CUDA tensors, got {dev}")


def verify_pre(index, a_idx, b_idx, flipped, k: int, band: int, n_rows: int, orient: bool,
               chunk: int, center_stride: int = 1):
    """Kernel K7: (ext_in, n_anchor, flipped, seedA, seedB, n_minor) of
    ops.align._verify_pre for the pairs (a_idx[q], b_idx[q]) (int64 rows of
    the ReadIndex `index`, flipped bool, all [G * chunk]) on the card:
    ext_in = (a uint8[2 G chunk, n_rows], a_len int32, b uint8[2 G chunk,
    n_rows + band], b_len int32, centers int32[2 G chunk, n_rows + 1], or
    with center_stride 16 their grid int32[2 G chunk, n_rows // 16 + 1])
    with chunk g's forward rows at 2 g chunk + p and its backward rows at 2
    g chunk + chunk + p; the per-pair outputs int32[G chunk] (flipped
    bool)."""
    global PRE_LAUNCHES
    if a_idx.dim() != 1:
        raise ValueError("a_idx must be 1-D")
    dev = a_idx.device
    n = a_idx.shape[0]
    if chunk < 1 or n % chunk:
        raise ValueError(f"kernel K7 takes whole chunks: {n} pairs, chunk {chunk}")
    if band < 0 or n_rows < 1:
        raise ValueError(f"kernel K7 needs band >= 0 and n_rows >= 1, got {band}, {n_rows}")
    if center_stride not in (1, 16):
        raise ValueError(f"kernel K7 stores centres at stride 1 or 16, got {center_stride}")
    words, length = index.words, index.length
    if words.dim() != 2 or index.mker.dim() != 2:
        raise ValueError("the index planes must be 2-D")
    Npad, W = words.shape
    Pm = index.mker.shape[1]
    if not 1 <= Pm <= MAX_PM:
        raise ValueError(f"kernel K7 takes index rows of 1..{MAX_PM} syncmers, got {Pm}")
    _nvcc.check_tensor("words", words, torch.int64, (Npad, W), dev)
    _nvcc.check_tensor("length", length, torch.int32, (Npad,), dev)
    _nvcc.check_tensor("mker", index.mker, torch.int64, (Npad, Pm), dev)
    _nvcc.check_tensor("mpos", index.mpos, torch.int32, (Npad, Pm), dev)
    _nvcc.check_tensor("mstr", index.mstr, torch.int32, (Npad, Pm), dev)
    _nvcc.check_tensor("a_idx", a_idx, torch.int64, (n,), dev)
    _nvcc.check_tensor("b_idx", b_idx, torch.int64, (n,), dev)
    _nvcc.check_tensor("flipped", flipped, torch.bool, (n,), dev)
    _on_card("K7", dev)
    i32 = dict(dtype=torch.int32, device=dev)
    a = torch.empty((2 * n, n_rows), dtype=torch.uint8, device=dev)
    b = torch.empty((2 * n, n_rows + band), dtype=torch.uint8, device=dev)
    a_len, b_len = torch.empty(2 * n, **i32), torch.empty(2 * n, **i32)
    centers = torch.empty((2 * n, n_rows // 16 + 1 if center_stride == 16 else n_rows + 1),
                          **i32)
    n_anchor, seedA, seedB, n_minor = (torch.empty(n, **i32) for _ in range(4))
    fl_out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        fn = _load().canu_verify_pre
        with torch.cuda.device(dev):
            rc = fn(words.data_ptr(), int(W), length.data_ptr(), index.mker.data_ptr(),
                    index.mpos.data_ptr(), index.mstr.data_ptr(), int(Pm), a_idx.data_ptr(),
                    b_idx.data_ptr(), flipped.data_ptr(), int(n), int(chunk), int(k), int(band),
                    int(n_rows), int(bool(orient)), int(center_stride == 16), a.data_ptr(),
                    a_len.data_ptr(),
                    b.data_ptr(), b_len.data_ptr(), centers.data_ptr(), n_anchor.data_ptr(),
                    fl_out.data_ptr(), seedA.data_ptr(), seedB.data_ptr(), n_minor.data_ptr(),
                    _stream(dev))
        _raise_on(rc, "K7")
        PRE_LAUNCHES += 1
    return (a, a_len, b, b_len, centers), n_anchor, fl_out, seedA, seedB, n_minor


def _syncmer_checks(words, k: int, pm: int):
    if words.dim() != 2:
        raise ValueError("words must be 2-D")
    if not 2 <= k <= 32 or not 1 <= pm <= MAX_PM:
        raise ValueError(f"kernel K8 takes k in 2..32 and pm >= 1 (at most {MAX_PM}), "
                         f"got {k}, {pm}")


def _syncmer_launch(words, lengths, rows, wbs, k, s, t, pm, mker, mpos, mstr, n_sel) -> None:
    global SYNCMER_LAUNCHES
    dev = words.device
    fn = _load().canu_syncmer
    with torch.cuda.device(dev):
        rc = fn(words.data_ptr(), int(words.shape[1]), lengths.data_ptr(), rows.data_ptr(),
                wbs.data_ptr(), int(rows.shape[0]), int(k), int(s), int(t), int(pm),
                mker.data_ptr(), mpos.data_ptr(), mstr.data_ptr(),
                n_sel.data_ptr() if n_sel is not None else None, _stream(dev))
    _raise_on(rc, "K8")
    SYNCMER_LAUNCHES += 1


def syncmer(words, lengths, k: int, s: int, t: int, pm: int):
    """Kernel K8 on one padded block: (mker int64[B, pm], mpos int32[B,
    pm], mstr int32[B, pm], n_sel int32[B]) of ops.minimizers
    ._syncmer_kernel for words int64[B, W] (uint32 values, 16 bases a word)
    and lengths int32[B] on the card, with the syncmer parameters (s, t) of
    k."""
    _syncmer_checks(words, k, pm)
    dev = words.device
    B, W = words.shape
    if W < 1 or 16 * W - k + 1 < 0:
        raise ValueError(f"kernel K8: {W} words a read hold no {k}-mer window")
    _nvcc.check_tensor("words", words, torch.int64, (B, W), dev)
    _nvcc.check_tensor("lengths", lengths, torch.int32, (B,), dev)
    _on_card("K8", dev)
    mker = torch.empty((B, pm), dtype=torch.int64, device=dev)
    mpos = torch.empty((B, pm), dtype=torch.int32, device=dev)
    mstr = torch.empty((B, pm), dtype=torch.int32, device=dev)
    n_sel = torch.empty(B, dtype=torch.int32, device=dev)
    if B:
        rows = torch.arange(B, dtype=torch.int32, device=dev)
        wbs = torch.full((B,), W, dtype=torch.int32, device=dev)
        _syncmer_launch(words, lengths, rows, wbs, k, s, t, pm, mker, mpos, mstr, n_sel)
    return mker, mpos, mstr, n_sel


def syncmer_index(words, lengths, rows, wbs, min_wb: int, k: int, s: int, t: int, mker, mpos,
                  mstr, n_sel=None) -> None:
    """Kernel K8 over a whole read index in one launch: read rows[i] (int32,
    a row of the word plane words int64[N, W] and lengths int32[N]) padded
    to wbs[i] <= W words (int32, its length bucket's width; min_wb the
    smallest, checked on the host) gets rows rows[i] of mker int64[N, pm],
    mpos and mstr int32[N, pm] (written in place) bit for bit as
    ``syncmer`` gives them on the block of its bucket; n_sel (int32[N], or
    None) gets their n_sel at the same rows."""
    _syncmer_checks(words, k, mker.shape[1] if mker.dim() == 2 else 0)
    dev = words.device
    N, W = words.shape
    pm = mker.shape[1]
    n = rows.shape[0] if rows.dim() == 1 else -1
    if min_wb < 1 or 16 * min_wb - k + 1 < 0:
        raise ValueError(f"kernel K8: {min_wb} words a read hold no {k}-mer window")
    _nvcc.check_tensor("words", words, torch.int64, (N, W), dev)
    _nvcc.check_tensor("lengths", lengths, torch.int32, (N,), dev)
    _nvcc.check_tensor("rows", rows, torch.int32, (n,), dev)
    _nvcc.check_tensor("wbs", wbs, torch.int32, (n,), dev)
    for name, plane, dtype in (("mker", mker, torch.int64), ("mpos", mpos, torch.int32),
                               ("mstr", mstr, torch.int32)):
        _nvcc.check_tensor(name, plane, dtype, (N, pm), dev)
    if n_sel is not None:
        _nvcc.check_tensor("n_sel", n_sel, torch.int32, (N,), dev)
    _on_card("K8", dev)
    if n:
        _syncmer_launch(words, lengths, rows, wbs, k, s, t, pm, mker, mpos, mstr, n_sel)


def pair_stats_plan(lenA, lenB, k: int) -> dict:
    """K12's plan for pairs of reads of lengths lenA, lenB (numpy): each
    pair's table slots (a power of two, K12_MIN_SLOTS..K12_SLOTS, at least
    twice A's on-read positions where K12_SLOTS allows), rounds (A's
    positions over half the table; 0 without a position in either read)
    and room in the device hit list (its possible hits, min(nA, nB), past
    the K12_HITS kept in shared memory).  csrc/verify.cu k12_plan computes
    the same slots and rounds on the card."""
    T, HS = K12_SLOTS, K12_HITS
    nA = np.maximum(np.asarray(lenA, np.int64) - k + 1, 0)
    nB = np.maximum(np.asarray(lenB, np.int64) - k + 1, 0)
    S = np.ones_like(nA)
    for _ in range(31):  # pow2 at least 2 nA
        S = np.where(S < 2 * nA, 2 * S, S)
    S = np.clip(S, K12_MIN_SLOTS, T)
    rounds = np.where((nA > 0) & (nB > 0), -(-nA // (S // 2)), 0)
    return {"slots": S, "rounds": rounds, "room": np.maximum(np.minimum(nA, nB) - HS, 0),
            "nA": nA, "nB": nB}


def _pair_stats_launch(words, lengths, a_idx, b_idx, fk, k: int, hit_off, dhits, rounds=None):
    """Launch K12 on pairs (row a_idx[q], row b_idx[q]) of the word plane,
    checked by the callers, at the K12_* plan; returns out int32[7, M]."""
    global PAIR_STATS_LAUNCHES
    dev = words.device
    M = a_idx.shape[0]
    out = torch.empty((7, M), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _load().canu_pair_stats(
            words.data_ptr(), lengths.data_ptr(), int(words.shape[1]), a_idx.data_ptr(),
            b_idx.data_ptr(), int(M), fk.data_ptr(), int(fk.shape[0]), int(k), int(K12_SLOTS),
            int(K12_HITS), hit_off.data_ptr() if hit_off is not None else None,
            dhits.data_ptr() if dhits is not None else None, out.data_ptr(),
            rounds.data_ptr() if rounds is not None else None, _stream(dev))
    _raise_on(rc, "K12")
    if M:
        PAIR_STATS_LAUNCHES += 1
    return out


def launch_rows(words, lengths, a_idx, b_idx, fk, k: int, lists, rounds=None):
    """K12 on the pairs (a_idx, b_idx) of the word plane, one launch for
    each (q0, q1, hit_off, dhits) of lists (rows_hit_lists), checked by the
    callers: int32[7, M]."""
    outs = [_pair_stats_launch(words, lengths, a_idx[q0:q1], b_idx[q0:q1], fk, k, off, dh,
                               rounds[q0:q1] if rounds is not None else None)
            for q0, q1, off, dh in lists]
    if not outs:
        return torch.empty((7, 0), dtype=torch.int32, device=words.device)
    return outs[0] if len(outs) == 1 else torch.cat(outs, 1)


def hit_list_groups(need, budget: int) -> list:
    """Consecutive pair ranges (q0, q1, room) of a call whose summed room in
    the device hit list (need int64[M], numpy: each pair's entries) stays
    within budget entries: one range where the whole call fits, and a pair
    past the budget alone in its range."""
    c = np.concatenate([[0], np.cumsum(need, dtype=np.int64)])
    out, q0 = [], 0
    while q0 < len(need):
        q1 = max(q0 + 1, int(np.searchsorted(c, c[q0] + budget, side="right")) - 1)
        out.append((q0, q1, int(c[q1] - c[q0])))
        q0 = q1
    return out


def _hit_lists(need, groups) -> list:
    """(q0, q1, hit_off, dhits) for each group of hit_list_groups: the
    pairs' offsets in the group's list (need int64[M] on the card), or
    None where no pair of the group has any room."""
    out = []
    for q0, q1, room in groups:
        if not room:
            out.append((q0, q1, None, None))
            continue
        n = need[q0:q1]
        out.append((q0, q1, torch.cumsum(n, 0) - n,
                    torch.empty((room, 2), dtype=torch.int32, device=need.device)))
    return out


def _check_pair_inputs(k: int, W: int, fk, dev) -> None:
    if not 2 <= k <= 32:
        raise ValueError(f"kernel K12 takes k in 2..32, got {k}")
    if W < 1 or 16 * W - k + 1 < 1:
        raise ValueError(f"kernel K12: {W} words a read hold no {k}-mer window")
    if fk.dim() != 1 or fk.shape[0] < 1:
        raise ValueError("fk must be a 1-D table of at least one k-mer")
    _nvcc.check_tensor("fk", fk, torch.int64, (fk.shape[0],), dev)


def pair_stats(wordsA, lenA, wordsB, lenB, fk, k: int, rounds=None):
    """Kernel K12 on a chunk: (flipped bool[C], the second median,
    n_inliers, a_lo, a_hi, b_lo, b_hi int32[C]) of
    ops.minhash._pair_stats_kernel for the chunk's pairs (wordsA/wordsB
    int64[C, W] of uint32 values, lenA/lenB int32[C]; fk int64[F >= 1], the
    sorted frequent k-mers) on the card: the two blocks stacked into one
    plane, pair i its row i against its row C + i, in one launch (more
    where the chunk's hit list would pass K12_HIT_LIST).  Each pair's room
    in the device hit list is sized from W (no fetch).  rounds (int32[C],
    optional) gets each pair's rounds."""
    if wordsA.dim() != 2:
        raise ValueError("wordsA must be 2-D")
    dev = wordsA.device
    C, W = wordsA.shape
    _check_pair_inputs(k, W, fk, dev)
    _nvcc.check_tensor("wordsA", wordsA, torch.int64, (C, W), dev)
    _nvcc.check_tensor("wordsB", wordsB, torch.int64, (C, W), dev)
    _nvcc.check_tensor("lenA", lenA, torch.int32, (C,), dev)
    _nvcc.check_tensor("lenB", lenB, torch.int32, (C,), dev)
    if rounds is not None:
        _nvcc.check_tensor("rounds", rounds, torch.int32, (C,), dev)
    _on_card("K12", dev)
    room = max(0, 16 * W - k + 1 - K12_HITS)  # a pair's possible hits past the shared list
    idx = torch.arange(C, dtype=torch.int32, device=dev)
    need = torch.full((C,), room, dtype=torch.int64, device=dev)
    lists = _hit_lists(need, hit_list_groups(np.full(C, room, np.int64), K12_HIT_LIST))
    out = launch_rows(torch.cat([wordsA, wordsB]), torch.cat([lenA, lenB]), idx, idx + C, fk, k,
                      lists, rounds)
    return (out[0] != 0, *out[1:].unbind(0))


def pair_stats_rows(words, lengths, a_idx, b_idx, fk, k: int, rounds=None):
    """Kernel K12 on a whole call: int32[7, M] (flipped, the second median,
    n_inliers, a_lo, a_hi, b_lo, b_hi) of ops.minhash._pair_stats_kernel
    for the pairs (row a_idx[q], row b_idx[q]) (int32[M]) of the word plane
    words int64[N, W] (uint32 values) with lengths int32[N], on the card in
    one launch, each read at its own length (in launches of consecutive
    pairs where their device hit list would pass K12_HIT_LIST).  One fetch
    checks the rows and sizes the hit list (rows_hit_lists).  rounds as for
    pair_stats."""
    if words.dim() != 2 or a_idx.dim() != 1:
        raise ValueError("words must be 2-D and a_idx 1-D")
    dev = words.device
    N, W = words.shape
    M = a_idx.shape[0]
    _check_pair_inputs(k, W, fk, dev)
    _nvcc.check_tensor("lengths", lengths, torch.int32, (N,), dev)
    _nvcc.check_tensor("a_idx", a_idx, torch.int32, (M,), dev)
    _nvcc.check_tensor("b_idx", b_idx, torch.int32, (M,), dev)
    if rounds is not None:
        _nvcc.check_tensor("rounds", rounds, torch.int32, (M,), dev)
    if M == 0:
        _on_card("K12", dev)
        return torch.empty((7, 0), dtype=torch.int32, device=dev)
    lists = rows_hit_lists(lengths, a_idx, b_idx, k)
    _on_card("K12", dev)
    return launch_rows(words, lengths, a_idx, b_idx, fk, k, lists, rounds)


def rows_hit_lists(lengths, a_idx, b_idx, k: int) -> list:
    """A call's launches as (q0, q1, hit_off, dhits) (launch_rows): each
    pair's room past the K12_HITS kept in shared memory, min(nA, nB) -
    K12_HITS where positive, packed in pair order, the pairs split where
    their summed room passes K12_HIT_LIST (hit_list_groups), after one
    fetch that also checks every row lies in the plane (a second, of each
    pair's room, only where the call is split)."""
    N = lengths.shape[0]
    ab = torch.stack([a_idx, b_idx]).to(torch.int64)
    n = torch.clamp(lengths.to(torch.int64)[ab.clamp(0, N - 1)] - k + 1, min=0)
    need = torch.clamp(torch.minimum(n[0], n[1]) - K12_HITS, min=0)
    lo, hi, total = torch.stack([ab.min(), ab.max(), need.sum()]).tolist()
    if lo < 0 or hi >= N:
        raise ValueError(f"kernel K12: pair rows {lo}..{hi} outside the plane's {N} rows")
    M = a_idx.shape[0]
    groups = ([(0, M, total)] if total <= K12_HIT_LIST
              else hit_list_groups(need.cpu().numpy(), K12_HIT_LIST))
    return _hit_lists(need, groups)


def pair_stats_resources() -> dict:
    """What the card gives K12 at the K12_* plan: resident blocks an SM,
    registers a thread, dynamic and static shared bytes a block, threads a
    block (the library's K12_NT)."""
    out = (ctypes.c_int * 5)()
    _raise_on(_load().canu_pair_stats_resources(K12_SLOTS, K12_HITS, out), "K12 resources")
    return dict(zip(("blocks_per_sm", "registers", "dynamic_smem", "static_smem", "threads"),
                    out[:5]))


def resources(Pm: int, pm: int) -> dict:
    """What the card gives K7 at index rows of Pm entries and K8 at pm:
    resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers a thread, dynamic and static shared bytes a block."""
    out = (ctypes.c_int * 8)()
    _raise_on(_load().canu_verify_resources(int(Pm), int(pm), out), "K7/K8 resources")
    keys = ("blocks_per_sm", "registers", "dynamic_smem", "static_smem")
    return {"K7": dict(zip(keys, out[:4])), "K8": dict(zip(keys, out[4:]))}
