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

K12 (``pair_stats``) is stage C's pair statistics for a chunk of read
pairs in one launch, one block of 256 threads a pair: the join of the two
reads' canonical k-mers through a hash table in a device scratch sized
here, the strand vote, the two lower medians by radix selects, the
inliers and their spans.  ops.minhash.place_candidates launches it on CUDA
tensors; it is held against ops.minhash._pair_stats_kernel.

The library is built by ops/kernels/_nvcc.py and loaded with ctypes;
nothing here falls back to the plain versions: a failed build, a tensor
the kernels do not take, or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "verify.cu"

# launches since the last reset (read by chip_smoke.py): K7, K8, K12
PRE_LAUNCHES = SYNCMER_LAUNCHES = PAIR_STATS_LAUNCHES = 0

# device bytes K12's scratch may take (a hash table and a hit list a
# block); a chunk of longer reads gets fewer blocks, each striding over
# the chunk's pairs
PAIR_STATS_SCRATCH = 1 << 30

# K7 keeps each hit's two slots in 11 bits each; K8 holds pm (key,
# position) pairs in shared memory
MAX_PM = 2048

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.canu_verify_pre.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, i, i, i, i,
                                        p, p, p, p, p, p, p, p, p, p, p]
        lib.canu_syncmer.argtypes = [p, i, p, p, p, i, i, i, i, i, p, p, p, p, p]
        lib.canu_verify_resources.argtypes = [i, i, p]
        lib.canu_pair_stats.argtypes = [p, p, p, p, i, i, p, i, i, i, i, i, p, p, p, p, p, p]
        for fn in (lib.canu_verify_pre, lib.canu_syncmer, lib.canu_verify_resources,
                   lib.canu_pair_stats):
            fn.restype = ctypes.c_int
        _lib = lib
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


def pair_stats_scratch(W: int, k: int, C: int) -> tuple[int, int, int]:
    """(blocks, table slots a block, hits a block) of K12's scratch for a
    chunk of C pairs padded to W words: a table of pow2(4 P) slots (load
    at most one half) and P hits a block, as many blocks as
    PAIR_STATS_SCRATCH holds, 1 to C."""
    P = 16 * W - k + 1
    S = 1 << max(0, (4 * P - 1).bit_length())
    per_block = 12 * S + 8 * P
    return max(1, min(C, PAIR_STATS_SCRATCH // per_block)), S, P


def pair_stats(wordsA, lenA, wordsB, lenB, fk, k: int):
    """Kernel K12: (flipped bool[C], the second median, n_inliers, a_lo,
    a_hi, b_lo, b_hi int32[C]) of ops.minhash._pair_stats_kernel for the
    chunk's pairs (wordsA/wordsB int64[C, W] of uint32 values, lenA/lenB
    int32[C]; fk int64[F >= 1], the sorted frequent k-mers) on the card, in
    one launch."""
    global PAIR_STATS_LAUNCHES
    if wordsA.dim() != 2:
        raise ValueError("wordsA must be 2-D")
    dev = wordsA.device
    C, W = wordsA.shape
    if not 2 <= k <= 32:
        raise ValueError(f"kernel K12 takes k in 2..32, got {k}")
    if W < 1 or 16 * W - k + 1 < 1:
        raise ValueError(f"kernel K12: {W} words a read hold no {k}-mer window")
    _nvcc.check_tensor("wordsA", wordsA, torch.int64, (C, W), dev)
    _nvcc.check_tensor("wordsB", wordsB, torch.int64, (C, W), dev)
    _nvcc.check_tensor("lenA", lenA, torch.int32, (C,), dev)
    _nvcc.check_tensor("lenB", lenB, torch.int32, (C,), dev)
    if fk.dim() != 1 or fk.shape[0] < 1:
        raise ValueError("fk must be a 1-D table of at least one k-mer")
    _nvcc.check_tensor("fk", fk, torch.int64, (fk.shape[0],), dev)
    _on_card("K12", dev)
    out = torch.empty((7, C), dtype=torch.int32, device=dev)
    if C:
        blocks, S, H = pair_stats_scratch(W, k, C)
        keys = torch.empty((blocks, S), dtype=torch.int32, device=dev)
        sides = torch.empty((2, blocks, S), dtype=torch.int32, device=dev)
        hits = torch.empty((blocks, H, 2), dtype=torch.int32, device=dev)
        fn = _load().canu_pair_stats
        with torch.cuda.device(dev):
            rc = fn(wordsA.data_ptr(), lenA.data_ptr(), wordsB.data_ptr(), lenB.data_ptr(),
                    int(W), int(C), fk.data_ptr(), int(fk.shape[0]), int(k), int(blocks),
                    int(S), int(H), keys.data_ptr(), sides[0].data_ptr(), sides[1].data_ptr(),
                    hits.data_ptr(), out.data_ptr(), _stream(dev))
        _raise_on(rc, "K12")
        PAIR_STATS_LAUNCHES += 1
    return (out[0] != 0, *out[1:].unbind(0))


def resources(Pm: int, pm: int) -> dict:
    """What the card gives K7 at index rows of Pm entries and K8 at pm:
    resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers a thread, dynamic and static shared bytes a block."""
    out = (ctypes.c_int * 8)()
    _raise_on(_load().canu_verify_resources(int(Pm), int(pm), out), "K7/K8 resources")
    keys = ("blocks_per_sm", "registers", "dynamic_smem", "static_smem")
    return {"K7": dict(zip(keys, out[:4])), "K8": dict(zip(keys, out[4:]))}
