"""Kernels K7 and K8 on Hopper: build, bind and launch csrc/verify.cu.

K7 (``verify_pre``) is verify's anchor-and-inputs step for a group of
chunks in one launch, one block of 256 threads a pair: the syncmer join
of the pair's two index rows, the strand vote, the median diagonal and
its inliers, the running-max chain and the MAX_ANCHORS picks, the seed,
the interpolated band centres and the four shifted, oriented base rows,
written straight into the group's wide extension inputs (chunk g's
forward rows, then its backward rows, then chunk g + 1's).
ops.align._verify_pre launches it on CUDA tensors; it is held against
ops.align._verify_pre_plain.

K8 (``syncmer``) is the open-syncmer selection and compaction of a padded
read block, one block of 256 threads a read, its selected positions
sorted in a device scratch row of the read.  ops.minimizers
._syncmer_kernel launches it on CUDA tensors; it is held against
ops.minimizers._syncmer_kernel_plain.

The library is built by ops/kernels/_nvcc.py and loaded with ctypes;
nothing here falls back to the plain versions: a failed build, a tensor
the kernels do not take, or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "verify.cu"

# launches since the last reset (read by chip_smoke.py): K7, K8
PRE_LAUNCHES = SYNCMER_LAUNCHES = 0

# K7 keeps a hit's join position and slot in 24 bits of its sort key
MAX_PM = 2048

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.canu_verify_pre.argtypes = [p, i, p, p, p, p, i, p, p, p, i, i, i, i, i, i,
                                        p, p, p, p, p, p, p, p, p, p, p]
        lib.canu_syncmer.argtypes = [p, i, i, p, i, i, i, i, p, i, p, p, p, p, p]
        for fn in (lib.canu_verify_pre, lib.canu_syncmer):
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
               chunk: int):
    """Kernel K7: (ext_in, n_anchor, flipped, seedA, seedB, n_minor) of
    ops.align._verify_pre for the pairs (a_idx[q], b_idx[q]) (int64 rows of
    the ReadIndex `index`, flipped bool, all [G * chunk]) on the card:
    ext_in = (a uint8[2 G chunk, n_rows], a_len int32, b uint8[2 G chunk,
    n_rows + band], b_len int32, centers int32[2 G chunk, n_rows + 1]) with
    chunk g's forward rows at 2 g chunk + p and its backward rows at 2 g
    chunk + chunk + p; the per-pair outputs int32[G chunk] (flipped
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
    centers = torch.empty((2 * n, n_rows + 1), **i32)
    n_anchor, seedA, seedB, n_minor = (torch.empty(n, **i32) for _ in range(4))
    fl_out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        fn = _load().canu_verify_pre
        with torch.cuda.device(dev):
            rc = fn(words.data_ptr(), int(W), length.data_ptr(), index.mker.data_ptr(),
                    index.mpos.data_ptr(), index.mstr.data_ptr(), int(Pm), a_idx.data_ptr(),
                    b_idx.data_ptr(), flipped.data_ptr(), int(n), int(chunk), int(k), int(band),
                    int(n_rows), int(bool(orient)), a.data_ptr(), a_len.data_ptr(),
                    b.data_ptr(), b_len.data_ptr(), centers.data_ptr(), n_anchor.data_ptr(),
                    fl_out.data_ptr(), seedA.data_ptr(), seedB.data_ptr(), n_minor.data_ptr(),
                    _stream(dev))
        _raise_on(rc, "K7")
        PRE_LAUNCHES += 1
    return (a, a_len, b, b_len, centers), n_anchor, fl_out, seedA, seedB, n_minor


def syncmer(words, lengths, k: int, s: int, t: int, pm: int):
    """Kernel K8: (mker int64[B, pm], mpos int32[B, pm], mstr int32[B, pm],
    n_sel int32[B]) of ops.minimizers._syncmer_kernel for words int64[B, W]
    (uint32 values, 16 bases a word) and lengths int32[B] on the card, with
    the syncmer parameters (s, t) of k."""
    global SYNCMER_LAUNCHES
    if words.dim() != 2:
        raise ValueError("words must be 2-D")
    if not 2 <= k <= 32 or pm < 1:
        raise ValueError(f"kernel K8 takes k in 2..32 and pm >= 1, got {k}, {pm}")
    dev = words.device
    B, W = words.shape
    Pk = 16 * W - k + 1
    if W < 1 or Pk < 0:
        raise ValueError(f"kernel K8: {W} words a read hold no {k}-mer window")
    _nvcc.check_tensor("words", words, torch.int64, (B, W), dev)
    _nvcc.check_tensor("lengths", lengths, torch.int32, (B,), dev)
    _on_card("K8", dev)
    mker = torch.empty((B, pm), dtype=torch.int64, device=dev)
    mpos = torch.empty((B, pm), dtype=torch.int32, device=dev)
    mstr = torch.empty((B, pm), dtype=torch.int32, device=dev)
    n_sel = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return mker, mpos, mstr, n_sel
    cap = 1 << max(0, (max(Pk, 1) - 1).bit_length())
    scratch = torch.empty((B, cap), dtype=torch.int64, device=dev)
    fn = _load().canu_syncmer
    with torch.cuda.device(dev):
        rc = fn(words.data_ptr(), int(B), int(W), lengths.data_ptr(), int(k), int(s), int(t),
                int(pm), scratch.data_ptr(), int(cap),
                mker.data_ptr(), mpos.data_ptr(), mstr.data_ptr(), n_sel.data_ptr(),
                _stream(dev))
    _raise_on(rc, "K8")
    SYNCMER_LAUNCHES += 1
    return mker, mpos, mstr, n_sel
