"""Kernels K2 and K3 on Hopper: build, bind and launch csrc/banded_extend.cu.

K2 (``banded_extend_warp``, one warp per extension) is what
ops.align.banded_extend launches on CUDA tensors at bands up to 512; K3
(``banded_extend_block``, one block per extension, one thread per cell)
computes the same function and carries the bands from 640 to 1024, which
K2 cannot hold in registers.  Both are held against
ops.align.banded_extend_plain.  The library is built by ops/kernels/
_nvcc.py and loaded with ctypes; nothing here falls back to the plain
loop: a failed build, a tensor or band the kernel does not take, or a
refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "banded_extend.cu"
WARP_BANDS = (128, 256, 384, 512)  # K2 holds band/32 cells per lane in registers
BLOCK_MAX_BAND = 1024  # K3: one thread per cell

# launches of each kernel since the last reset (read by chip_smoke.py)
WARP_LAUNCHES = 0
BLOCK_LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i = ctypes.c_int
        for fn in (lib.canu_extend_warp, lib.canu_extend_block):
            fn.argtypes = [p, i, p, p, i, p, p, i, i, i, i, p, p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(name: str, a, a_len, b, b_len, centers, band: int, n_rows: int):
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    B = a.shape[0]
    _nvcc.check_tensor("a", a, torch.uint8, (B, a.shape[1]), dev)
    _nvcc.check_tensor("a_len", a_len, torch.int32, (B,), dev)
    _nvcc.check_tensor("b", b, torch.uint8, (B, b.shape[1]), dev)
    _nvcc.check_tensor("b_len", b_len, torch.int32, (B,), dev)
    _nvcc.check_tensor("centers", centers, torch.int32, (B, centers.shape[1]), dev)
    if a.shape[1] < 1 or b.shape[1] < 1:
        raise ValueError("a and b must have at least one column")
    if n_rows < 0 or centers.shape[1] < n_rows + 1:
        raise ValueError(f"centers has {centers.shape[1]} columns, need n_rows+1 = {n_rows + 1}")
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    fn = getattr(_load(), name)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(a.data_ptr(), int(a.shape[1]), a_len.data_ptr(), b.data_ptr(),
                int(b.shape[1]), b_len.data_ptr(), centers.data_ptr(), int(centers.shape[1]),
                int(B), int(band), int(n_rows), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {'unsupported band' if rc < 0 else f'cudaError {rc}'}")
    return out[0], out[1], out[2]


def banded_extend_warp(a, a_len, b, b_len, centers, band: int, n_rows: int):
    """Kernel K2: ops.align.banded_extend_plain's (edits, a_used, b_used)
    for a uint8[B, LA], a_len int32[B], b uint8[B, LB], b_len int32[B],
    centers int32[B, >= n_rows+1] on the card; band in WARP_BANDS."""
    global WARP_LAUNCHES
    if band not in WARP_BANDS:
        raise ValueError(f"kernel K2 holds bands {WARP_BANDS} in registers, got {band}")
    res = _launch("canu_extend_warp", a, a_len, b, b_len, centers, band, n_rows)
    WARP_LAUNCHES += 1
    return res


def banded_extend_block(a, a_len, b, b_len, centers, band: int, n_rows: int):
    """Kernel K3: the same function as banded_extend_warp, one block per
    extension; band a multiple of 128 up to BLOCK_MAX_BAND."""
    global BLOCK_LAUNCHES
    if band % 128 or not 128 <= band <= BLOCK_MAX_BAND:
        raise ValueError(f"kernel K3 takes bands 128..{BLOCK_MAX_BAND} in steps of 128, got {band}")
    res = _launch("canu_extend_block", a, a_len, b, b_len, centers, band, n_rows)
    BLOCK_LAUNCHES += 1
    return res
