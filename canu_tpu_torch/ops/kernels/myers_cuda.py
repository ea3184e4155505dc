"""Kernel K1 on Hopper: build, bind and launch csrc/myers_tile.cu.

The CUDA source is compiled with nvcc for sm_90a into a shared library
with a plain C interface at first use (ops/kernels/_nvcc.py, into
canu_tpu_torch/_build/), and loaded with ctypes.  Nothing here falls
back to the plain PyTorch loop: a failed build, a tensor the kernel does
not take, or a refused launch raises.  The plain version is
ops.myers._myers_segment.
"""

from __future__ import annotations

import ctypes

import torch

from ..myers import NC
from . import _nvcc

SOURCE = _nvcc.CSRC / "myers_tile.cu"

WINDOW = 16  # bytes of a row the kernel loads at once (one uint4)

# launches of the kernel since the last reset (read by chip_smoke.py)
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        fn = lib.canu_myers_rows
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, i, p, p, i, i, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _row_aligned(name: str, t: torch.Tensor) -> torch.Tensor:
    """t uint8[B, L] with its row stride padded to a multiple of WINDOW (a
    copy only when L is not one), on a WINDOW-aligned address, or raise:
    the kernel loads WINDOW bytes of a row with one instruction."""
    if t.shape[1] % WINDOW:
        t = torch.nn.functional.pad(t, (0, WINDOW - t.shape[1] % WINDOW))
    if t.data_ptr() % WINDOW:
        raise ValueError(f"{name} must start on a {WINDOW}-byte boundary")
    return t


def myers_rows_cuda(planes: torch.Tensor, a: torch.Tensor, s_bits: torch.Tensor,
                    b: torch.Tensor, a_len: torch.Tensor, b_len: torch.Tensor, n_run: int,
                    cap_q: int) -> torch.Tensor:
    """Run rows 1..n_run of every extension in one launch.

    planes int32[43, B] carry (uint32 bit patterns, ops.myers._carry_pack
    order); a uint8[B, >= n_run] (row i reads a[:, i-1]); s_bits
    int32[ceil(n_run/32), B] the band shifts, one bit a row
    (ops.myers._shift_bits); b uint8[B, LB]; a_len/b_len int32[B].  The
    entering B char of a shifted row is b[x, clamp(o + 127, 0, LB - 1)],
    o the carried window start.  One thread per extension, in blocks of
    32.  Returns the final carry int32[43, B].
    """
    global LAUNCHES
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"myers_rows_cuda needs CUDA tensors, got {dev}")
    B = planes.shape[1]
    _nvcc.check_tensor("planes", planes, torch.int32, (NC, B), dev)
    _nvcc.check_tensor("a", a, torch.uint8, (B, a.shape[1]), dev)
    _nvcc.check_tensor("s_bits", s_bits, torch.int32, (-(-n_run // 32), B), dev)
    _nvcc.check_tensor("b", b, torch.uint8, (B, b.shape[1]), dev)
    _nvcc.check_tensor("a_len", a_len, torch.int32, (B,), dev)
    _nvcc.check_tensor("b_len", b_len, torch.int32, (B,), dev)
    if a.shape[1] < n_run:
        raise ValueError(f"a has {a.shape[1]} columns, the rows need {n_run}")
    if b.shape[1] < 1:
        raise ValueError("b must have at least one column")
    LB = int(b.shape[1])
    a, b = _row_aligned("a", a), _row_aligned("b", b)
    out = torch.empty_like(planes)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.canu_myers_rows(
            planes.data_ptr(), out.data_ptr(), a.data_ptr(), int(a.shape[1]),
            s_bits.data_ptr(), b.data_ptr(), int(b.shape[1]), LB, a_len.data_ptr(),
            b_len.data_ptr(), int(B), int(n_run), int(cap_q), stream)
    if rc != 0:
        raise RuntimeError(f"myers_rows_kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
