"""Kernel K4 on Hopper: build, bind and launch csrc/vote_dp.cu.

K4 (``vote_dp_keys``) is the vote engine's banded forward + backward DP,
two warps a job: the forward warp runs up from row 0 and the backward
warp down from row t_len at the same time, each storing the rows up to
their meeting point in scratch allocated here (uint8 forward rows with
their int32 minima, int16 backward rows), then folding the combine into
the other half.  It returns each row's least combine key;
ops.trace.align_positions_lean computes the anchors before it and the
positions and edits after it, and launches it on CUDA tensors, one launch
for every job it is given (the vote engine hands it a group of chunks),
the blocks longest job first (``job_order``).
Held against ops.trace.align_positions_lean_plain.  The library is built
by ops/kernels/_nvcc.py and loaded with ctypes; nothing here falls back
to the plain version: a failed build, a tensor, band or row count the
kernel does not take, or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "vote_dp.cu"
SROW = 32  # rows a super-row (ops.trace.SROW)
MAX_BAND = 256  # the uint8 normalization of the forward rows

# launches and the jobs they took since the last reset (read by chip_smoke.py)
LAUNCHES = JOBS_LAUNCHED = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.canu_vote_dp.argtypes = [p, i, p, p, i, p, p, p, i, i, i, i, i, i, p, p, p, p, p]
        lib.canu_vote_dp.restype = ctypes.c_int
        _lib = lib
    return _lib


def row_lanes(band: int) -> int:
    """Lanes of a stored forward row: the window band + 128 padded to 32
    lanes of 8 or 12 cells (csrc/vote_dp.cu canu_vote_dp_row_lanes)."""
    return 256 if band + 4 * SROW <= 256 else 384


def half_rows(n_rows: int) -> int:
    """The most rows either warp of a job stores before the two meet, over
    every t_len: 32 * ceil(n_rows / 64) (csrc/vote_dp.cu
    canu_vote_dp_half_rows; the meeting row is 32 * round(t_len / 64))."""
    return SROW * ((n_rows // SROW + 1) // 2)


def scratch_bytes(B: int, band: int, n_rows: int) -> int:
    """Device bytes vote_dp_keys allocates for B jobs: H + 1 uint8 forward
    rows with their int32 minima, H int16 backward rows (H =
    half_rows(n_rows)) and the int32 keys of n_rows + 1 rows."""
    W, H = row_lanes(band), half_rows(n_rows)
    return B * ((H + 1) * (W + 4) + H * 2 * W + 4 * (n_rows + 1))


def job_order(t_len: torch.Tensor, n_rows: int) -> torch.Tensor:
    """int32[B]: the jobs by their rows (t_len clamped to 0..n_rows),
    longest first and in order among equals; block i of a launch runs job
    order[i], so the jobs that take longest start first and the short ones
    fill the card's slots at the end."""
    rows = torch.clamp(t_len, 0, n_rows)
    return torch.argsort(rows, descending=True, stable=True).to(torch.int32)


def group_jobs(band: int, n_rows: int, budget_bytes: int) -> int:
    """Jobs one launch may take for its scratch to fit budget_bytes; raises
    when not even one job fits."""
    n = budget_bytes // scratch_bytes(1, band, n_rows)
    if n < 1:
        raise ValueError(f"kernel K4's scratch for one job at band {band} and {n_rows} rows "
                         f"({scratch_bytes(1, band, n_rows)} bytes) exceeds the budget of "
                         f"{budget_bytes} bytes")
    return n


def vote_dp_keys(t, t_len, e, e_len, anchors, band: int, n_rows: int, ends_free: bool):
    """Kernel K4: int32[B, n_rows+1], each row's least key tot * Ww + x of
    ops.trace.align_positions_lean_plain's combine, for t uint8[B, LT]
    (LT >= n_rows), t_len int32[B], e uint8[B, LE], e_len int32[B] and
    anchors int32[B, n_rows // 32] (ops.trace._anchors) on the card; band
    1..256, n_rows a positive multiple of 32."""
    global LAUNCHES, JOBS_LAUNCHED
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"kernel K4 takes bands 1..{MAX_BAND}, got {band}")
    if n_rows < SROW or n_rows % SROW:
        raise ValueError(f"kernel K4 takes n_rows a positive multiple of {SROW}, got {n_rows}")
    if t.dim() != 2 or e.dim() != 2:
        raise ValueError("t and e must be 2-D")
    dev = t.device
    B = t.shape[0]
    if t.shape[1] < n_rows:
        raise ValueError(f"t has {t.shape[1]} columns, need n_rows = {n_rows}")
    _nvcc.check_tensor("t", t, torch.uint8, (B, t.shape[1]), dev)
    _nvcc.check_tensor("t_len", t_len, torch.int32, (B,), dev)
    _nvcc.check_tensor("e", e, torch.uint8, (B, e.shape[1]), dev)
    _nvcc.check_tensor("e_len", e_len, torch.int32, (B,), dev)
    _nvcc.check_tensor("anchors", anchors, torch.int32, (B, n_rows // SROW), dev)
    if dev.type != "cuda":
        raise ValueError(f"kernel K4 needs CUDA tensors, got {dev}")
    W, H = row_lanes(band), half_rows(n_rows)
    K = torch.empty((B, n_rows + 1), dtype=torch.int32, device=dev)
    if B == 0:
        return K
    Fu = torch.empty((B, H + 1, W), dtype=torch.uint8, device=dev)
    Fm = torch.empty((B, H + 1), dtype=torch.int32, device=dev)
    Gs = torch.empty((B, H, W), dtype=torch.int16, device=dev)
    order = job_order(t_len, n_rows)
    fn = _load().canu_vote_dp
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(t.data_ptr(), int(t.shape[1]), t_len.data_ptr(), e.data_ptr(), int(e.shape[1]),
                e_len.data_ptr(), anchors.data_ptr(), order.data_ptr(), int(B), int(band),
                int(n_rows), int(bool(ends_free)), int(W), int(H), Fu.data_ptr(), Fm.data_ptr(),
                Gs.data_ptr(), K.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kernel K4 launch failed: "
                           f"{f'refused its arguments ({rc})' if rc < 0 else f'cudaError {rc}'}")
    LAUNCHES += 1
    JOBS_LAUNCHED += B
    return K
