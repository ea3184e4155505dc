"""Kernel K9 on Hopper: build, bind and launch csrc/vote_fold.cu.

K9 (``vote_fold``) is the vote engine's fold of a whole DP group of chunks
in one launch, a block of 256 threads a job: each job's deletion counts at
the template's run starts, its rows' packed codes, and their channels
added by atomicAdd into the block's float32 votes in place.
ops.votepile.pile_votes launches it on CUDA tensors once a group; it is
held against ops.votepile._fold_chunk, chunk after chunk.

The atomics add in any order, which is exact only while every term is a
multiple of 2^-7 and every column's sum stays below 2^17 (the .cu's
header): ``vote_fold`` checks the group's weights on the host copy of its
columns and raises before a launch that would break it.  The library is
built by ops/kernels/_nvcc.py and loaded with ctypes; nothing here falls
back to the plain version: a failed build, weights outside that range, a
tensor or row count the kernel does not take, or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "vote_fold.cu"
MAX_ROWS = 32768  # csrc/vote_fold.cu MAX_ROWS: a shared byte a row, within 48 KB
EXACT_SUM = float(1 << 17)  # a column's sums stay below it: float32 adds them exactly
WEIGHT_STEP = 2.0 ** -7  # every rounded weight a multiple of it
N_CH = 15
COL_SLOT, COL_WEIGHT = 7, 8

# launches since the last reset (read by chip_smoke.py)
LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.canu_vote_fold.argtypes = [p, i, i, p, p, p, i, p, i, i, i, p]
        lib.canu_vote_fold.restype = ctypes.c_int
        _lib = lib
    return _lib


def rounded_weights(bits: np.ndarray) -> np.ndarray:
    """float32 weights, from their int32 bits, rounded to bfloat16 as the
    fold rounds them (torch's cast: round to nearest even)."""
    w = torch.from_numpy(np.ascontiguousarray(bits, np.int32)).view(torch.float32)
    return w.to(torch.bfloat16).to(torch.float32).numpy()


def add_load(host_cols: np.ndarray, load: np.ndarray) -> None:
    """Add a group's jobs to load float64[G], the bound on each slot's
    column sums so far (15 x its summed rounded weights: a job adds at most
    15 w to a column), and raise unless the fold stays exact: every rounded
    weight finite, >= 0 and a multiple of 2^-7, every slot's bound below
    2^17.  A job whose slot lies off the block adds nothing and is not
    counted.  host_cols is the group's int32[9, n] columns on the host."""
    w = rounded_weights(host_cols[COL_WEIGHT]).astype(np.float64)
    bad = ~np.isfinite(w) | (w < 0) | (w / WEIGHT_STEP != np.floor(w / WEIGHT_STEP))
    if bad.any():
        raise ValueError(f"kernel K9 adds in any order, exact only for weights that round to "
                         f"non-negative multiples of 2^-7 in bfloat16; got "
                         f"{host_cols[COL_WEIGHT].view(np.float32)[bad][:4].tolist()}")
    slot = host_cols[COL_SLOT].astype(np.int64)
    on = (slot >= 0) & (slot < len(load))
    new = load.copy()
    np.add.at(new, slot[on], 15.0 * w[on])
    if (new >= EXACT_SUM).any():
        s = int(np.argmax(new))
        raise ValueError(f"kernel K9 adds in any order, exact only while a column's sum stays "
                         f"below 2^17; slot {s}'s jobs may reach {new[s]}")
    load[:] = new


def vote_fold(votes, js, t_sub, e_sub, cols, n_rows: int, t_mask: int, host_cols: np.ndarray,
              load: np.ndarray) -> None:
    """Kernel K9: add the fold of n jobs (ops.votepile._fold_chunk's votes,
    every chunk of them) into votes f32[G, 15, Lt] in place, for js
    int32[n, n_rows + 1], t_sub uint8[n, n_rows], e_sub uint8[n, W_e] and
    cols int32[9, n] (ops.votepile's job columns) on the card; t_mask the
    mask of the template shift (2^log_rounds(Lt) - 1); host_cols the same
    columns on the host and load the block's slot bounds (add_load), which
    are checked first."""
    global LAUNCHES
    if not 1 <= n_rows <= MAX_ROWS:
        raise ValueError(f"kernel K9 takes 1..{MAX_ROWS} rows, got {n_rows}")
    if votes.dim() != 3 or votes.shape[1] != N_CH:
        raise ValueError(f"votes must be [G, {N_CH}, Lt], got {tuple(votes.shape)}")
    if js.dim() != 2 or e_sub.dim() != 2:
        raise ValueError("js and e_sub must be 2-D")
    n, W_e = js.shape[0], e_sub.shape[1]
    G, Lt = votes.shape[0], votes.shape[2]
    if host_cols.shape != (9, n) or host_cols.dtype != np.int32:
        raise ValueError(f"host_cols must be int32[9, {n}], got {host_cols.dtype}"
                         f"{host_cols.shape}")
    if load.shape != (G,):
        raise ValueError(f"load must hold the block's {G} slots, got {load.shape}")
    if W_e < 1 or t_mask < 0:
        raise ValueError(f"kernel K9 needs W_e >= 1 and t_mask >= 0, got {W_e}, {t_mask}")
    dev = votes.device
    _nvcc.check_tensor("votes", votes, torch.float32, (G, N_CH, Lt), dev)
    _nvcc.check_tensor("js", js, torch.int32, (n, n_rows + 1), dev)
    _nvcc.check_tensor("t_sub", t_sub, torch.uint8, (n, n_rows), dev)
    _nvcc.check_tensor("e_sub", e_sub, torch.uint8, (n, W_e), dev)
    _nvcc.check_tensor("cols", cols, torch.int32, (9, n), dev)
    add_load(host_cols, load)
    if dev.type != "cuda":
        raise ValueError(f"kernel K9 needs CUDA tensors, got {dev}")
    if n == 0:
        return
    fn = _load().canu_vote_fold
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(votes.data_ptr(), int(G), int(Lt), js.data_ptr(), t_sub.data_ptr(),
                e_sub.data_ptr(), int(W_e), cols.data_ptr(), int(n), int(n_rows), int(t_mask),
                stream)
    if rc != 0:
        raise RuntimeError(f"kernel K9 launch failed: "
                           f"{f'refused its arguments ({rc})' if rc < 0 else f'cudaError {rc}'}")
    LAUNCHES += 1
