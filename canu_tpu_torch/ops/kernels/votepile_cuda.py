"""Kernel K9 on Hopper: build, bind and launch csrc/vote_fold.cu.

K9 (``vote_fold``) is the vote engine's fold of a whole DP group of chunks
in one launch: a block of 8 warps owns one slot's tile of 64 template
columns, its warps take the group's jobs of that slot in turn
(``slot_order``, built here from the host copy of the group's columns and
uploaded with them), read each job's rows that land on the tile once,
find the deletion counts at the template's run starts by warp ballots and
add the channels up in shared memory; the block then adds its tile into
the block's float32 votes in place, with no atomics in device memory.
ops.votepile.pile_votes launches it on CUDA tensors once a group; it is
held against ops.votepile._fold_chunk, chunk after chunk.

The kernel sums each column in another order than the plain version,
which is exact only while every term is a multiple of 2^-7 and every
column's sum stays below 2^17 (the .cu's header): ``vote_fold`` checks the
group's weights on the host copy of its columns and raises before a launch
that would break it.  The library is built by ops/kernels/_nvcc.py and
loaded with ctypes; nothing here falls back to the plain version: a failed
build, weights outside that range, a tensor the kernel does not take, or a
refused launch raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "vote_fold.cu"
EXACT_SUM = float(1 << 17)  # a column's sums stay below it: float32 adds them exactly
WEIGHT_STEP = 2.0 ** -7  # every rounded weight a multiple of it
N_CH = 15
COL_T_SPAN, COL_SLOT, COL_WEIGHT = 3, 7, 8

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
        lib.canu_vote_fold.argtypes = [p, i, i, p, p, p, i, p, i, i, i, p, p]
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


def slot_order(host_cols: np.ndarray, G: int) -> np.ndarray:
    """The kernel's list of a group's voting jobs by slot, int32[G + 1 +
    m]: the offsets of each slot's jobs (G + 1 of them, the first 0, the
    last m), then the m jobs that vote, ordered by slot and, within a slot,
    by their place in the group.  A job votes where its t_span is above 0,
    its weight rounds to a bfloat16 other than 0 and its slot lies in
    0..G-1.  host_cols is the group's int32[9, n] columns on the host."""
    slot = host_cols[COL_SLOT].astype(np.int64)
    votes = ((host_cols[COL_T_SPAN] > 0) & (rounded_weights(host_cols[COL_WEIGHT]) != 0)
             & (slot >= 0) & (slot < G))
    jobs = np.flatnonzero(votes)
    jobs = jobs[np.argsort(slot[jobs], kind="stable")]
    offsets = np.zeros(G + 1, np.int64)
    np.cumsum(np.bincount(slot[jobs], minlength=G), out=offsets[1:])
    return np.concatenate([offsets, jobs]).astype(np.int32)


def vote_fold(votes, js, t_sub, e_sub, cols, n_rows: int, t_mask: int, host_cols: np.ndarray,
              load: np.ndarray) -> None:
    """Kernel K9: add the fold of n jobs (ops.votepile._fold_chunk's votes,
    every chunk of them) into votes f32[G, 15, Lt] in place, for js
    int32[n, n_rows + 1], t_sub uint8[n, n_rows], e_sub uint8[n, W_e] and
    cols int32[9, n] (ops.votepile's job columns) on the card; t_mask the
    mask of the template shift (2^log_rounds(Lt) - 1); host_cols the same
    columns on the host and load the block's slot bounds (add_load), which
    are checked first.  The jobs' order by slot (slot_order) goes up to
    the card beside them, with no wait for the card; then ``launch``."""
    if n_rows < 1:
        raise ValueError(f"kernel K9 takes 1 or more rows, got {n_rows}")
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
    # through pinned memory: the copy is queued on the stream, the host waits for nothing
    by_slot = torch.from_numpy(slot_order(host_cols, G)).pin_memory().to(dev, non_blocking=True)
    launch(votes, js, t_sub, e_sub, cols, n_rows, t_mask, by_slot)


def launch(votes, js, t_sub, e_sub, cols, n_rows: int, t_mask: int, by_slot) -> None:
    """K9's launch alone, on the card: what vote_fold launches once it has
    checked its tensors and weights and uploaded the jobs' order by slot
    (by_slot, slot_order's int32 list on the card).  Counts a launch."""
    global LAUNCHES
    G, Lt = votes.shape[0], votes.shape[2]
    n, W_e = js.shape[0], e_sub.shape[1]
    with torch.cuda.device(votes.device):
        stream = torch.cuda.current_stream(votes.device).cuda_stream
        rc = _load().canu_vote_fold(votes.data_ptr(), int(G), int(Lt), js.data_ptr(),
                                    t_sub.data_ptr(), e_sub.data_ptr(), int(W_e), cols.data_ptr(),
                                    int(n), int(n_rows), int(t_mask), by_slot.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kernel K9 launch failed: "
                           f"{f'refused its arguments ({rc})' if rc < 0 else f'cudaError {rc}'}")
    LAUNCHES += 1
