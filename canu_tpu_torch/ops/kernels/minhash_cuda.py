"""Kernels K5 and K6 on Hopper: build, bind and launch csrc/minhash.cu.

K5 (``sketch``) is the MinHash sketch of a padded read block: one block
of 128 threads a (read, 256 hash slots), the read's canonical keys built
a tile of 512 windows at a time, the frequent ones dropped by a binary
search in the sorted table, the kept ones compacted into shared memory
and hashed by every thread for its 2 slots.  ops.minhash._sketch_kernel
launches it on CUDA tensors; it is held against
ops.minhash._sketch_kernel_plain.

K6 is the block matcher's two launches: ``slot_counts`` (the count
launch alone: the slot agreements of every (i, j) of a block pair, 32 x 32
cells a block) and ``match_block`` (the count launch, which also writes
each row's set cells a 32-column tile, then the compact launch: the scan
of those counts, the set cells in row-major order, the fixed-size nonzero
of canu_tpu, its padding and n_found), with nothing else enqueued between
or around them.  ops.minhash._match_kernel launches match_block and
ops.minhash.slot_counts (the sharded ring's count) the count launch; they
are held against ops.minhash._match_kernel_plain and _slot_counts_plain.

The library is built by ops/kernels/_nvcc.py and loaded with ctypes;
nothing here falls back to the plain versions: a failed build, a tensor
the kernels do not take, or a refused launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _nvcc

SOURCE = _nvcc.CSRC / "minhash.cu"
TILE = 32  # csrc/minhash.cu MT: the count launch's 32 x 32 cells a block, a tile_set column
SCAN_BLOCK = 256  # csrc/minhash.cu CM_THREADS: tile_set entries a block of the compact's scan

# launches since the last reset (read by chip_smoke.py): K5, K6's count
# launch (one a block pair or ring step) and its compact launch
SKETCH_LAUNCHES = MATCH_LAUNCHES = COMPACT_LAUNCHES = 0

_lib = None


def _load():
    global _lib
    if _lib is None:
        path, _, _ = _nvcc.build(SOURCE)[0]
        lib = ctypes.CDLL(str(path))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.canu_minhash_sketch.argtypes = [p, i, i, p, p, i, p, i, i, p, p]
        lib.canu_slot_match_count.argtypes = [p, i, p, i, i, i, i, p, p, p, i, p]
        lib.canu_slot_match_compact.argtypes = [p, p, i, i, i, i, p, i, p, p, p, p, p]
        for fn in (lib.canu_minhash_sketch, lib.canu_slot_match_count,
                   lib.canu_slot_match_compact):
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


def sketch(words, lengths, seeds, fk, k: int) -> torch.Tensor:
    """Kernel K5: int64[B, H] min-hash values (uint32; UINT32_MAX where a
    read keeps no window) of words int64[B, W] (uint32 values, 16 bases a
    word), lengths int32[B], seeds int64[H] and the sorted frequent table
    fk int64[F] (F >= 1) on the card, k in 2..32."""
    global SKETCH_LAUNCHES
    if not 2 <= k <= 32:
        raise ValueError(f"kernel K5 takes k in 2..32, got {k}")
    if words.dim() != 2:
        raise ValueError("words must be 2-D")
    dev = words.device
    B, W = words.shape
    H, F = seeds.shape[0], fk.shape[0]
    if F < 1:
        raise ValueError("kernel K5 needs a frequent table of at least one entry (the sentinel)")
    _nvcc.check_tensor("words", words, torch.int64, (B, W), dev)
    _nvcc.check_tensor("lengths", lengths, torch.int32, (B,), dev)
    _nvcc.check_tensor("seeds", seeds, torch.int64, (H,), dev)
    _nvcc.check_tensor("fk", fk, torch.int64, (F,), dev)
    _on_card("K5", dev)
    out = torch.empty((B, H), dtype=torch.int64, device=dev)
    if B == 0 or H == 0:
        return out
    fn = _load().canu_minhash_sketch
    with torch.cuda.device(dev):
        rc = fn(words.data_ptr(), int(B), int(W), lengths.data_ptr(), seeds.data_ptr(), int(H),
                fk.data_ptr(), int(F), int(k), out.data_ptr(), _stream(dev))
    _raise_on(rc, "K5")
    SKETCH_LAUNCHES += 1
    return out


def _blocks(SA, SB):
    """(Na, Nb, H) of two sketch blocks on the card, checked."""
    if SA.dim() != 2 or SB.dim() != 2:
        raise ValueError("SA and SB must be 2-D")
    dev = SA.device
    Na, H = SA.shape
    Nb = SB.shape[0]
    _nvcc.check_tensor("SA", SA, torch.int64, (Na, H), dev)
    _nvcc.check_tensor("SB", SB, torch.int64, (Nb, H), dev)
    _on_card("K6", dev)
    return Na, Nb, H


def slot_counts(SA, SB) -> torch.Tensor:
    """K6's count launch alone: int32[Na, Nb] slot agreements of SA
    int64[Na, H] and SB int64[Nb, H] (uint32 values) on the card."""
    global MATCH_LAUNCHES
    Na, Nb, H = _blocks(SA, SB)
    dev = SA.device
    cnt = torch.empty((Na, Nb), dtype=torch.int32, device=dev)
    if Na == 0 or Nb == 0:
        return cnt
    with torch.cuda.device(dev):
        rc = _load().canu_slot_match_count(SA.data_ptr(), Na, SB.data_ptr(), Nb, H, 0, 0,
                                           cnt.data_ptr(), None, None, 0, _stream(dev))
    _raise_on(rc, "K6")
    MATCH_LAUNCHES += 1
    return cnt


def match_block(SA, SB, min_matches: int, self_block: bool, max_out: int):
    """Kernel K6: (ii int64[max_out], jj int64[max_out], c int32[max_out],
    n_found int64 0-d) for SA int64[Na, H], SB int64[Nb, H] on the card:
    the first max_out cells with at least min_matches agreeing slots (i <
    j in a self block) in row-major order, padded with Na, Na and 0;
    n_found counts every set cell, also past max_out.  Two launches, the
    count and the compact; the outputs and one scratch buffer (the scan
    state, each row's set cells a 32-column tile, the counts) are
    torch.empty, nothing else is enqueued and nothing leaves the card."""
    global MATCH_LAUNCHES, COMPACT_LAUNCHES
    if max_out < 0:
        raise ValueError(f"max_out must be >= 0, got {max_out}")
    Na, Nb, H = _blocks(SA, SB)
    dev = SA.device
    n_tiles = -(-Nb // TILE)
    n_scan = -(-Na * n_tiles // SCAN_BLOCK) + 1
    # int32 words: the scan state (int64[n_scan]), tile_set [Na, n_tiles], cnt [Na, Nb]
    scratch = torch.empty(2 * n_scan + Na * n_tiles + Na * Nb, dtype=torch.int32, device=dev)
    scan = scratch.data_ptr()
    tile_set = scan + 8 * n_scan
    cnt = tile_set + 4 * Na * n_tiles
    ii = torch.empty(max_out, dtype=torch.int64, device=dev)
    jj = torch.empty(max_out, dtype=torch.int64, device=dev)
    c = torch.empty(max_out, dtype=torch.int32, device=dev)
    n_found = torch.empty((), dtype=torch.int64, device=dev)
    lib = _load()
    self_block = int(bool(self_block))
    with torch.cuda.device(dev):
        stream = _stream(dev)
        rc = lib.canu_slot_match_count(SA.data_ptr(), Na, SB.data_ptr(), Nb, H, int(min_matches),
                                       self_block, cnt, tile_set, scan, n_scan, stream)
        _raise_on(rc, "K6")
        MATCH_LAUNCHES += 1
        rc = lib.canu_slot_match_compact(cnt, tile_set, Na, Nb, int(min_matches), self_block, scan,
                                         int(max_out), ii.data_ptr(), jj.data_ptr(), c.data_ptr(),
                                         n_found.data_ptr(), stream)
    _raise_on(rc, "K6 (compact)")
    COMPACT_LAUNCHES += 1
    return ii, jj, c, n_found
