"""32-bit mixing hashes for k-mer sketching (counterpart of canu_tpu.ops.hashing).

uint32 values are held in int64 tensors (0 .. 2**32-1): every op below
keeps them in that range, so sorts and comparisons see the unsigned order.
"""

from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) and a constant c < 2**32.

    A full u32 x u32 product overflows int64, so x is split into 16-bit
    halves: x*c = lo*c + (hi*c mod 2**16) << 16 (mod 2**32), and every
    partial product stays below 2**49.
    """
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer: a well-dispersed bijective uint32 mix."""
    x = x.to(torch.int64) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_seeds(n: int, seed: int = 0xA5EED) -> np.ndarray:
    """n distinct uint32 seeds derived from a master seed (host numpy,
    the same draws as canu_tpu.ops.hashing.hash_seeds)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**32, size=n, dtype=np.uint32)


def u32_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy uint32 array -> int64 tensor holding the same values."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of uint32 values -> numpy uint32 array."""
    return t.cpu().numpy().astype(np.uint32)
