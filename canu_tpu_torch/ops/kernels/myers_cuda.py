"""Kernel K1 on Hopper: build, bind and launch csrc/myers_tile.cu.

The CUDA source is compiled with nvcc for sm_90a into a shared library
with a plain C interface at first use, into canu_tpu_torch/_build/ (named
by a hash of the source and flags, so an edited source rebuilds), and
loaded with ctypes.  Nothing here falls back to the plain PyTorch loop: a
failed build, a tensor the kernel does not take, or a refused launch
raises.  The plain version is ops.myers._myers_segment.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ..myers import NC

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "myers_tile.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# launches of the kernel since the last reset (read by chip_smoke.py)
LAUNCHES = 0

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: kernel K1 needs the CUDA toolkit to build")


def build() -> tuple[Path, float, str]:
    """Compile the kernel library if it is not built yet.

    Returns (library path, build seconds (0 when already built), the
    compiler's register/spill report)."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmyers_tile-{tag}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.monotonic()
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    secs = time.monotonic() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={r.returncode}) on {SOURCE}:\n{r.stderr[-4000:]}")
    log.write_text(r.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
    return lib, secs, r.stderr


def _load():
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.canu_myers_rows
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, p, p, i, i, i, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def myers_rows_cuda(planes: torch.Tensor, a_rows: torch.Tensor, s_rows: torch.Tensor,
                    ent_rows: torch.Tensor, b: torch.Tensor, a_len: torch.Tensor,
                    b_len: torch.Tensor, cap_q: int) -> torch.Tensor:
    """Run rows 1..n_run of every extension in one launch.

    planes int32[43, B] carry (uint32 bit patterns, ops.myers._carry_pack
    order); a_rows/s_rows uint8[n_run, B] A chars and band shifts;
    ent_rows int32[n_run, B] entering-B-char indices; b uint8[B, LB];
    a_len/b_len int32[B].  Returns the final carry int32[43, B].
    """
    global LAUNCHES
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"myers_rows_cuda needs CUDA tensors, got {dev}")
    B = planes.shape[1]
    n_run = a_rows.shape[0]
    _check("planes", planes, torch.int32, (NC, B), dev)
    _check("a_rows", a_rows, torch.uint8, (n_run, B), dev)
    _check("s_rows", s_rows, torch.uint8, (n_run, B), dev)
    _check("ent_rows", ent_rows, torch.int32, (n_run, B), dev)
    _check("b", b, torch.uint8, (B, b.shape[1]), dev)
    _check("a_len", a_len, torch.int32, (B,), dev)
    _check("b_len", b_len, torch.int32, (B,), dev)
    if b.shape[1] < 1:
        raise ValueError("b must have at least one column")
    out = torch.empty_like(planes)
    lib = _load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.canu_myers_rows(
            planes.data_ptr(), out.data_ptr(), a_rows.data_ptr(), s_rows.data_ptr(),
            ent_rows.data_ptr(), b.data_ptr(), int(b.shape[1]), a_len.data_ptr(),
            b_len.data_ptr(), int(B), int(n_run), int(cap_q), stream)
    if rc != 0:
        raise RuntimeError(f"myers_rows_kernel launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
