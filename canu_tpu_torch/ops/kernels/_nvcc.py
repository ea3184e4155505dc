"""Build the port's CUDA sources into shared libraries with a plain C
interface, for ctypes.

Each ``canu_tpu_torch/csrc/<name>.cu`` compiles with nvcc for sm_90a into
``canu_tpu_torch/_build/lib<name>-<hash>.so``; the hash covers the source
and the flags, so an edited source rebuilds and an unchanged one is
reused.  ``build`` starts one nvcc per missing library, all at once, and
waits for them together.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit to build")


def library_path(source: Path) -> Path:
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{tag}.so"


def build(*sources: Path) -> list[tuple[Path, float, str]]:
    """Compile every source whose library is not built yet, in parallel.

    Returns, per source, (library path, build seconds (0 when already
    built), the compiler's register/spill report)."""
    out: dict[Path, tuple[Path, float, str]] = {}
    running = []
    for src in sources:
        lib = library_path(src)
        log = lib.with_suffix(".log")
        if lib.exists():
            out[src] = (lib, 0.0, log.read_text() if log.exists() else "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        running.append((src, lib, tmp, proc, time.monotonic()))
    failed = []
    for src, lib, tmp, proc, t0 in running:
        _, err = proc.communicate()
        secs = time.monotonic() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed (rc={proc.returncode}) on {src}:\n{err[-4000:]}")
            continue
        lib.with_suffix(".log").write_text(err)
        os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
        out[src] = (lib, secs, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out[src] for src in sources]


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    """Raise unless t is a contiguous tensor of that dtype and shape on device."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
