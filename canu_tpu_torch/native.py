"""The external merge sort of overlap records, ``native/ovsort.cc``.

The C++ source is the repository's (``native/``, beside both packages);
at first use g++ compiles it with ``-O3 -shared -fPIC -pthread`` into
``canu_tpu_torch/_build/libovsort-<hash>.so`` (the hash covers the
source and the flags, so an edited source rebuilds), and ctypes loads it.
A failed build or a failed sort raises: there is no in-memory fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent
SOURCE = PKG.parent / "native" / "ovsort.cc"
BUILD_DIR = PKG / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lib = None


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libovsort-{tag}.so"


def build() -> Path:
    """Compile native/ovsort.cc unless its library is built; returns the
    library's path."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the overlap store's external sort "
                           f"({SOURCE}) needs a C++ compiler to build")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed (rc={r.returncode}) on {SOURCE}:\n{r.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent builder never loads a partial file
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.ovsort_file.restype = ctypes.c_longlong
        lib.ovsort_file.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_longlong, ctypes.c_int]
        _lib = lib
    return _lib


def ovsort_file(in_path: str, out_path: str, tmp_dir: str, mem_budget: int = 1 << 30,
                n_threads: int = 0) -> int:
    """Sort a file of packed 28-byte overlap records by (a_id, b_id) into
    out_path (runs of mem_budget bytes sorted by n_threads threads, 0 =
    every core, then merged; run files in tmp_dir).  Returns the record
    count; raises OSError when the sort fails."""
    r = _load().ovsort_file(os.fsencode(in_path), os.fsencode(out_path),
                            os.fsencode(tmp_dir), int(mem_budget), int(n_threads))
    if r < 0:
        raise OSError(f"ovsort_file failed with code {r} on {in_path}")
    return int(r)
