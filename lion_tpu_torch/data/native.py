"""The native parallel `.npy` reader (port of lion_tpu/data/native.py).

`lion_tpu_torch/csrc/npy_loader.cpp` is compiled on first use with
`g++ -O3 -shared -fPIC -std=c++17 -pthread` into `build/lion_tpu_torch/`
in the checkout, named by a hash of the source and the flags, and bound
with ctypes. A failed build raises with the compiler's output. A file the
reader refuses (not C-order float32 / float64, fewer rows than asked, other
columns) is read by `np.load`, as the JAX package reads it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "npy_loader.cpp"
BUILD_DIR = _PKG.parent / "build" / "lion_tpu_torch"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIB = None


def library_path() -> Path:
    """Path of the built reader for the current source (may not exist)."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libnpyloader_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the reader unless a library for this source exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) building "
                               f"{SOURCE}:\n{res.stdout}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded reader, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.npy_load_batch.restype = ctypes.c_int
        lib.npy_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int]
        lib.npy_probe.restype = ctypes.c_int
        lib.npy_probe.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_longlong)]
        _LIB = lib
    return _LIB


def npy_shape(path: str) -> Optional[tuple]:
    """(rows, cols) from the file's header, or None where the reader
    refuses the header."""
    shape = (ctypes.c_longlong * 2)()
    if library().npy_probe(os.fsencode(path), shape) != 0:
        return None
    return int(shape[0]), int(shape[1])


def load_npy_batch(paths: List[str], n_points: int, dims: int = 3,
                   n_threads: int = 0) -> np.ndarray:
    """len(paths) .npy clouds -> (len(paths), n_points, dims) float32, read
    by `n_threads` threads (0: one a core). Each file must hold at least
    n_points rows; further rows are left out (the reference reads the
    first 15k / 10k points)."""
    n = len(paths)
    out = np.empty((n, n_points, dims), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = library().npy_load_batch(
        c_paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_points, dims, n_threads)
    if rc == 0:
        return out
    # the reader refused a file (rc is its index from 1): numpy reads them
    for i, p in enumerate(paths):
        out[i] = np.load(p)[:n_points, :dims].astype(np.float32)
    return out
