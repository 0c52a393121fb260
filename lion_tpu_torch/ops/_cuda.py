"""Build, load and dispatch the port's hand-written CUDA kernels.

The kernels live in `lion_tpu_torch/csrc/*.cu`. On first use they are
compiled with nvcc for Hopper (`sm_90a`) into one shared library with a
plain C interface under `build/lion_tpu_torch/` in the checkout, named by a
hash of the sources and flags, and loaded with ctypes. Nothing is compiled
or imported from CUDA when this module is imported, so the CPU tests run
on machines without nvcc.

Every kernel has a wrapper made by `kernel(...)`. The wrapper runs the
kernel's plain PyTorch version for a tensor on the CPU, launches the kernel
for a CUDA tensor, and raises for any other device; there is no fallback
from the card to the plain version. Each wrapper carries two plain counters:
`launches` (kernel launches) and `plain_calls` (plain-version calls made by
the wrapper), which `reset_counts` zeroes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "lion_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points (csrc/*.cu) and their argument types; every one returns
# cudaGetLastError() as an int.
_SIGNATURES = {
    "lion_fps": (_P, _P, _P, _I, _I, _I, _P),
    "lion_ball_query_group": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P),
    "lion_avg_voxelize": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "lion_conv3d_3x3_fused": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _P),
    "lion_trilinear_devoxelize": (_P, _P, _P, _I, _I, _I, _I, _P),
    "lion_three_nn_interpolate": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
}

# name -> wrapper, in registration order (one entry per kernel)
KERNELS: Dict[str, Callable] = {}
_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Path of the built library for the current sources (may not exist)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"liblion_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.

    The compiler's resource report (-Xptxas=-v) is kept beside the library
    as `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    out.with_name(out.name + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.lion_error_string.argtypes = (ctypes.c_int,)
        lib.lion_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def launch(entry: str, *args) -> None:
    """Call C entry `entry` with `args` (ints for pointers and the stream
    are passed as given) and raise if it reports a CUDA error."""
    lib = library()
    err = getattr(lib, entry)(*args)
    if err != 0:
        msg = lib.lion_error_string(err).decode()
        raise RuntimeError(f"{entry}: CUDA error {err}: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    """Device pointer of a tensor, or None (NULL) for an absent operand."""
    return None if t is None else t.data_ptr()


def check_cuda(*tensors, dtype=torch.float32) -> None:
    """Raise unless every given tensor is a contiguous CUDA tensor of
    `dtype` on the device of the first."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")


def kernel(name: str, plain: Callable, source: str, replaces: str):
    """Make `launch_fn` the CUDA side of kernel `name`.

    The returned wrapper takes the same arguments as `plain`; its first
    argument's device picks the route. `source` is the kernel's .cu file and
    `replaces` the TPU kernel it ports (file:line), both for reports."""
    def deco(launch_fn):
        @functools.wraps(launch_fn)
        def wrapper(*args, **kwargs):
            dev = args[0].device
            if dev.type == "cpu":
                wrapper.plain_calls += 1
                return plain(*args, **kwargs)
            if dev.type != "cuda":
                raise ValueError(f"{name}: no kernel for device {dev}")
            with torch.cuda.device(dev):
                out = launch_fn(*args, **kwargs)
            wrapper.launches += 1
            return out

        wrapper.launches = 0
        wrapper.plain_calls = 0
        wrapper.plain = plain
        wrapper.source = source
        wrapper.replaces = replaces
        KERNELS[name] = wrapper
        return wrapper
    return deco


def reset_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0
        w.plain_calls = 0
