"""Build, load and dispatch the port's hand-written CUDA kernels.

The kernels live in `lion_tpu_torch/csrc/*.cu`. On first use each source is
compiled with nvcc for Hopper (`sm_90a`), all sources at once in parallel
processes, and the objects are linked into one shared library with a plain
C interface under `build/lion_tpu_torch/` in the checkout, named by a hash
of the sources and flags, and loaded with ctypes. Nothing is compiled or
imported from CUDA when this module is imported, so the CPU tests run on
machines without nvcc.

Every kernel has a wrapper made by `kernel(...)`. The wrapper runs the
kernel's plain PyTorch version for a tensor on the CPU, launches the kernel
for a CUDA tensor, and raises for any other device; there is no fallback
from the card to the plain version. Each wrapper carries three plain
counters, which `reset_counts` zeroes: `launches` (kernel launches),
`launches_bf16` (those given a bfloat16 tensor) and `plain_calls`
(plain-version calls made by the wrapper).
"""
from __future__ import annotations

import contextlib
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
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points (csrc/*.cu) and their argument types; every one returns
# cudaGetLastError() as an int.
_SIGNATURES = {
    "lion_fps": (_P, _P, _P, _I, _I, _I, _P),
    "lion_ball_query_group": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                              _I, _I, _I, _P),
    "lion_ball_query": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "lion_ball_query_group_cf": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                 _I, _I, _I, _I, _P),
    "lion_emd_cost": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lion_avg_voxelize": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lion_conv3d_brick": (_P,) * 8 + (_I,) * 18 + (_P,),
    "lion_conv3d_pair": (_P,) * 13 + (_I,) * 13 + (_P,),
    "lion_conv3d_wgrad": (_P,) * 4 + (_I,) * 10 + (_P,),
    "lion_pvconv_block_pair": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _P),
    "lion_sa_fused": (_P,) * 9 + (_I,) + (_P,) * 5 + (_I,) * 9 + (_F, _P),
    "lion_trilinear_devoxelize": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                  _I, _P),
    "lion_three_nn_interpolate": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _P),
    "lion_row_sum": (_P,) * 6 + (_I,) * 5 + (_P,),
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


def _run_all(cmds):
    """Run the commands in parallel; raise with the compiler's errors if
    any fails. Returns their stdout + stderr, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    failed = [(c, p.returncode, o) for c, p, o in zip(cmds, procs, outs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{' '.join(c)} ({rc}):\n{o}" for c, rc, o in failed))
    return outs


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    nvcc per source, all started together, then one link.

    The compiler's resource report (-Xptxas=-v) is kept beside the library
    as `<library>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in srcs]
    tmp = out.with_name(f"{tag}.so.tmp")
    try:
        logs = _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                         for s, o in zip(srcs, objs)])
        logs += _run_all([[_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                           str(tmp), *map(str, objs)]])
        out.with_name(out.name + ".log").write_text("".join(logs))
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def build_probe(src: Path) -> ctypes.CDLL:
    """Compile a measurement probe (a source under csrc/probe/ that
    includes a kernel's source, or a patched copy of a kernel's source
    anywhere, its includes resolved against csrc/) on its own into a
    library beside the kernels' library, unless one for this source
    exists, and load it. The kernels' library never contains a probe."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (src, *_sources()):
        h.update(f.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.so.tmp")
        try:
            _run_all([[_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-shared",
                       "-o", str(tmp), str(src)]])
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
    return ctypes.CDLL(str(out))


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


def check_cuda(*tensors, dtype=torch.float32, device=None) -> None:
    """Raise unless every given tensor (None is skipped) is a contiguous,
    16-byte aligned CUDA tensor of `dtype` on `device`, by default the
    device of the first (the kernels read rows with 16-byte loads)."""
    dev = device or tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"expected CUDA tensors on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
        if t.data_ptr() % 16:
            raise ValueError("expected a 16-byte aligned tensor")


def check_float(t: torch.Tensor, name: str) -> torch.dtype:
    """The activation dtype a kernel takes: float32 or bfloat16."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    return t.dtype


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
            if any(getattr(a, "dtype", None) == torch.bfloat16
                   for a in args):
                wrapper.launches_bf16 += 1
            return out

        wrapper.launches = 0
        wrapper.launches_bf16 = 0
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
        w.launches_bf16 = 0
        w.plain_calls = 0


@contextlib.contextmanager
def no_tf32():
    """Full float32 for cuBLAS matmuls and cuDNN convolutions inside the
    block (cuDNN runs float32 convolutions in TF32 by default); the previous
    settings come back after it."""
    mm, conv = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = conv
