"""Smoke test of the PyTorch/CUDA port (lion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 100]

Phases, each printing its results; any failure raises and the script exits
non-zero:
  1. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off for matmuls and cuDNN.
  2. build: compiles the six CUDA kernels from lion_tpu_torch/csrc.
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the main path's shapes (batch 16), with times from CUDA events.
  4. forward parity: one full-width local-prior forward (batch 2) on the
     card against the same module on the CPU (plain versions).
  5. main path: the flagship LION (2048 points, nf 2048, fp32) with random
     weights from a seed serves three sampling requests of 4 shapes each
     through `LION.sample`, `--steps` DDPM steps per prior (1000 is the
     released chain); every kernel must have launched and no plain version
     may have run.
The card's name and power limit are printed as nvidia-smi gives them, on a
line of their own. The line before the last is a JSON object describing the
kernels; the last line is {"ok": true, "device": {...}}.
"""
import argparse
import copy
import json
import subprocess
import sys
import time

import torch

BATCH_KERNELS = 16
BATCH = 4
REQUESTS = 3


def log(*args):
    print(*args, flush=True)


def cuda_time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a, b):
    return float((a.float() - b.float()).abs().max())


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False); the port's kernels need an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from lion_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    report = path.with_name(path.name + ".log")
    if report.exists():   # ptxas: registers, shared memory, spills
        for line in report.read_text().splitlines():
            if "Used" in line or ("spill" in line and
                                  "0 bytes spill stores, 0 bytes spill loads"
                                  not in line):
                log(f"[build] {line.strip()}")


class KernelCheck:
    """One kernel-vs-plain comparison at one shape."""

    def __init__(self, name, case, args, kwargs, compare, iters, plain_iters):
        self.name, self.case = name, case
        self.args, self.kwargs = args, kwargs
        self.compare, self.iters, self.plain_iters = compare, iters, \
            plain_iters

    def run(self, kernels):
        w = kernels[self.name]
        got = w(*self.args, **self.kwargs)
        ref = w.plain(*self.args, **self.kwargs)
        torch.cuda.synchronize()
        err = self.compare(got, ref)
        ms = cuda_time_ms(lambda: w(*self.args, **self.kwargs), self.iters)
        plain_ms = cuda_time_ms(lambda: w.plain(*self.args, **self.kwargs),
                                self.plain_iters, warmup=1)
        log(f"[kernels] {self.name} {self.case}: max_abs_err {err:.3e}, "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _exact(got, ref):
    """Index outputs equal; float outputs equal bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for g, r in zip(got, ref):
        if g.dtype in (torch.int32, torch.int64):
            if not torch.equal(g.long(), r.long()):
                raise AssertionError("index outputs differ")
        else:
            err = max(err, max_abs(g, r))
            if err != 0.0:
                raise AssertionError(f"expected bitwise equality, {err:.3e}")
    return err


def _close(rtol, atol):
    def compare(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = 0.0
        for g, r in zip(got, ref):
            err = max(err, max_abs(g, r))
            torch.testing.assert_close(g, r, rtol=rtol, atol=atol)
        return err
    return compare


def _conv_compare(got, ref):
    """y at fp32 rounding of 27*Ci-term sums taken in another order (the
    plain version is cuDNN with TF32 off); the stats sum up to 32768 such
    values per channel with atomics, so they get a tolerance scaled to their
    size. Returns y's error; the stats' is logged."""
    (y, st), (yr, sr) = got, ref
    torch.testing.assert_close(y, yr, rtol=1e-4, atol=1e-4)
    scale = float(sr.abs().max())
    torch.testing.assert_close(st, sr, rtol=1e-4, atol=1e-4 * scale)
    log(f"[kernels]   stats max_abs_err {max_abs(st, sr):.3e} "
        f"(max |stats| {scale:.3e})")
    return max_abs(y, yr)


def phase_kernels():
    from lion_tpu_torch import ops
    from lion_tpu_torch.ops.voxel import normalize_coords
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    b = BATCH_KERNELS

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    cloud = randn(b, 2048, 3, scale=0.3)
    centers = ops.KERNELS["fps"].plain(cloud, 1024)[1]
    nc32 = normalize_coords(cloud, 32).contiguous()
    vox32 = torch.round(nc32).to(torch.int32)
    w64 = randn(3, 3, 3, 64, 64, scale=(27 * 64) ** -0.5)
    w128 = randn(3, 3, 3, 128, 64, scale=(27 * 128) ** -0.5)
    checks = [
        # K1, K2, K5, K6 evaluate the same unfused arithmetic in the same
        # order as their plain versions, so they must agree bit for bit
        KernelCheck("fps", "B16 N2048->M1024", (cloud, 1024), {}, _exact,
                    20, 2),
        KernelCheck("ball_query_group", "B16 N2048 M1024 K32 r0.1 C32",
                    (cloud, centers, randn(b, 2048, 32), 0.1, 32), {},
                    _exact, 20, 3),
        # K3: both scatter with atomics in varying order; a cell sums at
        # most a few dozen features
        KernelCheck("avg_voxelize", "B16 N2048 r32 C64",
                    (randn(b, 2048, 64), vox32, 32), {},
                    _close(1e-5, 1e-5), 20, 5),
        KernelCheck("trilinear_devoxelize", "B16 N2048 r32 C64",
                    (randn(b, 32, 32, 32, 64), nc32, 32), {}, _exact, 20, 5),
        KernelCheck("conv3d_3x3_fused", "B16 r32 C64->64 affine+swish",
                    (randn(b, 32, 32, 32, 64), w64,
                     1.0 + randn(b, 64, scale=0.1), randn(b, 64, scale=0.1)),
                    {"pre_swish": True}, _conv_compare, 5, 5),
        KernelCheck("conv3d_3x3_fused", "B16 r16 C128->64",
                    (randn(b, 16, 16, 16, 128), w128), {}, _conv_compare,
                    10, 10),
        KernelCheck("three_nn_interpolate", "B16 N2048 M1024 C192",
                    (cloud, centers, randn(b, 1024, 192)), {}, _exact, 20, 5),
    ]
    results = {}
    for c in checks:
        r = c.run(ops.KERNELS)
        prev = results.get(c.name)
        if prev is None:
            results[c.name] = r
        else:   # keep the first case's times, the worst error
            prev["max_abs_err"] = max(prev["max_abs_err"], r["max_abs_err"])
    return results


def phase_forward_parity(cfg):
    """Full-width local prior, B=2: kernels on the card vs plain on CPU."""
    from lion_tpu_torch.models.registry import build_local_prior
    from lion_tpu_torch.nn import init_weights
    cpu = build_local_prior(cfg)
    init_weights(cpu, torch.Generator().manual_seed(7))
    gpu = copy.deepcopy(cpu).cuda()
    g = torch.Generator().manual_seed(8)
    x = (torch.randn(2, 2048, 4, generator=g)
         * torch.tensor([0.3, 0.3, 0.3, 1.0])).reshape(2, -1)
    t = torch.tensor([500.0, 20.0])
    cond = torch.randn(2, 128, generator=g)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref = cpu(x, t, condition_input=cond)
        t1 = time.perf_counter()
        got = gpu(x.cuda(), t.cuda(), condition_input=cond.cuda()).cpu()
        t2 = time.perf_counter()
    err = max_abs(got, ref)
    scale = float(ref.abs().max())
    log(f"[parity] local prior forward B2 (full width): max_abs_err "
        f"{err:.3e} (max |ref| {scale:.3e}); cpu {t1 - t0:.1f} s, "
        f"gpu {t2 - t1:.2f} s (first call)")
    # ~40 layers of fp32 sums in other orders; every index decision (FPS,
    # ball query, voxel rounding, 3-NN) is identical on both devices. That
    # drift has measured ~1e-5 of the output's size; a limit of 1e-4 of it
    # leaves ~10x room and still catches a systematic error, such as a wrong
    # fold or stats at one resolution, that shows only at full width
    torch.testing.assert_close(got, ref, rtol=0.0, atol=1e-4 * scale)
    return err


def phase_main_path(cfg, steps, batch, requests):
    from lion_tpu_torch import ops
    from lion_tpu_torch.models import LION
    cfg.ddpm.num_steps = steps
    t0 = time.perf_counter()
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0)).cuda()
    log(f"[main] LION flagship fp32, {sum(p.numel() for p in lion.parameters())}"
        f" params, init {time.perf_counter() - t0:.1f} s; {requests} requests"
        f" x batch {batch}, {steps} DDPM steps per prior")
    ops.reset_counts()
    runs = []
    for i in range(requests):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        t0 = time.perf_counter()
        out = lion.sample(batch, generator=gen)
        wall = time.perf_counter() - t0
        pts = out["points"]
        if tuple(pts.shape) != (batch, 2048, 3):
            raise AssertionError(f"points shape {tuple(pts.shape)}")
        if not bool(torch.isfinite(pts).all()):
            raise AssertionError("non-finite points")
        s = out["stage_seconds"]
        runs.append((wall, s))
        log(f"[main] request {i}: {wall:.3f} s wall (global {s['global']:.3f},"
            f" local {s['local']:.3f}, decode {s['decode']:.3f} s); "
            f"points |max| {float(pts.abs().max()):.3f}, "
            f"std {float(pts.std()):.4f}")
    counts = {n: (w.launches, w.plain_calls) for n, w in ops.KERNELS.items()}
    log(f"[main] launches (kernel, plain) during the requests: {counts}")
    missing = [n for n, (k, _) in counts.items() if k == 0]
    plain = [n for n, (_, p) in counts.items() if p != 0]
    if missing or plain:
        raise AssertionError(f"kernels not launched: {missing}; "
                             f"plain versions run: {plain}")
    steady = runs[1:] or runs
    wall = sum(r[0] for r in steady) / len(steady)
    g_ms = 1e3 * sum(r[1]["global"] for r in steady) / len(steady) / steps
    l_ms = 1e3 * sum(r[1]["local"] for r in steady) / len(steady) / steps
    log(f"[main] steady ({len(steady)} requests): {batch / wall:.4f} shapes/s,"
        f" global-prior step {g_ms:.3f} ms, local-prior step {l_ms:.3f} ms "
        f"(batch {batch})")
    return {n: k for n, (k, _) in counts.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100,
                    help="DDPM steps per prior (1000: the released chain)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    phase_device()
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.ops import KERNELS
    phase_build()
    results = phase_kernels()
    phase_forward_parity(flagship_cfg())
    launches = phase_main_path(flagship_cfg(), args.steps, BATCH, REQUESTS)

    report = []
    for name, w in KERNELS.items():
        report.append({"name": name, "route": "cuda", "source": w.source,
                       "replaces": w.replaces, "launches": launches[name],
                       **results[name]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
