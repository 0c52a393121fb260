"""Device-time breakdown of the denoise steps of both priors on one GPU.

    python -m lion_tpu_torch.profile_step [--batch 4] [--steps 5]

Builds the flagship LION (fp32, random weights from a seed), warms up, then
records `--steps` ancestral steps of the local prior and of the global prior
(model forward + update, as `LION.sample` runs them) under torch.profiler.
For each prior it prints the wall ms per step, the summed device ms per
step, the device's busy share (device time over wall time; the step runs on
one stream) and the device time by kernel name, largest first.
"""
import argparse

import torch
from torch.profiler import ProfilerActivity, profile

# our kernels' __global__ names -> the wrapper they belong to
_OURS = {"fps_kernel": "fps", "bqg_kernel": "ball_query_group",
         "vox_scatter_kernel": "avg_voxelize",
         "vox_divide_kernel": "avg_voxelize",
         "conv3d_kernel": "conv3d_3x3_fused",
         "devox_kernel": "trilinear_devoxelize",
         "three_nn_kernel": "three_nn_interpolate"}


def _group(name: str) -> str:
    for k, v in _OURS.items():
        if k in name:
            return f"K {v}"
    if "gemm" in name or "cutlass" in name or "gemv" in name:
        return "cuBLAS matmul"
    if "reduce" in name.lower():
        return "torch reductions"
    if "elementwise" in name.lower() or "vectorized" in name.lower():
        return "torch elementwise"
    return "torch other: " + name[:60]


def profile_steps(step, steps: int, label: str) -> None:
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            step()
        end.record()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end) / steps
    groups = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            g = groups.setdefault(_group(ev.key), [0.0, 0])
            g[0] += dev_us / 1e3 / steps
            g[1] += ev.count // steps
    busy = sum(v[0] for v in groups.values())
    print(f"[{label}] wall {wall:.3f} ms/step, device {busy:.3f} ms/step, "
          f"busy share {busy / wall:.3f}, "
          f"{sum(v[1] for v in groups.values())} device ops/step")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[
            :12]:
        print(f"[{label}]   {ms:8.3f} ms  {n:5d} ops  {name}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from .config import flagship_cfg
    from .models import LION
    lion = LION(flagship_cfg()).init_params(
        torch.Generator().manual_seed(0)).cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    b = args.batch
    z_global = torch.randn(b, lion.style_dim, generator=g, device="cuda")
    x_local = torch.randn(b, lion.num_points, lion.point_channels,
                          generator=g, device="cuda")
    noise_g, noise_l = torch.randn_like(z_global), torch.randn_like(x_local)
    diff = lion.diffusion
    print(f"[setup] {torch.cuda.get_device_name(0)}, batch {b}, "
          f"{args.steps} profiled steps per prior")

    with torch.no_grad():
        profile_steps(lambda: diff._ancestral_step(
            lambda x, t: lion.local_prior(x, t, condition_input=z_global),
            x_local, 500, noise_l), args.steps, "local")
        profile_steps(lambda: diff._ancestral_step(
            lion.global_prior, z_global, 500, noise_g), args.steps, "global")


if __name__ == "__main__":
    main()
