"""Device-time breakdown of the denoise steps of both priors, or of the
two training steps, on one GPU.

    python -m lion_tpu_torch.profile_step [--batch 4] [--steps 5] [--bf16]
    python -m lion_tpu_torch.profile_step --train [--batch 16] [--steps 3]
        [--bf16]
    python -m lion_tpu_torch.profile_step --repeat
    python -m lion_tpu_torch.profile_step --convs [--batch 16]
    python -m lion_tpu_torch.profile_step --split [--batch 16] [--only K5,K12]
    python -m lion_tpu_torch.profile_step --given-noise PATH
    python -m lion_tpu_torch.profile_step --emd [X.cu ...]
    python -m lion_tpu_torch.profile_step --fps-clock [--batch 16]
    python -m lion_tpu_torch.profile_step --plans [--batch 16] [--source X.cu]

Builds the flagship LION (fp32, or with `tpu.bf16 = True` under --bf16;
random weights from a seed), warms up, then
records `--steps` ancestral steps of the local prior and of the global prior
(model forward + update, as `LION.sample` runs them) under torch.profiler.
For each prior it prints the wall ms per step, the summed device ms per
step, the device's busy share (device time over wall time; the step runs on
one stream) and the device time by kernel name, largest first.

With --train it profiles `--steps` calls of `make_prior_train_step` (fp32,
or bf16 under --bf16 (tpu.bf16); dropout on) in three windows: the frozen
encode alone, the loss forward alone, and the whole step. K10's forward
time is its time in the forward window; K10-dx is the rest of its time in
the step (the same kernel runs both); the encode's kernels are those of
the encode window. Then the stage-1 step (`make_vae_train_step` on the
flagship VAE, `l1_sum`, dropout on, the KL anneal; bf16 under --bf16) at
its released batch of 32 in two windows, the loss forward and the whole
step, with its peak device memory and the step's wall without the
profiler. Each step's wall without the profiler and its peak are also
printed for the two-prior step.

With --repeat it runs one step of each training step twice from the same
state and draws (a fresh flagship model from one seed, one generator
seed): the fp32 two-prior step at batch 16, the fp32 stage-1 step at 32,
the fp32 weighted step (the continuous objective with SN, Jacobian and
kinetic terms) at 16, and the bf16 two-prior and stage-1 steps; it prints
whether the updated parameters and EMA are equal bit for bit (and which
tensors differ); then the stage-1 step's device ms of K10's weight
gradient and of the whole step.

With --convs it prints the device ms per call of every K4 and K10 case of
`chip_smoke.py` phase 3 and of cuDNN's conv on the same inputs (bf16 in
channels-last, fp32 with TF32 off; dx against `conv3d_input`): the kernels
alone, without the wrapper's host time that CUDA events include. Then K8
at r32 C64 beside two cuDNN bf16 convs (its yardstick; no PyTorch call
computes the pair), and K9 at r8 C128 N256 at the batch and at batch 1
(one cluster of 8 blocks alone). Then K10's weight gradient at every shape
of the benchmark's two training steps (`WGRAD_STEPS`) in fp32 beside
cuDNN's `conv3d_weight`, and each step's sum of calls x device ms (`--only
wgrad` keeps those alone).

With --split it prints, for K1 (`fps`) at the local step's four levels
(N 2048 -> 1024, 1024 -> 256, 256 -> 64, 64 -> 16), for K2
(`ball_query_group`) and K11 (`ball_query`) at its four SA levels, K13
(`ball_query_group_cf`, fp32 and bf16) at the first three and K6
(`three_nn_interpolate`, fp32 and bf16) at its four FP levels on those
clouds, for K7 (`sa_fused`)
at the bf16 local step's SA0 and SA3 shapes and for K3 (`avg_voxelize`) at
r32 C64 in fp32 and bf16, for K5 (`trilinear_devoxelize`) at the local
step's devoxelizing levels in fp32 and bf16 (alone, followed by the
per-(item, channel) affine as a separate op, and with the affine in its
epilogue) and for K12 (`emd_cost`) on one 16 x 33 block of 2048-point
pairs, the device ms per call of every CUDA kernel and memset the call
runs, by name, beside the call's CUDA-event ms and the host ms the
wrapper takes to enqueue it (`--only` keeps the cases whose labels start
with the given prefixes). Then it profiles the bf16 local step at the
batch and the fp32 local step at batch 4 (the two sampling paths) and
prints the device ms and launches per step of K1, K2, K4, K5, K6, K8, K9
and the elementwise ops, beside the step's device ms and device ops.

With --given-noise PATH it samples 10 steps under `given_noise` on both
paths (chip_smoke.py phase 4's weights and noise) and writes the outputs
to PATH, or compares them bit for bit with those of an earlier run.

With --emd it times K12 on one 16 x 33 block of 2048-point pairs, and
each patched copy of csrc/emd.cu named after it (built on its own; its
includes resolve against csrc/), with each copy's costs against the
library's and their repeat.

With --fps-clock it builds the K1 probe (csrc/probe/fps_probe.cu) and, at
each of the four levels, runs K1's kernel on every plan of whole warps
(threads, points per thread P = 1 .. 16, at most 1024 threads): its
CUDA-event ms, its indices against K1's own plan's, and the split of one
pick in clock cycles (update, warp argmax, barrier, fold of the slots, the
broadcast of the pick and the loop), averaged over the picks, of block
0's thread 0 and of its last warp's lane 0 (summed in registers, written
once at the end). Then the chain's floor: M - 1 empty rounds (one
barrier, two redux.sync, one shared store and load) on 32 to 1024
threads, in cycles per round and, for the N2048 plan's threads, CUDA-event
ms; and the cycles a step of dependent redux.sync, dependent shared loads
and barriers take, on 32 to 1024 threads.

With --plans it runs K6 (fp32) at its four FP levels on every plan of
32-256 threads and 1-32 lanes a point, K2 at its four SA levels on every
plan of 1-32 centers a block and 64-256 threads, K11 there on every plan
of 1-32 centers and 32-256 threads and K13 (fp32, bf16) at the first
three on every plan of 4-32 centers and 1-8 slot groups: the device ms of
each, whether its output equals the wrapper's plan's bit for bit, and
which plan the wrapper takes; then, on the wrapper's plan at the top
level, K6's and K2's scan alone (C = 0) and output alone (K6: 4 centers;
K2: a cloud of 128 points). --source X.cu times the kernels of a patched
copy of csrc/three_nn.cu, ball_query_group.cu, ball_query.cu or
ball_query_group_cf.cu (built on its own, like the K1 probe; its includes
resolve against its own directory, then csrc/) in place of the
library's; a K11 or K13 source whose entry takes no plan (an older tree's
copy, with its own headers beside it) runs once a level, so an older
design and the library's run in one call.
"""
import argparse
import functools
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

# our kernels' __global__ names -> the wrapper they belong to
_OURS = {"fps_kernel": "fps", "bqg_kernel": "ball_query_group",
         "vox_order_kernel": "avg_voxelize",
         "vox_mean_kernel": "avg_voxelize",
         "conv3d_brick": "conv3d_3x3_fused",
         "devox_kernel": "trilinear_devoxelize",
         "three_nn_kernel": "three_nn_interpolate",
         "sa_pass_kernel": "sa_fused",
         "pair_conv0_brick": "conv3d_pair",
         "pair_conv1_brick": "conv3d_pair", "pair_fold_kernel": "conv3d_pair",
         "pvblock_brick": "pvconv_block_pair", "bq_kernel": "ball_query",
         "row_order_kernel": "row_sum", "row_sum_kernel": "row_sum",
         "bqg_cf_kernel": "ball_query_group_cf",
         "k10_wgrad_": "conv3d_weight_grad"}
# K4's cases (r, ci, co, dtype, affine + swish prologue): fp32, the encode's
# and the fp32 path's widest convs; bf16, every (r, ci, co) of the bf16
# local step's twelve K4 calls. K10's: (r, ci, co), its dx at r32 C64.
K4_CASES = (
    (32, 64, 64, torch.float32, True),
    (16, 128, 64, torch.float32, False),
    (8, 128, 128, torch.float32, True),
    (32, 4, 32, torch.bfloat16, False),
    (32, 32, 32, torch.bfloat16, True),
    (16, 64, 64, torch.bfloat16, True),
    (16, 128, 64, torch.bfloat16, False),
    (16, 128, 128, torch.bfloat16, False),
    (8, 192, 128, torch.bfloat16, False),
    (8, 128, 128, torch.bfloat16, True),
)
K10_CASES = ((32, 64, 64), (32, 4, 32), (16, 128, 64), (8, 192, 128))
# K10's (r, ci, co) in the stage-1 VAE step that the two-prior step never
# runs: the forward convs of the style encoder and the encoder, and the dx
# of the decoder's first conv (C4 -> 32), whose input carries the encoder's
# gradient (the other dx calls have square shapes)
STAGE1_K10_CASES = ((32, 3, 32), (32, 32, 32), (16, 32, 32), (16, 64, 64),
                    (8, 128, 128), (16, 128, 128))
STAGE1_K10_DX = ((32, 32, 4),)
# K10's weight gradients a step takes, {(b, r, ci, co): calls}: the stage-1
# step at its batch of 32 and the two-prior step at 40, the benchmark's
# training cells (counted from its plain reference on the meta device)
WGRAD_STEPS = {
    "stage1 B32": {(32, 32, 64, 64): 8, (32, 32, 32, 32): 9,
                   (32, 32, 4, 32): 1, (32, 32, 3, 32): 2,
                   (32, 16, 128, 128): 8, (32, 16, 64, 64): 4,
                   (32, 16, 32, 32): 2, (32, 8, 128, 128): 28},
    "two-prior B40": {(40, 32, 64, 64): 4, (40, 32, 32, 32): 3,
                      (40, 32, 4, 32): 1, (40, 16, 128, 128): 4,
                      (40, 16, 64, 64): 1, (40, 16, 128, 64): 1,
                      (40, 8, 128, 128): 13, (40, 8, 192, 128): 1},
}
VAE_BATCH = 32   # stage 1's released batch a GPU (script/train_vae.sh)
# K4's kernels without statistics are K10 (the training conv), fp32 and bf16
_K10 = ("conv3d_brick_f32<", "conv3d_brick_bf16<")


def _group(name: str) -> str:
    if any(k in name for k in _K10) and ", false>" in name:
        return "K conv3d_3x3_same"
    for k, v in _OURS.items():
        if k in name:
            return f"K {v}"
    low = name.lower()
    if "wgrad" in low:
        return "cuDNN wgrad"
    if "conv" in low or "xmma" in low or "cudnn" in low:
        return "cuDNN other"
    if "multi_tensor" in low or "foreach" in low or "adam" in low:
        return "optimizer + EMA (foreach)"
    if "scatter" in low or "gather" in low or "index" in low:
        return "torch scatter/gather"
    if "gemm" in low or "cutlass" in low or "gemv" in low:
        return "cuBLAS matmul"
    if "reduce" in low:
        return "torch reductions"
    if "elementwise" in low or "vectorized" in low:
        return "torch elementwise"
    return "torch other: " + name[:60]


def _device_groups(fn, steps: int):
    """(wall ms per call, {group: [device ms per call, ops per call]}) of
    `steps` calls of fn under torch.profiler, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(steps):
            fn()
        end.record()
        torch.cuda.synchronize()
    groups = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            g = groups.setdefault(_group(ev.key), [0.0, 0])
            g[0] += dev_us / 1e3 / steps
            g[1] += ev.count // steps
    return start.elapsed_time(end) / steps, groups


def weighted_cfg(cfg):
    """The weighted objective on the continuous diffusion with every
    regularizer at tests/test_regularization.py's values (_reg_cfg,
    _jackin_cfg): ll_iw, mixed prediction, SN and norm scale at 1e-2, the
    Jacobian term with 2 probes and the kinetic term at 1."""
    cfg.sde.ode_sample = 1
    cfg.sde.iw_sample_p = "ll_iw"
    cfg.latent_pts.pvd_mse_loss = 0
    cfg.sde.mixed_prediction = True
    cfg.sde.weight_decay_norm_dae = 1e-2
    cfg.sde.regularize_mlogit_margin = 1.0
    cfg.sde.bound_mlogit_value = -5.42
    cfg.sde.jac_reg_coeff = 1.0
    cfg.sde.kin_reg_coeff = 1.0
    cfg.sde.jac_reg_samples = 2
    return cfg


def stage1_batch(batch: int, num_points: int) -> torch.Tensor:
    """Shapes as the stage-1 loader gives them: random ellipsoid shells,
    each recentred on its bounding box and scaled into [-1, 1]
    (data/shapenet.py, recenter_per_shape), from seed 41, on the card."""
    rs = np.random.RandomState(41)
    v = rs.randn(batch, num_points, 3)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = v * rs.uniform(0.2, 0.5, (batch, 1, 3)) \
        + 0.01 * rs.randn(batch, num_points, 3)
    lo, hi = v.min(axis=1, keepdims=True), v.max(axis=1, keepdims=True)
    v = (v - (lo + hi) / 2) / ((hi - lo).max(axis=-1, keepdims=True) / 2)
    return torch.from_numpy(v.astype(np.float32)).cuda()


def damp_style_head(vae) -> None:
    """The style posterior's head (the style encoder's last dense layer)
    times 0.01."""
    with torch.no_grad():
        vae.style_encoder.mlp.kernel.mul_(0.01)
        vae.style_encoder.mlp.bias.mul_(0.01)


def train_step_of(kind: str, bf16: bool, batch: int):
    """(step, parameter names, x, generator) of a flagship training step on
    the card, built from seed 0: the two-prior step ("prior",
    scripts/profile_train_step.py's schedule; a generator seeded 21), its
    weighted form ("weighted", `weighted_cfg`) or the stage-1 VAE step
    ("vae", `l1_sum`, the KL anneal, on `stage1_batch`; seeded 22);
    tpu.bf16 = bf16. The VAE's style posterior head starts damped by 0.01,
    as lion_tpu's bf16 trainer test damps it (tests/test_trainers.py:
    482-491): at random weights its log sigma can overflow exp() for some
    clouds, and the step's loss turns non-finite in either package."""
    from .config import flagship_cfg
    from .models import LION
    from .models.vae import VAE
    from .nn import init_weights
    from .trainers import (make_prior_train_step, make_vae_train_step,
                           warmup_cosine_schedule)
    cfg = flagship_cfg()
    cfg.tpu.bf16 = bf16
    if kind == "vae":
        gen = torch.Generator(device="cuda").manual_seed(22)
        cfg.ddpm.loss_type = "l1_sum"
        cfg.trainer.anneal_kl = 1
        with torch.device("cuda"):
            vae = VAE(cfg)
        init_weights(vae, torch.Generator().manual_seed(0))
        damp_style_head(vae)
        step = make_vae_train_step(vae, num_total_iter=1000)
        names = [n for n, _ in vae.named_parameters()]
        return step, names, stage1_batch(batch, vae.num_points), gen
    gen = torch.Generator(device="cuda").manual_seed(21)
    if kind == "weighted":
        cfg = weighted_cfg(cfg)
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0))
    step = make_prior_train_step(
        lion, warmup_cosine_schedule(2e-4, 2e-4, 10, 10, 1, 10))
    names = [f"{p}.{k}" for p in ("global_prior", "local_prior")
             for k, _ in getattr(lion, p).named_parameters()]
    x = torch.randn(batch, lion.num_points, 3, generator=gen,
                    device="cuda") * 0.3
    return step, names, x, gen


def step_twice(kind: str, bf16: bool, batch: int):
    """One step of `train_step_of(kind, bf16, batch)` on two fresh copies
    -> (the names of the parameters or EMA tensors that differ, the two
    losses). Raises when a loss is not finite (NaN is never equal)."""
    runs = []
    for _ in range(2):
        step, names, x, gen = train_step_of(kind, bf16, batch)
        loss = float(step(x, gen)["loss"])
        if not np.isfinite(loss):
            raise SystemExit(f"profile_step: {kind} step's loss is {loss}")
        runs.append(([p.detach().clone() for p in step.params],
                     [e.clone() for e in step.ema.shadow], loss))
        del step, x
    torch.cuda.synchronize()
    (p0, e0, l0), (p1, e1, l1) = runs
    differ = [n for n, a, b in zip(names, p0, p1) if not torch.equal(a, b)]
    differ += [f"ema {n}" for n, a, b in zip(names, e0, e1)
               if not torch.equal(a, b)]
    return differ, (l0, l1)


REPEAT_CASES = (("prior", False, 16), ("vae", False, 32),
                ("weighted", False, 16), ("prior", True, 16),
                ("vae", True, 32))


def repeat_steps(only=None) -> None:
    """`only`: the kinds of REPEAT_CASES to run (all by default)."""
    print(f"[setup] {torch.cuda.get_device_name(0)}, each training step "
          f"twice from the same state and draws")
    for kind, bf16, batch in REPEAT_CASES:
        if only and kind not in only:
            continue
        differ, losses = step_twice(kind, bf16, batch)
        print(f"[repeat] {kind} {'bf16' if bf16 else 'fp32'} B{batch}: "
              f"{'bit-equal' if not differ else 'DIFFERS'}; losses "
              f"{losses}; {len(differ)} tensors differ"
              + (f" (first: {differ[:6]})" if differ else ""))
    step, _, x, gen = train_step_of("vae", False, 32)
    wall, groups = _device_groups(lambda: step(x, gen), 2)
    wgrad = groups.get("K conv3d_weight_grad", [0.0, 0])
    print(f"[repeat] stage-1 fp32 B32 step: wall {wall:.3f} ms, device "
          f"{sum(v[0] for v in groups.values()):.3f} ms, K10's weight "
          f"gradient {wgrad[0]:.3f} ms in {wgrad[1]} launches")


def profile_train(batch: int, steps: int, bf16: bool = False) -> None:
    from .trainers import prior_loss
    step, _, x, gen = train_step_of("prior", bf16, batch)
    lion = step.lion
    print(f"[setup] {torch.cuda.get_device_name(0)}, train step, batch "
          f"{batch}, {'bf16' if bf16 else 'fp32'}, {steps} profiled steps "
          f"per window")
    for _ in range(2):
        step(x, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(x, gen)
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / steps * 1e3
    print(f"[train] step without the profiler: {plain_wall:.3f} ms, "
          f"{batch / plain_wall * 1e3:.3f} samples/s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")

    lion.vae.eval()   # frozen, as the step runs it

    def encode():
        with torch.no_grad():
            lion.vae.encode(x, gen)

    def forward():
        prior_loss(lion, x, gen)

    wall_e, enc = _device_groups(encode, steps)
    wall_f, fwd = _device_groups(forward, steps)
    wall_s, full = _device_groups(lambda: step(x, gen), steps)
    busy = sum(v[0] for v in full.values())
    k10 = full.get("K conv3d_3x3_same", [0.0, 0])
    k10_fwd = fwd.get("K conv3d_3x3_same", [0.0, 0])
    print(f"[train] step: wall {wall_s:.3f} ms, device {busy:.3f} ms, busy "
          f"share {busy / wall_s:.3f}, "
          f"{sum(v[1] for v in full.values())} device ops; "
          f"{batch / wall_s * 1e3:.3f} samples/s under the profiler")
    print(f"[train] encode window: wall {wall_e:.3f} ms, device "
          f"{sum(v[0] for v in enc.values()):.3f} ms; forward window: wall "
          f"{wall_f:.3f} ms, device {sum(v[0] for v in fwd.values()):.3f} ms")
    print(f"[train]   {k10_fwd[0]:8.3f} ms  {k10_fwd[1]:5d} ops  K10 forward")
    print(f"[train]   {k10[0] - k10_fwd[0]:8.3f} ms  "
          f"{k10[1] - k10_fwd[1]:5d} ops  K10 dx")
    enc_ours = {k: v for k, v in enc.items() if k.startswith("K ")}
    print(f"[train]   {sum(v[0] for v in enc_ours.values()):8.3f} ms  "
          f"{sum(v[1] for v in enc_ours.values()):5d} ops  the encode's "
          f"kernels ({', '.join(sorted(enc_ours))})")
    for name, (ms, n) in sorted(full.items(), key=lambda kv: -kv[1][0]):
        print(f"[train]   {ms:8.3f} ms  {n:5d} ops  {name} (whole step)")


def profile_vae_train(batch: int, steps: int, bf16: bool = False) -> None:
    # At random weights some clouds overflow the VAE's latents (sigma =
    # exp(log_sigma) > 3e38); such a step is non-finite in the JAX package
    # too, and is refused here
    step, _, x, gen = train_step_of("vae", bf16, batch)
    print(f"[setup] {torch.cuda.get_device_name(0)}, stage-1 VAE step, "
          f"batch {batch}, {'bf16' if bf16 else 'fp32'}, {steps} profiled "
          f"steps per window")

    def forward():
        step.loss(x, gen)

    def whole():
        step(x, gen)

    for _ in range(2):
        loss = float(step(x, gen)["loss"])
        if not np.isfinite(loss):
            raise SystemExit(f"profile_step: the stage-1 step's loss is "
                             f"{loss} at these weights and inputs")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(steps):
        whole()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    wall_f, fwd = _device_groups(forward, steps)
    wall_s, full = _device_groups(whole, steps)
    busy = sum(v[0] for v in full.values())
    k10 = full.get("K conv3d_3x3_same", [0.0, 0])
    k10_fwd = fwd.get("K conv3d_3x3_same", [0.0, 0])
    print(f"[vae train] step without the profiler: {plain_wall:.3f} ms, "
          f"{batch / plain_wall * 1e3:.3f} samples/s; peak device memory "
          f"{peak:.3f} GiB")
    print(f"[vae train] step: wall {wall_s:.3f} ms, device {busy:.3f} ms, "
          f"busy share {busy / wall_s:.3f}, "
          f"{sum(v[1] for v in full.values())} device ops; forward window: "
          f"wall {wall_f:.3f} ms, device "
          f"{sum(v[0] for v in fwd.values()):.3f} ms")
    print(f"[vae train]   {k10_fwd[0]:8.3f} ms  {k10_fwd[1]:5d} ops  K10 "
          f"forward")
    print(f"[vae train]   {k10[0] - k10_fwd[0]:8.3f} ms  "
          f"{k10[1] - k10_fwd[1]:5d} ops  K10 dx")
    for name, (ms, n) in sorted(full.items(), key=lambda kv: -kv[1][0]):
        print(f"[vae train]   {ms:8.3f} ms  {n:5d} ops  {name} (whole step)")


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _oidhw(w):
    return w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)


def profile_convs(batch: int, steps: int, only=None) -> None:
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def device_ms(fn):
        return sum(v[0] for v in _device_groups(fn, steps)[1].values())

    print(f"[setup] {torch.cuda.get_device_name(0)}, batch {batch}, "
          f"{steps} profiled calls per case")
    if only != "wgrad":
        profile_k4_k10(batch, device_ms, randn)
        profile_pair(batch, device_ms, randn)
    profile_wgrad(device_ms, randn)


def profile_wgrad(device_ms, randn) -> None:
    """K10's weight gradient at the training cells' shapes beside cuDNN's
    conv3d_weight (fp32, TF32 off), and each step's total."""
    from . import ops
    for step, calls in WGRAD_STEPS.items():
        total = [0.0, 0.0]
        for (b, r, ci, co), n in calls.items():
            x, gy = randn(b, r, r, r, ci), randn(b, r, r, r, co)
            k = device_ms(functools.partial(ops.conv3d_weight_grad, x, gy))
            c = device_ms(functools.partial(
                torch.nn.grad.conv3d_weight, _ncdhw(x), (co, ci, 3, 3, 3),
                _ncdhw(gy), padding=1))
            bound = 2 * 27 * ci * co * b * r ** 3 / 67e12 * 1e3
            total[0] += n * k
            total[1] += n * c
            print(f"[wgrad] {step} r{r} C{ci}->{co} x{n}: kernel {k:.4f} "
                  f"ms, cuDNN {c:.4f} ms (device), bound {bound:.4f} ms "
                  f"(FFMA), {bound / k:.1%} of it")
            del x, gy
        print(f"[wgrad] {step}: kernel {total[0]:.2f} ms a step, cuDNN "
              f"{total[1]:.2f} ms")


def profile_k4_k10(batch, device_ms, randn) -> None:
    """K4's and K10's cases beside cuDNN's conv (dx: conv3d_input)."""
    import torch.nn.functional as F
    from . import ops
    cases = []
    for r, ci, co, dt, pro in K4_CASES:
        x = randn(batch, r, r, r, ci).to(dt)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dt)
        sc = 1.0 + randn(batch, ci, scale=0.1) if pro else None
        sh = randn(batch, ci, scale=0.1) if pro else None
        label = (f"K4 {'bf16' if dt == torch.bfloat16 else 'fp32'} r{r} "
                 f"C{ci}->{co}{' affine+swish' if pro else ''}")
        cases.append((label, functools.partial(
            ops.conv3d_3x3_fused, x, w, sc, sh, pre_swish=pro),
            functools.partial(F.conv3d, _ncdhw(x), _oidhw(w), padding=1)))
    for r, ci, co in K10_CASES:
        x = randn(batch, r, r, r, ci)
        w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5)
        cases.append((f"K10 r{r} C{ci}->{co}", functools.partial(
            ops.KERNELS["conv3d_3x3_same"], x, w),
            functools.partial(F.conv3d, _ncdhw(x), _oidhw(w), padding=1)))
    gy = randn(batch, 32, 32, 32, 64)
    w = randn(3, 3, 3, 64, 64, scale=(27 * 64) ** -0.5)
    cases.append(("K10 dx r32 C64", functools.partial(
        ops.KERNELS["conv3d_3x3_same"], gy,
        w.flip(0, 1, 2).transpose(3, 4).contiguous()),
        functools.partial(torch.nn.grad.conv3d_input, _ncdhw(gy).shape,
                          _oidhw(w), _ncdhw(gy), padding=1)))
    for label, ours, cudnn in cases:
        k, c = device_ms(ours), device_ms(cudnn)
        print(f"[convs] {label} B{batch}: kernel {k:.4f} ms, cuDNN {c:.4f} "
              f"ms (device), ratio {k / c:.2f}")


def profile_pair(batch, device_ms, randn) -> None:
    """K8 beside two cuDNN convs, and K9."""
    import torch.nn.functional as F
    from . import ops
    from .ops.voxel import normalize_coords
    bf = torch.bfloat16
    c = 64
    x = randn(batch, 32, 32, 32, c).to(bf)
    w = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(bf)
    pair = (x, w, randn(c, scale=0.1), 1.0 + randn(batch, c, scale=0.1),
            randn(batch, c, scale=0.1), w)
    xc, wc = _ncdhw(x), _oidhw(w)
    two = device_ms(lambda: (F.conv3d(xc, wc, padding=1),
                             F.conv3d(xc, wc, padding=1)))
    k = device_ms(functools.partial(ops.conv3d_pair, *pair))
    print(f"[convs] K8 bf16 r32 C64 B{batch}: kernel {k:.4f} ms, two cuDNN "
          f"convs {two:.4f} ms (device), ratio {k / two:.2f}")
    c = 128
    w = randn(3, 3, 3, c, c, scale=(27 * c) ** -0.5).to(bf)
    for b in (batch, 1):   # batch 1: one cluster's latency
        nc = normalize_coords(randn(b, 256, 3, scale=0.3), 8).contiguous()
        block = (randn(b, 256, c).to(bf), torch.round(nc).to(torch.int32),
                 nc, w, randn(c, scale=0.1), 1.0 + randn(b, c, scale=0.1),
                 randn(b, c, scale=0.1), w, 8)
        k = device_ms(functools.partial(ops.pvconv_block_pair, *block))
        print(f"[convs] K9 bf16 r8 C128 N256 B{b}: kernel {k:.4f} ms "
              f"(device)")


# (N, M) of K1 at the local step's four levels (models/priors.py)
FPS_LEVELS = ((2048, 1024), (1024, 256), (256, 64), (64, 16))


# one block of the evaluation's EMD matrix (eval/metrics.py EMD_BLOCK)
EMD_PAIRS = (16, 33)
# (r, C, N) at which the local step's PVConvs devoxelize (K5): SA0-SA2's
# convs at N 2048, 1024, 256 and FP3-FP0's at 2048, 1024, 256, 64
# (models/priors.py); the bf16 step runs K9 in place of K5 at r8 C128
# where C_in == C_out
DEVOX_LEVELS = ((32, 32, 2048), (32, 64, 2048), (16, 64, 1024),
                (16, 128, 1024), (8, 128, 256), (8, 128, 64))


def devox_level_inputs(batch, randn, dtype):
    """[(label, (grid, norm_coords, r), (scale, bias))] of K5 at the
    DEVOX_LEVELS: a random grid of `dtype`, the normalized coordinates of
    a random cloud, and a per-(item, channel) affine."""
    from .ops.voxel import normalize_coords
    out = []
    for r, c, n in DEVOX_LEVELS:
        nc = normalize_coords(randn(batch, n, 3, scale=0.3), r).contiguous()
        out.append((f"r{r} C{c} N{n}",
                    (randn(batch, r, r, r, c).to(dtype), nc, r),
                    (1.0 + randn(batch, c, scale=0.2),
                     randn(batch, c, scale=0.2))))
    return out


def fps_level_inputs(batch, randn):
    """[(N, M, cloud)] of the four levels: a random cloud of 2048 points,
    then each level's cloud is the previous level's picks (the plain
    version's, on the card)."""
    from . import ops
    cloud = randn(batch, FPS_LEVELS[0][0], 3, scale=0.3)
    out = []
    for n, m in FPS_LEVELS:
        out.append((n, m, cloud))
        cloud = ops.KERNELS["fps"].plain(cloud, m)[1].contiguous()
    return out


# (N, M, C, radius) of K2 at the local step's four SA levels (K = 32) and
# C of K6 at its four FP levels (nn/unet.py: 128 features beside the 64-d
# time embedding, but SA0's 32 features)
SA_LEVELS = ((2048, 1024, 32, 0.1), (1024, 256, 64, 0.2),
             (256, 64, 128, 0.4), (64, 16, 192, 0.8))
FP_C = 192


def bqg_level_inputs(batch, randn):
    """[(label, (points, centers, features, radius, K))] of K2 at the four
    SA levels, on fps_level_inputs' clouds and their picks."""
    from . import ops
    out = []
    for (n, m, cloud), (_, _, c, r) in zip(fps_level_inputs(batch, randn),
                                           SA_LEVELS):
        centers = ops.KERNELS["fps"].plain(cloud, m)[1].contiguous()
        out.append((f"N{n} M{m} C{c} r{r}",
                    (cloud, centers, randn(batch, n, c), r, 32)))
    return out


def three_nn_level_inputs(batch, randn):
    """[(label, (points, centers, features))] of K6 at the four FP levels
    (points: a level's cloud, centers: its picks), fp32 features."""
    from . import ops
    return [(f"N{n} M{m} C{FP_C}",
             (cloud, ops.KERNELS["fps"].plain(cloud, m)[1].contiguous(),
              randn(batch, m, FP_C)))
            for n, m, cloud in fps_level_inputs(batch, randn)]


def _split_cases(batch, randn):
    """(label, call) of K1 at its four levels, K2 and K11 at the four SA
    levels, K6 at the four FP levels (fp32 and bf16), K13 at the first
    three SA levels (fp32 and bf16), K7
    at SA0 and SA3 (K = 32; bf16 local step's widths) and K3 at r32 C64
    (its wrapper without the autograd Function, as chip_smoke.py times it),
    on random inputs at the batch."""
    from . import ops
    from .eval.metrics import block_pairs
    from .ops.voxel import normalize_coords
    bf = torch.bfloat16

    def sa(n, m, widths, radius):
        pts = randn(batch, n, 3, scale=0.3)
        ctr = ops.KERNELS["fps"].plain(pts, m)[1]
        args = (pts, ctr, randn(batch, n, widths[0]),
                -(ctr @ randn(3, widths[0], scale=0.5)).contiguous(),
                [randn(ci, co, scale=ci ** -0.5).to(bf)
                 for ci, co in zip(widths[:-1], widths[1:])],
                [randn(co, scale=0.1) for co in widths[1:]],
                [1.0 + randn(batch, co, scale=0.2) for co in widths],
                [randn(batch, co, scale=0.2) for co in widths], radius, 32)
        return functools.partial(ops.sa_fused, *args)

    vox = torch.round(normalize_coords(randn(batch, 2048, 3, scale=0.3),
                                       32)).to(torch.int32)
    f64 = randn(batch, 2048, 64)
    fps = [(f"K1 N{n}->M{m}", functools.partial(ops.KERNELS["fps"], c, m))
           for n, m, c in fps_level_inputs(batch, randn)]
    bqg = [(f"K2 {label}", functools.partial(ops.KERNELS["ball_query_group"],
                                             *args))
           for label, args in bqg_level_inputs(batch, randn)]
    nn = [(f"K6 {name} {label}",
           functools.partial(ops.KERNELS["three_nn_interpolate"], p, c,
                             f.to(dt)))
          for label, (p, c, f) in three_nn_level_inputs(batch, randn)
          for name, dt in (("fp32", torch.float32), ("bf16", bf))]
    k11 = [(f"K11 {label}", functools.partial(ops.KERNELS["ball_query"], c,
                                               p, r, k))
           for label, (p, c, _, r, k) in bqg_level_inputs(batch, randn)]
    k13 = [(f"K13 {name} {label}", functools.partial(
        ops.KERNELS["ball_query_group_cf"], p, c, f.to(dt), r, k))
        for label, (p, c, f, r, k) in bqg_level_inputs(batch, randn)[:3]
        for name, dt in (("fp32", torch.float32), ("bf16", bf))]
    return fps + bqg + nn + k11 + k13 + [
            ("K7 SA0 N2048 M1024 K32 C32,64", sa(2048, 1024, (32, 64), 0.1)),
            ("K7 SA3 N64 M16 K32 C128x3", sa(64, 16, (128,) * 3, 0.8)),
            ("K3 fp32 N2048 r32 C64",
             functools.partial(ops.KERNELS["avg_voxelize"], f64, vox, 32)),
            ("K3 bf16 N2048 r32 C64",
             functools.partial(ops.KERNELS["avg_voxelize"], f64.to(bf), vox,
                               32))] + _devox_cases(batch, randn) + [
            (f"K12 {EMD_PAIRS[0]} x {EMD_PAIRS[1]} pairs N2048 M2048",
             functools.partial(ops.emd_cost, randn(EMD_PAIRS[0], 2048, 3,
                                                   scale=0.3),
                               randn(EMD_PAIRS[1], 2048, 3, scale=0.3),
                               block_pairs(0, 0, *EMD_PAIRS, "cuda")))]


def _devox_cases(batch, randn):
    """(label, call) of K5 at the DEVOX_LEVELS in fp32 and bf16: alone, then
    followed by the per-(item, channel) affine as PVConv applied it before
    K5 took it (`pts.float() * scale + bias`, cast to the dtype), then with
    the affine in its epilogue where the wrapper takes one (`--split` also
    reads a checkout of an older tree)."""
    import inspect

    from . import ops
    k5 = ops.KERNELS["trilinear_devoxelize"]
    epilogue = "scale" in inspect.signature(k5).parameters
    cases = []
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for label, args, (sc, bi) in devox_level_inputs(batch, randn, dt):
            def then_affine(args=args, sc=sc, bi=bi, dt=dt):
                return (k5(*args).float() * sc[:, None] + bi[:, None]).to(dt)
            cases += [(f"K5 {name} {label}", functools.partial(k5, *args)),
                      (f"K5 + affine {name} {label}", then_affine)]
            if epilogue:
                cases.append((f"K5 epilogue {name} {label}",
                              functools.partial(k5, *args, sc, bi)))
    return cases


def profile_split(batch: int, steps: int, only=None) -> None:
    import time
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    print(f"[setup] {torch.cuda.get_device_name(0)}, batch {batch}, bf16 K7, "
          f"{steps} profiled calls per case")
    for label, fn in _split_cases(batch, randn):
        if only and not label.startswith(tuple(only)):
            continue
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / steps
        end.record()
        torch.cuda.synchronize()
        events = start.elapsed_time(end) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        names = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", 0.0)
            if dev_us > 0 and \
                    ev.device_type == torch.autograd.DeviceType.CUDA:
                names[ev.key] = (dev_us / 1e3 / steps, ev.count // steps)
        device = sum(v[0] for v in names.values())
        print(f"[split] {label} B{batch}: events {events:.4f} ms, device "
              f"{device:.4f} ms, host enqueue {host:.4f} ms per call")
        for name, (ms, n) in sorted(names.items(), key=lambda kv: -kv[1][0]):
            print(f"[split]   {ms:8.4f} ms  {n:3d} x  {name[:90]}")
        # the launches of one call in order (the last call of the window)
        launches = sorted((e for e in prof.events()
                           if e.device_type == torch.autograd.DeviceType.CUDA),
                          key=lambda e: e.time_range.start)
        per_call = sum(v[1] for v in names.values())
        print("[split]   in order: " + ", ".join(
            f"{e.time_range.elapsed_us() / 1e3:.4f}"
            for e in launches[-per_call:]) + " ms")
    _split_step(batch, steps, bf16=True)
    _split_step(4, steps, bf16=False)


def _takes_plan(source, name) -> bool:
    """Whether the C entry `name` of `source` (None: the library's) takes
    the arguments `_cuda._SIGNATURES` gives it, the plan among them; a
    copy of an older design's source may take none."""
    import re
    from pathlib import Path
    from .ops import _cuda
    decl = source and re.search(rf"LION_EXPORT int {name}\(([^)]*)\)",
                                Path(source).read_text())
    return not decl or decl.group(1).count(",") + 1 == len(
        _cuda._SIGNATURES[name])


def profile_plans(batch: int, steps: int, source=None, only=None) -> None:
    """K6 (fp32) at the four FP levels on every plan (threads, lanes), K2
    and K11 at the four SA levels on every plan (centers a block, threads)
    and K13 (fp32 and bf16) at the first three on every plan (centers a
    block, slot groups): device ms, and whether the output equals the
    wrapper's plan's bit for bit; the wrapper's plan is starred. Then K6
    and K2 on the wrapper's plan at the top level's N and M with the output
    cut to 3 floats a row (C = 0: the scan alone) and with the scan cut
    short (K6: M = 4 centers; K2: a cloud of 128 points: the output alone).
    With `source`, the kernels of that file (a patched copy of
    csrc/three_nn.cu, ball_query_group.cu, ball_query.cu or
    ball_query_group_cf.cu, built on its own; its includes resolve against
    its own directory, then csrc/) are timed instead of the library's, and
    a K11 or K13 whose entry takes no plan (an older design) once a level;
    the references stay the library's. `only` keeps the kernels named
    (e.g. ('K11', 'K13'))."""
    from pathlib import Path
    from .ops import _cuda
    from .ops._cuda import ptr, stream_of
    from .ops.interpolate import three_nn_interpolate, three_nn_plan
    from .ops.points import (_r2, ball_query, ball_query_group_cf_kernel,
                             ball_query_group_kernel, bq_plan, bqg_cf_plan,
                             bqg_plan)
    lib = _cuda.build_probe(Path(source)) if source else _cuda.library()
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def device_ms(fn):
        return sum(v[0] for v in _device_groups(fn, steps)[1].values())

    def entry(name, *args):
        """The entry with `args`, the stream last; an entry that takes no
        plan gets the signature's first arguments and the stream."""
        fn = getattr(lib, name, None)
        if fn is None:
            return None
        sig = _cuda._SIGNATURES[name]
        fn.argtypes = sig[:len(args) - 1] + sig[-1:] if args else sig
        return functools.partial(fn, *args)

    def row(plan, chosen, fn, out, ref):
        fn()
        same = torch.equal(out, ref)
        mark = ("" if same else " DIFFERS") + (" *" if plan == chosen else "")
        return "x".join(map(str, plan)) + f" {device_ms(fn):.4f}{mark}"

    def k6(p, c, f, plan):
        (b, n, _), (m, ch) = p.shape, f.shape[1:]
        out = torch.empty(b, n, ch, device="cuda")
        return out, entry("lion_three_nn_interpolate", ptr(p), ptr(c), ptr(f),
                          ptr(out), None, None, b, n, m, ch, 0, *plan,
                          stream_of(p))

    def k2(p, c, f, r, k, plan):
        (b, n, _), m, ch = p.shape, c.shape[1], f.shape[2]
        out = torch.empty(b, m, k, 3 + ch, device="cuda")
        return out, entry("lion_ball_query_group", ptr(p), ptr(c), ptr(f),
                          ptr(out), b, n, m, ch, k, _r2(r), 0, *plan,
                          stream_of(p))

    print(f"[setup] {torch.cuda.get_device_name(0)}, batch {batch}, "
          f"{steps} profiled calls per plan"
          + (f", kernels from {source}" if source else ""))
    nn = three_nn_level_inputs(batch, randn)
    def wanted(tag, name):
        return entry(name) is not None and (not only or tag in only)

    if wanted("K6", "lion_three_nn_interpolate"):
        for label, (p, c, f) in nn:
            chosen = three_nn_plan(p.shape[0], p.shape[1])
            ref = three_nn_interpolate(p, c, f)
            rows = [row((threads, lanes), chosen,
                        *k6(p, c, f, (threads, lanes))[::-1], ref)
                    for threads in (32, 64, 128, 256)
                    for lanes in (1, 2, 4, 8, 16, 32)]
            print(f"[plans] K6 fp32 {label} B{batch} (threads x lanes ms): "
                  + ", ".join(rows))
        p, c, f = nn[0][1]
        plan = three_nn_plan(p.shape[0], p.shape[1])
        parts = [("full", (p, c, f)), ("C 0", (p, c, f[..., :0])),
                 ("M 4", (p, c[:, :4].contiguous(),
                          f[:, :4].contiguous()))]
        print(f"[plans] K6 fp32 {nn[0][0]} B{batch} on {plan}: " + ", ".join(
            f"{name} {device_ms(k6(*args, plan)[1]):.4f}"
            for name, args in parts) + " ms")
    bq = bqg_level_inputs(batch, randn)
    if wanted("K2", "lion_ball_query_group"):
        for label, (p, c, f, r, k) in bq:
            (b, n, _), m, ch = p.shape, c.shape[1], f.shape[2]
            cpb0, threads0, tile, _ = bqg_plan(b, n, m, ch, k)
            ref = ball_query_group_kernel(p, c, f, r, k)
            rows = [row((cpb, threads), (cpb0, threads0),
                        *k2(p, c, f, r, k, (cpb, threads, tile))[::-1], ref)
                    for cpb in (1, 2, 4, 8, 16, 32)
                    for threads in (64, 128, 256)]
            print(f"[plans] K2 {label} B{batch} (centers x threads ms): "
                  + ", ".join(rows))
        p, c, f, r, k = bq[0][1]
        (b, n, _), m = p.shape, c.shape[1]
        plan = bqg_plan(b, n, m, f.shape[2], k)[:3]
        parts = [("full", (p, c, f)), ("C 0", (p, c, f[..., :0])),
                 ("N 128", (p[:, :128].contiguous(), c,
                            f[:, :128].contiguous()))]
        print(f"[plans] K2 {bq[0][0]} B{batch} on {plan}: " + ", ".join(
            f"{name} {device_ms(k2(*args, r, k, plan)[1]):.4f}"
            for name, args in parts) + " ms")

    def k11(p, c, r, k, plan):
        (b, n, _), m = p.shape, c.shape[1]
        out = torch.empty(b, m, k, dtype=torch.int32, device="cuda")
        return out, entry("lion_ball_query", ptr(c), ptr(p), ptr(out), b, n,
                          m, k, _r2(r), *plan, stream_of(p))

    def k13(p, c, f, r, k, plan):
        (b, n, _), m, ch = p.shape, c.shape[1], f.shape[2]
        out = torch.empty(b, k, 3 + ch, m, dtype=f.dtype, device="cuda")
        return out, entry("lion_ball_query_group_cf", ptr(p), ptr(c), ptr(f),
                          ptr(out), b, n, m, ch, k, _r2(r),
                          int(f.dtype == torch.bfloat16), *plan, stream_of(p))

    if wanted("K11", "lion_ball_query"):
        planned = _takes_plan(source, "lion_ball_query")
        for label, (p, c, _, r, k) in bq:
            (b, n, _), m = p.shape, c.shape[1]
            cpb0, threads0, tile, _ = bq_plan(b, n, m, k)
            ref = ball_query(c, p, r, k)
            plans = [(cpb, threads, tile) for cpb in (1, 2, 4, 8, 16, 32)
                     for threads in (32, 64, 128, 256)] if planned else [()]
            rows = [row(plan[:2], (cpb0, threads0),
                        *k11(p, c, r, k, plan)[::-1], ref) for plan in plans]
            print(f"[plans] K11 {label} B{batch} "
                  + ("(centers x threads ms): " if planned
                     else "(its own design, ms): ") + ", ".join(rows))
    if wanted("K13", "lion_ball_query_group_cf"):
        planned = _takes_plan(source, "lion_ball_query_group_cf")
        for label, (p, c, f, r, k) in bq[:3]:
            for dt in (torch.float32, torch.bfloat16):
                x = f.to(dt)
                (b, n, _), m, ch = p.shape, c.shape[1], f.shape[2]
                cpb0, groups0, threads, tile, _ = bqg_cf_plan(
                    b, n, m, ch, k, x.element_size())
                ref = ball_query_group_cf_kernel(p, c, x, r, k)
                plans = [(cpb, groups, threads, tile)
                         for cpb in (4, 8, 16, 32) for groups in (1, 2, 4, 8)
                         ] if planned else [()]
                rows = [row(plan[:2], (cpb0, groups0),
                            *k13(p, c, x, r, k, plan)[::-1], ref)
                        for plan in plans]
                print(f"[plans] K13 {str(dt)[6:]} {label} B{batch} "
                      + ("(centers x groups ms): " if planned
                         else "(its own design, ms): ") + ", ".join(rows))
        p, c, f, r, k = bq[0][1]
        for dt in (torch.float32, torch.bfloat16):
            x = f.to(dt)
            plan = bqg_cf_plan(*p.shape[:2], c.shape[1], f.shape[2], k,
                               x.element_size())[:4] if planned else ()
            parts = [("full", (p, c, x)), ("C 0", (p, c, x[..., :0])),
                     ("N 128", (p[:, :128].contiguous(), c,
                                x[:, :128].contiguous()))]
            print(f"[plans] K13 {str(dt)[6:]} {bq[0][0]} B{batch} on "
                  f"{plan}: " + ", ".join(
                      f"{name} {device_ms(k13(*args, r, k, plan)[1]):.4f}"
                      for name, args in parts) + " ms")


# the wrappers whose device time per local step --split sums: K1, K2, K4,
# K5, K6, K8, K9 (K2 runs on the fp32 path, K8 and K9 on the bf16 path)
_SPLIT_STEP = ("fps", "ball_query_group", "conv3d_3x3_fused",
               "trilinear_devoxelize", "three_nn_interpolate", "conv3d_pair",
               "pvconv_block_pair")


def _split_step(batch: int, steps: int, bf16: bool) -> None:
    """The kernels' device ms and launches per local step at the batch, in
    bf16 or fp32."""
    from .config import flagship_cfg
    from .models import LION
    cfg = flagship_cfg()
    cfg.tpu.bf16 = bf16
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    z = torch.randn(batch, lion.style_dim, generator=g, device="cuda")
    x = torch.randn(batch, lion.num_points, lion.point_channels,
                    generator=g, device="cuda")
    noise = torch.randn_like(x)
    with torch.no_grad():
        wall, groups = _device_groups(lambda: lion.diffusion._ancestral_step(
            lambda xx, t: lion.local_prior(xx, t, condition_input=z), x,
            500, noise), steps)
    parts = {k: groups.get(f"K {k}", [0.0, 0]) for k in _SPLIT_STEP}
    parts["torch elementwise"] = groups.get("torch elementwise", [0.0, 0])
    device = sum(v[0] for v in groups.values())
    print(f"[split] {'bf16' if bf16 else 'fp32'} local step B{batch}: device "
          f"{device:.3f} ms, {sum(v[1] for v in groups.values())} device "
          f"ops, wall {wall:.3f} ms; kernels " + ", ".join(
              f"{k} {v[0]:.3f} ({v[1]} ops)" for k, v in parts.items()))


def profile_fps_clock(batch: int, steps: int) -> None:
    """K1's plans at the four levels, timed and split by the probe."""
    import ctypes
    from . import ops
    from .ops import _cuda
    from .ops.points import FPS_MAX_P, FPS_MAX_THREADS, fps_plan
    lib = _cuda.build_probe(_cuda.CSRC / "probe" / "fps_probe.cu")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.lion_fps_on_plan.argtypes = (vp, vp, vp) + (i32,) * 5 + (vp,)
    lib.lion_fps_probe.argtypes = (vp, vp, vp) + (i32,) * 5 + (vp, vp)
    lib.lion_fps_empty_rounds.argtypes = (i32, i32, i32, vp, vp, vp)
    lib.lion_fps_plan.argtypes = (i32, ctypes.POINTER(i32))
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: CUDA error {err}")

    stream = torch.cuda.current_stream().cuda_stream
    print(f"[setup] {torch.cuda.get_device_name(0)}, batch {batch}, K1 "
          f"plans, {4 * steps} timed calls each")
    for n, m, xyz in fps_level_inputs(batch, randn):
        ref = ops.fps(xyz, m)[0]
        plan = fps_plan(n)[:2]
        t = i32(0)
        assert (lib.lion_fps_plan(n, ctypes.byref(t)), t.value) == \
            plan[::-1], "the probe's plan is not ops.points.fps_plan's"
        p = 1
        while p <= FPS_MAX_P:
            threads = 32 * -(-n // (32 * p))
            if threads > FPS_MAX_THREADS or (threads == 32 and p > 1
                                             and 16 * p >= n):
                p *= 2
                continue
            idx = torch.empty_like(ref)
            ctr = torch.empty(batch, m, 3, device="cuda")
            args = (xyz.data_ptr(), idx.data_ptr(), ctr.data_ptr(), batch,
                    n, m, threads, p)

            def run():
                check(lib.lion_fps_on_plan(*args, stream), "lion_fps_on_plan")
            for _ in range(3):
                run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(4 * steps):
                run()
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end) / (4 * steps)
            same = torch.equal(idx, ref)
            stamps = torch.zeros(12, dtype=torch.int32, device="cuda")
            check(lib.lion_fps_probe(*args, stamps.data_ptr(), stream),
                  "lion_fps_probe")
            torch.cuda.synchronize()
            us = ms * 1e3 / max(m - 1, 1)
            split = []
            for who, st in (("thread 0", stamps[:6]),
                            ("last warp", stamps[6:])):
                st = st.cpu().double()
                picks = float(st[5])
                # the tail runs from the second pick on
                per = [float(st[0]) / max(picks - 1, 1)] + [
                    float(v) / max(picks, 1) for v in st[1:5]]
                split.append(f"{who} {sum(per):.1f} = " + ", ".join(
                    f"{k} {v:.1f}" for k, v in zip(
                        ("tail", "update", "warp", "barrier", "fold"), per)))
            print(f"[fps-clock] N{n}->M{m} threads {threads} P {p}"
                  f"{' (plan)' if (threads, p) == plan else ''}: events "
                  f"{ms:.4f} ms, {us:.4f} us a pick, indices equal K1's "
                  f"{same}; cycles a pick: " + "; ".join(split))
            if not same:
                raise AssertionError(f"N{n} plan ({threads}, {p}) differs")
            p *= 2
    n, m = FPS_LEVELS[0]
    plan_threads = fps_plan(n)[0]
    out = torch.empty(batch * FPS_MAX_THREADS, dtype=torch.int32,
                      device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    lib.lion_fps_latency.argtypes = (i32, i32, i32, i32, vp, vp, vp)
    for threads in (32, 256, 512, 1024):
        def rounds():
            check(lib.lion_fps_empty_rounds(batch, threads, m, out.data_ptr(),
                                            cycles.data_ptr(), stream),
                  "lion_fps_empty_rounds")
        for _ in range(3):
            rounds()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(4 * steps):
            rounds()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (4 * steps)
        print(f"[fps-clock] chain floor N{n}->M{m}: {m - 1} empty rounds on "
              f"{threads} threads{' (the plan)' if threads == plan_threads else ''}"
              f", {float(cycles[0]) / (m - 1):.1f} cycles a round, events "
              f"{ms:.4f} ms")
        line = []
        for kind, name in enumerate(("redux.sync", "shared load",
                                     "barrier")):
            check(lib.lion_fps_latency(kind, batch, threads, 1024,
                                       out.data_ptr(), cycles.data_ptr(),
                                       stream), "lion_fps_latency")
            torch.cuda.synchronize()
            line.append(f"{name} {float(cycles[0]) / 1024:.1f}")
        print(f"[fps-clock] cycles a dependent step on {threads} threads: "
              + ", ".join(line))


def given_noise_samples(path: str) -> None:
    """A 10-step `LION.sample` under `given_noise` on the fp32 path (batch
    4) and the bf16 path (batch 16), with the weights and noise of
    chip_smoke.py phase 4; writes the outputs to `path` or, when it
    exists, compares them with its contents bit for bit (a run of another
    tree writes it)."""
    import os

    import numpy as np

    from .config import flagship_cfg
    from .models import LION
    outs = {}
    for bf16, batch in ((False, 4), (True, 16)):
        cfg = flagship_cfg()
        cfg.tpu.bf16 = bf16
        cfg.ddpm.num_steps = 10
        lion = LION(cfg).init_params(torch.Generator().manual_seed(3))
        rs = np.random.RandomState(12)
        noise = tuple(
            (torch.from_numpy(rs.randn(batch, d).astype(np.float32)).cuda(),
             torch.from_numpy(rs.randn(10, batch, d).astype(np.float32))
             .cuda())
            for d in (lion.style_dim, lion.local_dim))
        out = lion.sample(batch, given_noise=noise)
        for k in ("z_global", "z_local", "points"):
            outs[f"{'bf16' if bf16 else 'fp32'} {k}"] = out[k].cpu()
    if not os.path.exists(path):
        torch.save(outs, path)
        print(f"[given-noise] wrote {sorted(outs)} to {path}")
        return
    ref = torch.load(path)
    for k, v in outs.items():
        diff = float((v.double() - ref[k].double()).abs().max())
        print(f"[given-noise] {k} {tuple(v.shape)}: bit-equal "
              f"{torch.equal(v, ref[k])}, max |diff| {diff:.3e}, "
              f"max |value| {float(ref[k].abs().max()):.3e}")


def profile_emd(steps: int, sources) -> None:
    """K12 on one 16 x 33 block of 2048-point pairs: CUDA-event ms a call
    and a pair of the library's kernel and of each patched copy of
    csrc/emd.cu in `sources` (built on its own, like the K1 probe), each
    copy's costs against the library's (the gate, rtol 2e-3) and whether
    they repeat bit for bit."""
    import ctypes
    from pathlib import Path

    from . import ops
    from .eval.metrics import block_pairs
    from .ops import _cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    s_n, r_n = EMD_PAIRS
    a = torch.randn(s_n, 2048, 3, generator=g, device="cuda") * 0.3
    b = torch.randn(r_n, 2048, 3, generator=g, device="cuda") * 0.3
    pairs = block_pairs(0, 0, s_n, r_n, "cuda")
    ref = ops.emd_cost(a, b, pairs)
    print(f"[emd] {torch.cuda.get_device_name(0)}, {pairs.shape[0]} pairs "
          f"N2048 M2048, {steps} timed calls")
    for name, lib in [("library", _cuda.library())] + [
            (src, _cuda.build_probe(Path(src))) for src in sources]:
        fn = lib.lion_emd_cost
        fn.argtypes = _cuda._SIGNATURES["lion_emd_cost"]
        fn.restype = ctypes.c_int
        outs = [torch.empty_like(ref) for _ in range(2)]

        def run(out):
            err = fn(a.data_ptr(), b.data_ptr(), pairs.data_ptr(),
                     out.data_ptr(), pairs.shape[0], s_n, r_n, 2048, 2048,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        run(outs[0])
        run(outs[1])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            run(outs[1])
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / steps
        rel = float(((outs[0] - ref).abs() / ref.abs()).max())
        print(f"[emd] {name}: {ms:.4f} ms a call, {ms / pairs.shape[0]:.5f} "
              f"ms a pair; max relative difference from the library "
              f"{rel:.3e}; repeats bit for bit "
              f"{torch.equal(outs[0], outs[1])}")


def profile_steps(step, steps: int, label: str) -> None:
    wall, groups = _device_groups(step, steps)
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
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 configuration (tpu.bf16 = True)")
    ap.add_argument("--train", action="store_true",
                    help="profile the two-prior and the stage-1 VAE "
                    "training steps (fp32, or bf16 with --bf16)")
    ap.add_argument("--repeat", action="store_true",
                    help="each training step twice from the same state: "
                    "bit-equal?, and the cost of K10's weight gradient")
    ap.add_argument("--convs", action="store_true",
                    help="device ms of every K4 / K10 case and cuDNN's conv")
    ap.add_argument("--split", action="store_true",
                    help="K1's, K2's, K6's, K7's, K3's, K5's and K12's device "
                    "ms by launch, events and host time; the kernels per "
                    "step")
    ap.add_argument("--only", default=None,
                    help="with --split: the cases whose labels start with "
                    "one of these comma-separated prefixes (e.g. 'K5,K12'); "
                    "with --plans: the kernels named (e.g. 'K11,K13'); "
                    "with --convs: 'wgrad' for its cases alone; "
                    "with --repeat: the steps named (prior, vae, weighted)")
    ap.add_argument("--given-noise", metavar="PATH", default=None,
                    help="write the 10-step given_noise samples of both "
                    "paths to PATH, or compare them with it bit for bit")
    ap.add_argument("--emd", nargs="*", metavar="X.cu", default=None,
                    help="K12's ms a pair on one 16 x 33 block, and that of "
                    "each patched copy of csrc/emd.cu given")
    ap.add_argument("--fps-clock", action="store_true",
                    help="K1's plans timed and split into phases by clock64")
    ap.add_argument("--plans", action="store_true",
                    help="K6's, K2's, K11's and K13's device ms on every "
                    "plan at the levels")
    ap.add_argument("--source", default=None,
                    help="with --plans: time the kernels of this patched "
                    "copy of a K6, K2, K11 or K13 source (or an older "
                    "design's) instead of the library's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train:
        profile_train(args.batch, args.steps, args.bf16)
        profile_vae_train(VAE_BATCH, args.steps, args.bf16)
        return
    if args.repeat:
        repeat_steps(args.only.split(",") if args.only else None)
        return
    if args.convs:
        profile_convs(args.batch, args.steps, args.only)
        return
    if args.split:
        profile_split(args.batch, args.steps,
                      args.only.split(",") if args.only else None)
        return
    if args.given_noise:
        given_noise_samples(args.given_noise)
        return
    if args.emd is not None:
        profile_emd(args.steps, args.emd)
        return
    if args.fps_clock:
        profile_fps_clock(args.batch, args.steps)
        return
    if args.plans:
        profile_plans(args.batch, args.steps, args.source,
                      args.only.split(",") if args.only else None)
        return

    from .config import flagship_cfg
    from .models import LION
    cfg = flagship_cfg()
    cfg.tpu.bf16 = args.bf16
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0)).eval()
    g = torch.Generator(device="cuda").manual_seed(0)
    b = args.batch
    z_global = torch.randn(b, lion.style_dim, generator=g, device="cuda")
    x_local = torch.randn(b, lion.num_points, lion.point_channels,
                          generator=g, device="cuda")
    noise_g, noise_l = torch.randn_like(z_global), torch.randn_like(x_local)
    diff = lion.diffusion
    print(f"[setup] {torch.cuda.get_device_name(0)}, batch {b}, "
          f"{'bf16' if args.bf16 else 'fp32'}, {args.steps} profiled steps "
          "per prior")

    with torch.no_grad():
        profile_steps(lambda: diff._ancestral_step(
            lambda x, t: lion.local_prior(x, t, condition_input=z_global),
            x_local, 500, noise_l), args.steps, "local")
        profile_steps(lambda: diff._ancestral_step(
            lion.global_prior, z_global, 500, noise_g), args.steps, "global")


if __name__ == "__main__":
    main()
