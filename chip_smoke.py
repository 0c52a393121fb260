"""Smoke test of the PyTorch/CUDA port (lion_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--steps 100] [--eval-n 0]

Phases, each printing its results; any failure raises and the script exits
non-zero:
  1. device: needs CUDA; prints the card's name and power limit and turns
     TF32 off for matmuls and cuDNN.
  2. build: compiles the fifteen CUDA kernels from lion_tpu_torch/csrc
     (K1-K13, the ordered row sum of the backwards and K10's weight
     gradient).
  3. kernels vs plain: each kernel against its plain PyTorch version on the
     card at the main paths' shapes (batch 16), fp32 and bf16, with times
     from CUDA events; every K4 and K10 case with its bound and cuDNN's
     conv beside it (bf16 in channels-last, fp32 with TF32 off); K10's
     weight gradient at r32 C64->64 B16 and C3->32 B32 beside cuDNN's
     `conv3d_weight`; K8 beside two cuDNN convs;
     K12's approximate EMD on the evaluation's block of 16 x 33 pairs of
     2048-point clouds (repeating bit for bit), N != M both ways and a
     permuted copy; K13's
     backward against K2's backward of the permuted gradient, bit for bit;
     K2's, K13's, K5's and K6's backwards at the training shapes, fp32 and
     bf16, twice each, bit for bit; the ordered row sum at those backwards'
     shapes (fp32 and bf16 rows) against its plain version on a CPU copy,
     bit for bit, beside index_add_; K10 in bf16 at the training shapes
     (forward and dx, down to Co = 4) within 2e-2 of the output's size
     beside cuDNN's bf16 conv, and K2 on bf16 features, exact; K1 at the
     local step's four levels (N 2048 -> 1024 -> 256 -> 64 -> 16), K2 and
     K11 at its four SA levels, K13 at the first three (CF_SHAPES, fp32
     and bf16) and K6 at its four FP levels (fp32 and bf16, with its
     indices and weights) on those clouds, exact, repeating bit for bit,
     with K2's rows those grouped from K11's balls (one scan, two
     epilogues), and their times per level (`ms_levels`); K5 at the local step's devoxelizing levels in fp32
     and bf16, with and without its affine epilogue, exact, repeating bit
     for bit, with its times per level; K3 (fp32, bf16), K4 (every case
     above), K7 (SA0, SA3),
     K8 and K9 run twice and must repeat bit for bit, and K3 must equal the
     float32 sum in point order over the count. K10 also runs at the
     stage-1 step's shapes at its batch of 32 (the style encoder's and the
     encoder's forward convs, and the dx of the decoder's first conv, Co =
     4), each held to its plain version within 1e-4 (outputs of size ~1-5)
     beside cuDNN.
  4. forward parity: one full-width local-prior forward (batch 2) on the
     card against the same module on the CPU (plain versions), in fp32 and
     in bf16, and the card's bf16 forward against its fp32 one. Then the
     full-width local-prior forward in bf16 at batch 16 and in fp32 at
     batch 4, and a 10-step `LION.sample` under `given_noise` on each path
     (fp32 batch 4, bf16 batch 16), twice each: bit for bit.
  5. fp32 main path: the flagship LION (2048 points, nf 2048, fp32) with
     random weights from a seed serves three sampling requests of 4 shapes
     each through `LION.sample`, `--steps` DDPM steps per prior (1000 is
     the released chain); every kernel of the path must have launched and
     no plain version may have run.
  6. bf16 main path: the same LION with `tpu.bf16 = True` (the JAX bench's
     configuration) serves three requests of 16 shapes each, with the same
     checks on the bf16 path's kernels.
  7. gradient parity: one full-width flagship two-prior loss (batch 2,
     dropout 0) and its gradients on the card against the same modules on
     the CPU (plain versions), on the same x and draws.
  8. training main path: the flagship's two priors and frozen VAE take 2
     warm-up and 5 timed steps of `make_prior_train_step` at batch 16; the
     losses, parameters and EMA must stay finite and change, every kernel
     of the training path must have launched and no plain version run.
  9. channel-first grouping path: `ops.ball_query_group_cf` (K13) at the
     three SA shapes of scripts/profile_bqg_cf.py, its only caller in the
     JAX package, and one backward.
 10. evaluation main path: the bf16 flagship samples 64 shapes with DDIM
     (50 steps of the `--steps` schedule, 4 batches of 16; with random
     weights the 1000-step schedule's x_0 estimates grow the samples to
     ~1e5), writes them and 64 reference clouds made
     from a seed to .pt files, and scores them through `compute_score`
     (MMD / COV / 1-NNA under CD and EMD, and JSD) on the card; every
     kernel of the path, K12 included, must have launched and no plain
     version run. One 16 x 16 block of the EMD matrix is checked against
     the plain version on the card, and its diagonal (the paired CD and
     EMD) against the CPU plain version.
 11. stage-1 gradient parity: one full-width flagship VAE `get_loss`
     (batch 2, dropout 0, `l1_sum`, train mode) and its gradients on the
     card against the same module on the CPU, on the same x and posterior
     draws.
 12. stage-1 main path: a synthetic PointFlow-layout dataset made from a
     seed (15000-point clouds) in a temporary directory, and the flagship
     VAE trained on it by `trainers.hvae_trainer.Trainer(cfg, args)
     .train_epochs()` at the released batch of 32 (`l1_sum`, the KL anneal,
     dropout on): 2 warm-up and 5 timed steps; the losses, parameters and
     EMA must stay finite and change; the final checkpoint resumed by a
     second Trainer must equal it (parameters, EMA, Adam state, epoch,
     step); then `eval_nll` on the test split (K12). Every kernel of the
     path must have launched and no plain version run.
 13. stage-2 main path: the flagship two-prior trainer
     (`trainers.get_trainer("trainers.train_2prior")(cfg, args)`, fp32) with
     phase 12's final checkpoint as its sde.vae_checkpoint (stage 1 hands
     over to stage 2), on a second synthetic split of the same kind: one
     epoch of 2 warm-up and 5 timed steps at the released batch of 10 and
     one `run_eval` (16 shapes, 25 DDIM steps, CD); the losses, parameters
     and EMA must stay finite and change; a second trainer resumes the
     final checkpoint equal (parameters, EMA, Adam state, epoch, step);
     `eval_sample(metric2="EMD")` scores 16 shapes against the test split
     (K12); `export_torch` writes the released .pt schema, which
     `load_lion_checkpoint` loads into a LION on the card equal to the EMA
     bit for bit, and a DDIM sample from it is finite. Then the
     single-prior trainer (2 steps at batch 10, `sample(2)`) and the
     interpolation trainers at full width, cut in depth (100 DDPM steps;
     diffuse_t 100), each finite. Every kernel of the path must have
     launched and no plain version run; it prints ms/step, samples/s, peak
     memory and the seconds of `eval_sample`.
 14. with `--eval-n N`: N generated against N reference clouds scored
     without sampling (662 is the chair test set, the counterpart of
     scripts/bench_eval.py).
 15. PF-ODE sampling: the flagship (fp32, random weights from a seed) with
     sde.ode_sample = 1 serves the same request of 4 shapes twice through
     `LION.sample` (adaptive dopri5 on both priors at ODE_TOL, printed
     with each prior's evaluations, the seconds, ms per local evaluation
     and shapes/s): equal outputs and evaluations, every kernel of the
     fp32 path launched and no plain version run; then a 2-step Euler
     sample at batch 2 on the card against the CPU, within 1e-4 of each
     output's size.
 16. the weighted objective: one full-width two-prior loss (batch 2,
     dropout 0; continuous ll_iw, mixed prediction, SN and norm scale, the
     Jacobian term with 2 probes and the kinetic term, at
     tests/test_regularization.py's values) and its gradients, through
     K10's dx inside the second-order graph, on the card against the CPU
     (loss within 1e-5, flattened gradient within 1e-4; the Jacobian
     terms' gradient alone, all second order, within 1e-3), and on the
     card with K10's dx unrecorded as before, which the Jacobian gate must
     fail by 10x; then 2 + 5 such
     steps at batch 16 (ms/step, samples/s, peak memory; every kernel of
     the training path launched) and the device ms of the objective and
     the whole step under torch.profiler.
 18. bf16 gradient parity (after phase 11): phases 7's and 11's losses under
     tpu.bf16, their gradients on the card against the CPU within
     BF16_LOSS_TOL / BF16_GRAD_TOL.
 19. repeat steps: one fp32 two-prior step at batch 16 and one bf16 stage-1
     step at batch 32, each on two fresh copies from one seed and the same
     draws: the updated parameters and EMA equal bit for bit.
 20. bf16 training steps: the two-prior step at batch 16 and the stage-1
     step at batch 32 under tpu.bf16, 2 warm-up + 5 timed steps each
     (ms/step, samples/s, peak, busy share under torch.profiler); every
     kernel of the training path launched, K10, K2, K3, K5, K6 and the row
     sum on bf16 tensors; fp32 parameters.
 21. bf16 trainers (after phase 13, on its and phase 12's splits): the
     stage-1 Trainer under sde.autocast_train (which sets tpu.bf16) and the
     two-prior Trainer under tpu.bf16 on its final checkpoint, one epoch
     each; fp32 parameters; each final checkpoint resumed equal by a bf16
     and by an fp32 trainer.
 17. the stage-2 trainer under the PF-ODE: the flagship two-prior trainer
     with sde.ode_sample = 1 and the weighted objective (SN, mixed
     prediction) on phase 12's checkpoint: 2 + 5 steps at batch 10, one
     `run_eval` sampling through the ODE, then `interpolate_posterior_ode`
     from 2 test shapes to 4 rows; every kernel of the training path
     launched and no plain version run.
 22. the CLIs on the card (last): in a temporary working directory,
     `lion_tpu_torch.train_dist.main` with the overrides of
     lion_tpu_torch/scripts/train_vae.sh read from the file (2048 points,
     tpu.bf16, batch 32) plus `trainer.epochs 1`, `snapshot_min 0` (a
     snapshot after the epoch, which auto-resume reads) and
     `viz.viz_freq 2` where matplotlib imports (else 0, said in a line)
     over 64 synthetic clouds (the random init's style head damped by 0.01
     as in phases 20 and 21: at random weights the style posterior can
     overflow on these clouds); the same command again resumes from the
     snapshot and takes one more epoch (the step goes on); then
     train_prior.sh's overrides on its final checkpoint (batch 10, one
     epoch over 20 clouds; `viz.vis_sample_ddim_step 25` when drawing);
     `--eval_generation --num_samples 16` at 25 DDIM steps against a
     seeded reference set under ./datasets/test_data/; and
     `lion_tpu_torch.demo.main` on the stage-2 trainer's `.pt` export (4
     shapes, 25 DDIM steps). Each run's exp dir (cfg.yml, the final
     checkpoint, metrics.jsonl) and outputs are checked finite; each run
     launched its path's kernels (K2 and the rest on bf16 in training)
     and ran no plain version.
 23. data parallel (after phase 22, on its stage-1 checkpoint and stage-2
     split): (a) `python -m lion_tpu_torch.train_dist` with
     train_prior.sh's overrides (B10, bf16, one epoch of 2 steps) twice,
     each in a child process: with `--distributed_init` in a one-rank NCCL
     group (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT set here) and
     without; the final checkpoints and the logged losses equal bit for
     bit; (b) two child processes on the one card in a gloo group, full
     width fp32 (dropout 0): DP_STEPS two-prior steps at B8 a rank on
     seeded rows and draws, parameters `torch.equal` across the ranks and
     within rtol 1e-4 / atol 1e-5 of this process's one-process B16 step on
     the same rows and draws (2 lr a step where the gradient is rounding
     noise, as Adam's sign may differ there), then a 2-rank
     `eval_sample` gathering 16 clouds on rank 0. Children have a time
     limit, and a child's failure fails the run.
 24. class and CLIP conditioning at full width: the flagship with
     data.cond_on_cat (55 classes, a 64-wide embedding) and with
     clipforge.enable (PriorSEClip, HashClip features): the
     class-conditioned local prior and decoder and the se_clip global
     prior and CLIP-mapped local prior, B2, on the card against the CPU
     (1e-4 of the output's size); a labelled and a CLIP-conditioned
     sample on each path (fp32 B4, bf16 B16, `--steps` steps); one
     class- and one CLIP-conditioned two-prior step at B10; `demo --text`
     on 4 shapes. Each run launched its path's kernels and no plain
     version.
Beside each kernel the JSON line gives its bound on the card (the larger of
its bytes over 3.35 TB/s and its operations over 67 TFLOP/s fp32 or 989
TFLOP/s bf16, H100 SXM peaks, with exps at the special-function units' 16
per SM per clock, counted from this run's inputs) and, where one PyTorch
call computes the same function, that call's time (TF32 off).
The card's name and power limit are printed as nvidia-smi gives them, on a
line of their own. The line before the last is a JSON object describing the
kernels; the last line is {"ok": true, "device": {...}}.
"""
import argparse
import contextlib
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

BATCH_KERNELS = 16
BATCH = 4          # fp32 main path
BATCH_BF16 = 16    # bf16 main path, the JAX bench's batch (bench.py:36)
REQUESTS = 3
# the kernels of each main path (ball_query_group leaves the bf16 path:
# every SA block there runs the fused SA kernel)
FP32_PATH = ("fps", "ball_query_group", "avg_voxelize", "conv3d_3x3_fused",
             "trilinear_devoxelize", "three_nn_interpolate")
BF16_PATH = ("fps", "avg_voxelize", "conv3d_3x3_fused",
             "trilinear_devoxelize", "three_nn_interpolate", "sa_fused",
             "conv3d_pair", "pvconv_block_pair")
# the two-prior step: the frozen encode's eval flow (K1-K6), the priors'
# train flow (K10 forward, dx and its weight gradient), the SA blocks'
# backward (K11) and the point ops' backwards (the ordered row sum)
TRAIN_PATH = FP32_PATH + ("conv3d_3x3_same", "conv3d_weight_grad",
                          "ball_query", "row_sum")
# the channel-first grouping op (K13) has no model caller; its path is the
# op at scripts/profile_bqg_cf.py's shapes. Evaluation samples on the bf16
# path and scores with K12.
CF_PATH = ("ball_query_group_cf",)
EVAL_PATH = BF16_PATH + ("emd_cost",)
# the stage-1 trainer: the three networks of the VAE in train mode (K1, K2,
# K3, K5, K6, K10 forward and dx, K11), and eval_nll's reconstruction in
# eval mode (K1-K6) scored with K12
VAE_TRAIN_PATH = TRAIN_PATH + ("emd_cost",)
# the stage-2 trainers run the same kernel set: the two-prior step (the
# frozen encode on K1-K6, the priors' train flow on K10, K11 and the
# backward passes), fp32 sampling (K1-K6) in run_eval, eval_sample's EMD on
# K12, the single-prior and the interpolation trainers (K1-K6)
STAGE2_TRAINER_PATH = VAE_TRAIN_PATH
# the bare stage-1 step: the three networks of the VAE in train mode, no
# eval flow (no K4)
STAGE1_STEP_PATH = ("fps", "ball_query_group", "avg_voxelize",
                    "trilinear_devoxelize", "three_nn_interpolate",
                    "conv3d_3x3_same", "conv3d_weight_grad", "ball_query",
                    "row_sum")
# the bf16 training steps and trainers launch the training path's kernels,
# these among them on bf16 tensors (the U-Nets' convs and grouping)
BF16_TRAIN_KERNELS = ("conv3d_3x3_same", "conv3d_weight_grad",
                      "ball_query_group",
                      "avg_voxelize", "trilinear_devoxelize",
                      "three_nn_interpolate", "row_sum")
REPORT_ORDER = FP32_PATH + ("sa_fused", "conv3d_pair", "pvconv_block_pair",
                            "conv3d_3x3_same", "conv3d_weight_grad",
                            "ball_query", "ball_query_group_cf", "emd_cost",
                            "row_sum")
BATCH_TRAIN = 16   # scripts/profile_train_step.py's batch
WARMUP_STEPS, TRAIN_STEPS = 2, 5
BATCH_VAE = 32     # stage 1's released batch a GPU (script/train_vae.sh)
BATCH_STAGE2 = 10  # stage 2's released batch a GPU (script/train_prior.sh)
# run_eval's and eval_sample's shapes and DDIM steps (the released 1000-step
# chain would take minutes); the interpolation trainers' chains are cut
# from 1000 DDPM steps and diffuse_t 200 to these
STAGE2_VAL_SAMPLES, STAGE2_DDIM_STEPS, INTERP_STEPS = 16, 25, 100
# (N, M, C, radius) of SA0-SA2, K = 32, batch 16 (scripts/profile_bqg_cf.py)
CF_SHAPES = ((2048, 1024, 32, 0.1), (1024, 256, 64, 0.2), (256, 64, 128, 0.4))
EVAL_SHAPES, EVAL_BATCH, EVAL_DDIM_STEPS = 64, 16, 50
# the PF-ODE phases: batch 4 (the fp32 path's) and the adaptive solver's
# tolerance, loosened from the config's 1e-5: at random weights the
# flagship's local ODE took 1960 evaluations (~100 s a request) at 1e-3
# and 8575 at 1e-4 (NVIDIA H100 80GB HBM3, 700 W); run_eval's shapes; the
# ODE interpolation's end time, raised from 1e-5 (its ODEs take no mixed
# prediction: 2849 local evaluations, 147 s, at 1e-3 on that card)
ODE_BATCH, ODE_TOL = 4, 1e-2
ODE_VAL_SAMPLES, INTERP_ODE_EPS = 8, 1e-3
# phase 22, the CLIs: the clouds of each stage's one epoch (2 steps at the
# scripts' batches of 32 and 10), the evaluation's shapes, the DDIM steps
# of the evaluation, the sample grids and the demo, the demo's shapes, and
# the visualizations' cadence where matplotlib imports
CLI_STAGE1_CLOUDS, CLI_STAGE2_CLOUDS = 64, 20
CLI_EVAL_SHAPES, CLI_DDIM_STEPS, CLI_DEMO_SHAPES = 16, 25, 4
CLI_VIZ_FREQ = 2
# phase 23, data parallel: each rank's batch, the ranks of the gloo group
# on the one card, its steps, eval_sample's shapes, a child's time limit
DP_BATCH, DP_WORLD, DP_STEPS, DP_EVAL_SHAPES = 8, 2, 2, 16
DP_TIMEOUT = 300
# phase 24, conditioning: the class config's categories (all of ShapeNet)
# and embedding width
COND_NCLASS, COND_EMB = 55, 64
# H100 SXM peaks (NVIDIA's data sheet, dense): fp32 outside the tensor
# cores, bf16 on them, device memory; the special-function units (exp)
# give 16 results per SM per clock against the fp32 lanes' 256 operations
PEAK_FP32, PEAK_BF16, PEAK_BYTES = 67e12, 989e12, 3.35e12
PEAK_MUFU = PEAK_FP32 / 16


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound(moved_bytes, fp32_ops=0.0, bf16_ops=0.0, exps=0.0):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of their type. The
    special-function units run beside the fp32 lanes, so the exps bound the
    time on their own."""
    t_bytes = moved_bytes / PEAK_BYTES * 1e3
    t_ops = max(fp32_ops / PEAK_FP32 + bf16_ops / PEAK_BF16,
                exps / PEAK_MUFU) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


class KernelCheck:
    """One kernel-vs-plain comparison at one shape. `work` is the case's
    bound (`bound(...)`) or None; `library` a single PyTorch call computing
    the same function, timed beside the kernel, or None. The report keeps
    each kernel's first case."""

    def __init__(self, name, case, args, kwargs, compare, iters, plain_iters,
                 work=None, library=None):
        self.name, self.case = name, case
        self.args, self.kwargs = args, kwargs
        self.compare, self.iters, self.plain_iters = compare, iters, \
            plain_iters
        self.work, self.library = work, library

    def run(self, kernels):
        w = kernels[self.name]
        got = w(*self.args, **self.kwargs)
        ref = w.plain(*self.args, **self.kwargs)
        torch.cuda.synchronize()
        err = self.compare(got, ref)
        ms = cuda_time_ms(lambda: w(*self.args, **self.kwargs), self.iters)
        plain_ms = cuda_time_ms(lambda: w.plain(*self.args, **self.kwargs),
                                self.plain_iters, warmup=1)
        lib_ms = None if self.library is None else cuda_time_ms(
            self.library, self.iters)
        line = (f"[kernels] {self.name} {self.case}: max_abs_err {err:.3e}, "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if self.work is not None:
            line += (f", bound {self.work['bound_ms']:.4f} ms "
                     f"({self.work['bound_by']})")
        if lib_ms is not None:
            line += f", library {lib_ms:.4f} ms"
        log(line)
        return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **(self.work or {}), "library_ms": lib_ms}


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


def _bf16_close(rel):
    """bf16 outputs whose float32 sums were taken in another order: a
    rounding may land one bf16 ulp (2^-8 relative) apart, and a flip in an
    early stage moves what follows by about as much. Float32 statistics are
    held to the same relative bound of their size. Returns the first
    output's error."""
    def compare(got, ref):
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            if g.dtype != r.dtype:
                raise AssertionError(f"dtype {g.dtype} != {r.dtype}")
            scale = float(r.float().abs().max())
            torch.testing.assert_close(g.float(), r.float(), rtol=rel,
                                       atol=rel * scale)
        return max_abs(got[0], ref[0])
    return compare


def _sa_case(randn, points, centers, widths, radius):
    """Arguments of the fused SA kernel at one SA block's shapes (K = 32):
    random layer-1 rows A, the center term of random xyz weights, random
    kernels, biases and channel affines."""
    (b, n, _), m = points.shape, centers.shape[1]
    bc = -(centers @ randn(3, widths[0], scale=0.5)).contiguous()
    ws = [randn(ci, co, scale=ci ** -0.5).to(torch.bfloat16)
          for ci, co in zip(widths[:-1], widths[1:])]
    bs = [randn(co, scale=0.1) for co in widths[1:]]
    cas = [1.0 + randn(b, co, scale=0.2) for co in widths]
    cbs = [randn(b, co, scale=0.2) for co in widths]
    return (points, centers, randn(b, n, widths[0]), bc, ws, bs, cas, cbs,
            radius, 32)


def _scan_pairs(centers, points, radius, k):
    """The (center, point) pairs a ball query tests on these inputs: each
    center's scan of the cloud in index order stops at its K-th hit."""
    from lion_tpu_torch.ops.points import _r2, _sq_dist
    reached = (_sq_dist(centers, points) < _r2(radius)).cumsum(-1) >= k
    stop = torch.where(reached.any(-1), reached.int().argmax(-1) + 1,
                       points.shape[1])
    return float(stop.sum())


def _conv_ops(b, r, ci, co):
    return 2.0 * 27 * ci * co * b * r ** 3


def _devox_cells(nc, r):
    """Grid cells that trilinear devoxelization reads at these coords."""
    from lion_tpu_torch.ops.voxel import _corners
    idx = torch.cat([i for i, _ in _corners(nc, r, torch.float32)], dim=1)
    seen = torch.zeros((nc.shape[0], r ** 3), dtype=torch.bool,
                       device=nc.device)
    return float(seen.scatter_(1, idx, True).sum())


def _sa_work(args, widths):
    points, centers, a, bc, ws, bs, cas, cbs, radius, k = args
    b, m = centers.shape[:2]
    moved = nbytes(points, centers, a, bc, *ws, *bs, *cas, *cbs) \
        + b * m * widths[-1] * 2
    dense = sum(2.0 * ci * co * b * m * k
                for ci, co in zip(widths[:-1], widths[1:]))
    return bound(moved, fp32_ops=8 * _scan_pairs(centers, points, radius, k),
                 bf16_ops=dense)


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


def _oidhw(w):
    return w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)


def _conv_fused_check(randn, b, r, ci, co, dtype, pro):
    """K4 at one shape (`pro`: the affine + swish prologue), with its bound
    and cuDNN's conv alone beside it (in channels-last, the layout K4
    reads; TF32 off for fp32): no PyTorch call has K4's prologue and
    statistics."""
    import torch.nn.functional as F
    x = randn(b, r, r, r, ci).to(dtype)
    w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
    s = 1.0 + randn(b, ci, scale=0.1) if pro else None
    h = randn(b, ci, scale=0.1) if pro else None
    bf = dtype == torch.bfloat16
    iters = 5 if r == 32 and not bf else 10 if r * ci >= 2048 else 20
    xc, wc = _ncdhw(x), _oidhw(w)
    flops = _conv_ops(b, r, ci, co)
    return KernelCheck(
        "conv3d_3x3_fused", f"{'bf16 ' if bf else ''}B{b} r{r} C{ci}->{co}"
        f"{' affine+swish' if pro else ''}",
        (x, w, s, h), {"pre_swish": pro},
        _bf16_close(1e-2) if bf else _conv_compare, iters, max(2, iters // 2),
        bound(nbytes(x, w, s, h) + b * r ** 3 * co * x.element_size()
              + b * 2 * co * 4, **{"bf16_ops" if bf else "fp32_ops": flops}),
        lambda: F.conv3d(xc, wc, padding=1))


def _k10_gate(dtype):
    """fp32: sums of 27*Ci terms in another order (cuDNN, TF32 off); bf16:
    the same float32 sums rounded once, a one-ulp rounding apart where the
    order differs, held to 2e-2 of the output's size."""
    return _close(1e-4, 1e-4) if dtype == torch.float32 else \
        _bf16_close(2e-2)


def _conv_same_check(randn, case, b, r, ci, co, iters, dtype=torch.float32):
    """K10 forward at one shape, with cuDNN's conv of the same dtype beside
    it (bf16 in channels-last)."""
    import torch.nn.functional as F
    x = randn(b, r, r, r, ci).to(dtype)
    w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
    xc, wc = _ncdhw(x), _oidhw(w)
    bf = dtype == torch.bfloat16
    return KernelCheck(
        "conv3d_3x3_same", f"{'bf16 ' if bf else ''}{case}", (x, w), {},
        _k10_gate(dtype), iters, iters,
        bound(nbytes(x, w) + b * r ** 3 * co * x.element_size(),
              **{"bf16_ops" if bf else "fp32_ops": _conv_ops(b, r, ci, co)}),
        lambda: F.conv3d(xc, wc, padding=1))


def _conv_dx_check(randn, b, r, ci, co, iters, dtype=torch.float32):
    """K10 as the dx of a (ci -> co) conv: the output's gradient (co
    channels) through the flipped, transposed weights to ci channels, with
    cuDNN's `conv3d_input` of the same dtype beside it."""
    gy = randn(b, r, r, r, co).to(dtype)
    w = randn(3, 3, 3, ci, co, scale=(27 * ci) ** -0.5).to(dtype)
    w_flip = w.flip(0, 1, 2).transpose(3, 4).contiguous()
    gyc, wc = _ncdhw(gy), _oidhw(w)
    shape = (b, ci, r, r, r)
    bf = dtype == torch.bfloat16
    return KernelCheck(
        "conv3d_3x3_same", f"{'bf16 ' if bf else ''}dx B{b} r{r} C{co}->{ci}",
        (gy, w_flip), {}, _k10_gate(dtype), iters, iters,
        bound(nbytes(gy, w) + b * r ** 3 * ci * gy.element_size(),
              **{"bf16_ops" if bf else "fp32_ops": _conv_ops(b, r, co, ci)}),
        lambda: torch.nn.grad.conv3d_input(shape, wc, gyc, padding=1))


def _wgrad_check(randn, b, r, ci, co, iters, dtype=torch.float32):
    """K10's weight gradient at one shape: x and the output's gradient g
    against the plain version (cuDNN's, TF32 off, on float32 copies), with
    cuDNN's `conv3d_weight` on x and g as they are beside it as the
    library's time. fp32: sums of b r^3 products in another order, within
    1e-4 of the largest entry; bf16: the same float32 sums rounded once.
    Bound: FFMA (the products are float32 in both dtypes)."""
    x = randn(b, r, r, r, ci).to(dtype)
    g = randn(b, r, r, r, co).to(dtype)
    xc, gc = _ncdhw(x), _ncdhw(g)
    bf = dtype == torch.bfloat16

    def gate(got, ref):
        scale = float(ref.float().abs().max())
        return _close(0, 1e-4 * scale)(got, ref) if not bf else \
            _bf16_close(1e-2)(got, ref)
    return KernelCheck(
        "conv3d_weight_grad", f"{'bf16 ' if bf else ''}B{b} r{r} C{ci}->{co}",
        (x, g), {}, gate, iters, max(2, iters // 2),
        bound(nbytes(x, g) + 27 * ci * co * x.element_size(),
              fp32_ops=_conv_ops(b, r, ci, co)),
        lambda: torch.nn.grad.conv3d_weight(xc, (co, ci, 3, 3, 3), gc,
                                            padding=1))


def _row_sum_check(randn, case, idx, rows, n, iters):
    """The ordered row sum at one backward's shape: bit for bit against its
    plain version (a float32 scatter_add_) on a CPU copy, which adds in
    ascending r; the plain version on the card (atomics) is timed only.
    Bound: the rows and indices read once, the sums written once; library:
    one index_add_ over the flattened items."""
    from lion_tpu_torch import ops
    b, r, c = rows.shape
    plain = ops.KERNELS["row_sum"].plain
    want = plain(idx.cpu(), rows.cpu(), n)

    def compare(got, _):
        if not torch.equal(got.cpu(), want):
            raise AssertionError(f"row_sum {case}: not the CPU's sums")
        return 0.0
    flat = (idx.long() + n * torch.arange(b, device=idx.device)[:, None]
            ).reshape(-1)
    return KernelCheck(
        "row_sum", case, (idx, rows, n), {}, compare, iters, iters,
        bound(nbytes(idx, rows) + b * n * c * 4, fp32_ops=float(b * r * c)),
        lambda: torch.zeros(b * n, c, device=rows.device).index_add_(
            0, flat, rows.reshape(-1, c).float()))


def _emd_work(sample, ref, pairs):
    """K12's bound: each cloud and the pair list read once, one cost per
    pair written; per (n, m) entry of a pair the matmul-form distance (8
    operations) and, at each of the 10 levels, about 10 fp32 operations and
    (at the 9 levels below 0) one exp."""
    entries = float(pairs.shape[0]) * sample.shape[1] * ref.shape[1]
    return bound(nbytes(sample, ref, pairs) + pairs.shape[0] * 4,
                 fp32_ops=(10 * 10 + 8) * entries, exps=9 * entries)


def check_cf_backward(cloud, centers, feats, g):
    """K13's backward against K2's backward of the permuted gradient: the
    same code on the same gradient, every row summed in a fixed order
    (the ordered row sum), so they are equal bit for bit."""
    from lion_tpu_torch import ops
    xs = [t.detach().clone().requires_grad_(True)
          for t in (cloud, centers, feats)]
    cf = torch.autograd.grad(ops.ball_query_group_cf(*xs, 0.1, 32), xs, g)
    rows = torch.autograd.grad(ops.ball_query_group(*xs, 0.1, 32), xs,
                               g.permute(0, 3, 1, 2))
    same = all(torch.equal(a, b) for a, b in zip(cf, rows))
    log(f"[kernels] ball_query_group_cf backward vs K2's backward of the "
        f"permuted gradient: bit-equal {same}")
    if not same:
        raise AssertionError("K13's backward differs from K2's")


def check_backward_repeats(b, randn):
    """K2's, K13's, K5's and K6's backwards at the training shapes (SA0,
    r32 C64, the top FP level), fp32 and bf16, twice on the same gradient:
    equal bit for bit (the ordered row sum, no float atomics)."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.ops.voxel import normalize_coords
    from lion_tpu_torch.profile_step import bqg_level_inputs
    _, (p, c, f, r, k) = bqg_level_inputs(b, randn)[0]
    nc = normalize_coords(p, 32).contiguous()
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        x, grid = f.to(dt), randn(b, 32, 32, 32, 64).to(dt)
        cf = randn(b, c.shape[1], 192).to(dt)
        g2 = randn(b, c.shape[1], k, 3 + f.shape[-1]).to(dt)
        cases = (
            ("ball_query_group", lambda *a: ops.ball_query_group(*a, r, k),
             (p, c, x), g2),
            ("ball_query_group_cf",
             lambda *a: ops.ball_query_group_cf(*a, r, k), (p, c, x),
             g2.permute(0, 2, 3, 1).contiguous()),
            ("trilinear_devoxelize",
             lambda gg: ops.trilinear_devoxelize(gg, nc, 32), (grid,),
             randn(b, p.shape[1], 64).to(dt)),
            ("three_nn_interpolate",
             lambda ff: ops.nearest_neighbor_interpolate(p, c, ff), (cf,),
             randn(b, p.shape[1], 192).to(dt)))
        for label, fn, inputs, cot in cases:
            def grads(fn=fn, inputs=inputs, cot=cot):
                xs = [t.detach().clone().requires_grad_(True)
                      for t in inputs]
                return torch.autograd.grad(fn(*xs), xs, cot)
            _bit_equal(f"{label} backward B{b} {name}", grads)


def _ordered_mean(feats, vox, r):
    """K3's reference on the CPU: each cell's float32 sum in point order
    (np.add.at applies in index order) over the count, rounded once."""
    f, v = feats.float().cpu().numpy(), vox.long().cpu().numpy()
    cells = (v[..., 0] * r + v[..., 1]) * r + v[..., 2]
    out = np.zeros((f.shape[0], r ** 3, f.shape[-1]), np.float32)
    for i in range(f.shape[0]):
        np.add.at(out[i], cells[i], f[i])
        count = np.bincount(cells[i], minlength=r ** 3)[:, None]
        out[i] = np.where(count > 0, out[i] / np.maximum(count, 1)
                          .astype(np.float32), np.float32(0))
    return torch.from_numpy(out).to(feats.dtype).reshape(
        f.shape[0], r, r, r, f.shape[-1])


def _bit_equal(label, fn, tag="kernels"):
    """Run fn twice; raise unless every output is equal bit for bit.
    Returns the first run's outputs as a tuple."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    first = first if isinstance(first, tuple) else (first,)
    second = second if isinstance(second, tuple) else (second,)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"[{tag}] repeat {label}: bit-equal {same}")
    if not same:
        raise AssertionError(f"{label}: two runs differ")
    return first


def check_repeats(vox32, f64, sa0, sa3, checks):
    """K3 (fp32 and bf16, B16 r32 C64), K7 (SA0, SA3) and every K4, K8 and
    K9 case of `checks` twice on the same inputs: each must repeat bit for
    bit (no float atomics, fixed-order sums), and K3 must equal the ordered
    float32 reference."""
    from lion_tpu_torch import ops
    runs = [(f"avg_voxelize {dt} B16 r32 C64",
             lambda x=f64.to(dt): ops.avg_voxelize(x, vox32, 32))
            for dt in (torch.float32, torch.bfloat16)]
    runs += [("sa_fused B16 SA0", lambda: ops.sa_fused(*sa0)),
             ("sa_fused B16 SA3", lambda: ops.sa_fused(*sa3))]
    runs += [(f"{c.name} {c.case}",
              lambda c=c: ops.KERNELS[c.name](*c.args, **c.kwargs))
             for c in checks if c.name in ("conv3d_3x3_fused", "conv3d_pair",
                                           "pvconv_block_pair")]
    for label, fn in runs:
        first = _bit_equal(label, fn)[0]
        if label.startswith("avg_voxelize"):
            x = f64.to(first.dtype)
            if not torch.equal(first.cpu(), _ordered_mean(x, vox32, 32)):
                raise AssertionError(f"{label}: not the ordered mean")
            log(f"[kernels] {label} equals the ordered float32 reference "
                f"bit for bit")


def check_fps_levels(b, randn):
    """K1 at the local step's four levels, each level's cloud the previous
    level's picks: exact against the plain version; the time per level."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.profile_step import fps_level_inputs
    ms = {}
    for n, m, cloud in fps_level_inputs(b, randn):
        _exact(ops.fps(cloud, m), ops.KERNELS["fps"].plain(cloud, m))
        ms[f"N{n}->M{m}"] = cuda_time_ms(lambda: ops.fps(cloud, m), 20)
    log(f"[kernels] fps per level B{b} (exact): " + ", ".join(
        f"{k} {v:.4f} ms" for k, v in ms.items())
        + f"; the four levels {sum(ms.values()):.4f} ms")
    return ms


def check_bqg_levels(b, randn):
    """K2 and K11 at the local step's four SA levels: each exact against
    its plain version and repeating bit for bit, K2's rows those grouped
    from K11's balls; the time per level of each."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.ops.points import grouping
    from lion_tpu_torch.profile_step import bqg_level_inputs
    k2, k11 = ops.KERNELS["ball_query_group"], ops.KERNELS["ball_query"]
    ms2, ms11 = {}, {}
    for label, args in bqg_level_inputs(b, randn):
        p, c, f, r, k = args
        got = _bit_equal(f"ball_query_group B{b} {label}",
                         lambda a=args: k2(*a))[0]
        _exact(got, k2.plain(*args))
        idx = _bit_equal(f"ball_query B{b} {label}",
                         lambda: k11(c, p, r, k))[0]
        _exact(idx, k11.plain(c, p, r, k))
        _exact(got, torch.cat([grouping(p, idx) - c[:, :, None],
                               grouping(f, idx)], -1))
        ms2[label] = cuda_time_ms(lambda a=args: k2(*a), 20)
        ms11[label] = cuda_time_ms(lambda: k11(c, p, r, k), 20)
    for name, ms in (("ball_query_group", ms2), ("ball_query", ms11)):
        log(f"[kernels] {name} per level B{b} (exact; K2's rows from K11's "
            f"balls): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
            + f"; the four levels {sum(ms.values()):.4f} ms")
    return ms2, ms11


def check_cf_levels(b, randn):
    """K13 at the SA levels of CF_SHAPES in fp32 and bf16: exact against
    its plain version, repeating bit for bit; the time per level."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.profile_step import bqg_level_inputs
    k13 = ops.KERNELS["ball_query_group_cf"]
    ms = {}
    levels = bqg_level_inputs(b, randn)[:len(CF_SHAPES)]
    for (label, (p, c, f, r, k)), shape in zip(levels, CF_SHAPES):
        if (p.shape[1], c.shape[1], f.shape[2], r) != shape:
            raise AssertionError(f"{label} is not CF_SHAPES' {shape}")
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = f.to(dt)
            got = _bit_equal(f"ball_query_group_cf B{b} {name} {label}",
                             lambda x=x: k13(p, c, x, r, k))[0]
            _exact(got, k13.plain(p, c, x, r, k))
            ms[f"{label} {name}"] = cuda_time_ms(lambda x=x: k13(p, c, x, r, k),
                                                 20)
    log(f"[kernels] ball_query_group_cf per level B{b} (exact): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    return ms


def check_three_nn_levels(b, randn):
    """K6 at the local step's four FP levels in fp32 and bf16, with its
    indices and weights: exact against the plain version, repeating bit for
    bit; the time per level."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.profile_step import three_nn_level_inputs
    k6 = ops.KERNELS["three_nn_interpolate"]
    ms = {}
    for label, (p, c, f) in three_nn_level_inputs(b, randn):
        for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            x = f.to(dt)
            got = _bit_equal(f"three_nn_interpolate B{b} {name} {label}",
                             lambda x=x: k6(p, c, x, with_weights=True))
            _exact(got, k6.plain(p, c, x, with_weights=True))
            _exact(k6(p, c, x), got[0])
            ms[f"{label} {name}"] = cuda_time_ms(lambda x=x: k6(p, c, x), 20)
    log(f"[kernels] three_nn_interpolate per level B{b} (exact): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    return ms


def check_devox_levels(b, randn):
    """K5 at the local step's devoxelizing levels in fp32 and bf16, with and
    without the affine epilogue: exact against the plain version, repeating
    bit for bit; the time per level."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.profile_step import devox_level_inputs
    k5 = ops.KERNELS["trilinear_devoxelize"]
    ms = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        for label, args, affine in devox_level_inputs(b, randn, dt):
            for tag, extra in (("", ()), (" affine", affine)):
                got = _bit_equal(f"trilinear_devoxelize B{b} {name} {label}"
                                 f"{tag}", lambda e=extra: k5(*args, *e))
                _exact(got, k5.plain(*args, *extra))
                ms[f"{label} {name}{tag}"] = cuda_time_ms(
                    lambda e=extra: k5(*args, *e), 20)
    log(f"[kernels] trilinear_devoxelize per level B{b} (exact): "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
    return ms


def phase_kernels():
    import torch.nn.functional as F
    from lion_tpu_torch import ops
    from lion_tpu_torch.eval.metrics import block_pairs
    from lion_tpu_torch.ops._cuda import no_tf32
    from lion_tpu_torch.ops.voxel import _corners, normalize_coords
    from lion_tpu_torch.profile_step import (K4_CASES, K10_CASES,
                                             STAGE1_K10_CASES, STAGE1_K10_DX)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    b = BATCH_KERNELS
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    cloud = randn(b, 2048, 3, scale=0.3)
    centers = ops.KERNELS["fps"].plain(cloud, 1024)[1]
    cloud64 = centers[:, :64].contiguous()             # SA2's 64 centers
    centers16 = ops.KERNELS["fps"].plain(cloud64, 16)[1]
    centers256 = ops.KERNELS["fps"].plain(centers, 256)[1]
    nc32 = normalize_coords(cloud, 32).contiguous()
    vox32 = torch.round(nc32).to(torch.int32)
    cloud256 = centers[:, :256].contiguous()
    nc8 = normalize_coords(cloud256, 8).contiguous()
    vox8 = torch.round(nc8).to(torch.int32)
    w64 = randn(3, 3, 3, 64, 64, scale=(27 * 64) ** -0.5)
    w128b = randn(3, 3, 3, 128, 128, scale=(27 * 128) ** -0.5).to(bf)
    w64b = w64.to(bf)
    f32c = randn(b, 2048, 32)
    f64 = randn(b, 2048, 64)
    cells = ((vox32[..., 0] * 32 + vox32[..., 1]) * 32 + vox32[..., 2]).long()
    cells = cells[:, :, None].expand(-1, -1, 64)
    grid64 = randn(b, 32, 32, 32, 64)
    affine64 = (1.0 + randn(b, 64, scale=0.2), randn(b, 64, scale=0.2))
    # grid_sample reads (x, y, z) as (W, H, D) in [-1, 1]: the port's grid
    # is indexed (ix, iy, iz) = (D, H, W)
    gs_grid = (nc32 / 31 * 2 - 1).flip(-1).reshape(b, 1, 1, 2048, 3)
    f192 = randn(b, 1024, 192)
    sa0 = _sa_case(randn, cloud, centers, (32, 64), 0.1)
    sa3 = _sa_case(randn, cloud64, centers16, (128, 128, 128), 0.8)
    xp = randn(b, 32, 32, 32, 64).to(bf)
    pair_args = (xp, w64b, randn(64, scale=0.1), 1.0 + randn(b, 64, scale=0.1),
                 randn(b, 64, scale=0.1), w64b)
    fb = randn(b, 256, 128).to(bf)
    block_args = (fb, vox8, nc8, w128b, randn(128, scale=0.1),
                  1.0 + randn(b, 128, scale=0.1), randn(b, 128, scale=0.1),
                  w128b, 8)
    # K12 on one EMD block of the metrics (16 x 33 pairs of 2048-point
    # clouds, two waves of two CTAs per SM), and N != M both ways
    emd_s, emd_r = randn(16, 2048, 3, scale=0.3), randn(33, 2048, 3,
                                                        scale=0.3)
    emd_block = (emd_s, emd_r, block_pairs(0, 0, 16, 33, dev))
    half = randn(4, 1024, 3, scale=0.3)
    pairs4 = block_pairs(0, 0, 4, 4, dev)
    # the backwards' indices: K11's balls at SA0, K5's eight corners at r32,
    # K6's three neighbours at the top FP level
    bq_idx = ops.ball_query(centers, cloud, 0.1, 32).reshape(b, -1)
    devox_idx = torch.cat([i for i, _ in _corners(nc32, 32, torch.float32)],
                          dim=1).to(torch.int32)
    nn_idx = ops.KERNELS["three_nn_interpolate"](
        cloud, centers, f192, with_weights=True)[1].reshape(b, -1)
    checks = [
        # K1, K2, K5, K6, K11 evaluate the same unfused arithmetic in the
        # same order as their plain versions, so they must agree bit for bit
        KernelCheck("fps", "B16 N2048->M1024", (cloud, 1024), {}, _exact,
                    20, 2, bound(nbytes(cloud) + b * 1024 * 16,
                                 fp32_ops=10.0 * b * 1024 * 2048)),
        KernelCheck("ball_query_group", "B16 N2048 M1024 K32 r0.1 C32",
                    (cloud, centers, f32c, 0.1, 32), {}, _exact, 20, 3,
                    bound(nbytes(cloud, centers, f32c)
                          + b * 1024 * 32 * 35 * 4,
                          fp32_ops=8 * _scan_pairs(centers, cloud, 0.1, 32))),
        # K3: the plain version scatters with atomics in varying order; a
        # cell sums at most a few dozen features
        KernelCheck("avg_voxelize", "B16 N2048 r32 C64", (f64, vox32, 32), {},
                    _close(1e-5, 1e-5), 20, 5,
                    bound(nbytes(f64, vox32) + b * 32 ** 3 * 64 * 4,
                          fp32_ops=b * 2048 * 64 + b * 32 ** 3 * 64),
                    lambda: torch.zeros(b, 32 ** 3, 64, device=dev)
                    .scatter_reduce_(1, cells, f64, "mean",
                                     include_self=False)),
        KernelCheck("avg_voxelize", "bf16 B16 N2048 r32 C64",
                    (randn(b, 2048, 64).to(bf), vox32, 32), {},
                    _bf16_close(8e-3), 20, 5),
        KernelCheck("trilinear_devoxelize", "B16 N2048 r32 C64",
                    (grid64, nc32, 32), {}, _exact, 20, 5,
                    bound(_devox_cells(nc32, 32) * 64 * 4 + nbytes(nc32)
                          + b * 2048 * 64 * 4,
                          fp32_ops=16.0 * b * 2048 * 64),
                    lambda: F.grid_sample(_ncdhw(grid64), gs_grid,
                                          align_corners=True)),
        KernelCheck("trilinear_devoxelize", "bf16 B16 N2048 r32 C64",
                    (randn(b, 32, 32, 32, 64).to(bf), nc32, 32), {}, _exact,
                    20, 5),
        # with the per-(item, channel) affine of PVConv's eval flow
        KernelCheck("trilinear_devoxelize", "affine B16 N2048 r32 C64",
                    (grid64, nc32, 32, *affine64), {}, _exact, 20, 5),
        KernelCheck("trilinear_devoxelize", "affine bf16 B16 N2048 r32 C64",
                    (grid64.to(bf), nc32, 32, *affine64), {}, _exact, 20,
                    5),
        # K4 at the main paths' shapes (the bf16 path's twelve K4 calls
        # per local step and the fp32 path's widest ones; the first is the
        # report's)
        *(_conv_fused_check(randn, b, *case) for case in K4_CASES),
        KernelCheck("three_nn_interpolate", "B16 N2048 M1024 C192",
                    (cloud, centers, f192), {}, _exact, 20, 5,
                    bound(nbytes(cloud, centers, f192) + b * 2048 * 192 * 4,
                          fp32_ops=10.0 * b * 2048 * 1024
                          + 5.0 * b * 2048 * 192)),
        KernelCheck("three_nn_interpolate", "bf16 B16 N2048 M1024 C192",
                    (cloud, centers, randn(b, 1024, 192).to(bf)), {}, _exact,
                    20, 5),
        KernelCheck("three_nn_interpolate",
                    "with (idx, w) B16 N2048 M1024 C192",
                    (cloud, centers, f192), {"with_weights": True}, _exact,
                    20, 5),
        # K7-K9: GroupNorm over bf16 activations whose statistics are summed
        # in another order on each side: a few one-ulp rounding flips
        KernelCheck("sa_fused", "bf16 B16 SA0 N2048 M1024 K32 r0.1 C32,64",
                    sa0, {}, _bf16_close(2e-2), 10, 3,
                    _sa_work(sa0, (32, 64))),
        KernelCheck("sa_fused", "bf16 B16 SA3 N64 M16 K32 r0.8 C128x3",
                    sa3, {}, _bf16_close(2e-2), 20, 5),
        KernelCheck("conv3d_pair", "bf16 B16 r32 C64", pair_args, {},
                    _bf16_close(2e-2), 5, 3,
                    bound(nbytes(*pair_args, xp) + 2 * b * 2 * 64 * 4,
                          bf16_ops=2 * _conv_ops(b, 32, 64, 64))),
        KernelCheck("pvconv_block_pair", "bf16 B16 r8 C128 N256", block_args,
                    {}, _bf16_close(2e-2), 20, 5,
                    bound(nbytes(*block_args[:8], fb) + b * 2 * 128 * 4,
                          bf16_ops=2 * _conv_ops(b, 8, 128, 128))),
        # K10: fp32 sums of 27*Ci terms in another order (cuDNN, TF32 off)
        _conv_same_check(randn, "B16 r32 C64->64", b, 32, 64, 64, 5),
        _conv_same_check(randn, "B16 r32 C4->32", b, 32, 4, 32, 10),
        _conv_same_check(randn, "B16 r16 C128->64", b, 16, 128, 64, 10),
        _conv_same_check(randn, "B16 r8 C192->128", b, 8, 192, 128, 20),
        _conv_dx_check(randn, b, 32, 64, 64, 5),
        # K10 at the stage-1 step's shapes at its batch: the forward convs
        # the two-prior step never runs, and the dx of the decoder's first
        # conv (C4 -> 32) down to Co = 4
        *(_conv_same_check(randn, f"B{BATCH_VAE} r{r} C{ci}->{co}",
                           BATCH_VAE, r, ci, co, 5)
          for r, ci, co in STAGE1_K10_CASES),
        *(_conv_dx_check(randn, BATCH_VAE, r, co, ci, 5)
          for r, ci, co in STAGE1_K10_DX),
        # K10 in bf16 (bf16 training): the same training shapes, forward
        # and dx, down to Co = 4 (the first is the report's bf16 case)
        *(_conv_same_check(randn, f"B16 r{r} C{ci}->{co}", b, r, ci, co,
                           5 if r == 32 else 10, bf)
          for r, ci, co in K10_CASES),
        _conv_dx_check(randn, b, 32, 64, 64, 5, bf),
        *(_conv_dx_check(randn, BATCH_VAE, r, co, ci, 5, bf)
          for r, ci, co in STAGE1_K10_DX),
        # K10's weight gradient: the stage-1 step's widest conv at the
        # kernels' batch and its smallest (C3 -> 32) at its batch of 32
        _wgrad_check(randn, b, 32, 64, 64, 5),
        _wgrad_check(randn, BATCH_VAE, 32, 3, 32, 10),
        _wgrad_check(randn, b, 32, 64, 64, 5, bf),
        _wgrad_check(randn, BATCH_VAE, 32, 3, 32, 10, bf),
        # K2 on bf16 features (the SA blocks' train flow under bf16): the
        # coordinates rounded once, the features copied, bit for bit
        KernelCheck("ball_query_group", "bf16 B16 N2048 M1024 K32 r0.1 C32",
                    (cloud, centers, f32c.to(bf), 0.1, 32), {}, _exact, 20,
                    3, bound(nbytes(cloud, centers) + b * 2048 * 32 * 2
                             + b * 1024 * 32 * 35 * 2,
                             fp32_ops=8 * _scan_pairs(centers, cloud, 0.1,
                                                      32))),
        # the ordered row sum at the training backwards' shapes: K2's at
        # SA0 (fp32 and bf16 gradients), K5's at r32 C64, K6's top level
        _row_sum_check(randn, "K2 backward B16 R32768 n2048 C35",
                       bq_idx, randn(b, 1024 * 32, 35), 2048, 10),
        _row_sum_check(randn, "bf16 K2 backward B16 R32768 n2048 C35",
                       bq_idx, randn(b, 1024 * 32, 35).to(bf), 2048, 10),
        _row_sum_check(randn, "K5 backward B16 R16384 n32768 C64",
                       devox_idx, randn(b, 8 * 2048, 64), 32 ** 3, 10),
        _row_sum_check(randn, "K6 backward B16 R6144 n1024 C192",
                       nn_idx, randn(b, 3 * 2048, 192), 1024, 10),
        KernelCheck("ball_query", "B16 N2048 M1024 K32 r0.1",
                    (centers, cloud, 0.1, 32), {}, _exact, 20, 3,
                    bound(nbytes(centers, cloud) + b * 1024 * 32 * 4,
                          fp32_ops=8 * _scan_pairs(centers, cloud, 0.1, 32))),
        KernelCheck("ball_query", "B16 N1024 M256 K32 r0.2",
                    (centers256, centers, 0.2, 32), {}, _exact, 20, 3),
        # K13: K2's indices and fp32 subtraction in the channel-first
        # layout, the features copied as they are
        KernelCheck("ball_query_group_cf", "B16 N2048 M1024 K32 r0.1 C32",
                    (cloud, centers, f32c, 0.1, 32), {}, _exact, 20, 3,
                    bound(nbytes(cloud, centers, f32c)
                          + b * 1024 * 32 * 35 * 4,
                          fp32_ops=8 * _scan_pairs(centers, cloud, 0.1, 32))),
        KernelCheck("ball_query_group_cf", "bf16 B16 N2048 M1024 K32 r0.1 C32",
                    (cloud, centers, f32c.to(bf), 0.1, 32), {}, _exact, 20,
                    3),
        # K12: the JAX package's gate between its EMD kernel and its XLA
        # form (tests/test_ops.py:291); exp(level * d2) at |level| up to
        # 16384 amplifies fp32 rounding of sums taken in another order
        KernelCheck("emd_cost", "16 x 33 pairs N2048 M2048", emd_block, {},
                    _close(2e-3, 1e-5), 3, 1, _emd_work(*emd_block)),
        KernelCheck("emd_cost", "4 x 4 pairs N2048 M1024",
                    (emd_s, half, pairs4), {}, _close(2e-3, 1e-5), 5, 1),
        KernelCheck("emd_cost", "4 x 4 pairs N1024 M2048",
                    (half, emd_r, pairs4), {}, _close(2e-3, 1e-5), 5, 1),
    ]
    results, bf16_first = {}, set()
    with no_tf32():
        for c in checks:
            r = c.run(ops.KERNELS)
            bf = c.case.startswith("bf16 ")
            prev = results.get(c.name)
            if prev is None:
                results[c.name] = r
                if bf:
                    bf16_first.add(c.name)
                continue
            # a kernel's first bf16 case beside its fp32 one; each keeps
            # its first case's times and the worst error of its dtype
            if bf and c.name not in bf16_first:
                if "bf16" not in prev:
                    prev["bf16"] = {"case": c.case, **r}
                    continue
                prev = prev["bf16"]
            prev["max_abs_err"] = max(prev["max_abs_err"], r["max_abs_err"])
        # the library calls compute the kernels' functions: K3's scatter
        # mean and K5's trilinear sample against the kernels
        mean = torch.zeros(b, 32 ** 3, 64, device=dev).scatter_reduce_(
            1, cells, f64, "mean", include_self=False)
        sampled = F.grid_sample(_ncdhw(grid64), gs_grid, align_corners=True)
        err_mean = max_abs(mean.reshape(b, 32, 32, 32, 64),
                           ops.avg_voxelize(f64, vox32, 32))
        err_sample = max_abs(sampled.reshape(b, 64, 2048).transpose(1, 2),
                             ops.trilinear_devoxelize(grid64, nc32, 32))
        log(f"[kernels] library vs kernel: scatter_reduce mean "
            f"{err_mean:.3e}, grid_sample {err_sample:.3e}")
        # K8's yardstick, for information only (no single PyTorch call
        # computes the pair): two cuDNN bf16 convs at its shape
        xc, wc = _ncdhw(xp), _oidhw(w64b)
        ms = cuda_time_ms(lambda: (F.conv3d(xc, wc, padding=1),
                                   F.conv3d(xc, wc, padding=1)), 5)
        log(f"[kernels] conv3d_pair yardstick: two cuDNN bf16 convs B16 "
            f"r32 C64->64 {ms:.4f} ms (not its library call)")
        emd = results["emd_cost"]
        emd["ms_per_pair"] = emd["ms"] / emd_block[2].shape[0]
        log(f"[kernels] emd_cost: {emd['ms_per_pair']:.5f} ms per pair, "
            f"bound {emd['bound_ms'] / emd_block[2].shape[0]:.5f} ms per "
            f"pair")
        # a permuted copy of a cloud is the same set: its cost is ~0
        perm = torch.randperm(2048, generator=g, device=dev)
        own = ops.emd_cost(emd_s[:4], emd_s[:4, perm].contiguous(),
                           torch.stack([torch.arange(4, dtype=torch.int32,
                                                     device=dev)] * 2, 1))
        log(f"[kernels] emd_cost of 4 permuted copies: "
            f"{own.tolist()} (limit 1e-3)")
        if not float(own.max()) < 1e-3:
            raise AssertionError(f"EMD of a permuted copy: {own.tolist()}")
        _bit_equal("emd_cost 16 x 33 pairs N2048 M2048",
                   lambda: ops.emd_cost(*emd_block))
        check_cf_backward(cloud, centers, f32c, randn(b, 32, 35, 1024))
        check_backward_repeats(b, randn)
        results["fps"]["ms_levels"] = check_fps_levels(b, randn)
        (results["ball_query_group"]["ms_levels"],
         results["ball_query"]["ms_levels"]) = check_bqg_levels(b, randn)
        results["ball_query_group_cf"]["ms_levels"] = check_cf_levels(b,
                                                                      randn)
        results["three_nn_interpolate"]["ms_levels"] = \
            check_three_nn_levels(b, randn)
        results["trilinear_devoxelize"]["ms_levels"] = \
            check_devox_levels(b, randn)
        check_repeats(vox32, f64, sa0, sa3, checks)
    return results


def _local_prior_pair(cfg):
    """The full-width local prior on the CPU and a copy on the card, in eval
    mode."""
    from lion_tpu_torch.models.registry import build_local_prior
    from lion_tpu_torch.nn import init_weights
    cpu = build_local_prior(cfg).eval()
    init_weights(cpu, torch.Generator().manual_seed(7))
    return cpu, copy.deepcopy(cpu).cuda()


def _forward_inputs():
    g = torch.Generator().manual_seed(8)
    x = (torch.randn(2, 2048, 4, generator=g)
         * torch.tensor([0.3, 0.3, 0.3, 1.0])).reshape(2, -1)
    t = torch.tensor([500.0, 20.0])
    cond = torch.randn(2, 128, generator=g)
    return x, t, cond


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def phase_forward_parity(cfg):
    """Full-width local prior, B=2: kernels on the card vs plain on CPU, in
    fp32 and in bf16; and the card's bf16 forward vs its fp32 forward."""
    x, t, cond = _forward_inputs()
    cpu, gpu = _local_prior_pair(cfg)
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

    cfg16 = copy.deepcopy(cfg)
    cfg16.tpu.bf16 = True
    cpu16, gpu16 = _local_prior_pair(cfg16)
    with torch.no_grad():
        t0 = time.perf_counter()
        ref16 = cpu16(x, t, condition_input=cond)
        t1 = time.perf_counter()
        got16 = gpu16(x.cuda(), t.cuda(), condition_input=cond.cuda()).cpu()
    rel = _rel_l2(got16, ref16)
    drift = _rel_l2(got16, got)
    log(f"[parity] bf16 local prior forward B2 (full width): card vs CPU "
        f"plain relative L2 {rel:.3e} (limit 0.03), card bf16 vs card fp32 "
        f"relative L2 {drift:.3e} (limit 0.06); cpu {t1 - t0:.1f} s")
    # bf16 roundings land on the other side of a boundary where the card's
    # sums run in another order, and GroupNorm carries each flip on; the
    # CPU tests hold the port's bf16 within 0.03 of lion_tpu's bf16
    if not rel <= 0.03:
        raise AssertionError(f"bf16 card vs CPU: relative L2 {rel:.3e}")
    # the JAX package's own bf16 gate (tests/test_bf16_quality.py:87)
    if not drift <= 0.06:
        raise AssertionError(f"bf16 vs fp32 drift {drift:.3e}")
    return {"fp32_max_abs_err": err, "bf16_rel_l2": rel, "bf16_drift": drift}


def phase_repeat_paths(cfg):
    """The full-width local-prior forward (bf16 at batch 16, fp32 at batch
    4) and a 10-step LION.sample under given_noise on each path (fp32 at
    batch 4, bf16 at batch 16), twice each on the same inputs: bit for
    bit, and finite."""
    from lion_tpu_torch.models import LION
    g = torch.Generator().manual_seed(9)
    for bf16, batch in ((True, BATCH_BF16), (False, BATCH)):
        c = copy.deepcopy(cfg)
        c.tpu.bf16 = bf16
        _, net = _local_prior_pair(c)
        xs = (torch.randn(batch, 2048, 4, generator=g)
              * torch.tensor([0.3, 0.3, 0.3, 1.0])).reshape(batch, -1).cuda()
        ts = torch.full((batch,), 500.0, device="cuda")
        cs = torch.randn(batch, 128, generator=g).cuda()
        with torch.no_grad():
            out = _bit_equal(f"local prior forward {'bf16' if bf16 else 'fp32'}"
                             f" B{batch}", lambda: net(xs, ts,
                                                       condition_input=cs),
                             "repeat")
        if not torch.isfinite(out[0]).all():
            raise AssertionError("non-finite forward")
    for bf16, batch in ((False, BATCH), (True, BATCH_BF16)):
        c = copy.deepcopy(cfg)
        c.tpu.bf16 = bf16
        c.ddpm.num_steps = 10
        lion = LION(c).init_params(torch.Generator().manual_seed(3))
        rs = np.random.RandomState(12)
        noise = tuple(
            (torch.from_numpy(rs.randn(batch, d).astype(np.float32)).cuda(),
             torch.from_numpy(rs.randn(10, batch, d).astype(np.float32))
             .cuda())
            for d in (lion.style_dim, lion.local_dim))

        def sample():
            out = lion.sample(batch, given_noise=noise)
            return out["z_global"], out["z_local"], out["points"]
        out = _bit_equal(f"LION.sample 10 steps given_noise "
                         f"{'bf16' if bf16 else 'fp32'} B{batch}", sample,
                         "repeat")
        if not all(torch.isfinite(o).all() for o in out):
            raise AssertionError("non-finite samples")
        del lion


def _path_counts(path, label):
    """The launch and plain-call counts since the last reset; raise unless
    every kernel of `path` launched and no plain version ran."""
    from lion_tpu_torch import ops
    counts = {n: (w.launches, w.plain_calls) for n, w in ops.KERNELS.items()}
    log(f"[{label}] launches (kernel, plain): {counts}")
    missing = [n for n in path if counts[n][0] == 0]
    plain = [n for n, (_, p) in counts.items() if p != 0]
    if missing or plain:
        raise AssertionError(f"kernels not launched: {missing}; "
                             f"plain versions run: {plain}")
    return {n: k for n, (k, _) in counts.items()}


def phase_main_path(cfg, steps, batch, requests, path, label):
    """Serve `requests` sampling requests through LION.sample; the launch
    counters are zeroed just before and read just after."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.models import LION
    cfg.ddpm.num_steps = steps
    t0 = time.perf_counter()
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0))
    log(f"[main {label}] LION flagship {label}, "
        f"{sum(p.numel() for p in lion.parameters())} params, init "
        f"{time.perf_counter() - t0:.1f} s; {requests} requests x batch "
        f"{batch}, {steps} DDPM steps per prior")
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
        log(f"[main {label}] request {i}: {wall:.3f} s wall (global "
            f"{s['global']:.3f}, local {s['local']:.3f}, decode "
            f"{s['decode']:.3f} s); points |max| "
            f"{float(pts.abs().max()):.3f}, std {float(pts.std()):.4f}")
    counts = _path_counts(path, f"main {label}")
    steady = runs[1:] or runs
    wall = sum(r[0] for r in steady) / len(steady)
    g_ms = 1e3 * sum(r[1]["global"] for r in steady) / len(steady) / steps
    l_ms = 1e3 * sum(r[1]["local"] for r in steady) / len(steady) / steps
    log(f"[main {label}] steady ({len(steady)} requests): "
        f"{batch / wall:.4f} shapes/s, global-prior step {g_ms:.3f} ms, "
        f"local-prior step {l_ms:.3f} ms (batch {batch})")
    return counts


def _to(draws, dev):
    return {k: (tuple(t.to(dev) for t in v) if isinstance(v, tuple)
                else v.to(dev)) for k, v in draws.items()}


def phase_grad_parity(cfg, loss_tol=1e-4, grad_tol=1e-3):
    """One full-width flagship two-prior loss at batch 2 with dropout 0, its
    gradients on the card against the same modules on the CPU (in bf16
    under cfg.tpu.bf16)."""
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.ops._cuda import no_tf32
    from lion_tpu_torch.trainers import prior_loss
    cfg.sde.dropout = cfg.ddpm.dropout = 0.0
    cpu = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(11))
    gpu = LION(cfg)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=g)
    # a normalized-scale cloud, the encoder's two standard normals, t and
    # the two diffusion noises, on the CPU
    x = randn(2, 2048, 3) * 0.3
    draws = dict(rho=(randn(2, 128), randn(2, 2048 * 4)),
                 timestep=torch.tensor([500, 20]),
                 noise=(randn(2, 128), randn(2, 2048 * 4)))
    runs, seconds = [], []
    for lion, dev in ((cpu, "cpu"), (gpu, "cuda")):
        t0 = time.perf_counter()
        with no_tf32():
            loss, metrics = prior_loss(lion, x.to(dev), **_to(draws, dev))
            loss.backward()
        grads = {f"{prior}.{k}": p.grad.detach().cpu()
                 for prior in ("global_prior", "local_prior")
                 for k, p in getattr(lion, prior).named_parameters()}
        runs.append(({k: float(v.detach()) for k, v in metrics.items()},
                     grads))
        seconds.append(time.perf_counter() - t0)
    # fp32 through the encode, two priors and their backward, with every
    # sum taken in another order on each side; the index decisions (FPS,
    # ball query, voxel rounding, 3-NN) match, so the gradients agree to
    # fp32 rounding amplified by depth
    label = "flagship prior loss B2" + (" bf16" if cfg.tpu.bf16 else "")
    return _grad_gate("grad parity", label, runs, seconds, loss_tol,
                      grad_tol)


def _grad_gate(tag, label, runs, seconds, loss_tol=1e-4, grad_tol=1e-3):
    """Hold the card's (metrics, gradients) to the CPU's: the loss within
    `loss_tol` relative, the flattened gradient within `grad_tol` relative
    L2; print the worst tensor."""
    (ref_m, ref_g), (got_m, got_g) = runs
    loss_rel = abs(got_m["loss"] - ref_m["loss"]) / abs(ref_m["loss"])
    diff = torch.cat([(got_g[k].double() - ref_g[k].double()).reshape(-1)
                      for k in ref_g])
    norm = torch.cat([g.double().reshape(-1) for g in ref_g.values()]).norm()
    rel = float(diff.norm() / norm)
    worst = max(ref_g, key=lambda k: float(
        (got_g[k].double() - ref_g[k].double()).norm()
        / max(float(ref_g[k].double().norm()), 1e-30)))
    worst_rel = float((got_g[worst].double() - ref_g[worst].double()).norm()
                      / ref_g[worst].double().norm())
    log(f"[{tag}] {label}: card {got_m} vs cpu {ref_m}; "
        f"loss relative error {loss_rel:.3e} (limit {loss_tol:g}), "
        f"flattened gradient relative L2 {rel:.3e} (limit {grad_tol:g}) "
        f"over {diff.numel()} "
        f"values; worst tensor {worst} {worst_rel:.3e}; cpu "
        f"{seconds[0]:.1f} s, card {seconds[1]:.2f} s (first call)")
    if not loss_rel <= loss_tol:
        raise AssertionError(f"loss: relative error {loss_rel:.3e}")
    if not rel <= grad_tol:
        raise AssertionError(f"gradient: relative L2 {rel:.3e}")
    return {"loss_rel": loss_rel, "grad_rel_l2": rel}


def phase_train(cfg, batch, warmup, steps):
    """The flagship two-prior training step, with dropout, on the default
    device; the launch counters are zeroed just before the steps and read
    just after."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.trainers import (make_prior_train_step,
                                         warmup_cosine_schedule)
    t0 = time.perf_counter()
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0))
    # the schedule scripts/profile_train_step.py gives the JAX step
    step = make_prior_train_step(
        lion, warmup_cosine_schedule(2e-4, 2e-4, 10, 10, 1, 10))
    gen = torch.Generator(device="cuda").manual_seed(21)
    x = torch.randn(batch, 2048, 3, generator=gen, device="cuda") * 0.3
    n_params = sum(p.numel() for p in step.params)
    log(f"[train] flagship two-prior step, {n_params} prior params, init "
        f"{time.perf_counter() - t0:.1f} s; batch {batch}, {warmup} warm-up "
        f"+ {steps} timed steps")
    params0 = [p.detach().clone() for p in step.params]
    ema0 = [e.clone() for e in step.ema.shadow]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    metrics = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        metrics.append(step(x, gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _path_counts(TRAIN_PATH, "train")
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    log(f"[train] losses: {[round(m['loss'], 4) for m in losses]}")
    if not all(torch.isfinite(torch.tensor(list(m.values()))).all()
               for m in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for name, now, before in (("parameters", step.params, params0),
                              ("EMA", step.ema.shadow, ema0)):
        if not all(bool(torch.isfinite(p).all()) for p in now):
            raise AssertionError(f"non-finite {name}")
        moved = sum(int((p.detach() != q).sum()) for p, q in zip(now, before))
        log(f"[train] {name}: {moved} of {n_params} values changed")
        if moved == 0:
            raise AssertionError(f"the {name} did not change")
    log(f"[train] {wall / steps * 1e3:.3f} ms/step, "
        f"{batch * steps / wall:.3f} samples/s at batch {batch}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return counts


def phase_vae_grad_parity(cfg, loss_tol=1e-4, grad_tol=1e-3):
    """One full-width flagship VAE `get_loss` at batch 2 (dropout 0,
    `l1_sum`, train mode: the modular PVConv flow on K10 and the SA blocks'
    unfused branch), its gradients on the card against the same module on
    the CPU (in bf16 under cfg.tpu.bf16)."""
    from lion_tpu_torch.models.vae import VAE
    from lion_tpu_torch.nn import init_weights
    from lion_tpu_torch.ops._cuda import no_tf32
    cfg.ddpm.dropout = 0.0
    cfg.ddpm.loss_type = "l1_sum"
    cpu = VAE(cfg)
    init_weights(cpu, torch.Generator().manual_seed(13))
    with torch.device("cuda"):
        gpu = VAE(cfg)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(14)
    x = torch.randn(2, 2048, 3, generator=g) * 0.3
    rho = (torch.randn(2, 128, generator=g),
           torch.randn(2, 2048 * 4, generator=g))
    runs, seconds = [], []
    for vae, dev in ((cpu, "cpu"), (gpu, "cuda")):
        t0 = time.perf_counter()
        vae.train()
        with no_tf32():
            out = vae.get_loss(x.to(dev), rho=tuple(r.to(dev) for r in rho))
            out["loss"].backward()
        metrics = {k: float(out[k].detach()) for k in
                   ("loss", "print/loss_0", "print/kl_glb", "print/kl_pt",
                    "print/kl_feat")}
        runs.append((metrics, {k: p.grad.detach().cpu()
                               for k, p in vae.named_parameters()}))
        seconds.append(time.perf_counter() - t0)
    # the three networks and their backward in fp32, sums in other orders;
    # FPS, ball query, voxel rounding and 3-NN decide alike on both sides
    label = "flagship VAE get_loss B2" + (" bf16" if cfg.tpu.bf16 else "")
    return _grad_gate("vae grad parity", label, runs, seconds, loss_tol,
                      grad_tol)


# bf16 training's card-vs-CPU gate: both sides round to bf16 at the same
# places (the kernels and their plain versions), but their float32 sums run
# in other orders, so a rounding lands one bf16 ulp (2^-8) apart here and
# there and moves what follows; the bf16 forward gate of the JAX package
# (relative L2 0.03, tests/test_bf16_quality.py:87) bounds the gradient,
# and the loss, a mean over the batch, is held to 1e-2
BF16_LOSS_TOL, BF16_GRAD_TOL = 1e-2, 3e-2


def phase_bf16_grad_parity():
    """bf16 training (tpu.bf16): phase 7's two-prior loss and phase 11's VAE
    get_loss in bf16, their gradients on the card against the CPU."""
    from lion_tpu_torch.config import flagship_cfg
    out = {}
    for name, fn in (("prior", phase_grad_parity),
                     ("vae", phase_vae_grad_parity)):
        cfg = flagship_cfg()
        cfg.tpu.bf16 = True
        out[name] = fn(cfg, BF16_LOSS_TOL, BF16_GRAD_TOL)
    return out


def phase_repeat_steps():
    """Run-to-run reproducibility of training: one fp32 two-prior step at
    batch 16 and one bf16 stage-1 step at batch 32, each on two fresh
    flagship copies from one seed and the same draws
    (profile_step.step_twice): the updated parameters and EMA must be
    equal bit for bit."""
    from lion_tpu_torch.profile_step import step_twice
    for kind, bf16, batch in (("prior", False, BATCH_TRAIN),
                              ("vae", True, BATCH_VAE)):
        t0 = time.perf_counter()
        differ, losses = step_twice(kind, bf16, batch)
        label = f"{kind} {'bf16' if bf16 else 'fp32'} B{batch} step"
        log(f"[repeat steps] {label}: losses {losses}; "
            f"{'bit-equal' if not differ else f'{len(differ)} tensors differ'}"
            f" ({time.perf_counter() - t0:.1f} s)")
        if differ:
            raise AssertionError(f"{label} does not repeat: {differ[:6]}")


def _timed_steps(tag, step, x, gen, warmup, steps, batch, path):
    """warmup + steps calls of a training step with the launch counters
    zeroed just before and read just after (every kernel of the training
    path launched, K10 and K2 among them on bf16 tensors); ms/step,
    samples/s, peak; then the device ms and busy share of 2 steps under
    torch.profiler. Returns the launch counts."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.profile_step import _device_groups
    params0 = [p.detach().clone() for p in step.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    losses = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        losses.append(step(x, gen)["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _path_counts(path, tag)
    bf16 = {n: ops.KERNELS[n].launches_bf16 for n in BF16_TRAIN_KERNELS}
    log(f"[{tag}] launches on bf16 tensors: {bf16}")
    if not all(bf16.values()):
        raise AssertionError(f"kernels not launched on bf16: {bf16}")
    losses = [float(v) for v in losses]
    moved = sum(int((p.detach() != q).sum())
                for p, q in zip(step.params, params0))
    if not np.isfinite(losses).all() or moved == 0 or not all(
            bool(torch.isfinite(p).all()) and p.dtype == torch.float32
            for p in step.params + step.ema.shadow):
        raise AssertionError(f"{tag}: losses {losses}, {moved} moved")
    wall_p, groups = _device_groups(lambda: step(x, gen), 2)
    busy = sum(v[0] for v in groups.values())
    k10 = groups.get("K conv3d_3x3_same", [0.0, 0])
    wgrad = groups.get("K conv3d_weight_grad", [0.0, 0])
    log(f"[{tag}] losses {[round(v, 4) for v in losses]}; "
        f"{wall / steps * 1e3:.3f} ms/step, {batch * steps / wall:.3f} "
        f"samples/s at batch {batch}; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; fp32 parameters, {moved} values "
        f"changed; under torch.profiler {wall_p:.3f} ms wall, device "
        f"{busy:.3f} ms, busy share {busy / wall_p:.3f}: K10 "
        f"{k10[0]:.3f} ms, K10's wgrad {wgrad[0]:.3f} ms")
    for name, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"[{tag}]   {ms:9.3f} ms {n:6d} ops  {name}")
    return counts


def phase_bf16_train(warmup, steps):
    """bf16 training's main steps: the flagship two-prior step at batch 16
    and the stage-1 VAE step at batch 32 under tpu.bf16 (profile_step's
    inputs), warmup + steps each (`_timed_steps`)."""
    from lion_tpu_torch.profile_step import train_step_of
    out = {}
    for kind, batch, path in (("prior", BATCH_TRAIN, TRAIN_PATH),
                              ("vae", BATCH_VAE, STAGE1_STEP_PATH)):
        step, _, x, gen = train_step_of(kind, True, batch)
        out[kind] = _timed_steps(f"bf16 train {kind}", step, x, gen, warmup,
                                 steps, batch, path)
        del step, x
    return out


def _write_pointflow(root, counts, seed):
    """A synthetic PointFlow-layout split (<root>/<synset>/<split>/*.npy)
    of 15000-point clouds, each a random ellipsoid shell with noise."""
    rs = np.random.RandomState(seed)
    for split, count in counts.items():
        d = os.path.join(root, "03001627", split)
        os.makedirs(d)
        for i in range(count):
            v = rs.randn(15000, 3)
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            pts = v * rs.uniform(0.2, 0.5, 3) + 0.01 * rs.randn(15000, 3)
            np.save(os.path.join(d, f"{i:04d}.npy"), pts.astype(np.float32))


def _equal_steps(a, b):
    """True when two trainers' steps hold equal parameters, EMA, Adam state
    and counts."""
    pairs = [(a.params, b.params), (a.ema.shadow, b.ema.shadow),
             *zip(a.optimizer.moments(), b.optimizer.moments())]
    return all(torch.equal(x, y) for u, v in pairs for x, y in zip(u, v)) \
        and a.optimizer.count == b.optimizer.count


def _stage1_cfg(batch):
    """Phase 12's stage-1 trainer configuration: the flagship VAE, `l1_sum`,
    the KL anneal, one epoch, the visualizations off."""
    from lion_tpu_torch.config import flagship_cfg
    cfg = flagship_cfg()
    cfg.data.cates = "chair"
    cfg.data.batch_size = cfg.data.batch_size_test = batch
    cfg.data.eval_test_split = 1
    cfg.ddpm.loss_type = "l1_sum"
    cfg.trainer.anneal_kl = 1
    cfg.trainer.epochs = 1
    cfg.viz.viz_freq = 0
    return cfg


def _stage2_cfg(batch, vae_checkpoint):
    """Phase 13's two-prior trainer configuration on a stage-1 checkpoint:
    one epoch, run_eval every epoch (STAGE2_VAL_SAMPLES shapes at
    STAGE2_DDIM_STEPS DDIM steps), the visualizations off."""
    from lion_tpu_torch.config import flagship_cfg
    cfg = flagship_cfg()
    cfg.trainer.type = "trainers.train_2prior"
    cfg.data.cates = "chair"
    cfg.data.batch_size = cfg.data.batch_size_test = batch
    cfg.data.eval_test_split = 1
    cfg.sde.vae_checkpoint = vae_checkpoint
    cfg.trainer.epochs = 1
    cfg.viz.viz_freq = 0
    cfg.viz.val_freq = 1
    cfg.eval_ddim_step = STAGE2_DDIM_STEPS
    cfg.num_val_samples = STAGE2_VAL_SAMPLES
    return cfg


def phase_vae_trainer(tmp, batch, warmup, steps):
    """The flagship stage-1 trainer: `Trainer(cfg, args).train_epochs()`
    over one epoch of warmup + steps batches of a synthetic dataset under
    `tmp`, a resume of its final checkpoint, and `eval_nll` on the test
    split; the launch counters are zeroed just before the epoch and read
    just after eval_nll. Returns the counts and the final checkpoint's
    path (stage 2's sde.vae_checkpoint)."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.trainers.hvae_trainer import Trainer
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    _write_pointflow(data, {"train": (warmup + steps) * batch,
                            "val": batch, "test": batch}, seed=41)
    cfg = _stage1_cfg(batch)
    args = argparse.Namespace(save_dir=os.path.join(tmp, "exp"),
                              data_root=data)
    trainer = Trainer(cfg, args)
    step = trainer.step_fn
    n_params = sum(p.numel() for p in step.params)
    log(f"[vae train] flagship VAE, {n_params} params, data and init "
        f"{time.perf_counter() - t0:.1f} s; batch {batch}, {warmup} "
        f"warm-up + {steps} timed steps of Trainer.train_epochs")
    params0 = [p.detach().clone() for p in step.params]
    ema0 = [e.clone() for e in step.ema.shadow]
    ends, losses = [], []
    train_iter = trainer.train_iter

    def timed_iter(b, step):
        metrics = train_iter(b, step)   # floats: synchronised
        ends.append(time.perf_counter())
        losses.append(metrics)
        return metrics
    trainer.train_iter = timed_iter
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    trainer.train_epochs()
    peak = torch.cuda.max_memory_allocated()
    train_counts = {n: w.launches for n, w in ops.KERNELS.items()}
    log(f"[vae train] losses: {[round(m['loss'], 3) for m in losses]}; "
        f"kl weights {[m['print/kl_weight'] for m in losses]}")
    if trainer.step != warmup + steps or not all(
            np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"{trainer.step} steps, losses {losses}")
    for name, now, before in (("parameters", step.params, params0),
                              ("EMA", step.ema.shadow, ema0)):
        if not all(bool(torch.isfinite(p).all()) for p in now):
            raise AssertionError(f"non-finite {name}")
        moved = sum(int((p.detach() != q).sum())
                    for p, q in zip(now, before))
        log(f"[vae train] {name}: {moved} of {n_params} values changed")
        if moved == 0:
            raise AssertionError(f"the {name} did not change")
    wall = ends[-1] - ends[warmup - 1]
    log(f"[vae train] {wall / steps * 1e3:.3f} ms/step, "
        f"{batch * steps / wall:.3f} samples/s at batch {batch}; peak "
        f"device memory {peak / 2 ** 30:.3f} GiB; launches a step "
        f"{ {n: c // (warmup + steps) for n, c in train_counts.items() if c} }")

    t0 = time.perf_counter()
    again = Trainer(cfg, args)
    again.resume(os.path.join(trainer.ckpt_dir, "final.npz"))
    if not _equal_steps(step, again.step_fn) or (
            again.epoch, again.step) != (trainer.epoch, trainer.step):
        raise AssertionError("the resumed stage-1 trainer differs")
    log(f"[vae train] final.npz resumed by a second Trainer: parameters, "
        f"EMA, Adam state, epoch {again.epoch}, step {again.step} equal "
        f"({time.perf_counter() - t0:.1f} s)")
    del again

    t0 = time.perf_counter()
    results = trainer.eval_nll()
    if not np.isfinite([results["MMD-CD"], results["MMD-EMD"]]).all():
        raise AssertionError(f"eval_nll: {results}")
    log(f"[vae train] eval_nll on the test split ({batch} clouds): CD "
        f"{results['MMD-CD']:.6f}, EMD {results['MMD-EMD']:.6f} "
        f"({time.perf_counter() - t0:.2f} s)")
    trainer.writer.close()
    return (_path_counts(VAE_TRAIN_PATH, "vae train"),
            os.path.join(trainer.ckpt_dir, "final.npz"))


def phase_stage2_trainer(tmp, vae_checkpoint, batch, warmup, steps):
    """The flagship stage-2 trainers on the stage-1 phase's checkpoint: the
    two-prior `Trainer` (through `get_trainer`) for one epoch of warmup +
    steps batches of a synthetic dataset under `tmp` with one `run_eval`,
    a resume, `eval_sample` with EMD, the `.pt` export loaded back into a
    LION; then the single-prior trainer (2 steps and a sample) and the two
    interpolation trainers, cut in depth. The launch counters are zeroed
    just before the epoch and read at the end."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.ckpt import load_checkpoint, load_lion_checkpoint
    from lion_tpu_torch.ckpt.io import flatten_tree
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.trainers import get_trainer
    data = os.path.join(tmp, "data_stage2")
    t0 = time.perf_counter()
    _write_pointflow(data, {"train": (warmup + steps) * batch,
                            "val": batch, "test": STAGE2_VAL_SAMPLES},
                     seed=43)
    cfg = _stage2_cfg(batch, vae_checkpoint)
    args = argparse.Namespace(save_dir=os.path.join(tmp, "exp2"),
                              data_root=data)
    trainer = get_trainer(cfg.trainer.type)(cfg, args)
    step = trainer.step_fn
    n_params = sum(p.numel() for p in step.params)
    stage1, _ = load_checkpoint(vae_checkpoint)
    vae_names, vae_tensors = zip(*trainer.vae.named_parameters())
    want = {".".join(k): v for k, v in flatten_tree(stage1["model"]).items()}
    if not all(torch.equal(t.cpu(), torch.from_numpy(want[n]))
               for n, t in zip(vae_names, vae_tensors)):
        raise AssertionError("the stage-2 VAE is not the stage-1 checkpoint")
    log(f"[stage2] {type(trainer).__module__}.{type(trainer).__name__}, "
        f"{n_params} prior params, the VAE of {vae_checkpoint} (equal); data "
        f"and init {time.perf_counter() - t0:.1f} s; batch {batch}, "
        f"{warmup} warm-up + {steps} timed steps, one run_eval "
        f"({STAGE2_VAL_SAMPLES} shapes, {STAGE2_DDIM_STEPS} DDIM steps)")
    params0 = [p.detach().clone() for p in step.params]
    ema0 = [e.clone() for e in step.ema.shadow]
    ends, losses, evals = [], [], []
    train_iter, run_eval = trainer.train_iter, trainer.run_eval

    def timed_iter(b, step):
        metrics = train_iter(b, step)   # floats: synchronised
        ends.append(time.perf_counter())
        losses.append(metrics)
        return metrics

    def timed_eval():
        t = time.perf_counter()
        score = run_eval()
        evals.append((time.perf_counter() - t, score))
        return score
    trainer.train_iter, trainer.run_eval = timed_iter, timed_eval
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    trainer.train_epochs()
    peak = torch.cuda.max_memory_allocated()
    log(f"[stage2] losses: {[round(m['loss'], 4) for m in losses]}")
    if trainer.step != warmup + steps or not all(
            np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"{trainer.step} steps, losses {losses}")
    for name, now, before in (("parameters", step.params, params0),
                              ("EMA", step.ema.shadow, ema0)):
        if not all(bool(torch.isfinite(p).all()) for p in now):
            raise AssertionError(f"non-finite {name}")
        moved = sum(int((p.detach() != q).sum()) for p, q in zip(now, before))
        log(f"[stage2] {name}: {moved} of {n_params} values changed")
        if moved == 0:
            raise AssertionError(f"the {name} did not change")
    if len(evals) != 1 or not np.isfinite(evals[0][1]):
        raise AssertionError(f"run_eval: {evals}")
    wall = ends[-1] - ends[warmup - 1]
    log(f"[stage2] {wall / steps * 1e3:.3f} ms/step, "
        f"{batch * steps / wall:.3f} samples/s at batch {batch}; peak "
        f"device memory {peak / 2 ** 30:.3f} GiB; run_eval (CD) "
        f"{evals[0][0]:.3f} s, 1-NN-CD accuracy {evals[0][1]:.4f}")

    t0 = time.perf_counter()
    again = get_trainer(cfg.trainer.type)(cfg, args)
    again.resume(os.path.join(trainer.ckpt_dir, "final.npz"))
    if not _equal_steps(step, again.step_fn) or (
            again.epoch, again.step) != (trainer.epoch, trainer.step):
        raise AssertionError("the resumed stage-2 trainer differs")
    log(f"[stage2] final.npz resumed by a second Trainer: parameters, EMA, "
        f"Adam state, epoch {again.epoch}, step {again.step} equal "
        f"({time.perf_counter() - t0:.1f} s)")
    del again

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = trainer.eval_sample(trainer.step, num_gen=STAGE2_VAL_SAMPLES,
                                  metric2="EMD")
    seconds = time.perf_counter() - t0
    if "1-NN-EMD-acc" not in results or not np.isfinite(
            list(results.values())).all():
        raise AssertionError(f"eval_sample: {results}")
    log(f"[stage2] eval_sample(metric2='EMD'): {STAGE2_VAL_SAMPLES} shapes "
        f"({STAGE2_DDIM_STEPS} DDIM steps, batches of {batch}) scored against "
        f"the test split in {seconds:.3f} s: "
        f"{ {k: round(float(v), 6) for k, v in results.items()} }")

    t0 = time.perf_counter()
    path = os.path.join(tmp, "prior.pt")
    trainer.export_torch(path)
    lion = LION(cfg).load_jax_params(load_lion_checkpoint(path, cfg))
    sd = lion.state_dict()
    if not all(torch.equal(sd[n], e) for n, e in
               zip(trainer.param_names, step.ema.shadow)) or not all(
            torch.equal(sd[f"vae.{n}"], t)
            for n, t in zip(vae_names, vae_tensors)):
        raise AssertionError("the exported .pt differs from the EMA priors")
    pts = lion.sample(2, torch.Generator(device="cuda").manual_seed(5),
                      ddim_step=STAGE2_DDIM_STEPS)["points"]
    if tuple(pts.shape) != (2, 2048, 3) or not bool(torch.isfinite(pts).all()):
        raise AssertionError(f"sample of the exported LION {pts.shape}")
    log(f"[stage2] export_torch -> load_lion_checkpoint -> LION on the card: "
        f"equal to the EMA bit for bit; a {STAGE2_DDIM_STEPS}-step DDIM "
        f"sample finite ({time.perf_counter() - t0:.1f} s)")
    del lion, sd, trainer, step

    t0 = time.perf_counter()
    cfg1 = copy.deepcopy(cfg)
    cfg1.trainer.type = "trainers.train_prior"
    single = get_trainer(cfg1.trainer.type)(cfg1, argparse.Namespace(
        save_dir=os.path.join(tmp, "exp_single"), data_root=data))
    batches = iter(single.train_loader)
    metrics = [single.train_iter(next(batches), i) for i in range(2)]
    pts = single.sample(2)
    if not (np.isfinite([m["loss"] for m in metrics]).all()
            and bool(torch.isfinite(pts).all())
            and tuple(pts.shape) == (2, 2048, 3)):
        raise AssertionError(f"single prior: {metrics}, {pts.shape}")
    log(f"[stage2] single-prior trainer (eps_dim {single.eps_dim}): 2 steps "
        f"at batch {batch}, losses {[round(m['loss'], 4) for m in metrics]}; "
        f"sample(2) over {cfg1.ddpm.num_steps} steps finite "
        f"({time.perf_counter() - t0:.1f} s)")
    del single

    for kind, over, call in (
            ("trainers.interpolate_latent", INTERP_STEPS,
             lambda t: t.sample(4)),
            ("trainers.encode_interp_interp", None,
             lambda t: t.sample(4, diffuse_t=INTERP_STEPS))):
        t0 = time.perf_counter()
        cfgi = copy.deepcopy(cfg)
        cfgi.trainer.type = kind
        if over:
            cfgi.ddpm.num_steps = over
        interp = get_trainer(kind)(cfgi, argparse.Namespace(
            save_dir=os.path.join(tmp, "exp_interp"), data_root=data))
        pts = call(interp)
        if tuple(pts.shape) != (4, 2048, 3) or not bool(
                torch.isfinite(pts).all()):
            raise AssertionError(f"{kind}: {tuple(pts.shape)}")
        cut = (f"ddpm.num_steps 1000 -> {INTERP_STEPS}" if over else
               f"diffuse_t 200 -> {INTERP_STEPS}")
        log(f"[stage2] {kind}: sample(4) finite, cut in depth: {cut} "
            f"({time.perf_counter() - t0:.1f} s)")
        del interp
    return _path_counts(STAGE2_TRAINER_PATH, "stage2 train")


def phase_bf16_trainers(tmp, batch_vae, batch_stage2):
    """bf16 training through the trainers, on phases 12's and 13's
    synthetic splits: the stage-1 Trainer under sde.autocast_train (which
    sets tpu.bf16) for one epoch at batch `batch_vae`, then the two-prior
    Trainer under tpu.bf16 on that run's final checkpoint for one epoch at
    `batch_stage2` (run_eval off). Each: fp32 parameters, every kernel of
    the training path launched (K10, K2, K3, K5, K6 and the row sum on
    bf16 tensors), its final checkpoint resumed equal by a bf16 trainer and
    by an fp32 one. The launch counters are zeroed before each epoch. The
    stage-1 VAE's style posterior head starts damped by 0.01, as in
    profile_step.train_step_of."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.profile_step import damp_style_head
    from lion_tpu_torch.trainers import get_trainer
    out, stage1 = {}, None
    for kind, batch, key, data, path in (
            ("trainers.hvae_trainer", batch_vae, "sde.autocast_train",
             "data", STAGE1_STEP_PATH),
            ("trainers.train_2prior", batch_stage2, "tpu.bf16",
             "data_stage2", TRAIN_PATH)):
        def cfg_of(bf16, kind=kind, batch=batch, key=key):
            cfg = _stage1_cfg(batch) if stage1 is None else \
                _stage2_cfg(batch, stage1)
            cfg.trainer.type = kind
            cfg.viz.val_freq = 0
            if bf16:
                node, leaf = key.split(".")
                setattr(getattr(cfg, node), leaf, True)
            return cfg
        args = argparse.Namespace(save_dir=os.path.join(tmp, f"bf16_{kind}"),
                                  data_root=os.path.join(tmp, data))
        t0 = time.perf_counter()
        cfg = cfg_of(True)
        trainer = get_trainer(kind)(cfg, args)
        if stage1 is None:
            # lion_tpu's bf16 trainer test damps the random-init style
            # posterior head, whose log sigma can overflow exp()
            # (profile_step.damp_style_head); stage 2 loads this run's VAE
            damp_style_head(trainer.vae)
        if not cfg.tpu.bf16:
            raise AssertionError(f"{kind}: {key} did not set tpu.bf16")
        ends = []
        train_iter = trainer.train_iter

        def timed_iter(b, step, train_iter=train_iter, ends=ends):
            metrics = train_iter(b, step)   # floats: synchronised
            ends.append((time.perf_counter(), metrics["loss"]))
            return metrics
        trainer.train_iter = timed_iter
        tag = f"bf16 trainer {kind.split('.')[-1]}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        t1 = time.perf_counter()
        trainer.train_epochs()
        peak = torch.cuda.max_memory_allocated()
        out[kind] = _path_counts(path, tag)
        bf16 = {n: ops.KERNELS[n].launches_bf16 for n in BF16_TRAIN_KERNELS}
        step = trainer.step_fn
        losses = [v for _, v in ends]
        if not all(bf16.values()) or not np.isfinite(losses).all() or not \
                all(p.dtype == torch.float32 and bool(torch.isfinite(p).all())
                    for p in step.params + step.ema.shadow):
            raise AssertionError(f"{tag}: bf16 launches {bf16}, losses "
                                 f"{losses}")
        n = len(ends)
        if n < 2:
            raise AssertionError(f"{tag}: {n} steps")
        wall = (ends[-1][0] - ends[0][0]) / (n - 1)
        log(f"[{tag}] {key} -> tpu.bf16: {n} steps at batch {batch}, "
            f"losses {[round(v, 4) for v in losses]}; "
            f"{wall * 1e3:.3f} ms/step after the first; "
            f"peak {peak / 2 ** 30:.3f} GiB; launches on bf16 {bf16}; "
            f"built in {t1 - t0:.1f} s")
        final = os.path.join(trainer.ckpt_dir, "final.npz")
        for bf in (True, False):
            again = get_trainer(kind)(cfg_of(bf), args)
            again.resume(final)
            if not _equal_steps(step, again.step_fn):
                raise AssertionError(f"{tag}: the resumed "
                                     f"{'bf16' if bf else 'fp32'} trainer "
                                     f"differs")
            del again
        log(f"[{tag}] final.npz (fp32 parameters) resumed equal by a bf16 "
            f"and an fp32 trainer")
        stage1 = final
        trainer.writer.close()
        del trainer, step
    return out


def _ode_cfg(cfg, tol):
    cfg.sde.ode_sample = 1
    cfg.sde.ode_solver_tol = tol
    return cfg


@torch.no_grad()
def _euler_sample(lion, init_g, init_l):
    """`LION.sample`'s PF-ODE branch with 2 Euler steps a prior in place of
    dopri5, from the starting points init_g (B, style) and init_l
    (B, N*C), then the decode."""
    from lion_tpu_torch.diffusion.continuous import make_diffusion
    lion.eval()
    sde = make_diffusion(lion.cfg.sde)
    b = init_g.shape[0]
    zg, _ = sde.sample_model_ode(
        lion.global_prior, b, (lion.style_dim,), noise=init_g,
        mixing_logit=lion.global_prior.mixing_logit
        if lion.mixed_prediction else None, method="euler", fixed_steps=2)
    zl, _ = sde.sample_model_ode(
        lambda x, t: lion.local_prior(x, t, condition_input=zg), b,
        (lion.local_dim,), noise=init_l,
        mixing_logit=lion.local_prior.mixing_logit
        if lion.mixed_prediction else None, method="euler", fixed_steps=2)
    return {"z_global": zg, "z_local": zl,
            "points": lion.vae.sample(b, [zg, zl])}


def phase_ode_sample(cfg, batch, tol):
    """The flagship LION with sde.ode_sample = 1 (fp32) serves the same
    request of `batch` shapes twice through `LION.sample` (adaptive dopri5
    from t = 1 to sde.ode_eps at tolerance `tol` on both priors): the
    outputs equal and the evaluations equal; the launch counters are zeroed
    just before and read just after. Then a 2-step Euler sample at batch 2
    on the card against the same model on the CPU."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.models import LION
    cfg = _ode_cfg(cfg, tol)
    t0 = time.perf_counter()
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0))
    log(f"[ode] flagship LION under the PF-ODE (dopri5, tolerance {tol}, "
        f"ode_eps {cfg.sde.ode_eps}), fp32, init "
        f"{time.perf_counter() - t0:.1f} s; 2 requests x batch {batch}")
    ops.reset_counts()
    runs = []
    for i in range(2):
        gen = torch.Generator(device="cuda").manual_seed(200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lion.sample(batch, generator=gen)
        wall = time.perf_counter() - t0
        pts = out["points"]
        if tuple(pts.shape) != (batch, 2048, 3) or not bool(
                torch.isfinite(pts).all()):
            raise AssertionError(f"ODE points {tuple(pts.shape)}")
        s = out["stage_seconds"]
        runs.append((wall, out))
        log(f"[ode] request {i}: {wall:.3f} s wall (global {s['global']:.3f}"
            f" s, {out['nfe_global']} evaluations; local {s['local']:.3f} s, "
            f"{out['nfe_local']} evaluations; decode {s['decode']:.3f} s); "
            f"{1e3 * s['local'] / out['nfe_local']:.3f} ms per local "
            f"evaluation, {1e3 * s['global'] / out['nfe_global']:.3f} ms per "
            f"global one; {batch / wall:.4f} shapes/s")
    counts = _path_counts(FP32_PATH, "ode")
    (_, a), (_, b) = runs
    same = all(torch.equal(a[k], b[k]) for k in ("z_global", "z_local",
                                                  "points"))
    log(f"[ode] the two requests: outputs equal {same}, evaluations "
        f"{a['nfe']} and {b['nfe']}")
    if not same or a["nfe"] != b["nfe"]:
        raise AssertionError("the PF-ODE sample does not repeat")

    cpu = LION(cfg, device="cpu")
    cpu.load_state_dict(lion.state_dict())
    g = torch.Generator().manual_seed(15)
    noise = (torch.randn(2, lion.style_dim, generator=g),
             torch.randn(2, lion.local_dim, generator=g))
    t0 = time.perf_counter()
    ref = _euler_sample(cpu, *noise)
    t1 = time.perf_counter()
    got = _euler_sample(lion, *(n.cuda() for n in noise))
    errs = {k: (max_abs(got[k].cpu(), ref[k]), float(ref[k].abs().max()))
            for k in ("z_global", "z_local", "points")}
    log(f"[ode] 2-step Euler B2 card vs CPU (full width): "
        f"{ {k: f'{e:.3e} of {m:.3e}' for k, (e, m) in errs.items()} } "
        f"(limit 1e-4 of the size); cpu {t1 - t0:.1f} s")
    # the first Euler step from t = 1 multiplies the prediction by
    # h g2 / 2 = 5 and the second by ~2.6: the forward's ~3e-6 of its size
    # (phase 4) reaches the latent ~17-fold
    for k, (e, m) in errs.items():
        if not e <= 1e-4 * m:
            raise AssertionError(f"ODE card vs CPU {k}: {e:.3e} of {m:.3e}")
    del lion, cpu
    return counts


@contextlib.contextmanager
def _unrecorded_dx():
    """K10's backward as it was before its dx went through the autograd
    Function: dx by the wrapper's raw launch, which autograd does not
    record, so a backward taken with create_graph loses every second-order
    term through the conv. Yields the list of the backward's calls."""
    from lion_tpu_torch.ops import conv3d
    cls, backward = conv3d._Conv3dSame, conv3d._Conv3dSame.backward
    raw = types.SimpleNamespace(apply=conv3d.conv3d_3x3_same_kernel)
    calls = []

    def raw_backward(ctx, g):
        calls.append(tuple(g.shape))
        conv3d._Conv3dSame = raw
        try:
            return backward(ctx, g)
        finally:
            conv3d._Conv3dSame = cls
    cls.backward = staticmethod(raw_backward)
    try:
        yield calls
    finally:
        cls.backward = staticmethod(backward)


def _weighted_grads(lion, dev, x, draws, sn0):
    """One weighted two-prior loss on `dev` -> ((metrics, gradients),
    (its Jacobian terms, their gradients alone)); the gradients by name on
    the CPU."""
    from lion_tpu_torch.ops._cuda import no_tf32
    from lion_tpu_torch.trainers import prior_loss
    names = [f"{p}.{k}" for p in ("global_prior", "local_prior")
             for k, _ in getattr(lion, p).named_parameters()]
    params = list(lion.global_prior.parameters()) + list(
        lion.local_prior.parameters())
    sn = {k: (u.to(dev), v.to(dev)) for k, (u, v) in sn0.items()}
    lion.zero_grad(set_to_none=True)
    with no_tf32():
        loss, metrics = prior_loss(lion, x.to(dev), sn_state=sn,
                                   **{k: _to_dev(v, dev)
                                      for k, v in draws.items()})
        jac = metrics["train/jac_reg_0"] + metrics["train/jac_reg_1"]
        g_jac = torch.autograd.grad(jac, params, retain_graph=True,
                                    allow_unused=True)
        loss.backward()
    grads = {n: p.grad.detach().cpu() for n, p in zip(names, params)}
    jac_grads = {n: (torch.zeros_like(p) if g is None else g).detach().cpu()
                 for n, p, g in zip(names, params, g_jac)}
    return (({k: float(v.detach()) for k, v in metrics.items()}, grads),
            ({"loss": float(jac.detach())}, jac_grads))


def _flat_rel(got, ref):
    return _rel_l2(torch.cat([got[k].reshape(-1) for k in ref]),
                   torch.cat([g.reshape(-1) for g in ref.values()]))


def phase_weighted_grad_parity(cfg):
    """One full-width weighted two-prior loss (batch 2, dropout 0) with its
    SN, Jacobian and kinetic terms, and its gradients (through K10's dx
    twice: J^T v, then the loss's backward of it), on the card against the
    same modules on the CPU on the same x, draws and power-iteration
    vectors: the whole loss's, and the Jacobian terms' alone, whose
    gradient is all second order. Then the card again with K10's backward
    as it was before (dx unrecorded): the Jacobian gate must fail on it."""
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.profile_step import weighted_cfg
    from lion_tpu_torch.utils.spectral_norm import init_sn_state
    cfg = weighted_cfg(cfg)
    cfg.sde.dropout = cfg.ddpm.dropout = 0.0
    cpu = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(11))
    gpu = LION(cfg)
    gpu.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=g)
    d = 2048 * 4
    x = randn(2, 2048, 3) * 0.3
    draws = dict(rho=(randn(2, 128), randn(2, d)),
                 iw_rho=torch.tensor([0.1, 0.7]),
                 noise=(randn(2, 128), randn(2, d)),
                 jac_probes=((randn(2, 128), randn(2, 128)),
                             (randn(2, d), randn(2, d))))
    names = [f"{p}.{k}" for p in ("global_prior", "local_prior")
             for k, _ in getattr(cpu, p).named_parameters()]
    sn0 = init_sn_state(zip(names, list(cpu.global_prior.parameters())
                            + list(cpu.local_prior.parameters())))
    runs, jac_runs, seconds = [], [], []
    for lion, dev in ((cpu, "cpu"), (gpu, "cuda")):
        t0 = time.perf_counter()
        whole, jac = _weighted_grads(lion, dev, x, draws, sn0)
        runs.append(whole)
        jac_runs.append(jac)
        seconds.append(time.perf_counter() - t0)
    # the parity gate of the CPU tests (a tiny model against lion_tpu):
    # the loss within 1e-5, the flattened gradient within 1e-4; the
    # Jacobian terms' gradient, a backward of a backward, at
    # phase_grad_parity's 1e-4 / 1e-3
    label = "flagship weighted prior loss B2 (SN, jac x2, kin)"
    out = _grad_gate("weighted grad parity", label, runs, seconds,
                     loss_tol=1e-5, grad_tol=1e-4)
    jac_tol = 1e-3
    out["jac"] = _grad_gate("weighted grad parity",
                            "its Jacobian terms alone", jac_runs, seconds,
                            grad_tol=jac_tol)
    with _unrecorded_dx() as calls:
        (_, g_old), (_, gj_old) = _weighted_grads(gpu, "cuda", x, draws,
                                                  sn0)
    old = {"grad_rel_l2": _flat_rel(g_old, runs[0][1]),
           "jac_grad_rel_l2": _flat_rel(gj_old, jac_runs[0][1])}
    log(f"[weighted grad parity] the card with K10's dx unrecorded, as "
        f"before ({len(calls)} K10 backwards): flattened gradient relative "
        f"L2 from the CPU {old['grad_rel_l2']:.3e} (the whole loss's gate "
        f"1e-4), the Jacobian terms' {old['jac_grad_rel_l2']:.3e} (gate "
        f"{jac_tol:g})")
    if not calls or not old["jac_grad_rel_l2"] > 10 * jac_tol:
        raise AssertionError(f"the Jacobian gate does not see K10's dx "
                             f"dropped from the second order: {old}")
    out["unrecorded_dx"] = old
    del cpu, gpu
    return out


def _to_dev(t, dev):
    return tuple(_to_dev(u, dev) for u in t) if isinstance(t, tuple) \
        else t.to(dev)


def phase_weighted_train(cfg, batch, warmup, steps):
    """The flagship weighted two-prior step (continuous ll_iw, SN, Jacobian
    with 2 probes, kinetic, dropout on) at batch `batch`: warmup + steps
    steps of `make_prior_train_step`, the launch counters zeroed just
    before and read just after; then the device time of the objective
    (forward with J^T v) and of the whole step under torch.profiler."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.profile_step import _device_groups, weighted_cfg
    from lion_tpu_torch.trainers import (make_prior_train_step,
                                         warmup_cosine_schedule)
    cfg = weighted_cfg(cfg)
    lion = LION(cfg).init_params(torch.Generator().manual_seed(0))
    step = make_prior_train_step(
        lion, warmup_cosine_schedule(2e-4, 2e-4, 10, 10, 1, 10))
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(batch, 2048, 3, generator=gen, device="cuda") * 0.3
    params0 = [p.detach().clone() for p in step.params]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    metrics = []
    for i in range(warmup + steps):
        if i == warmup:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        metrics.append(step(x, gen))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    counts = _path_counts(TRAIN_PATH, "weighted")
    losses = [{k: float(v) for k, v in m.items()} for m in metrics]
    log(f"[weighted] losses: {[m['loss'] for m in losses]}; the last "
        f"step's metrics: {losses[-1]}")
    if not all(np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"non-finite weighted step: {losses}")
    moved = sum(int((p.detach() != q).sum())
                for p, q in zip(step.params, params0))
    if moved == 0 or not all(bool(torch.isfinite(p).all())
                             for p in step.params):
        raise AssertionError("the weighted step did not train")
    log(f"[weighted] flagship weighted step B{batch} (ll_iw, SN, jac x2, "
        f"kin): {wall / steps * 1e3:.3f} ms/step, "
        f"{batch * steps / wall:.3f} samples/s; peak device memory "
        f"{peak / 2 ** 30:.3f} GiB; {moved} parameter values changed")
    wall_o, obj = _device_groups(lambda: step.objective(x, gen), 2)
    wall_s, full = _device_groups(lambda: step(x, gen), 2)
    dev_o = sum(v[0] for v in obj.values())
    dev_s = sum(v[0] for v in full.values())
    k10 = full.get("K conv3d_3x3_same", [0.0, 0])
    log(f"[weighted] device ms under torch.profiler: objective (forward, "
        f"J^T v, kinetic) {dev_o:.3f} of {wall_o:.3f} ms wall; whole step "
        f"{dev_s:.3f} of {wall_s:.3f} ms wall; so the backward with its "
        f"second-order pass and Adam {dev_s - dev_o:.3f} ms; K10 "
        f"{k10[0]:.3f} ms in {k10[1]} launches a step")
    for name, (ms, n) in sorted(full.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[weighted]   {ms:9.3f} ms {n:6d} ops  {name}")
    del lion, step
    return counts


def phase_ode_trainer(tmp, vae_checkpoint, batch, warmup, steps, tol):
    """The flagship two-prior trainer under sde.ode_sample = 1 and the
    weighted objective (SN, mixed prediction) on phase 12's checkpoint and
    a synthetic split: warmup + steps steps, one `run_eval` sampling its
    shapes through the PF-ODE at tolerance `tol`, then
    `interpolate_posterior_ode` on 2 shapes and 4 rows. The launch
    counters are zeroed just before the epoch and read at the end."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.trainers import get_trainer
    from lion_tpu_torch.trainers.interpolate import interpolate_posterior_ode
    data = os.path.join(tmp, "data_ode")
    _write_pointflow(data, {"train": (warmup + steps) * batch, "val": batch,
                            "test": STAGE2_VAL_SAMPLES}, seed=44)
    cfg = _ode_cfg(flagship_cfg(), tol)
    cfg.trainer.type = "trainers.train_2prior"
    cfg.latent_pts.pvd_mse_loss = 0
    cfg.sde.mixed_prediction = True
    cfg.sde.weight_decay_norm_dae = 1e-2
    cfg.data.cates = "chair"
    cfg.data.batch_size = cfg.data.batch_size_test = batch
    cfg.data.eval_test_split = 1
    cfg.sde.vae_checkpoint = vae_checkpoint
    cfg.trainer.epochs = 1
    cfg.viz.viz_freq = 0
    cfg.viz.val_freq = 1
    cfg.eval_ddim_step = 0
    cfg.num_val_samples = ODE_VAL_SAMPLES
    trainer = get_trainer(cfg.trainer.type)(cfg, argparse.Namespace(
        save_dir=os.path.join(tmp, "exp_ode"), data_root=data))
    if trainer.step_fn.sn_state is None:
        raise AssertionError("the ODE trainer holds no power-iteration state")
    ends, losses, evals = [], [], []
    train_iter, run_eval = trainer.train_iter, trainer.run_eval

    def timed_iter(b, step):
        metrics = train_iter(b, step)
        ends.append(time.perf_counter())
        losses.append(metrics)
        return metrics

    def timed_eval():
        t = time.perf_counter()
        score = run_eval()
        evals.append((time.perf_counter() - t, score))
        return score
    trainer.train_iter, trainer.run_eval = timed_iter, timed_eval
    torch.cuda.synchronize()
    ops.reset_counts()
    trainer.train_epochs()
    if trainer.step != warmup + steps or not all(
            np.isfinite(list(m.values())).all() for m in losses):
        raise AssertionError(f"{trainer.step} steps, losses {losses}")
    if len(evals) != 1 or not np.isfinite(evals[0][1]):
        raise AssertionError(f"run_eval: {evals}")
    wall = ends[-1] - ends[warmup - 1]
    log(f"[ode trainer] weighted continuous steps at batch {batch}: "
        f"{wall / steps * 1e3:.3f} ms/step; last metrics {losses[-1]}; "
        f"run_eval through the PF-ODE ({ODE_VAL_SAMPLES} shapes, tolerance "
        f"{tol}) {evals[0][0]:.3f} s, 1-NN-CD accuracy {evals[0][1]:.4f}")
    batch0 = next(iter(trainer.test_loader))
    x = torch.from_numpy(np.asarray(batch0["tr_points"], np.float32)[:2])
    t0 = time.perf_counter()
    with trainer.as_lion() as lion:
        out = interpolate_posterior_ode(
            lion, x[0].cuda(), x[1].cuda(), 4,
            torch.Generator(device="cuda").manual_seed(3),
            ode_eps=INTERP_ODE_EPS, ode_solver_tol=tol)
    pts = out["points"]
    if tuple(pts.shape) != (4, 2048, 3) or not bool(
            torch.isfinite(pts).all()):
        raise AssertionError(f"interpolate_posterior_ode {pts.shape}")
    log(f"[ode trainer] interpolate_posterior_ode, 2 shapes -> 4 rows "
        f"(ode_eps {INTERP_ODE_EPS}, tolerance {tol}): evaluations "
        f"{out['nfe']}, {time.perf_counter() - t0:.3f} s, finite")
    trainer.writer.close()
    return _path_counts(TRAIN_PATH, "ode trainer")


def phase_cf_op(batch):
    """`ops.ball_query_group_cf` at the SA shapes of scripts/profile_bqg_cf.py
    (bf16 features, K = 32) and one fp32 backward at SA0's shape; the
    counters are zeroed just before and read just after."""
    from lion_tpu_torch import ops
    g = torch.Generator(device="cuda").manual_seed(31)
    shapes = []
    for n, m, c, r in CF_SHAPES:
        pts = torch.randn(batch, n, 3, generator=g, device="cuda") * 0.3
        feats = torch.randn(batch, n, c, generator=g, device="cuda")
        shapes.append((pts, pts[:, :m].contiguous(), feats, r))
    ops.reset_counts()
    for pts, ctr, feats, r in shapes:
        out = ops.ball_query_group_cf(pts, ctr, feats.to(torch.bfloat16), r,
                                      32)
        if out.shape != (batch, 32, 3 + feats.shape[-1], ctr.shape[1]) \
                or out.dtype != torch.bfloat16:
            raise AssertionError(f"ball_query_group_cf {tuple(out.shape)} "
                                 f"{out.dtype}")
    pts, ctr, feats, r = shapes[0]
    xs = [t.clone().requires_grad_(True) for t in (pts, ctr, feats)]
    grads = torch.autograd.grad(ops.ball_query_group_cf(*xs, r, 32).sum(),
                                xs)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(t).all()) for t in grads):
        raise AssertionError("non-finite ball_query_group_cf gradients")
    log(f"[cf op] {len(CF_SHAPES)} shapes forward (bf16) and one backward "
        f"(fp32) at batch {batch}")
    return _path_counts(CF_PATH, "cf op")


def _reference_set(n, seed):
    """n reference clouds of 2048 points with per-cloud normalization stats
    in the layout of the released ref_val_<cat>.pt files: "ref" (n, 2048, 3),
    "mean" (n, 1, 3), "std" (n, 1, 1)."""
    rs = np.random.RandomState(seed)
    ref = rs.randn(n, 2048, 3).astype(np.float32) * 0.2
    mean = rs.randn(n, 1, 3).astype(np.float32) * 0.05
    std = (1.0 + 0.1 * np.abs(rs.randn(n, 1, 1))).astype(np.float32)
    return {"ref": torch.from_numpy(ref), "mean": torch.from_numpy(mean),
            "std": torch.from_numpy(std)}


def _score(samples, ref_set, seed, label):
    """Write the samples and the reference set to .pt files in a temporary
    directory and score them through compute_score on the card; returns
    the results and the seconds."""
    from lion_tpu_torch.eval import compute_score
    with tempfile.TemporaryDirectory() as tmp:
        s_path = os.path.join(tmp, "samples.pt")
        r_path = os.path.join(tmp, "ref.pt")
        torch.save(samples, s_path)
        torch.save(ref_set, r_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = compute_score(s_path, r_path, device="cuda",
                                results_dir=tmp, dataset=label,
                                rng=np.random.RandomState(seed))
        seconds = time.perf_counter() - t0
        with open(os.path.join(tmp, "eval_out.csv")) as f:
            tsv = f.read()
    want = {f"{s}-{m}" for s in ("lgan_mmd", "lgan_cov", "lgan_mmd_smp")
            for m in ("CD", "EMD")} | {
        f"1-NN-{m}-{a}" for m in ("CD", "EMD")
        for a in ("acc", "acc_t", "acc_f")} | {"jsd"}
    if set(results) != want:
        raise AssertionError(f"result keys {sorted(results)}")
    if not all(np.isfinite(v) and v >= 0 for v in results.values()):
        raise AssertionError(f"results {results}")
    if not all(0 <= results[k] <= 1 for k in want if "cov" in k
               or "acc" in k):
        raise AssertionError(f"COV / 1-NNA outside [0, 1]: {results}")
    if len(tsv.splitlines()) != 2 or label not in tsv:
        raise AssertionError(f"eval_out.csv: {tsv!r}")
    return results, seconds


def _emd_pairs(ns, nr):
    """The (sample, ref) pairs K12 computes for an ns x nr EMD matrix, the
    blocks' padding included."""
    from lion_tpu_torch.eval.metrics import EMD_BLOCK
    bs, br = EMD_BLOCK
    return (-(-ns // bs) * bs) * (-(-nr // br) * br)


def phase_eval(cfg, n_shapes, batch, ddim_step, seed=0):
    """The evaluation main path: DDIM sampling of `n_shapes` shapes in
    batches, then compute_score against a reference set made from the seed;
    the counters are zeroed just before sampling and read after scoring."""
    from lion_tpu_torch import ops
    from lion_tpu_torch.eval.metrics import block_pairs, pairwise_emd
    from lion_tpu_torch.models import LION
    lion = LION(cfg).init_params(torch.Generator().manual_seed(seed))
    ref_set = _reference_set(n_shapes, seed)
    log(f"[eval] LION flagship bf16: {n_shapes} shapes by DDIM "
        f"({ddim_step} steps, {cfg.sde.ddim_skip_type}, kappa "
        f"{cfg.sde.ddim_kappa}) in batches of {batch}, scored against "
        f"{n_shapes} reference clouds")
    ops.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    points = []
    for i in range(n_shapes // batch):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        points.append(lion.sample(batch, generator=gen,
                                  ddim_step=ddim_step)["points"])
    samples = torch.cat(points).float().cpu()
    t_sample = time.perf_counter() - t0
    if tuple(samples.shape) != (n_shapes, 2048, 3) or \
            not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"samples {tuple(samples.shape)}, finite "
                             f"{bool(torch.isfinite(samples).all())}")
    results, t_score = _score(samples, ref_set, seed, "smoke")
    counts = _path_counts(EVAL_PATH, "eval")
    pairs = 3 * _emd_pairs(n_shapes, n_shapes)
    log(f"[eval] sampling {t_sample:.3f} s ({n_shapes / t_sample:.4f} "
        f"shapes/s), scoring {t_score:.3f} s; K12 launches "
        f"{counts['emd_cost']} over {pairs} pairs; results "
        f"{ {k: round(v, 6) for k, v in sorted(results.items())} }")
    # after the counters: EMD pairs per second of one n x n matrix alone;
    # its first 16 x 16 block against the plain version on the card, and
    # the block's diagonal (with the paired CD) against the CPU, where the
    # plain version takes ~0.4 s per pair
    from lion_tpu_torch.eval.metrics import emd_cd_paired
    gen_pcs = (samples * ref_set["std"] + ref_set["mean"]).cuda()
    ref_pcs = (ref_set["ref"] * ref_set["std"] + ref_set["mean"]).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = pairwise_emd(gen_pcs, ref_pcs)
    t_emd = time.perf_counter() - t0
    log(f"[eval] pairwise_emd {n_shapes} x {n_shapes}: {t_emd:.3f} s, "
        f"{n_shapes * n_shapes / t_emd:.1f} pairs/s "
        f"({_emd_pairs(n_shapes, n_shapes)} pairs launched)")
    plain = ops.KERNELS["emd_cost"].plain(
        gen_pcs, ref_pcs, block_pairs(0, 0, 16, 16, "cuda")).reshape(16, 16)
    err = float(np.abs(card[:16, :16] - plain.cpu().numpy()).max())
    log(f"[eval] EMD block 16 x 16, K12 vs the plain version on the card: "
        f"max_abs_err {err:.3e} (rtol 2e-3, atol 1e-5; max |EMD| "
        f"{float(plain.abs().max()):.4e})")
    np.testing.assert_allclose(card[:16, :16], plain.cpu().numpy(),
                               rtol=2e-3, atol=1e-5)
    on_card = emd_cd_paired(gen_pcs[:16], ref_pcs[:16], reduced=False)
    t0 = time.perf_counter()
    on_cpu = emd_cd_paired(gen_pcs[:16].cpu(), ref_pcs[:16].cpu(),
                           reduced=False, device="cpu")
    log(f"[eval] paired CD / EMD of the block's diagonal, card vs CPU plain: "
        f"max_abs_err {np.abs(on_card['MMD-CD'] - on_cpu['MMD-CD']).max():.3e}"
        f" / {np.abs(on_card['MMD-EMD'] - on_cpu['MMD-EMD']).max():.3e}; "
        f"cpu {time.perf_counter() - t0:.1f} s")
    # the same K12 costs whatever the pair list around them
    if not np.array_equal(on_card["MMD-EMD"], np.diag(card[:16, :16])):
        raise AssertionError("paired EMD differs from the matrix diagonal")
    # CD: minima of matmul-form distances, cuBLAS against the CPU's GEMM
    np.testing.assert_allclose(on_card["MMD-CD"], on_cpu["MMD-CD"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(on_card["MMD-EMD"], on_cpu["MMD-EMD"],
                               rtol=2e-3, atol=1e-5)
    return counts


def phase_eval_scale(n, seed=0):
    """N generated against N reference clouds of 2048 points, scored
    through compute_score on the card without sampling (scripts/
    bench_eval.py's setting at the chair test set's N = 662); then one
    n x n CD matrix and one EMD matrix alone, of the three each that the
    suite computes."""
    from lion_tpu_torch.eval.metrics import pairwise_cd, pairwise_emd
    ref_set = _reference_set(n, seed)
    samples = torch.from_numpy(
        np.random.RandomState(seed + 1).randn(n, 2048, 3).astype(np.float32)
        * 0.2)
    results, seconds = _score(samples, ref_set, seed, f"scale{n}")
    log(f"[eval scale] {n} x {n}: compute_score {seconds:.3f} s "
        f"({3 * n * n} pairs per metric, {3 * _emd_pairs(n, n)} EMD pairs "
        f"launched); results "
        f"{ {k: round(v, 6) for k, v in sorted(results.items())} }")
    gen_pcs = (samples * ref_set["std"] + ref_set["mean"]).cuda()
    ref_pcs = (ref_set["ref"] * ref_set["std"] + ref_set["mean"]).cuda()
    for name, fn in (("CD", pairwise_cd), ("EMD", pairwise_emd)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(gen_pcs, ref_pcs)
        log(f"[eval scale] one {n} x {n} {name} matrix: "
            f"{time.perf_counter() - t0:.3f} s")


def _cli_run(label, path, fn, argv):
    """Run one CLI's `main(argv)` with the launch counters zeroed just
    before it; raise unless every kernel of `path` launched and no plain
    version ran. Returns (its result, the counts, the seconds)."""
    from lion_tpu_torch import ops
    torch.cuda.synchronize()
    ops.reset_counts()
    t0 = time.perf_counter()
    out = fn(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _path_counts(path, label)
    log(f"[{label}] {seconds:.1f} s")
    return out, counts, seconds


def _bf16_launched(label, kernels):
    from lion_tpu_torch import ops
    bf16 = {n: ops.KERNELS[n].launches_bf16 for n in kernels}
    if not all(bf16.values()):
        raise AssertionError(f"[{label}] kernels not run on bf16: {bf16}")
    log(f"[{label}] launches on bf16 tensors: {bf16}")


def _check_exp_dir(label, trainer, step):
    """cfg.yml, the final checkpoint at `step` and a finite metrics.jsonl
    in the trainer's experiment directory; finite parameters."""
    from lion_tpu_torch.ckpt import load_checkpoint
    d = trainer.save_dir
    _, meta = load_checkpoint(os.path.join(d, "checkpoints", "final.npz"))
    with open(os.path.join(d, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    values = [r["value"] for r in records if "value" in r]
    if not os.path.exists(os.path.join(d, "cfg.yml")) or \
            meta["step"] != step or trainer.step != step or not values or \
            not np.isfinite(values).all() or not all(
                bool(torch.isfinite(p).all())
                for p in trainer.step_fn.params):
        raise AssertionError(f"[{label}] {d}: step {trainer.step}, "
                             f"checkpoint {meta}, metrics {records}")
    images = sorted(os.listdir(os.path.join(d, "images"))) \
        if os.path.isdir(os.path.join(d, "images")) else []
    losses = [round(r["value"], 4) for r in records
              if r["tag"] == "train/loss"]
    log(f"[{label}] {d}: cfg.yml, final.npz at step {meta['step']}, "
        f"{len(records)} metrics.jsonl records (loss {losses}), finite "
        f"parameters, images {images}")


def phase_clis(tmp):
    """22. The user entry points on the card, in a temporary working
    directory (see the module's docstring). Returns the launch counts of
    each run."""
    import importlib.util
    from lion_tpu_torch import demo, train_dist
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "lion_tpu_torch", "scripts")
    t_start = time.perf_counter()
    viz = []
    if importlib.util.find_spec("matplotlib") is None:
        log("[cli] matplotlib does not import here: viz.viz_freq 0 (the "
            "trainers refuse the visualizations without it)")
        viz_freq = 0
    else:
        viz_freq = CLI_VIZ_FREQ
        viz = ["viz.vis_sample_ddim_step", str(CLI_DDIM_STEPS)]
    data1, data2 = os.path.join(tmp, "data1"), os.path.join(tmp, "data2")
    _write_pointflow(data1, {"train": CLI_STAGE1_CLOUDS, "val": 8}, seed=51)
    _write_pointflow(data2, {"train": CLI_STAGE2_CLOUDS, "val": 8}, seed=52)
    os.makedirs(os.path.join(tmp, "datasets", "test_data"))
    torch.save(_reference_set(CLI_EVAL_SHAPES, 53),
               os.path.join(tmp, "datasets", "test_data", "ref_val_chair.pt"))
    exp = os.path.join(tmp, "exp")
    common = ["trainer.epochs", "1", "viz.viz_freq", str(viz_freq)]
    stage1 = ["--exp_root", exp, "--data_root", data1] + \
        train_dist.script_overrides(os.path.join(scripts, "train_vae.sh"),
                                    CATE="chair") + \
        common + ["snapshot_min", "0"]
    log(f"[cli] stage 1: python -m lion_tpu_torch.train_dist "
        f"{' '.join(stage1)}")
    out = {}
    # at random weights the VAE's style posterior can overflow exp() on
    # these globally normalized clouds (std 1), in either package
    # (tests/test_torch_port_vae_train.py::test_flagship_vae_overflows_at_
    # random_weights_as_lion_tpu): the stage-1 Trainer's random init has
    # its style head damped by 0.01, as phases 20 and 21 and lion_tpu's
    # bf16 trainer test damp it; a resume loads the trained weights
    from lion_tpu_torch.profile_step import damp_style_head
    from lion_tpu_torch.trainers import hvae_trainer
    build_model = hvae_trainer.Trainer.build_model

    def damped_build_model(self):
        build_model(self)
        damp_style_head(self.vae)
    hvae_trainer.Trainer.build_model = damped_build_model
    try:
        tr, out["cli_stage1"], _ = _cli_run(
            "cli stage1", STAGE1_STEP_PATH, train_dist.main, stage1)
    finally:
        hvae_trainer.Trainer.build_model = build_model
    log("[cli stage1] the random init's style head damped by 0.01 "
        "(profile_step.damp_style_head)")
    _bf16_launched("cli stage1", BF16_TRAIN_KERNELS)
    steps = CLI_STAGE1_CLOUDS // tr.cfg.data.batch_size
    _check_exp_dir("cli stage1", tr, steps)
    vae_ckpt = os.path.join(tr.ckpt_dir, "final.npz")
    del tr
    tr, out["cli_resume"], _ = _cli_run("cli stage1 rerun", STAGE1_STEP_PATH,
                                        train_dist.main, stage1)
    _check_exp_dir("cli stage1 rerun", tr, 2 * steps)
    log(f"[cli stage1 rerun] resumed from the snapshot at step {steps}, "
        f"went on to step {tr.step}")
    del tr
    torch.cuda.empty_cache()

    stage2 = ["--exp_root", exp, "--data_root", data2] + \
        train_dist.script_overrides(os.path.join(scripts, "train_prior.sh"),
                                    CATE="chair", VAE_CKPT=vae_ckpt) + \
        common + viz
    log(f"[cli] stage 2: python -m lion_tpu_torch.train_dist "
        f"{' '.join(stage2)}")
    tr, out["cli_stage2"], _ = _cli_run("cli stage2", TRAIN_PATH,
                                        train_dist.main, stage2)
    _bf16_launched("cli stage2", BF16_TRAIN_KERNELS)
    _check_exp_dir("cli stage2", tr,
                   CLI_STAGE2_CLOUDS // tr.cfg.data.batch_size)
    save_dir = tr.save_dir
    lion_pt = os.path.join(tmp, "lion.pt")
    tr.export_torch(lion_pt)
    del tr
    torch.cuda.empty_cache()

    cfg_yml = os.path.join(save_dir, "cfg.yml")
    evaluation = ["--config", cfg_yml, "--pretrained",
                  os.path.join(save_dir, "checkpoints", "final.npz"),
                  "--eval_generation", "--num_samples", str(CLI_EVAL_SHAPES),
                  "eval_ddim_step", str(CLI_DDIM_STEPS)]
    log(f"[cli] python -m lion_tpu_torch.train_dist {' '.join(evaluation)}")
    tr, out["cli_eval"], _ = _cli_run("cli eval", EVAL_PATH, train_dist.main,
                                      evaluation)
    samples = torch.load(os.path.join(save_dir, "eval", "samples.pt"))
    with open(os.path.join(save_dir, "results", "eval_out.csv")) as f:
        tsv = f.read().splitlines()
    if tuple(samples.shape) != (CLI_EVAL_SHAPES, 2048, 3) or not bool(
            torch.isfinite(samples).all()) or len(tsv) != 2 or \
            not tsv[1].startswith("chair"):
        raise AssertionError(f"[cli eval] samples {tuple(samples.shape)}, "
                             f"results {tsv}")
    log(f"[cli eval] {CLI_EVAL_SHAPES} shapes, eval/samples.pt finite; "
        f"results/eval_out.csv: {tsv[1]}")
    del tr
    torch.cuda.empty_cache()

    npz = os.path.join(tmp, "demo.npz")
    shown = ["--config", cfg_yml, "--ckpt", lion_pt, "--num_samples",
             str(CLI_DEMO_SHAPES), "--ddim_step", str(CLI_DDIM_STEPS),
             "--out", npz]
    log(f"[cli] python -m lion_tpu_torch.demo {' '.join(shown)}")
    _, out["cli_demo"], _ = _cli_run("cli demo", BF16_PATH, demo.main, shown)
    with np.load(npz) as got:
        shapes = {k: got[k].shape for k in got.files}
        finite = all(np.isfinite(got[k]).all() for k in got.files)
    if shapes.get("points") != (CLI_DEMO_SHAPES, 2048, 3) or not finite:
        raise AssertionError(f"[cli demo] {shapes}, finite {finite}")
    log(f"[cli demo] {npz}: {shapes}, finite")
    log(f"[cli] phase 22: {time.perf_counter() - t_start:.1f} s")
    return out, {"data_root": data2, "vae_ckpt": vae_ckpt}


# ------------------------------------------------------------- phase 23
def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_children(name, out_dir, envs, timeout=DP_TIMEOUT):
    """Start `python chip_smoke.py --child name` once per environment in
    `envs` (all together), wait for them, kill any still running after
    `timeout` seconds; raise when one failed or timed out. Returns what
    each saved."""
    script = os.path.abspath(__file__)
    procs = []
    for r, env in enumerate(envs):
        log_f = open(os.path.join(out_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, script, "--child", name, "--child-dir", out_dir,
             "--child-rank", str(r)], env={**os.environ, **env},
            stdout=log_f, stderr=subprocess.STDOUT), log_f))
    deadline = time.time() + timeout
    failed = []
    for r, (proc, log_f) in enumerate(procs):
        try:
            proc.wait(max(deadline - time.time(), 1))
        except subprocess.TimeoutExpired:
            failed.append(f"rank {r} still running after {timeout} s")
        log_f.close()
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
    failed += [f"rank {r} exit code {p.returncode}"
               for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        tails = "".join(
            f"\n--- rank {r} ---\n" + open(os.path.join(
                out_dir, f"rank{r}.log")).read()[-3000:]
            for r in range(len(procs)))
        raise AssertionError(f"[{name}] children failed: {failed}{tails}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(len(procs))]


def _counts():
    from lion_tpu_torch import ops
    return {n: (w.launches, w.plain_calls) for n, w in ops.KERNELS.items()}


def _child_cli(rank, payload):
    """23(a): the CLI on train_prior.sh's overrides, in or out of a group
    of one (the child's command line and environment are the parent's
    choice: argv[rank])."""
    from lion_tpu_torch import ops, train_dist
    ops.reset_counts()
    t0 = time.perf_counter()
    tr = train_dist.main(payload["argv"][rank])
    torch.cuda.synchronize()
    return {"counts": _counts(), "seconds": time.perf_counter() - t0,
            "step": tr.step, "save_dir": tr.save_dir}


def _dp_trainer(payload, device):
    from lion_tpu_torch.trainers import get_trainer
    cfg = payload["cfg"]
    args = types.SimpleNamespace(save_dir=cfg.save_dir,
                                 data_root=payload["data_root"])
    return get_trainer(cfg.trainer.type)(cfg, args, device=device)


def _dp_steps(tr, payload, rows, device):
    """DP_STEPS steps of the trainer's step on `rows` of the payload's x
    and draws -> (ms a step, the last metrics)."""
    d = payload["draws"]
    draws = {"rho": tuple(t[rows].to(device) for t in d["rho"]),
             "timestep": d["timestep"][rows].to(device),
             "noise": tuple(t[rows].to(device) for t in d["noise"])}
    x = payload["x"][rows].to(device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_STEPS):
        metrics = tr.step_fn(x, None, **draws)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / DP_STEPS * 1e3
    return ms, {k: float(v) for k, v in metrics.items()}


def _child_dp(rank, payload):
    """23(b): one of two ranks on the one card over gloo: the two-prior
    trainer's step on its rows, then a gathered eval_sample."""
    import torch.distributed as dist
    from lion_tpu_torch import ops
    from lion_tpu_torch.parallel.dist import init_from_env
    dev = init_from_env("cuda", payload["store"], backend="gloo")
    try:
        t0 = time.perf_counter()
        tr = _dp_trainer(payload, dev)
        built = time.perf_counter() - t0
        n = payload["x"].shape[0] // DP_WORLD
        ops.reset_counts()
        ms, metrics = _dp_steps(tr, payload, slice(rank * n, (rank + 1) * n),
                                dev)
        counts = _counts()
        t0 = time.perf_counter()
        results = tr.eval_sample(step=0, num_gen=DP_EVAL_SHAPES,
                                 metric2=None)
        torch.cuda.synchronize()
        return {"ms": ms, "metrics": metrics, "counts": counts,
                "built": built, "eval_s": time.perf_counter() - t0,
                "results": None if results is None else
                {k: float(v) for k, v in results.items()
                 if np.ndim(v) == 0},
                "params": [p.detach().cpu() for p in tr.step_fn.params]}
    finally:
        dist.destroy_process_group()


CHILDREN = {"cli": _child_cli, "dp": _child_dp}


def child_main(name, out_dir, rank):
    """A child process of phase 23 (`--child`): runs CHILDREN[name] and
    saves what it returns, or its traceback, under out_dir."""
    import traceback
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    payload = torch.load(os.path.join(out_dir, "payload.pt"),
                         weights_only=False)
    try:
        out = CHILDREN[name](rank, payload)
    except BaseException:
        traceback.print_exc()
        raise
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _flat_npz(path):
    from lion_tpu_torch.ckpt import load_checkpoint
    from lion_tpu_torch.ckpt.io import flatten_tree
    trees, meta = load_checkpoint(path)
    return {k: np.asarray(v) for k, v in flatten_tree(trees).items()}, meta


def phase_data_parallel(tmp, data_root, vae_ckpt):
    """23. Data parallel (see the module's docstring): (a) train_prior.sh's
    CLI under a one-rank NCCL group and without one, equal bit for bit;
    (b) two processes on the card over gloo against the one-process step,
    and a gathered eval_sample. Returns the launch counts of each run."""
    from lion_tpu_torch import train_dist
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "lion_tpu_torch", "scripts")
    t_start = time.perf_counter()
    torch.cuda.empty_cache()    # the children share the card
    overrides = train_dist.script_overrides(
        os.path.join(scripts, "train_prior.sh"), CATE="chair",
        VAE_CKPT=vae_ckpt) + ["trainer.epochs", "1", "viz.viz_freq", "0",
                              "viz.log_freq", "1"]
    out = {}
    one_rank = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
                "NCCL_SOCKET_IFNAME": "lo"}
    # the two runs side by side on the card, each in its own experiment
    d = os.path.join(tmp, "dp_cli")
    os.makedirs(d)
    labels = ("nccl1", "nogroup")
    argvs = [["--exp_root", os.path.join(d, label), "--data_root",
              data_root] + flags + overrides
             for label, flags in zip(labels, (["--distributed_init"], []))]
    torch.save({"argv": argvs}, os.path.join(d, "payload.pt"))
    runs = dict(zip(labels, _spawn_children("cli", d, [one_rank, {}])))
    for label, argv in zip(labels, argvs):
        log(f"[dp {label}] python -m lion_tpu_torch.train_dist "
            f"{' '.join(argv)}: step {runs[label]['step']}, "
            f"{runs[label]['seconds']:.1f} s in the child")
    got, meta = _flat_npz(os.path.join(runs["nccl1"]["save_dir"],
                                       "checkpoints", "final.npz"))
    want, meta0 = _flat_npz(os.path.join(runs["nogroup"]["save_dir"],
                                         "checkpoints", "final.npz"))
    losses = []
    for label in ("nccl1", "nogroup"):
        with open(os.path.join(runs[label]["save_dir"],
                               "metrics.jsonl")) as f:
            losses.append([json.loads(line)["value"] for line in f
                           if json.loads(line)["tag"] == "train/loss"])
    if set(got) != set(want) or meta != meta0 or losses[0] != losses[1] or \
            not losses[0] or not all(np.array_equal(got[k], want[k])
                                     for k in want):
        raise AssertionError(f"[dp nccl1] differs from one process: losses "
                             f"{losses}, metadata {meta} vs {meta0}")
    log(f"[dp nccl1] a one-rank NCCL group equals no group bit for bit: "
        f"losses {losses[0]}, {len(want)} checkpoint arrays at step "
        f"{meta['step']}")
    for label in ("nccl1", "nogroup"):
        counts = runs[label]["counts"]
        if [n for n in TRAIN_PATH if counts[n][0] == 0] or \
                any(p for _, p in counts.values()):
            raise AssertionError(f"[dp {label}] launches {counts}")
        out[f"dp_{label}"] = {n: k for n, (k, _) in counts.items()}
    log(f"[dp nccl1] launches (kernel, plain): {runs['nccl1']['counts']}")

    # (b) two ranks over gloo on the one card, full width fp32
    d = os.path.join(tmp, "dp_gloo")
    os.makedirs(d)
    args = train_dist.get_args(
        ["--exp_root", os.path.join(d, "exp"), "--data_root", data_root]
        + overrides + ["tpu.bf16", "False", "sde.dropout", "0.0",
                       "ddpm.dropout", "0.0", "eval_ddim_step",
                       str(CLI_DDIM_STEPS)])
    cfg = train_dist.build_cfg(args)
    b = DP_WORLD * DP_BATCH
    g = torch.Generator().manual_seed(61)
    local = 2048 * 4
    payload = {
        "cfg": cfg, "data_root": data_root,
        "store": "file://" + os.path.join(d, "store"),
        "x": torch.randn(b, 2048, 3, generator=g) * 0.3,
        "draws": {"rho": (torch.randn(b, 128, generator=g),
                          torch.randn(b, local, generator=g)),
                  "timestep": torch.randint(1, 1001, (b,), generator=g),
                  "noise": (torch.randn(b, 128, generator=g),
                            torch.randn(b, local, generator=g))}}
    torch.save(payload, os.path.join(d, "payload.pt"))
    envs = [{"RANK": str(r), "WORLD_SIZE": str(DP_WORLD), "LOCAL_RANK": "0"}
            for r in range(DP_WORLD)]
    t0 = time.perf_counter()
    ranks = _spawn_children("dp", d, envs)
    gloo_s = time.perf_counter() - t0
    # the one-process step on all the rows, here, counted apart
    from lion_tpu_torch import ops
    one = _dp_trainer(payload, torch.device("cuda"))
    ops.reset_counts()
    ms_one, metrics_one = _dp_steps(one, payload, slice(0, b), "cuda")
    out["dp_one"] = {n: k for n, (k, _) in _counts().items()}
    want = [p.detach().cpu() for p in one.step_fn.params]
    grads = [p.grad.detach().cpu() for p in one.step_fn.params]
    lr = float(cfg.sde.learning_rate_dae)
    g_norm = float(torch.cat([x.reshape(-1) for x in grads]).norm())
    worst = 0.0
    for a, c, w, gr in zip(ranks[0]["params"], ranks[1]["params"], want,
                           grads):
        if not torch.equal(a, c):
            raise AssertionError("[dp gloo] the ranks' parameters differ")
        # where the gradient is rounding noise Adam's sign may differ: up
        # to 2 lr a step
        tol = torch.where(gr.abs() <= 1e-6 * g_norm,
                          torch.full_like(w, 2 * lr * DP_STEPS + 1e-5),
                          1e-5 + 1e-4 * w.abs())
        excess = float(((a - w).abs() - tol).max())
        worst = max(worst, float((a - w).abs().max()))
        if excess > 0:
            raise AssertionError(f"[dp gloo] parameters off the one-process "
                                 f"step by {excess:.3e} past the bound")
    m0 = ranks[0]["metrics"]
    if m0 != ranks[1]["metrics"] or not np.isclose(
            m0["loss"], metrics_one["loss"], rtol=1e-4, atol=1e-6):
        raise AssertionError(f"[dp gloo] metrics {m0} / "
                             f"{ranks[1]['metrics']} vs one process "
                             f"{metrics_one}")
    samples = torch.load(os.path.join(cfg.save_dir, "samples_0.pt"))
    res = ranks[0]["results"]
    if ranks[1]["results"] is not None or res is None or \
            tuple(samples.shape) != (DP_EVAL_SHAPES, 2048, 3) or \
            not bool(torch.isfinite(samples).all()):
        raise AssertionError(f"[dp gloo] eval_sample: {res}, "
                             f"{tuple(samples.shape)}")
    rank_counts = {n: sum(r["counts"][n][0] for r in ranks)
                   for n in ranks[0]["counts"]}
    if [n for n in TRAIN_PATH if rank_counts[n] == 0] or any(
            p for r in ranks for _, p in r["counts"].values()):
        raise AssertionError(f"[dp gloo] launches {ranks[0]['counts']} / "
                             f"{ranks[1]['counts']}")
    out["dp_gloo"] = rank_counts
    log(f"[dp gloo] {DP_WORLD} ranks on one card, {DP_STEPS} two-prior "
        f"steps at B{DP_BATCH} a rank: {ranks[0]['ms']:.3f} / "
        f"{ranks[1]['ms']:.3f} ms/step (one process at B{b}: "
        f"{ms_one:.3f} ms/step); parameters equal across the ranks, "
        f"max |rank - one process| {worst:.3e}; loss {m0['loss']:.6f} vs "
        f"{metrics_one['loss']:.6f}; eval_sample gathered "
        f"{DP_EVAL_SHAPES} clouds on rank 0 ({ranks[0]['eval_s']:.1f} s), "
        f"1-NN-CD {res['1-NN-CD-acc']:.4f}; children {gloo_s:.1f} s")
    log(f"[dp gloo] launches a rank (kernel, plain): {ranks[0]['counts']}")
    del one
    torch.cuda.empty_cache()
    log(f"[dp] phase 23: {time.perf_counter() - t_start:.1f} s")
    return out


# ------------------------------------------------------------- phase 24
def _cond_cfgs():
    """The flagship with class conditioning (55 classes, a 64-wide
    embedding) and with CLIP conditioning (PriorSEClip)."""
    from lion_tpu_torch.config import flagship_cfg
    cls = flagship_cfg()
    cls.data.cond_on_cat, cls.data.nclass = 1, COND_NCLASS
    cls.tpu.cls_emb_dim = COND_EMB
    clip = flagship_cfg()
    clip.clipforge.enable = 1
    clip.latent_pts.style_prior = "models.score_sde.resnet.PriorSEClip"
    return cls, clip


def _card_vs_cpu(label, cpu_fn, gpu_fn):
    with torch.no_grad():
        ref = cpu_fn()
        got = gpu_fn().cpu()
    err, scale = max_abs(got, ref), float(ref.abs().max())
    log(f"[cond] {label}: card vs CPU max_abs_err {err:.3e} (max |ref| "
        f"{scale:.3e})")
    torch.testing.assert_close(got, ref, rtol=0.0, atol=1e-4 * scale)


def phase_conditioning(steps, tmp):
    """24. Class and CLIP conditioning at full width (see the module's
    docstring). Returns the launch counts of each run."""
    from lion_tpu_torch import demo, ops
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.trainers import make_prior_train_step
    from lion_tpu_torch.utils.clip_helper import HashClip
    t_start = time.perf_counter()
    cls_cfg, clip_cfg = _cond_cfgs()
    g = torch.Generator().manual_seed(71)
    labels = torch.tensor([3, 54])
    feat = torch.from_numpy(HashClip().encode_text(["a chair", "a car"]))
    x, t, _ = _forward_inputs()
    out = {}

    # the forwards, card vs CPU
    cpu = LION(cls_cfg, device="cpu").init_params(
        torch.Generator().manual_seed(72)).eval()
    gpu = copy.deepcopy(cpu).cuda()
    cond = torch.cat([torch.randn(2, 128, generator=g),
                      cpu.class_condition(labels).detach()], dim=1)
    _card_vs_cpu("class-conditioned local prior B2", lambda: cpu.local_prior(
        x, t, condition_input=cond), lambda: gpu.local_prior(
        x.cuda(), t.cuda(), condition_input=cond.cuda()))
    z = [torch.randn(2, 128, generator=g),
         torch.randn(2, 2048 * 4, generator=g)]
    _card_vs_cpu("class-conditioned decoder B2", lambda: cpu.vae.sample(
        2, z, class_label=labels), lambda: gpu.vae.sample(
        2, [v.cuda() for v in z], class_label=labels.cuda()))
    del cpu, gpu
    cpu = LION(clip_cfg, device="cpu").init_params(
        torch.Generator().manual_seed(73)).eval()
    gpu = copy.deepcopy(cpu).cuda()
    _card_vs_cpu("se_clip global prior B2", lambda: cpu.global_prior(
        z[0], t, clip_feat=feat), lambda: gpu.global_prior(
        z[0].cuda(), t.cuda(), clip_feat=feat.cuda()))
    _card_vs_cpu("CLIP-conditioned local prior B2", lambda: cpu.local_prior(
        x, t, condition_input=z[0], clip_feat=feat), lambda: gpu.local_prior(
        x.cuda(), t.cuda(), condition_input=z[0].cuda(),
        clip_feat=feat.cuda()))
    del cpu, gpu

    # samples on both paths, and a two-prior step of each
    for kind, cfg in (("class", cls_cfg), ("clip", clip_cfg)):
        for path, batch, bf16, kernels in (("fp32", BATCH, False, FP32_PATH),
                                           ("bf16", BATCH_BF16, True,
                                            BF16_PATH)):
            c = copy.deepcopy(cfg)
            c.ddpm.num_steps = steps
            c.tpu.bf16 = bf16
            lion = LION(c).init_params(torch.Generator(
                device="cuda").manual_seed(74))
            if kind == "class":
                cond = {"class_label": torch.arange(batch) % COND_NCLASS}
            else:
                cond = {"clip_feat": HashClip().encode_text(
                    [f"shape {i}" for i in range(batch)])}
            torch.cuda.synchronize()
            ops.reset_counts()
            t0 = time.perf_counter()
            pts = lion.sample(batch, torch.Generator(
                device="cuda").manual_seed(75), **cond)["points"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            label = f"cond {kind} {path}"
            out[label.replace(" ", "_")] = _path_counts(kernels, label)
            if tuple(pts.shape) != (batch, 2048, 3) or not bool(
                    torch.isfinite(pts).all()):
                raise AssertionError(f"[{label}] points {tuple(pts.shape)}")
            log(f"[{label}] sample B{batch}, {steps} steps: {wall:.2f} s, "
                f"{batch / wall:.4f} shapes/s, points std "
                f"{float(pts.std()):.4f}")
            del lion
        lion = LION(cfg).init_params(torch.Generator(
            device="cuda").manual_seed(76))
        step = make_prior_train_step(lion, lambda i: 2e-4)
        gen = torch.Generator(device="cuda").manual_seed(77)
        xb = torch.randn(BATCH_STAGE2, 2048, 3, generator=gen,
                         device="cuda") * 0.3
        cond = {"class_label": torch.arange(BATCH_STAGE2,
                                            device="cuda") % COND_NCLASS} \
            if kind == "class" else {"clip_feat": torch.from_numpy(
                HashClip().encode_text([f"s{i}" for i in range(
                    BATCH_STAGE2)])).cuda()}
        torch.cuda.synchronize()
        ops.reset_counts()
        t0 = time.perf_counter()
        metrics = step(xb, gen, **cond)
        torch.cuda.synchronize()
        label = f"cond {kind} step"
        out[label.replace(" ", "_")] = _path_counts(TRAIN_PATH, label)
        loss = float(metrics["loss"])
        if not np.isfinite(loss) or not all(
                bool(torch.isfinite(p).all()) for p in step.params):
            raise AssertionError(f"[{label}] loss {loss}")
        log(f"[{label}] two-prior step B{BATCH_STAGE2}: loss {loss:.4f}, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first step)")
        del lion, step
        torch.cuda.empty_cache()

    # the demo's text prompt
    cfg_yml, npz = os.path.join(tmp, "clip_cfg.yml"), \
        os.path.join(tmp, "clip_demo.npz")
    clip_cfg.save(cfg_yml)
    argv = ["--config", cfg_yml, "--text", "a tall chair", "--num_samples",
            str(CLI_DEMO_SHAPES), "--ddim_step", str(CLI_DDIM_STEPS),
            "--out", npz]
    log(f"[cond] python -m lion_tpu_torch.demo {' '.join(argv)}")
    _, out["cond_demo"], _ = _cli_run("cond demo", FP32_PATH, demo.main,
                                      argv)
    with np.load(npz) as got:
        if got["points"].shape != (CLI_DEMO_SHAPES, 2048, 3) or \
                not np.isfinite(got["points"]).all():
            raise AssertionError(f"[cond demo] {got['points'].shape}")
    log(f"[cond] phase 24: {time.perf_counter() - t_start:.1f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=100,
                    help="DDPM steps per prior (1000: the released chain)")
    ap.add_argument("--eval-n", type=int, default=0,
                    help="also score N against N clouds without sampling "
                    "(662: the chair test set)")
    # a child process of phase 23 (the script starts its own)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--child-dir", help=argparse.SUPPRESS)
    ap.add_argument("--child-rank", type=int, default=0,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child_main(args.child, args.child_dir, args.child_rank)
    t_start = time.perf_counter()

    phase_device()
    from lion_tpu_torch.config import flagship_cfg
    from lion_tpu_torch.ops import KERNELS
    phase_build()
    results = phase_kernels()
    phase_forward_parity(flagship_cfg())
    phase_repeat_paths(flagship_cfg())
    fp32 = phase_main_path(flagship_cfg(), args.steps, BATCH, REQUESTS,
                           FP32_PATH, "fp32")
    cfg16 = flagship_cfg()
    cfg16.tpu.bf16 = True
    bf16 = phase_main_path(cfg16, args.steps, BATCH_BF16, REQUESTS,
                           BF16_PATH, "bf16")
    phase_grad_parity(flagship_cfg())
    train = phase_train(flagship_cfg(), BATCH_TRAIN, WARMUP_STEPS,
                        TRAIN_STEPS)
    phase_vae_grad_parity(flagship_cfg())
    phase_bf16_grad_parity()
    phase_repeat_steps()
    bf16_train = phase_bf16_train(WARMUP_STEPS, TRAIN_STEPS)
    with tempfile.TemporaryDirectory() as tmp:
        vae_train, vae_ckpt = phase_vae_trainer(tmp, BATCH_VAE, WARMUP_STEPS,
                                                TRAIN_STEPS)
        stage2 = phase_stage2_trainer(tmp, vae_ckpt, BATCH_STAGE2,
                                      WARMUP_STEPS, TRAIN_STEPS)
        bf16_trainers = phase_bf16_trainers(tmp, BATCH_VAE, BATCH_STAGE2)
        ode_trainer = phase_ode_trainer(tmp, vae_ckpt, BATCH_STAGE2,
                                        WARMUP_STEPS, TRAIN_STEPS, ODE_TOL)
    ode = phase_ode_sample(flagship_cfg(), ODE_BATCH, ODE_TOL)
    phase_weighted_grad_parity(flagship_cfg())
    weighted = phase_weighted_train(flagship_cfg(), BATCH_TRAIN,
                                    WARMUP_STEPS, TRAIN_STEPS)
    cf = phase_cf_op(BATCH_KERNELS)
    cfg_eval = flagship_cfg()
    cfg_eval.tpu.bf16 = True
    cfg_eval.ddpm.num_steps = args.steps
    evaluation = phase_eval(cfg_eval, EVAL_SHAPES, EVAL_BATCH,
                            EVAL_DDIM_STEPS)
    if args.eval_n:
        phase_eval_scale(args.eval_n)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            clis, stage2_files = phase_clis(tmp)
            dp = phase_data_parallel(tmp, **stage2_files)
            cond = phase_conditioning(args.steps, tmp)
        finally:
            os.chdir(cwd)

    paths = {"fp32": fp32, "bf16": bf16, "train": train, "cf_op": cf,
             "eval": evaluation, "vae_train": vae_train,
             "stage2_trainer": stage2, "ode_sample": ode,
             "weighted_train": weighted, "ode_trainer": ode_trainer,
             "bf16_train": bf16_train["prior"],
             "bf16_vae_train": bf16_train["vae"],
             "bf16_vae_trainer": bf16_trainers["trainers.hvae_trainer"],
             "bf16_stage2_trainer": bf16_trainers["trainers.train_2prior"],
             **clis, **dp, **cond}
    report = []
    for name in REPORT_ORDER:
        w = KERNELS[name]
        report.append({"name": name, "route": "cuda", "source": w.source,
                       "replaces": w.replaces,
                       "launches": sum(p[name] for p in paths.values()),
                       **{f"launches_{k}_path": p[name]
                          for k, p in paths.items()}, **results[name]})
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
