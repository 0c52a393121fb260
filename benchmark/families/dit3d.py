"""DiT-3D (Mo et al., NeurIPS 2023, github.com/DiT-3D/DiT-3D): a plain
diffusion transformer over voxel patches, global and 3-D window softmax
attention, trained with PVD's noise-prediction objective. The program is
`lion_tpu_torch`'s `models.dit3d.DiT3D` and `trainers.DiT3DTrainStep`;
its plain reference is `benchmark/reference_dit3d/`, its traffic
`benchmark/traffic_dit3d.py`; the contract is
`benchmark/families/__init__.py`'s.

The check (`check`), of a `train_dit` cell: the reference, in full
float32 with its blocks checkpointed, replays the step object's first
`check_steps` steps from the same weights, clouds and draws (t, the
noise, the dropped labels) with its own autograd and Adam. Per leaf
(parameter tensor) a gap is |norm_p - norm_r| over the larger of the
reference's norm of that leaf and of the median leaf's. Numbers:
  loss               the largest relative gap of a step's loss
  loss1_program, loss1_reference
                     the first step's loss on each side (not compared)
  grad               the worst leaf's gap of the first step's gradient
                     norm (the program's read from Adam's first moment,
                     m / (1 - beta1))
  change, change_median
                     the worst and the median leaf's gap of each leaf's
                     change over the steps, leaving out leaves whose
                     reference gradient is under 1e-3 of the median leaf's
A mix's `limits` name the numbers compared; PERF.md gives the readings each
limit was set from.
"""
from __future__ import annotations

import statistics
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark import reference_dit3d as ref
from benchmark.check import _leaf_gaps
from benchmark.faults import _patched, half_batch, unapplied
from benchmark.traffic_dit3d import KINDS  # noqa: F401
from benchmark.work import least_s

REFERENCE = "reference_dit3d"
# the check's control: the DiT's GEMMs and attention in TF32, the
# precision below the configuration's float32
CONTROL = {"dit3d.tf32": True}
# the attention kernels (lion_tpu_torch/ops/attention.py)
GROUPS = {"dit_attn_": "attention"}
# small sizes for the CPU tests: two blocks, one windowed, on an 8^3 grid
# of 2^3 patches (4^3 tokens, windows of 2^3), 64-point clouds
TINY = {"data.tr_max_sample_points": 64, "dit3d.hidden_size": 48,
        "dit3d.depth": 2, "dit3d.num_heads": 2, "dit3d.voxel_size": 8,
        "dit3d.window_size": 2, "dit3d.window_blocks": [1]}


def port_config(cfg: dict):
    """The program's config tree: DiT-3D's defaults (the file's
    trainer.type names DiT-3D's trainer) with the file's values."""
    from lion_tpu_torch.config import CfgNode, default_cfg_for
    node = default_cfg_for(cfg)
    node.merge_from_other_cfg(CfgNode(cfg))
    return node


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """DiT's initializer (the adaLN and final layers drawn, not zeroed;
    `reference_dit3d.init_state`) from one generator on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return ref.init_state(cfg, gen, device)


def check(cfg: dict, mix: dict, state, kept, device) -> Dict[str, float]:
    """The numbers of a `train_dit` mix (module docstring), the reference
    in full float32."""
    with ref.no_tf32():
        with torch.device(device):
            model = ref.DiT3D(cfg)
        model.load_state_dict(state, strict=True)
        named = dict(model.named_parameters())
        params = [named[n] for n in kept["names"]]
        opt = cfg["trainer"]["opt"]
        if float(opt["grad_clip"]) > 0 or float(opt["weight_decay"]):
            raise NotImplementedError("gradient clipping, weight decay")
        adam = ref.Adam(params, float(opt["lr"]), float(opt["beta1"]),
                        float(opt["beta2"]))
        start = [p.detach().clone() for p in params]
        sched = ref.Schedule(cfg)
        losses, grad_norms = [], None
        for s, (x, draws) in enumerate(kept["batches"]):
            y = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
            loss = ref.loss(model, sched, x, draws["t"], draws["noise"], y,
                            draws["drop"])
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            losses.append(float(loss.detach()))
            if s == 0:
                grad_norms = [float(g.norm()) for g in grads]
            del loss
            adam.step(grads)
            del grads
        with torch.no_grad():
            change = [float((p - p0).norm()) for p, p0 in zip(params, start)]
    med = statistics.median(grad_norms)
    moved = [g >= 1e-3 * med for g in grad_norms]
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(kept["losses"], losses)]
    change_gaps = _leaf_gaps(kept["change"], change, moved)
    out = {"loss": max(loss_gaps), "loss1_program": kept["losses"][0],
           "loss1_reference": losses[0],
           "grad": max(_leaf_gaps(kept["grad_norms"], grad_norms)),
           "change": max(change_gaps),
           "change_median": statistics.median(change_gaps)}
    return {k: (v if v == v else float("inf")) for k, v in out.items()}


work_of = ref.work_of


class AttentionWork(TorchDispatchMode):
    """The softmax attention's work, call by call as the reference makes
    the calls (`reference_dit3d.OBSERVERS`); per call and head the
    forward's FLOPs 4 L Lk d, the backward's 8 L Lk d; bytes Q, K, V and O
    read or written once, plus dO, dQ, dK, dV and the logsumexp; the
    least time, per pass, the larger of its FLOPs at 67 TFLOP/s and its
    bytes at 3.35 TB/s (`work.least_s`)."""

    def __init__(self):
        super().__init__()
        self.flops, self.bytes, self.least_s, self.calls = 0, 0, 0.0, 0

    def _observe(self, q_shape, k_shape):
        n, h, length, d = q_shape
        lk = k_shape[2]
        pairs = n * h * length * lk * d
        q_bytes, k_bytes = 4 * n * h * length * d, 4 * n * h * lk * d
        lse = 4 * n * h * length
        # Q and O, K and V; the backward also dO and dQ, dK and dV
        fwd_bytes = 2 * q_bytes + 2 * k_bytes + lse
        bwd_bytes = 4 * q_bytes + 4 * k_bytes + lse
        for flops, nbytes in ((4 * pairs, fwd_bytes),
                              (8 * pairs, bwd_bytes)):
            self.flops += flops
            self.bytes += nbytes
            self.least_s += least_s(flops, nbytes)
        self.calls += 1

    def __enter__(self):
        ref.OBSERVERS.append(self._observe)
        return super().__enter__()

    def __exit__(self, *exc):
        ref.OBSERVERS.remove(self._observe)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))

    def numbers(self) -> Dict[str, float]:
        return {"attention_flops": float(self.flops),
                "attention_bytes": float(self.bytes),
                "attention_least_s": self.least_s,
                "attention_calls": self.calls}


COUNTERS = (AttentionWork,)


# ------------------------------------------------------------- faults
# half_batch and unapplied are LION's (`benchmark.faults`: TrainStep's and
# Adam's, which this step shares)
def window_as_global(kind: str):
    """The windowed blocks attend over the whole cloud."""
    from lion_tpu_torch.nn.dit import DiTBlock
    forward = DiTBlock.forward

    def unwindowed(self, x, c):
        window, self.window = self.window, 0
        try:
            return forward(self, x, c)
        finally:
            self.window = window
    return _patched(DiTBlock, "forward", unwindowed)


FAULTS = {"half_batch": half_batch, "unapplied": unapplied,
          "window_as_global": window_as_global}
OF_KIND = {"train_dit": ("half_batch", "unapplied", "window_as_global")}
