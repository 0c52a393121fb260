"""The check that decides `correct`: what the timed path produced, against
the plain reference (`benchmark.reference`) on the weights and inputs the
benchmark made.

Sampling (teacher-forced): DDIM amplifies any rounding difference through
the local prior's discrete choices (FPS, ball query, voxel cells): a
relative 1e-6 at each step grows to 1e-2 within 8 of 25 steps. So the
reference follows the program from the program's own state, step by step:
at every step of both chains it evaluates the prior on the program's input
x_t at its own timestep and compares the program's prediction, and it
redoes the DDIM update from the program's x_t and prediction with the
noise re-drawn from the request's seed and compares the program's next
x_t. The chains' starting noises and the decoded points (decoded by the
reference from the program's two latents) are compared too. Numbers, each
the largest over the items of a request of |a - b| / |b| (L2 over an
item), and over the steps:
  global_eps, local_eps  the priors' predictions
  ddim_update            the starting noises and every update
  decode                 the decoded points
  chain_gap              the largest of the four, the number compared: the
                         control (bf16 U-Nets) moves only local_eps, the
                         faults only ddim_update or decode, and one limit
                         holds the whole hierarchy to what separates them

Training (replayed): the reference runs the first `check_steps` steps from
the same initial weights, batches, CLIP rows and generator states (so the
same posterior noises, timesteps, diffusion noises and dropout masks) with
its own objective, backward, Adam and EMA. The stage after the encode
takes the program's inputs, copied by hooks: the priors' (x_t of both
latents, the local prior's condition) in the two-prior step, the
decoder's (both latents) in the stage-1 step, where the encoder's
gradient flows as through the reference's own latents. Else the encode's
rounding would flip the FPS, ball and voxel choices made on the latent
points' coordinates now and then, as in sampling; the reference's own
inputs are compared with the program's by themselves. Per leaf (parameter
tensor) a gap is |norm_p - norm_r| over the larger of the reference's norm
of that leaf and of the median leaf. Numbers:
  prior_inputs, decoder_inputs
                     the largest per-item gap of the program's inputs of
                     that stage to the reference's own in the first step
                     (the later ones run on parameters that the sides
                     updated apart)
  loss, loss_step1   the largest relative gap of a step's loss; the first
                     step's alone
  loss1_program, loss1_reference
                     the first step's loss on each side (not compared: they
                     show whether a side repeats itself)
  grad               the worst leaf's gap of the first step's gradient norm
                     (the program's read from Adam's first moment,
                     m / (1 - beta1))
  change, change_median
                     the worst and the median leaf's gap of each leaf's
                     change over the steps, leaving out leaves whose
                     reference gradient is under 1e-3 of the median leaf's
                     (they move by round-off alone)
  ema_change, ema_change_median
                     the same of the EMA's change (steps with an EMA)
A mix's `limits` name the numbers compared; PERF.md gives the readings each
limit was set from and why the others are not compared.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from .reference import Lion, Schedule, no_tf32
from .reference.model import set_generator
from .reference.train import Adam, kl_weight, prior_loss, vae_loss


def rel_items(a: torch.Tensor, b: torch.Tensor) -> float:
    """max over items of ||a_i - b_i|| / ||b_i|| (inf for a shape mismatch
    or a non-finite value)."""
    if a.shape != b.shape:
        return float("inf")
    a = a.detach().float().reshape(a.shape[0], -1)
    b = b.detach().float().reshape(b.shape[0], -1)
    gap = (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-30)
    val = float(gap.max())
    return val if val == val else float("inf")


def reference_model(cfg: dict, state, device) -> Lion:
    with torch.device(device):
        ref = Lion(cfg)
    ref.load_state_dict(state, strict=True)
    return ref


@torch.no_grad()
def check_sample(cfg: dict, mix: dict, state, captures: List[Dict],
                 device) -> Dict[str, float]:
    ref = reference_model(cfg, state, device)
    ref.eval()
    sde = cfg["sde"]
    sched = Schedule(cfg).ddim(mix["ddim_step"], sde["ddim_skip_type"],
                               float(sde["ddim_kappa"]))
    b = mix["batch"]
    out = {"global_eps": 0.0, "local_eps": 0.0, "ddim_update": 0.0,
           "decode": 0.0}
    for cap in captures:
        gen = torch.Generator(device=device).manual_seed(cap["seed"])
        zg = cap["z_global"]
        zl = cap["z_local"].reshape(b, ref.local_prior.n, ref.local_prior.c)
        chains = (("global", cap["global"], zg, (b, zg.shape[1]),
                   lambda x, t: ref.global_prior(x, t, cap["clip"])),
                  ("local", cap["local"], zl, tuple(zl.shape),
                   lambda x, t: ref.local_prior(x, t, zg, cap["clip"])))
        for name, calls, last, shape, prior in chains:
            if len(calls) != len(sched):
                out[f"{name}_eps"] = out["ddim_update"] = float("inf")
                continue
            xs = [c[0] for c in calls] + [last]
            x0 = torch.randn(shape, generator=gen, device=device)
            upd = rel_items(xs[0], x0)
            eps_gap = 0.0
            for k, (t, scale, c, sigma) in enumerate(sched):
                eps = calls[k][2]
                tt = torch.full((b,), t + 1.0, device=device)
                eps_gap = max(eps_gap, rel_items(eps, prior(xs[k], tt)))
                nxt = scale * xs[k] + c * eps
                if sigma != 0:
                    nxt = nxt + sigma * torch.randn(shape, generator=gen,
                                                    device=device)
                upd = max(upd, rel_items(xs[k + 1], nxt))
            out[f"{name}_eps"] = max(out[f"{name}_eps"], eps_gap)
            out["ddim_update"] = max(out["ddim_update"], upd)
        pts = ref.vae.decode(zg, cap["z_local"])
        out["decode"] = max(out["decode"], rel_items(cap["points"], pts))
    out["chain_gap"] = max(out.values())
    return out


def _as(a, like: torch.Tensor) -> torch.Tensor:
    """a in the shape of `like` where it holds as many values (a flat
    latent), else as it is (a missing one: empty)."""
    if a is None:
        return torch.empty(0)
    return a.reshape(like.shape) if a.numel() == like.numel() else a


def _leaf_gaps(prog: List[float], ref: List[float], keep=None):
    """Per leaf |prog - ref| / max(ref, the median leaf's ref)."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    if not idx or len(prog) != len(ref):
        return [float("inf")]
    med = statistics.median(ref[i] for i in idx)
    gaps = [abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx]
    return [g if g == g else float("inf") for g in gaps]


# the number that holds the reference's own inputs of the stage it takes
# from the program to the program's
INPUTS = {"train_vae": "decoder_inputs", "train_prior": "prior_inputs"}


def check_train(cfg: dict, mix: dict, state, readings: Dict,
                device) -> Dict[str, float]:
    ref = reference_model(cfg, state, device)
    named = dict(ref.named_parameters())
    params = [named[n] for n in readings["names"]]
    kind = mix["kind"]
    if kind == "train_vae":
        opt_cfg = cfg["trainer"]["opt"]
        lr, clip = float(opt_cfg["lr"]), float(opt_cfg["grad_clip"])
        ema_decay = float(opt_cfg["ema_decay"]) if cfg["ddpm"]["ema"] else 0
    else:
        lr, clip = float(cfg["sde"]["learning_rate_dae"]), \
            float(cfg["sde"]["grad_clip_max_norm"])
        ema_decay = float(cfg["sde"]["ema_decay"])
        for p in ref.vae.parameters():
            p.requires_grad_(False)
    if clip > 0 or cfg["trainer"]["opt"]["weight_decay"]:
        raise NotImplementedError("gradient clipping, weight decay")
    adam = Adam(params, lr, cfg["trainer"]["opt"]["beta1"],
                cfg["trainer"]["opt"]["beta2"])
    start = [p.detach().clone() for p in params]
    shadow = [p.detach().clone() for p in params] if ema_decay else None
    losses, grad_norms, input_gap = [], None, None
    given = readings.get("inputs")
    for s, gen_state in enumerate(readings["gen_states"]):
        gen = torch.Generator(device=device)
        gen.set_state(gen_state)
        x, draws = readings["batches"][s]
        inputs = given[s] if given else None
        if kind == "train_vae":
            loss, own = vae_loss(cfg, ref.vae, x, gen,
                                 kl_weight(cfg, s, mix["total_iter"]),
                                 given=inputs)
        else:
            loss, own = prior_loss(cfg, ref, x, gen, draws.get("clip_feat"),
                                   given=inputs)
        if given and s == 0:
            input_gap = max(rel_items(_as(inputs.get(k), v), v)
                            for k, v in own.items())
        del own
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        losses.append(float(loss.detach()))
        if s == 0:
            grad_norms = [float(g.norm()) for g in grads]
        del loss
        adam.step(grads)
        del grads
        if shadow is not None:
            with torch.no_grad():
                for e, p in zip(shadow, params):
                    e.mul_(ema_decay).add_(p, alpha=1 - ema_decay)
    set_generator(ref, None)
    with torch.no_grad():
        change = [float((p - p0).norm()) for p, p0 in zip(params, start)]
        ema = None if shadow is None else \
            [float((e - p0).norm()) for e, p0 in zip(shadow, start)]
    med = statistics.median(grad_norms)
    moved = [g >= 1e-3 * med for g in grad_norms]
    loss_gaps = [abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(readings["losses"], losses)]
    change_gaps = _leaf_gaps(readings["change"], change, moved)
    out = {"loss": max(loss_gaps), "loss_step1": loss_gaps[0],
           "loss1_program": readings["losses"][0],
           "loss1_reference": losses[0],
           "grad": max(_leaf_gaps(readings["grad_norms"], grad_norms)),
           "change": max(change_gaps),
           "change_median": statistics.median(change_gaps)}
    if given:
        out[INPUTS[kind]] = input_gap
    if ema is not None:
        ema_gaps = _leaf_gaps(readings["ema_change"] or [], ema, moved)
        out["ema_change"] = max(ema_gaps)
        out["ema_change_median"] = statistics.median(ema_gaps)
    return {k: (v if v == v else float("inf")) for k, v in out.items()}


def check(cfg: dict, mix: dict, state, kept, device) -> Dict[str, float]:
    """The numbers of `mix`'s kind, the reference in full float32."""
    with no_tf32():
        if mix["kind"] == "sample":
            return check_sample(cfg, mix, state, kept, device)
        return check_train(cfg, mix, state, kept, device)
