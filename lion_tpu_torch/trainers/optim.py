"""Adam, the warmup-cosine schedule and the EMA copy (port of
lion_tpu/trainers/optim.py).

`Optimizer` computes what `make_optimizer`'s optax chain computes in the
JAX package (lion_tpu/trainers/optim.py:57-70): an optional global-norm
clip (optax.clip_by_global_norm), then Adam (torch.optim.Adam computes
optax.adam's update) or, with weight decay, AdamW (decoupled, as
optax.adamw), with the learning rate of the schedule evaluated at the step
count before the update, as optax's `scale_by_schedule` reads it.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable, List, Sequence

import numpy as np
import torch


def warmup_cosine_schedule(base_lr: float, min_lr: float, warmup_iters: int,
                           total_epochs: int, warmup_epochs: int,
                           steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warmup over warmup_iters steps, then cosine annealing stepped
    per epoch over (epochs - warmup_epochs - 1) epochs, evaluated in
    float32 as the JAX schedule is (lion_tpu/trainers/optim.py:36-54)."""
    f32 = np.float32
    decay_epochs = f32(max(float(total_epochs - warmup_epochs - 1), 1.0))

    def schedule(step: int) -> float:
        s = f32(step)
        if warmup_iters > 0 and step < warmup_iters:
            return float(f32(base_lr) * s / f32(max(warmup_iters, 1)))
        epoch = np.floor(s / f32(steps_per_epoch)) - f32(warmup_epochs)
        epoch = np.clip(epoch, f32(0.0), decay_epochs)
        cos = f32(min_lr) + f32(0.5) * f32(base_lr - min_lr) * (
            f32(1.0) + np.cos(f32(np.pi) * epoch / decay_epochs))
        return float(cos)

    return schedule


class Optimizer:
    """Adam or AdamW over `params` with a learning-rate schedule and an
    optional global-norm gradient clip. `step()` applies one update from the
    parameters' `.grad` and advances the step count."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr_schedule: Callable[[int], float], beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 grad_clip: float = -1.0, eps: float = 1e-8):
        self.params: List[torch.nn.Parameter] = list(params)
        self.lr_schedule = lr_schedule
        self.grad_clip = grad_clip
        self.count = 0
        kw = dict(lr=lr_schedule(0), betas=(beta1, beta2), eps=eps)
        if weight_decay and weight_decay > 0:
            self.opt = torch.optim.AdamW(self.params,
                                         weight_decay=weight_decay, **kw)
        else:
            self.opt = torch.optim.Adam(self.params, **kw)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        if self.grad_clip and self.grad_clip > 0:
            grads = [p.grad for p in self.params if p.grad is not None]
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            # optax: g unchanged below the limit, else g / norm * limit
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_schedule(self.count)
        self.opt.step()
        self.count += 1

    def moments(self):
        """(mu, nu): Adam's first and second moments of each parameter, in
        the order of `params` (zeros before the first step), as optax's
        ScaleByAdamState holds them."""
        mu, nu = [], []
        for p in self.params:
            st = self.opt.state.get(p, {})
            mu.append(st["exp_avg"] if st else torch.zeros_like(p))
            nu.append(st["exp_avg_sq"] if st else torch.zeros_like(p))
        return mu, nu

    @torch.no_grad()
    def load_state(self, count: int, mu: Sequence[torch.Tensor],
                   nu: Sequence[torch.Tensor]) -> None:
        """Set the step count and the moments (in the order of `params`),
        as a checkpoint holds them."""
        if len(mu) != len(self.params) or len(nu) != len(self.params):
            raise ValueError("Optimizer.load_state: one moment a parameter")
        self.count = int(count)
        for p, m, v in zip(self.params, mu, nu):
            self.opt.state[p] = {
                "step": torch.tensor(float(count)),
                "exp_avg": m.to(p.device, p.dtype).clone(),
                "exp_avg_sq": v.to(p.device, p.dtype).clone()}


class EMA:
    """An exponential moving average of `params`: after each update,
    ema = ema * decay + p * (1 - decay) (lion_tpu/trainers/optim.py:28-33)."""

    def __init__(self, params: Iterable[torch.nn.Parameter], decay: float):
        self.params = list(params)
        self.decay = decay
        self.shadow = [p.detach().clone() for p in self.params]

    @torch.no_grad()
    def update(self) -> None:
        torch._foreach_mul_(self.shadow, self.decay)
        torch._foreach_add_(self.shadow, [p.detach() for p in self.params],
                            alpha=1.0 - self.decay)

    @contextlib.contextmanager
    def swapped(self):
        """The EMA copy in the parameters inside the block (to sample or
        evaluate from it, as the JAX package reads `state.ema_params`);
        the trained values come back after it."""
        with torch.no_grad():
            for p, e in zip(self.params, self.shadow):
                p.data, e.data = e.data, p.data
        try:
            yield
        finally:
            with torch.no_grad():
                for p, e in zip(self.params, self.shadow):
                    p.data, e.data = e.data, p.data
