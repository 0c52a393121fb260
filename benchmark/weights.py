"""The model's weights, made by the benchmark from the seed.

Every parameter starts as the released model's initializers would start it
(`init_spec` of the reference's modules: uniform in +-bound for dense and
conv layers, ones and zeros for the norms and AdaGN's style bias). All
uniform draws come from one `torch.rand` call of a generator on the device,
so the weights are made on the card in the served type (float32). The
style posterior's head is damped by `damp_style_head`: at random weights
the full-width style posterior overflows exp() for some clouds.
"""
from __future__ import annotations

from typing import Dict

import torch

from .reference.model import Lion


def make_weights(cfg: dict, seed: int, device,
                 damp_style_head: float = 1.0) -> Dict[str, torch.Tensor]:
    """The state dict of the whole model (`vae.`, `global_prior.`,
    `local_prior.`) drawn from `seed` on `device`."""
    with torch.device("meta"):
        shapes = Lion(cfg)
    rules = []
    for mod_name, mod in shapes.named_modules():
        spec = getattr(mod, "init_spec", None)
        if spec is None:
            continue
        for pname, rule in spec().items():
            full = f"{mod_name}.{pname}" if mod_name else pname
            rules.append((full, tuple(getattr(mod, pname).shape), rule))
    gen = torch.Generator(device=device).manual_seed(seed)
    n_uniform = sum(_numel(s) for _, s, r in rules if r[0] == "uniform")
    draw = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    state, at = {}, 0
    for name, shape, (kind, arg) in rules:
        n = _numel(shape)
        if kind == "uniform":
            state[name] = (draw[at:at + n] * arg).reshape(shape)
            at += n
        elif kind == "const":
            state[name] = torch.full(shape, float(arg), device=device)
        elif kind == "ones_then_zeros":
            t = torch.zeros(shape, device=device)
            t[:arg] = 1.0
            state[name] = t
        else:
            raise ValueError(kind)
    for key in ("vae.style_encoder.mlp.kernel", "vae.style_encoder.mlp.bias"):
        state[key] = state[key] * damp_style_head
    missing = {n for n, _ in shapes.named_parameters()} - set(state)
    if missing:
        raise RuntimeError(f"no init rule for {sorted(missing)[:5]}")
    return state


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
