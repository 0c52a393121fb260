"""Spectral-norm regularization (port of lion_tpu/utils/spectral_norm.py).

The power-iteration vectors (u, v) of every `kernel` parameter live in a
dict keyed by the parameter's flax-path name ("global_prior.block0.conv1.
kernel"), carried beside the training step (`PriorTrainStep.sn_state`).
Kernels are read as torch's weight.view(out, -1) matrices: a dense kernel
(in, out) as its transpose, a conv kernel (k..., in, out) as (out,
k...*in).
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

SNState = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _as_matrix(w: torch.Tensor) -> torch.Tensor:
    """A channels-last kernel (..., in, out) as the (out, in * ...) matrix
    of torch's weight.view(out, -1)."""
    if w.ndim == 2:
        return w.t()
    return w.reshape(-1, w.shape[-1]).t()


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.vector_norm(x), 1e-3)


def init_sn_state(named_params: Iterable[Tuple[str, torch.Tensor]],
                  generator: torch.Generator = None) -> SNState:
    """Unit-norm random u (out,) and v (in * ...,) for each kernel, drawn in
    the parameters' order from `generator` (a CPU generator seeded 0 by
    default) and put on each kernel's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    state = {}
    for name, w in named_params:
        if name.rsplit(".", 1)[-1] != "kernel":
            continue
        m = _as_matrix(w)
        u = torch.randn(m.shape[0], generator=generator,
                        device=generator.device)
        v = torch.randn(m.shape[1], generator=generator,
                        device=generator.device)
        state[name] = (_normalize(u).to(w.device), _normalize(v).to(w.device))
    return state


def sn_state_from_jax(tree, device=None) -> SNState:
    """The JAX package's sn_state (nested dicts ending in
    {"kernel": {"u", "v"}}) as the port's dict, so both packages start
    from the same vectors."""
    state = {}

    def walk(node, path):
        if set(node) == {"u", "v"}:
            state[".".join(path)] = tuple(
                torch.from_numpy(np.array(node[k], np.float32)).to(device)
                for k in ("u", "v"))
            return
        for k, v in node.items():
            walk(v, path + (k,))
    walk(tree, ())
    return state


def spectral_norm_loss(named_params: Iterable[Tuple[str, torch.Tensor]],
                       sn_state: SNState, num_power_iter: int = 4):
    """Sum over the kernels of u^T W v after `num_power_iter` power
    iterations (u and v detached, so only W gets a gradient), and the new
    state -> (loss, new_state)."""
    loss = None
    new_state = {}
    for name, w in named_params:
        if name not in sn_state:
            continue
        m = _as_matrix(w)
        u, v = sn_state[name]
        with torch.no_grad():
            md = m.detach()
            for _ in range(num_power_iter):
                v = _normalize(md.t() @ u)
                u = _normalize(md @ v)
        sigma = u @ (m @ v)
        loss = sigma if loss is None else loss + sigma
        new_state[name] = (u, v)
    if loss is None:
        raise ValueError("spectral_norm_loss: no kernel of the state found")
    return loss, new_state


def norm_scale_loss(named_params: Iterable[Tuple[str, torch.Tensor]]):
    """Sum over the normalization layers' `scale` parameters of max |scale|
    (the reference's batchnorm_loss on GroupNorm scales)."""
    loss = None
    for name, w in named_params:
        if name.rsplit(".", 1)[-1] == "scale":
            term = torch.max(torch.abs(w))
            loss = term if loss is None else loss + term
    return loss if loss is not None else torch.zeros(())
