"""JAX param tree -> the port's state_dict.

The port names its parameters after the flax tree paths of the JAX package
(`local_prior.unet.sa0_conv0.vconv0.kernel`, ...) and stores every weight in
the flax layout (Dense kernels (in, out), conv kernels (3, 3, 3, in, out)),
so the bridge is a flatten of the nested dict with '.' joins and no
transposes. It takes numpy leaves (`jax.device_get(params)`), so this module
imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(flatten(v, name + "."))
        else:
            out[name] = np.asarray(v)
    return out


def state_dict_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> {dotted name: float32 tensor}."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in flatten(tree).items()}
