"""Native checkpoints (port of lion_tpu/ckpt/io.py).

One `.npz` a checkpoint, in the JAX package's layout, so that either
package resumes the other's files:
  - every leaf of every tree under "<tree>|<flax path joined by |>"
    ("model|encoder|layers|sa0_conv0|vconv0|kernel", "opt|leaf_3");
  - "__metadata__": the JSON of the run's metadata as uint8 bytes.

The trees of a stage-1 checkpoint are "model" (the VAE's parameters, under
the flax paths and layouts the port names them by, ckpt/from_jax.py),
"ema" (the EMA copy, same paths) and "opt": the leaves of optax's state
for `optax.chain([clip,] adam(schedule))` in its flatten order, leaf_0 the
Adam count (int32), then the first moments and the second moments in the
sorted order of the flax paths, then the schedule's count (int32)
(`adam_state_tree`). Snapshots for preemption resume are written as
`snapshot_bak`, then renamed to `snapshot`. `export_torch_checkpoint`
writes the released `.pt` schema (ckpt/torch_import.py maps the keys).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

_SEP = "|"


def flatten_tree(tree, prefix=()) -> Dict[Tuple[str, ...], Any]:
    """Nested dict -> {path tuple: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten_tree(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten_tree(flat: Dict[Tuple[str, ...], Any]) -> Dict[str, Any]:
    """{path tuple: leaf} -> nested dict."""
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def _numpy(v) -> np.ndarray:
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str, trees: Dict[str, Any],
                    metadata: Optional[dict] = None) -> None:
    """trees: name -> nested dict of arrays or tensors; metadata: JSON-able.
    Written to a temporary file, then renamed over `path`."""
    payload = {}
    for name, tree in trees.items():
        for k, v in flatten_tree(tree).items():
            payload[_SEP.join((name,) + k)] = _numpy(v)
    payload["__metadata__"] = np.frombuffer(
        json.dumps(metadata or {}).encode(), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], dict]:
    """-> (name -> nested dict of numpy arrays, metadata)."""
    grouped: Dict[str, dict] = {}
    with np.load(path, allow_pickle=False) as data:
        metadata = json.loads(bytes(data["__metadata__"]).decode())
        for key in data.files:
            if key == "__metadata__":
                continue
            name, rest = key.split(_SEP, 1)
            grouped.setdefault(name, {})[tuple(rest.split(_SEP))] = data[key]
    return {name: unflatten_tree(flat) for name, flat in grouped.items()}, \
        metadata


def save_snapshot(ckpt_dir: str, trees: Dict[str, Any],
                  metadata: dict) -> None:
    """The preemption snapshot: written as snapshot_bak, renamed to
    snapshot."""
    os.makedirs(ckpt_dir, exist_ok=True)
    bak = os.path.join(ckpt_dir, "snapshot_bak")
    save_checkpoint(bak, trees, metadata)
    os.replace(bak, os.path.join(ckpt_dir, "snapshot"))


def has_snapshot(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "snapshot"))


def load_snapshot(ckpt_dir: str):
    return load_checkpoint(os.path.join(ckpt_dir, "snapshot"))


# ------------------------------------------------- the port's modules
def tensors_tree(names: Sequence[str],
                 tensors: Sequence[torch.Tensor]) -> Dict[str, Any]:
    """Dotted parameter names and their tensors -> the flax tree (nested
    dict of numpy arrays)."""
    return unflatten_tree({tuple(n.split(".")): _numpy(t)
                           for n, t in zip(names, tensors)})


def module_arrays(module: torch.nn.Module) -> Dict[str, Any]:
    """A module's parameters as the flax tree of numpy arrays."""
    names, tensors = zip(*module.named_parameters())
    return tensors_tree(names, tensors)


def load_tensors_tree(names: Sequence[str], tensors: Sequence[torch.Tensor],
                      tree: Dict[str, Any]) -> None:
    """Copy a flax tree into `tensors` (named `names`) in place; the tree
    must hold exactly these paths and shapes."""
    flat = flatten_tree(tree)
    want = {tuple(n.split(".")) for n in names}
    if set(flat) != want:
        raise KeyError(f"checkpoint tree: missing {sorted(want - set(flat))}"
                       f", unexpected {sorted(set(flat) - want)}")
    with torch.no_grad():
        for n, t in zip(names, tensors):
            v = torch.from_numpy(np.asarray(flat[tuple(n.split("."))]))
            if tuple(v.shape) != tuple(t.shape):
                raise ValueError(f"checkpoint {n}: shape {tuple(v.shape)}, "
                                 f"parameter {tuple(t.shape)}")
            t.copy_(v)


def _flatten_order(names: Sequence[str]) -> List[int]:
    """The parameters' indices in jax.tree_util's order of the flax tree:
    dict keys sorted at every level, so the paths sorted as tuples."""
    return sorted(range(len(names)), key=lambda i: tuple(names[i].split(".")))


def adam_state_tree(count: int, mu: Sequence[torch.Tensor],
                    nu: Sequence[torch.Tensor],
                    names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Adam's state as the leaves of optax's chain state ({"leaf_i"}): the
    Adam count, mu and nu in the flax tree's flatten order, the schedule's
    count. `mu`, `nu` follow `names`."""
    order = _flatten_order(names)
    leaves = ([np.asarray(count, np.int32)]
              + [_numpy(mu[i]) for i in order]
              + [_numpy(nu[i]) for i in order]
              + [np.asarray(count, np.int32)])
    return {f"leaf_{i}": v for i, v in enumerate(leaves)}


def adam_state_from_tree(tree: Dict[str, Any], names: Sequence[str]):
    """The inverse of `adam_state_tree`: -> (count, mu, nu), the moments as
    tensors in the order of `names`."""
    p = len(names)
    if len(tree) != 2 * p + 2:
        raise ValueError(f"optimizer tree: {len(tree)} leaves for {p} "
                         f"parameters (want {2 * p + 2})")
    order = _flatten_order(names)
    leaf = lambda i: torch.from_numpy(np.array(tree[f"leaf_{i}"]))
    mu: List[Optional[torch.Tensor]] = [None] * p
    nu: List[Optional[torch.Tensor]] = [None] * p
    for j, i in enumerate(order):
        mu[i], nu[i] = leaf(1 + j), leaf(1 + p + j)
    count = int(np.asarray(tree["leaf_0"]))
    if int(np.asarray(tree[f"leaf_{2 * p + 1}"])) != count:
        raise ValueError("optimizer tree: the Adam and schedule counts "
                         "differ")
    return count, mu, nu


# ---------------------------------------------------------------- torch
def export_torch_checkpoint(path: str, vae_params, global_prior_params,
                            local_prior_params, epoch: int = 0,
                            global_step: int = 0) -> None:
    """Write the released .pt prior-checkpoint schema ({'epoch',
    'global_step', 'dae_state_dict' with the global prior under '0.' and
    the local prior under '1.', 'vae_state_dict'}) from the three flax
    trees, so the reference code loads models trained here."""
    from .torch_import import export_state_dict

    dae_sd = {}
    dae_sd.update(export_state_dict(global_prior_params, "global_prior", "0"))
    dae_sd.update(export_state_dict(local_prior_params, "local_prior", "1"))
    vae_sd = export_state_dict(vae_params, "vae")
    to_torch = lambda sd: {k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in sd.items()}
    torch.save({
        "epoch": epoch,
        "global_step": global_step,
        "dae_state_dict": to_torch(dae_sd),
        "vae_state_dict": to_torch(vae_sd),
    }, path)
