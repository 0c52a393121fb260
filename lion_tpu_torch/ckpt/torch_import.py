"""Released `.pt` checkpoints (port of lion_tpu/ckpt/torch_import.py).

Released LION checkpoints are torch `.pt` files with 'dae_state_dict' (a
ModuleList: '0.*' the global prior, '1.*' the local prior) and
'vae_state_dict'. This module maps their keys onto the flax paths that the
port names its parameters by (ckpt/from_jax.py), both ways.

The key map is structural: each flax path gives its torch key from the
naming conventions of both sides. The flax paths and shapes come from the
port's own modules, built on the `meta` device (`params_structure`), so
no weights are drawn. Weights are converted by the torch tensor's rank:
    Linear  (O, I)          -> kernel (I, O)
    Conv1d  (O, I, 1)       -> kernel (I, O)
    Conv2d  (O, I, 1, 1)    -> kernel (I, O)
    Conv3d  (O, I, k, k, k) -> kernel (k, k, k, I, O)
    GroupNorm weight/bias   -> scale/bias unchanged
    mixing_logit (1,C,1,1)  -> (C,) flattened
so a k=1 conv imports from a 2-D tensor (what `export_state_dict` writes)
as well as from the reference modules' Conv1d / Conv2d tensors.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .io import _numpy, flatten_tree, unflatten_tree


def torch_to_flax_array(t, flax_shape, leaf: str = "kernel") -> np.ndarray:
    """Rank- and leaf-driven weight transform torch -> flax. `leaf` is the
    flax param name: only 'kernel' leaves transpose (scale/bias/w pass
    through, so square Linear weights are not ambiguous)."""
    a = _numpy(t)
    fs = tuple(flax_shape)
    if leaf != "kernel":
        if a.shape != fs:  # e.g. mixing_logit (1,C,1,1) -> (C,)
            return a.reshape(fs)
        return a
    if a.ndim == 2:  # Linear
        return a.T
    if a.ndim == 3 and a.shape[-1] == 1:  # Conv1d k=1
        return a[:, :, 0].T
    if a.ndim == 4 and a.shape[-1] == 1 and a.shape[-2] == 1:  # Conv2d 1x1
        return a[:, :, 0, 0].T
    if a.ndim == 5:  # Conv3d
        return a.transpose(2, 3, 4, 1, 0)
    raise ValueError(f"Cannot map torch shape {a.shape} to flax {fs}")


def flax_to_torch_array(a, torch_shape) -> np.ndarray:
    """The inverse transform, to a given torch shape. A 1-D leaf (a mixing
    logit) reshapes; lion_tpu's version tries the Conv2d transpose on it
    first and fails."""
    a = _numpy(a)
    ts = tuple(torch_shape)
    if a.shape == ts:
        return a
    if a.ndim == 1:
        return a.reshape(ts)
    if len(ts) == 2:
        return a.T
    if len(ts) == 3 and ts[-1] == 1:
        return a.T[:, :, None]
    if len(ts) == 4 and ts[-1] == 1 and ts[-2] == 1:
        return a.T[:, :, None, None]
    if len(ts) == 5:
        return a.transpose(4, 3, 0, 1, 2)
    raise ValueError(f"Cannot map flax shape {a.shape} to torch {ts}")


# ------------------------------------------------------- key translation
def _wb(leaf: str) -> str:
    return {"kernel": "weight", "scale": "weight",
            "bias": "bias", "w": "w"}[leaf]


def _shared_mlp_key(rest: Tuple[str, ...], torch_prefix: str) -> str:
    """A SharedMLP leaf path (conv{i}|norm{i}/...) under `torch_prefix`,
    the SharedMLP module (its keys under `.layers`)."""
    m = re.fullmatch(r"(conv|norm)(\d+)", rest[0])
    assert m, rest
    kind, idx = m.group(1), int(m.group(2))
    if kind == "conv":
        return f"{torch_prefix}.layers.{3 * idx}.{_wb(rest[-1])}"
    # norm: plain -> GroupNorm at layers.{3i+1}; ada -> AdaGN there
    if rest[1] == "gn":
        return f"{torch_prefix}.layers.{3 * idx + 1}.{_wb(rest[-1])}"
    assert rest[1] == "ada", rest
    assert rest[2] in ("norm", "emd"), rest
    return f"{torch_prefix}.layers.{3 * idx + 1}.{rest[2]}.{_wb(rest[-1])}"


def _norm_key(rest: Tuple[str, ...], torch_prefix: str) -> str:
    """A Normalizer/AdaGN at a PVConv voxel-branch position."""
    if rest[0] == "gn":
        return f"{torch_prefix}.{_wb(rest[-1])}"
    assert rest[0] == "ada", rest
    if rest[1] == "norm":
        return f"{torch_prefix}.norm.{_wb(rest[-1])}"
    return f"{torch_prefix}.emd.{_wb(rest[-1])}"


def _pvconv_key(rest: Tuple[str, ...], torch_prefix: str) -> str:
    head = rest[0]
    if head == "vconv0":
        return f"{torch_prefix}.voxel_layers.0.{_wb(rest[-1])}"
    if head == "vnorm0":
        return _norm_key(rest[1:], f"{torch_prefix}.voxel_layers.1")
    if head == "vconv1":
        return f"{torch_prefix}.voxel_layers.4.{_wb(rest[-1])}"
    if head == "vnorm1":
        return _norm_key(rest[1:], f"{torch_prefix}.voxel_layers.5")
    if head == "se":
        sub = {"fc1": "fc.0", "fc2": "fc.2"}[rest[1]]
        return f"{torch_prefix}.voxel_layers.6.{sub}.{_wb(rest[-1])}"
    if head == "point_features":
        return _shared_mlp_key(rest[1:], f"{torch_prefix}.point_features")
    if head == "attn":
        return f"{torch_prefix}.attn.{rest[1]}.{_wb(rest[-1])}"
    raise KeyError(rest)


def _sa_module_key(rest: Tuple[str, ...], torch_prefix: str) -> str:
    m = re.fullmatch(r"mlp(\d+)", rest[0])
    assert m, rest
    return _shared_mlp_key(rest[1:], f"{torch_prefix}.mlps.{m.group(1)}")


def translate_unet_path(path: Tuple[str, ...], stage_blocks: Dict[str, int],
                        torch_prefix: str = "") -> str:
    """One flax leaf path of a PVCNN2Unet -> its torch key. `stage_blocks`
    ({'sa{i}': block count, 'fp{i}': count}) decides whether a stage is an
    nn.Sequential (an index in the key) or a bare module."""
    p = torch_prefix + "." if torch_prefix else ""
    head = path[0]
    m = re.fullmatch(r"sa(\d+)_conv(\d+)", head)
    if m:
        i, j = int(m.group(1)), int(m.group(2))
        base = f"{p}sa_layers.{i}" + (f".{j}" if stage_blocks[f"sa{i}"] > 1
                                      else "")
        if path[1].startswith(("conv", "norm")):
            return _shared_mlp_key(path[1:], base)  # SharedMLP block
        return _pvconv_key(path[1:], base)
    m = re.fullmatch(r"sa(\d+)_sa", head)
    if m:
        i = int(m.group(1))
        total = stage_blocks[f"sa{i}"]
        base = f"{p}sa_layers.{i}" + (f".{total - 1}" if total > 1 else "")
        return _sa_module_key(path[1:], base)
    if head == "global_att":
        return f"{p}global_att.{path[1]}.{_wb(path[-1])}"
    m = re.fullmatch(r"fp(\d+)_fp", head)
    if m:
        i = int(m.group(1))
        base = f"{p}fp_layers.{i}" + (".0" if stage_blocks[f"fp{i}"] > 1
                                      else "")
        assert path[1] == "mlp"
        return _shared_mlp_key(path[2:], f"{base}.mlp")
    m = re.fullmatch(r"fp(\d+)_conv(\d+)", head)
    if m:
        i, j = int(m.group(1)), int(m.group(2))
        base = f"{p}fp_layers.{i}.{j + 1}"
        if path[1].startswith(("conv", "norm")):
            return _shared_mlp_key(path[1:], base)
        return _pvconv_key(path[1:], base)
    if head == "cls_mlp":
        return _shared_mlp_key(path[1:], f"{p}classifier.0")
    simple = {"cls_out": "classifier.2", "embedf0": "embedf.0",
              "embedf1": "embedf.2", "clip_forge_mapping":
              "clip_forge_mapping", "style_clip": "style_clip"}
    if head in simple:
        return f"{p}{simple[head]}.{_wb(path[-1])}"
    raise KeyError(path)


def _stage_blocks_from_tree(flat_keys, prefix=()) -> Dict[str, int]:
    """The block count of each stage, from the flax key set."""
    counts: Dict[str, set] = {}
    for path in flat_keys:
        sub = path[len(prefix):]
        if not sub:
            continue
        m = re.fullmatch(r"(sa|fp)(\d+)_(conv(\d+)|sa|fp)", sub[0])
        if m:
            counts.setdefault(f"{m.group(1)}{m.group(2)}", set()).add(sub[0])
    return {k: len(v) for k, v in counts.items()}


def translate_encoder_path(path, stage_blocks, torch_prefix="") -> str:
    """PointNetPlusEncoder (its torch attribute is `layers`, not
    sa_layers)."""
    p = torch_prefix + "." if torch_prefix else ""
    head = path[0]
    m = re.fullmatch(r"sa(\d+)_conv(\d+)", head)
    if m:
        i, j = int(m.group(1)), int(m.group(2))
        base = f"{p}layers.{i}" + (f".{j}" if stage_blocks[f"sa{i}"] > 1
                                   else "")
        return _pvconv_key(path[1:], base)
    m = re.fullmatch(r"sa(\d+)_sa", head)
    if m:
        i = int(m.group(1))
        total = stage_blocks[f"sa{i}"]
        base = f"{p}layers.{i}" + (f".{total - 1}" if total > 1 else "")
        return _sa_module_key(path[1:], base)
    if head == "mlp":
        return f"{p}mlp.{_wb(path[-1])}"
    raise KeyError(path)


def translate_global_prior_path(path, torch_prefix="") -> str:
    p = torch_prefix + "." if torch_prefix else ""
    head = path[0]
    simple = {"temb0": "temb_layer.0", "temb1": "temb_layer.1",
              "input_layer": "input_layer", "output_layer": "output_layer",
              "clip_feat_mapping": "clip_feat_mapping"}
    if head in simple:
        return f"{p}{simple[head]}.{_wb(path[-1])}"
    if head == "mixing_logit":
        return f"{p}mixing_logit"
    if head == "temb_fun":
        return f"{p}temb_fun.{path[-1]}"
    m = re.fullmatch(r"block(\d+)", head)
    if m:
        i, sub = m.group(1), path[1]
        names = {"conv1": "conv1", "conv2": "conv2", "se_fc1": "SE.fc.0",
                 "se_fc2": "SE.fc.2", "norm1": "normalize1",
                 "norm2": "normalize2"}
        if sub in names:
            return f"{p}all_modules.{i}.{names[sub]}.{_wb(path[-1])}"
    raise KeyError(path)


# ------------------------------------------------------- model-level maps
def build_key_map(params: dict, model: str, torch_prefix: str = ""):
    """{flax path: torch key} for 'vae' | 'global_prior' | 'local_prior';
    `params` is the model's flax tree (any leaves)."""
    keys = list(flatten_tree(params))
    p = torch_prefix + "." if torch_prefix else ""
    out = {}
    if model == "global_prior":
        return {path: translate_global_prior_path(path, torch_prefix)
                for path in keys}
    if model == "local_prior":
        blocks = _stage_blocks_from_tree([k[1:] for k in keys
                                          if k[0] == "unet"])
        for path in keys:
            if path[0] == "unet":
                out[path] = translate_unet_path(path[1:], blocks,
                                                torch_prefix)
            elif path[0] == "mixing_logit":
                out[path] = f"{p}mixing_logit"
            else:
                raise KeyError(path)
        return out
    if model == "vae":
        for top in ("style_encoder", "encoder", "decoder"):
            sub_keys = [k for k in keys if k[0] == top]
            if top == "style_encoder":
                blocks = _stage_blocks_from_tree([k[1:] for k in sub_keys])
                for path in sub_keys:
                    out[path] = translate_encoder_path(path[1:], blocks,
                                                       f"{p}{top}")
            else:
                # PointTransPVC / LatentPointDecPVC wrap the U-Net as
                # `layers`
                unet_keys = [k for k in sub_keys if k[1] == "layers"]
                blocks = _stage_blocks_from_tree([k[2:] for k in unet_keys])
                for path in unet_keys:
                    out[path] = translate_unet_path(path[2:], blocks,
                                                    f"{p}{top}.layers")
        return out
    raise ValueError(model)


# ------------------------------------------------------------- top level
def module_tree(module: torch.nn.Module) -> Dict[str, Any]:
    """A module's parameters as the flax tree of its names (the tensors
    themselves, so `.shape` gives each leaf's shape)."""
    return unflatten_tree({tuple(n.split(".")): t
                           for n, t in module.named_parameters()})


def params_structure(cfg) -> Dict[str, Any]:
    """The flax trees of LION's three models ({'vae', 'global_prior',
    'local_prior'}), as parameters on the `meta` device: shapes only, no
    memory and no draws."""
    from ..models.lion import LION
    return module_tree(LION(cfg, device="meta"))


# torch keys that legitimately exist in released checkpoints but have no
# flax counterpart: module buffers that are constants or training-only
_STRICT_IGNORE = (
    r"num_batches_tracked$",      # BatchNorm bookkeeping
    r"\.sigma$",                  # spectral-norm power-iteration state
)


def import_state_dict(state_dict: Dict[str, Any], shapes: dict, model: str,
                      torch_prefix: str = "",
                      strict: bool = True) -> Dict[str, Any]:
    """A torch state_dict onto a flax (shape) tree -> a tree of float32
    numpy arrays.

    strict=True (the default): fail if any flax leaf has no torch key, or
    any torch key under `torch_prefix` is never consumed (except the buffer
    patterns of _STRICT_IGNORE). strict=False salvages partial
    checkpoints."""
    key_map = build_key_map(shapes, model, torch_prefix)
    flat_shapes = flatten_tree(shapes)
    out = {}
    missing = []
    for path, tkey in key_map.items():
        if tkey not in state_dict:
            missing.append(tkey)
            continue
        out[path] = np.asarray(torch_to_flax_array(
            state_dict[tkey], flat_shapes[path].shape, leaf=path[-1]),
            np.float32)
    if missing and strict:
        raise KeyError(f"{len(missing)} torch keys missing for {model}, "
                       f"e.g. {sorted(missing)[:5]}")
    if strict:
        prefix = torch_prefix + "." if torch_prefix else ""
        consumed = set(key_map.values())
        extra = [k for k in state_dict
                 if k.startswith(prefix) and k not in consumed
                 and not any(re.search(p, k) for p in _STRICT_IGNORE)]
        if extra:
            raise KeyError(
                f"{len(extra)} torch keys under prefix '{prefix or '<root>'}'"
                f" not consumed by {model}, e.g. {sorted(extra)[:5]} — "
                "the import map is incomplete (or pass strict=False)")
    return unflatten_tree(out)


def load_lion_checkpoint(model_path: str, cfg,
                         strict: bool = True) -> Dict[str, Any]:
    """A released LION .pt -> {'vae', 'global_prior', 'local_prior'} flax
    trees of numpy arrays, for `LION.load_jax_params`.

    strict (default True): every torch key maps to exactly one flax leaf
    and every leaf has its key (see import_state_dict)."""
    ckpt = torch.load(model_path, map_location="cpu", weights_only=True)
    dae_sd, vae_sd = ckpt["dae_state_dict"], ckpt["vae_state_dict"]
    shapes = params_structure(cfg)
    return {
        "vae": import_state_dict(vae_sd, shapes["vae"], "vae",
                                 strict=strict),
        "global_prior": import_state_dict(dae_sd, shapes["global_prior"],
                                          "global_prior", torch_prefix="0",
                                          strict=strict),
        "local_prior": import_state_dict(dae_sd, shapes["local_prior"],
                                         "local_prior", torch_prefix="1",
                                         strict=strict),
    }


def export_state_dict(params: dict, model: str,
                      torch_prefix: str = "") -> Dict[str, np.ndarray]:
    """The inverse map: a flax tree -> a torch-layout state_dict (numpy).

    Kernels of rank 2 (dense layers and k=1 convs) export as Linear-shaped
    2-D tensors and conv3d kernels as (O, I, k, k, k); everything else
    passes through. Import infers the transform from the rank, so the 2-D
    form of a k=1 conv reads back as the reference's Conv1d / Conv2d
    tensors do."""
    key_map = build_key_map(params, model, torch_prefix)
    flat = flatten_tree(params)
    out = {}
    for path, tkey in key_map.items():
        a = _numpy(flat[path])
        if path[-1] == "kernel" and a.ndim == 2:
            out[tkey] = a.T
        elif path[-1] == "kernel" and a.ndim == 5:
            out[tkey] = a.transpose(4, 3, 0, 1, 2)
        else:
            out[tkey] = a  # scale/bias/w/mixing_logit pass through
    return out
