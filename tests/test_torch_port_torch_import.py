"""The port's released-`.pt` import and export (ckpt/torch_import.py and
`ckpt.io.export_torch_checkpoint`) against lion_tpu's on the CPU: the key
maps of the VAE and both priors, `export_state_dict` bit for bit, `.pt`
files written by either package loaded by the other bit for bit, strict
mode, and every rank of a k=1 conv weight.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from lion_tpu.ckpt import io as jio
from lion_tpu.ckpt import torch_import as jti
from lion_tpu.config import get_default_cfg as jax_default_cfg

from lion_tpu_torch.ckpt import io
from lion_tpu_torch.ckpt import torch_import as ti
from lion_tpu_torch.config import flagship_cfg, get_default_cfg
from lion_tpu_torch.models import LION

from test_torch_port_sample import one_torch_thread, ROOT  # noqa: F401
from test_torch_port_train import train_cfg

MODELS = (("vae", ""), ("global_prior", "0"), ("local_prior", "1"))


@pytest.fixture(scope="module")
def tiny():
    """The tiny mixed-prediction LION's parameters (port init) as a flax
    tree of numpy arrays, with the two packages' configs."""
    cfg = train_cfg(get_default_cfg(), mixed=True)
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(5))
    return {"cfg": cfg, "jcfg": train_cfg(jax_default_cfg(), mixed=True),
            "tree": ti.module_tree(lion), "lion": lion,
            "arrays": io.tensors_tree(*zip(*lion.named_parameters()))}


def _assert_trees_equal(got, want):
    got, want = io.flatten_tree(got), io.flatten_tree(want)
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.float32 and g.shape == np.shape(w), k
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=str(k))


def _state_dicts_equal(a, b):
    assert set(a) == set(b)
    for k in b:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# ------------------------------------------------------------ key maps
def test_key_maps_equal_lion_tpu():
    """The released shapes (the flagship), with mixed prediction's
    logits."""
    cfg, jcfg = flagship_cfg(), __graft_entry__._flagship_cfg()
    cfg.sde.mixed_prediction = jcfg.sde.mixed_prediction = True
    shapes = ti.params_structure(cfg)
    jshapes, _ = jti.params_structure(jcfg)
    assert "mixing_logit" in shapes["local_prior"]
    assert all(p.device.type == "meta"
               for p in io.flatten_tree(shapes).values())
    for model, prefix in MODELS:
        got = ti.build_key_map(shapes[model], model, prefix)
        want = jti.build_key_map(jshapes[model], model, prefix)
        assert got == want, model
        # one torch key a leaf, every leaf mapped
        assert len(set(got.values())) == len(got) == \
            len(io.flatten_tree(shapes[model]))


# -------------------------------------------------------------- export
def test_export_state_dict_is_bit_equal_to_lion_tpus(tiny):
    for model, prefix in MODELS:
        got = ti.export_state_dict(tiny["arrays"][model], model, prefix)
        want = jti.export_state_dict(tiny["arrays"][model], model, prefix)
        _state_dicts_equal(got, want)
    # the torch tensors of the port's modules export as their arrays do
    got = ti.export_state_dict(tiny["tree"]["vae"], "vae")
    _state_dicts_equal(got, jti.export_state_dict(tiny["arrays"]["vae"],
                                                  "vae"))


def test_lion_tpu_pt_loads_bit_equal(tiny, tmp_path):
    """A .pt written by lion_tpu.ckpt.io.export_torch_checkpoint, through
    the port's load_lion_checkpoint, equals lion_tpu's load and the source
    tree, and loads into a LION."""
    arrays, path = tiny["arrays"], str(tmp_path / "lion.pt")
    jio.export_torch_checkpoint(path, arrays["vae"], arrays["global_prior"],
                                arrays["local_prior"], epoch=3,
                                global_step=70)
    got = ti.load_lion_checkpoint(path, tiny["cfg"])
    want = jti.load_lion_checkpoint(path, tiny["jcfg"])
    _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))
    _assert_trees_equal(got, arrays)
    lion = LION(tiny["cfg"], device="cpu").load_jax_params(got)
    for k, p in lion.state_dict().items():
        assert torch.equal(p, tiny["lion"].state_dict()[k]), k


def test_port_pt_loads_into_lion_tpu_exactly(tiny, tmp_path):
    arrays = tiny["arrays"]
    mine, theirs = str(tmp_path / "port.pt"), str(tmp_path / "jax.pt")
    io.export_torch_checkpoint(mine, arrays["vae"], arrays["global_prior"],
                               arrays["local_prior"], epoch=3,
                               global_step=70)
    jio.export_torch_checkpoint(theirs, arrays["vae"],
                                arrays["global_prior"], arrays["local_prior"],
                                epoch=3, global_step=70)
    a = torch.load(mine, weights_only=True)
    b = torch.load(theirs, weights_only=True)
    assert set(a) == set(b) == {"epoch", "global_step", "dae_state_dict",
                                "vae_state_dict"}
    assert (a["epoch"], a["global_step"]) == (3, 70)
    for key in ("dae_state_dict", "vae_state_dict"):
        _state_dicts_equal({k: v.numpy() for k, v in a[key].items()},
                           {k: v.numpy() for k, v in b[key].items()})
    want = jti.load_lion_checkpoint(mine, tiny["jcfg"])
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, want), arrays)


# -------------------------------------------------------------- strict
def _vae_state_dict(tiny):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
            ti.export_state_dict(tiny["arrays"]["vae"], "vae").items()}


def test_strict_import_rejects_mismatches(tiny):
    shapes = ti.params_structure(tiny["cfg"])["vae"]
    sd = _vae_state_dict(tiny)
    # the buffers of released checkpoints with no flax leaf are ignored
    ok = dict(sd)
    ok["style_encoder.mlp.num_batches_tracked"] = torch.tensor(0)
    ok["decoder.layers.sa_layers.0.0.voxel_layers.0.weight.sigma"] = \
        torch.ones(1)
    _assert_trees_equal(ti.import_state_dict(ok, shapes, "vae"),
                        tiny["arrays"]["vae"])
    missing = dict(sd)
    gone = sorted(missing)[3]
    del missing[gone]
    with pytest.raises(KeyError, match="missing"):
        ti.import_state_dict(missing, shapes, "vae")
    partial = ti.import_state_dict(missing, shapes, "vae", strict=False)
    assert len(io.flatten_tree(partial)) == len(sd) - 1
    extra = dict(sd)
    extra["encoder.layers.unknown.weight"] = torch.zeros(2)
    with pytest.raises(KeyError, match="not consumed"):
        ti.import_state_dict(extra, shapes, "vae")
    # keys outside the prefix belong to the other model of a ModuleList
    dae = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
           ti.export_state_dict(tiny["arrays"]["global_prior"],
                                "global_prior", "0").items()}
    dae["1.something.weight"] = torch.zeros(1)
    ti.import_state_dict(dae, ti.params_structure(tiny["cfg"])
                         ["global_prior"], "global_prior", "0")


@pytest.mark.parametrize("rank", [2, 3, 4])
def test_k1_conv_weights_import_at_every_rank(tiny, rank):
    """export writes rank-2 kernels; the reference's modules hold k=1 convs
    as Conv1d (O, I, 1) or Conv2d (O, I, 1, 1) weights: all import."""
    shapes = ti.params_structure(tiny["cfg"])
    for model, prefix in MODELS:
        sd = ti.export_state_dict(tiny["arrays"][model], model, prefix)
        ranked = {k: (v.reshape(v.shape + (1,) * (rank - 2))
                      if v.ndim == 2 else v) for k, v in sd.items()}
        assert sum(v.ndim == rank for v in ranked.values()) > 0
        got = ti.import_state_dict(
            {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in ranked.items()}, shapes[model], model, prefix)
        _assert_trees_equal(got, tiny["arrays"][model])
        want = jti.import_state_dict(ranked, jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
            tiny["arrays"][model]), model, prefix)
        _assert_trees_equal(got, jax.tree_util.tree_map(np.asarray, want))


def test_array_transforms_round_trip():
    rs = np.random.RandomState(3)
    for tshape, fshape in (((5, 3), (3, 5)), ((5, 3, 1), (3, 5)),
                           ((5, 3, 1, 1), (3, 5)),
                           ((4, 2, 3, 3, 3), (3, 3, 3, 2, 4))):
        t = rs.randn(*tshape).astype(np.float32)
        f = ti.torch_to_flax_array(torch.from_numpy(t), fshape)
        np.testing.assert_array_equal(f, jti.torch_to_flax_array(t, fshape))
        assert f.shape == fshape
        np.testing.assert_array_equal(ti.flax_to_torch_array(f, tshape), t)
    # a mixing logit (1, C, 1, 1) <-> (C,)
    m = rs.randn(1, 6, 1, 1).astype(np.float32)
    f = ti.torch_to_flax_array(m, (6,), leaf="mixing_logit")
    np.testing.assert_array_equal(ti.flax_to_torch_array(f, m.shape), m)
    with pytest.raises(ValueError):
        ti.torch_to_flax_array(np.zeros((2, 3, 2)), (3, 2))


def test_torch_import_leaves_jax_out():
    code = ("import sys, lion_tpu_torch.ckpt.torch_import;"
            "bad = [m for m in ('jax', 'flax', 'optax', 'lion_tpu') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
