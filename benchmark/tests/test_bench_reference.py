"""CPU tests of the benchmark's plain reference against lion_tpu_torch's CPU
path (its kernels' plain versions) at small widths, of the weights made
from the seed, and of the work counts."""
import numpy as np
import pytest
import torch

from benchmark import harness, work
from benchmark.check import INPUTS, check_sample, check_train, rel_items
from benchmark.reference import Lion, Schedule
from benchmark.families import lion
from benchmark.traffic import KINDS
from benchmark.weights import make_weights

MAN = harness.manifest()


def tiny(cell, **extra):
    _, conf, mix = harness.cell_of(MAN, cell)
    return harness.set_keys(harness.config_of(conf),
                            {**lion.TINY, **extra}), mix


@pytest.mark.parametrize("cell", ["uncond-sample-ddim25-b64",
                                  "clip-sample-ddim25-b64"])
def test_forwards_match_the_program(cell):
    from lion_tpu_torch.models import LION
    cfg, _ = tiny(cell)
    state = make_weights(cfg, 3, "cpu", damp_style_head=0.01)
    port = LION(lion.port_config(cfg), device="cpu")
    port.load_state_dict(state, strict=True)
    ref = Lion(cfg)
    ref.load_state_dict(state, strict=True)
    port.eval()
    ref.eval()
    g = torch.Generator().manual_seed(0)
    b, n = 3, cfg["data"]["tr_max_sample_points"]
    clip = torch.randn(b, 512, generator=g) \
        if cfg["clipforge"]["enable"] else None
    zg = torch.randn(b, 128, generator=g)
    zl = torch.randn(b, n * 4, generator=g)
    t = torch.full((b,), 321.0)
    with torch.no_grad():
        # the eval flow folds GroupNorm from the convs' float32 statistics
        assert rel_items(port.local_prior(zl.reshape(b, n, 4), t,
                                          condition_input=zg,
                                          clip_feat=clip),
                         ref.local_prior(zl.reshape(b, n, 4), t, zg,
                                         clip)) < 1e-4
        assert rel_items(port.global_prior(zg, t, clip_feat=clip),
                         ref.global_prior(zg, t, clip)) < 1e-5
        assert rel_items(port.vae.sample(b, [zg, zl]),
                         ref.vae.decode(zg, zl)) < 1e-5
        x = torch.rand(b, n, 3, generator=g) * 2 - 1
        eps = port.vae.encode(x, torch.Generator().manual_seed(1))[0]
        z = ref.vae.encode(x, torch.Generator().manual_seed(1))
        assert rel_items(eps[:, :128], z[0]) < 1e-5
        assert rel_items(eps[:, 128:], z[3]) < 1e-4
        # the training flow is the reference's, op for op
        port.local_prior.train()
        for m in port.local_prior.modules():
            if hasattr(m, "generator"):
                m.p = 0.0
        assert rel_items(port.local_prior(zl.reshape(b, n, 4), t,
                                          condition_input=zg,
                                          clip_feat=clip),
                         ref.local_prior(zl.reshape(b, n, 4), t, zg,
                                         clip)) < 1e-6


def test_ddim_schedule_matches_the_program():
    from lion_tpu_torch.config import get_default_cfg
    from lion_tpu_torch.diffusion.discrete import DiffusionDiscretized
    cfg = harness.config_of(harness.cell_of(
        MAN, "uncond-sample-ddim25-b64")[1])
    taus, a_next, sigma = DiffusionDiscretized(
        lion.port_config(cfg)).ddim_constants(25, "uniform", 1.0)
    ours = Schedule(cfg).ddim(25, "uniform", 1.0)
    assert [t for t, *_ in ours] == list(taus)
    np.testing.assert_allclose([s for *_, s in ours], sigma, rtol=1e-6)
    assert get_default_cfg().ddpm.num_steps == Schedule(cfg).steps


def test_sample_check_reads_the_program_as_sound():
    cfg, mix = tiny("uncond-sample-ddim25-b64")
    state = make_weights(cfg, 4, "cpu", damp_style_head=0.01)
    tr = KINDS["sample"](lion.port_config(cfg), cfg, mix, state, 9, "cpu")
    tr.setup()
    tr.window(0.001)
    numbers = check_sample(cfg, mix, state, tr.release([0]), "cpu")
    assert numbers["ddim_update"] < 1e-5
    assert numbers["decode"] < 1e-5
    assert numbers["global_eps"] < 1e-5
    assert numbers["local_eps"] < 1e-2


@pytest.mark.parametrize("cell", ["uncond-train-vae-b32",
                                  "clip-train-prior-b40"])
def test_train_check_follows_the_program_step(cell):
    cfg, mix = tiny(cell, **{"ddpm.dropout": 0.1})
    state = make_weights(cfg, 5, "cpu", damp_style_head=0.01)
    tr = KINDS[mix["kind"]](lion.port_config(cfg), cfg, mix, state, 6,
                            "cpu")
    tr.setup()
    numbers = check_train(cfg, mix, state, tr.release(), "cpu")
    # the first step agrees to rounding: same draws, masks and gradients
    assert numbers["grad"] < 1e-3
    assert numbers["loss_step1"] < 1e-5
    # the inputs the program made for the stage after the encode are the
    # reference's own
    assert numbers[INPUTS[mix["kind"]]] < 1e-4


def test_weights_are_the_seeds():
    cfg, _ = tiny("clip-train-prior-b40")
    a = make_weights(cfg, 11, "cpu")
    b = make_weights(cfg, 11, "cpu")
    c = make_weights(cfg, 12, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["local_prior.unet.sa0_conv0.vconv0.kernel"],
                           c["local_prior.unet.sa0_conv0.vconv0.kernel"])
    # the released initializers: uniform in +-1/sqrt(fan_in), GN affine 1/0
    k = a["global_prior.block0.conv1.kernel"]
    assert float(k.abs().max()) <= 1 / np.sqrt(k.shape[0])
    assert torch.equal(a["vae.style_encoder.sa0_conv0.vnorm0.gn.scale"],
                       torch.ones_like(
                           a["vae.style_encoder.sa0_conv0.vnorm0.gn.scale"]))


def test_conv_flops_closed_form():
    b, ci, co, r = 2, 4, 8, 6
    x = torch.randn(b, ci, r, r, r, requires_grad=True)
    w = torch.randn(co, ci, 3, 3, 3, requires_grad=True)
    counter = work.ConvWork()
    with counter:
        y = torch.nn.functional.conv3d(x, w, padding=1)
    closed = 2 * 27 * ci * co * r ** 3 * b
    assert counter.flops == closed
    assert counter.bytes == 4 * (x.numel() + w.numel() + y.numel())
    with counter:
        y.sum().backward()
    # the input and the weight gradient, each the forward's FLOPs
    assert counter.flops == 3 * closed
    assert counter.calls == 3


def test_unit_work_counts_the_cells_convs():
    cfg, mix = tiny("uncond-train-vae-b32")
    w = work.unit_work(cfg, mix, lion)
    assert 0 < w["conv_flops"] <= w["model_flops"]
    assert w["conv_least_s"] > 0
