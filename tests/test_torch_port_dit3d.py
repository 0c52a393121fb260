"""DiT-3D in lion_tpu_torch (`models.dit3d`, `nn.dit`, `ops.attention`,
`trainers.DiT3DTrainStep`, `trainers.dit3d_trainer`) against the plain
reference `benchmark/reference_dit3d` on the CPU, at small sizes, on
seeded random weights: the initializer, the forward pass with global and
windowed blocks, the window partition, the 3-D sin-cos table, one step's
loss and gradients, one Adam step, a 2-step DDIM chain on the same draws,
the attention's plain path forward and backward, the trainer through
`train_dist`, and the benchmark family's small cell through
`harness.run_cell` with each of its faults caught.

On the CPU the port's kernels run their plain versions; both sides are
float32 on the same inputs, so they differ by the order of their sums
alone. Tolerances, relative L2 unless stated: 1e-5 for a forward pass or
a gradient (float32 sums of up to 4 * 48 products in another order,
~1e-7, across two blocks and the devoxelization's 8-corner sums), 1e-6
for a table computed by the same float64 formula.
"""
import math

import pytest
import torch

import benchmark.reference_dit3d as ref
from benchmark import harness
from lion_tpu_torch import ops, train_dist
from lion_tpu_torch.config import default_cfg_for, get_default_cfg
from lion_tpu_torch.models import DiT3D
from lion_tpu_torch.nn import dit
from lion_tpu_torch.ops.attention import attention
from lion_tpu_torch.trainers import DiT3DTrainStep, get_trainer

from test_torch_port_sample import one_torch_thread  # noqa: F401
from test_torch_port_trainer import SYNSET, data_root  # noqa: F401

B, N = 2, 64
CELL = "dit3d-xl2-train-b4"
# a relative L2 gap of two float32 computations of one function (module
# docstring)
RTOL = 1e-5


def tiny_cfg(window_blocks=(0,)):
    """hidden 48 (16 a third of the position table), 2 heads of 24, two
    blocks on an 8^3 grid of 2^3 patches (64 tokens), windows of 2^3."""
    cfg = get_default_cfg(dit3d=True)
    m = cfg.dit3d
    m.hidden_size, m.depth, m.num_heads = 48, 2, 2
    m.voxel_size, m.patch_size, m.window_size = 8, 2, 2
    m.window_blocks = list(window_blocks)
    cfg.data.tr_max_sample_points = N
    return cfg


def gap(a, b) -> float:
    return float((a - b).norm() / b.norm())


def pair(cfg, seed=0):
    """The port's model (init_params) and the reference on its state."""
    port = DiT3D(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(seed))
    model = ref.DiT3D(cfg.to_dict())
    model.load_state_dict(dict(port.named_parameters()), strict=True)
    return port, model


def draws(seed=1, steps=1000):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, N, 3, generator=g) * 0.3
    t = torch.randint(0, steps, (B,), generator=g)
    noise = torch.randn(B, N, 3, generator=g)
    drop = torch.tensor([False, True])
    return x, t, noise, drop


def test_init_is_the_references():
    cfg = tiny_cfg()
    port = DiT3D(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3))
    state = ref.init_state(cfg.to_dict(), torch.Generator().manual_seed(3),
                           "cpu")
    mine = dict(port.named_parameters())
    assert list(mine) == list(state)
    assert all(torch.equal(mine[k], state[k]) for k in state)


@pytest.mark.parametrize("window_blocks", [(), (0,), (0, 1)],
                         ids=["global", "mixed", "windowed"])
def test_forward_matches_reference(window_blocks):
    port, model = pair(tiny_cfg(window_blocks))
    x, t, _, drop = draws()
    y = torch.zeros(B, dtype=torch.long)
    with torch.no_grad():
        got, want = port(x, t, y, drop), model(x, t, y, drop)
    assert got.shape == (B, N, 3)
    assert gap(got, want) < RTOL
    # windows change the function: the global model is not the windowed
    if window_blocks:
        glob, _ = pair(tiny_cfg(()))
        with torch.no_grad():
            assert gap(glob(x, t, y, drop), want) > 1e-3


@pytest.mark.parametrize("grid,w", [(4, 2), (16, 4)])
def test_window_partition_round_trip(grid, w):
    x = torch.randn(2, grid ** 3, 6)
    parts = dit.window_partition(x, grid, w)
    assert parts.shape == (2 * (grid // w) ** 3, w ** 3, 6)
    assert torch.equal(parts, ref.window_partition(x, grid, w))
    assert torch.equal(dit.window_unpartition(parts, grid, w), x)
    # window 0 holds the tokens whose (x, y, z) are all below w
    first = [(i * grid + j) * grid + k for i in range(w) for j in range(w)
             for k in range(w)]
    assert torch.equal(parts[0], x[0, first])


def test_sincos_3d_table():
    got = dit.sincos_3d(48, 4)
    assert torch.allclose(got, ref.sincos_3d(48, 4), rtol=0, atol=1e-6)
    # token (x, y, z) holds DiT's 1-D table of x, y and z, side by side
    tok = (1 * 4 + 2) * 4 + 3
    one_d = torch.from_numpy(ref.sincos_1d(16, torch.arange(4.).numpy()))
    want = torch.cat([one_d[1], one_d[2], one_d[3]]).float()
    assert torch.allclose(got[tok], want, rtol=0, atol=1e-6)


def test_loss_and_gradients_of_one_step():
    cfg = tiny_cfg()
    port, model = pair(cfg)
    x, t, noise, drop = draws()
    step = DiT3DTrainStep(port, lambda s: 1e-4)
    loss = step.loss(x, t=t, noise=noise, drop=drop)
    loss.backward()
    want = ref.loss(model, ref.Schedule(cfg.to_dict()), x, t, noise,
                    torch.zeros(B, dtype=torch.long), drop)
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) \
        / float(want.detach()) < RTOL
    ref_params = dict(model.named_parameters())
    for name, p in port.named_parameters():
        assert gap(p.grad, ref_params[name].grad) < RTOL, name


def test_one_adam_step_changes_as_the_references():
    cfg = tiny_cfg()
    port, model = pair(cfg)
    x, t, noise, drop = draws(2)
    start = {n: p.detach().clone() for n, p in port.named_parameters()}
    step = DiT3DTrainStep(port, lambda s: 1e-4)
    metrics = step(x, t=t, noise=noise, drop=drop)
    names = [n for n, _ in port.named_parameters()]
    params = [dict(model.named_parameters())[n] for n in names]
    adam = ref.Adam(params, 1e-4, 0.5, 0.999)
    loss = ref.loss(model, ref.Schedule(cfg.to_dict()), x, t, noise,
                    torch.zeros(B, dtype=torch.long), drop)
    adam.step(torch.autograd.grad(loss, params))
    assert abs(float(metrics["loss"]) - float(loss)) < RTOL * float(loss)
    for name, p, q in zip(names, port.parameters(), params):
        # Adam's first step moves each entry by ~lr sign(g): the changes
        # agree where the gradients do
        assert gap(p.detach() - start[name], q.detach() - start[name]) \
            < 1e-4, name


def test_step_draws_from_its_generator():
    cfg = tiny_cfg()
    port, _ = pair(cfg)
    step = DiT3DTrainStep(port, lambda s: 1e-4)
    x = draws()[0]
    a = step.draws(x, torch.Generator().manual_seed(7))
    b = step.draws(x, torch.Generator().manual_seed(7))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    t, noise, drop = a
    assert t.dtype == torch.int64 and 0 <= int(t.min()) and \
        int(t.max()) < 1000 and noise.shape == x.shape and \
        drop.dtype == torch.bool


def test_ddim_two_steps_match_reference():
    cfg = tiny_cfg()
    port, model = pair(cfg)
    model.eval()
    got = port.sample(B, generator=torch.Generator().manual_seed(4),
                      ddim_step=2)
    want = ref.ddim_sample(model, ref.Schedule(cfg.to_dict()), B, N, 2,
                           torch.Generator().manual_seed(4),
                           torch.zeros(B, dtype=torch.long))
    assert got.shape == (B, N, 3)
    assert gap(got, want) < RTOL


@pytest.mark.parametrize("d,length", [(72, 80), (8, 1100)])
def test_attention_plain_path_matches_reference(d, length):
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(2, 3, length, d, generator=g, dtype=torch.float64)
               for _ in range(3))
    do = torch.randn(2, 3, length, d, generator=g, dtype=torch.float64)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    w = ops.KERNELS["attention"]
    calls = w.plain_calls
    o = attention(*leaves)
    o.backward(do.float())
    assert w.plain_calls == calls + 1
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    o64 = ref.softmax_attention(*refs, 1.0 / math.sqrt(d))
    o64.backward(do)
    # float32 against float64: sums of up to 1100 terms
    assert gap(o.double(), o64) < RTOL
    for a, b in zip(leaves, refs):
        assert gap(a.grad.double(), b.grad) < RTOL


def test_trainer_through_train_dist(tmp_path, data_root):  # noqa: F811
    trainer = train_dist.main([
        "--exp_root", str(tmp_path), "--data_root", data_root,
        "--device", "cpu", "trainer.type", "trainers.dit3d_trainer",
        "data.cates", "airplane", "data.tr_max_sample_points", "64",
        "data.te_max_sample_points", "64", "data.batch_size", "4",
        "dit3d.hidden_size", "48", "dit3d.depth", "2", "dit3d.num_heads",
        "2", "dit3d.voxel_size", "8", "dit3d.window_size", "2",
        "dit3d.window_blocks", "[1]", "trainer.epochs", "1",
        "viz.viz_freq", "0", "viz.save_freq", "-1", "viz.val_freq", "-1"])
    assert type(trainer) is get_trainer("trainers.dit3d_trainer")
    assert isinstance(trainer.step_fn, DiT3DTrainStep)
    assert trainer.step == 2 and trainer.step_fn.optimizer.count == 2
    assert trainer.cfg.trainer.opt.beta1 == 0.5
    ckpt = tmp_path.glob("*/checkpoints/final.npz")
    assert len(list(ckpt)) == 1
    pts = trainer.sample(2, generator=torch.Generator().manual_seed(0),
                         ddim_step=2)
    assert pts.shape == (2, 64, 3) and bool(torch.isfinite(pts).all())


def test_the_reference_imports_nothing_of_the_program():
    _, conf, _ = harness.cell_of(harness.manifest(), CELL)
    path = harness.reference_path(harness.family_of(conf)) / "__init__.py"
    imports = [line for line in path.read_text().splitlines()
               if line.startswith(("import ", "from "))]
    assert imports and not any("lion_tpu" in line or "jax" in line
                               for line in imports)


def test_a_lion_run_has_no_dit3d_node():
    assert "dit3d" not in get_default_cfg()
    assert "dit3d" in default_cfg_for(
        None, ["trainer.type", "trainers.dit3d_trainer"])
    assert "dit3d" not in default_cfg_for(None, [])
    # the override pairs come after the file
    assert "dit3d" not in default_cfg_for(
        {"trainer": {"type": "trainers.dit3d_trainer"}},
        ["trainer.type", "trainers.train_2prior"])


# a LION config that names DiT-3D's trainer only in a comment and in
# another key's value, and one whose trainer.type is DiT-3D's
CONFIG_FILES = {
    "lion": ("# trainers.dit3d_trainer trains DiT-3D\n"
             "trainer:\n  type: trainers.train_2prior\n"
             "comet_key: trainers.dit3d_trainer\n", False),
    "dit3d": ("trainer:\n  type: trainers.dit3d_trainer\n", True),
}


@pytest.mark.parametrize("name", sorted(CONFIG_FILES))
def test_the_config_file_s_trainer_type_picks_the_tree(tmp_path, name):
    text, is_dit3d = CONFIG_FILES[name]
    path = tmp_path / "cfg.yml"
    path.write_text(text)
    cfg = train_dist.build_cfg(train_dist.get_args(
        ["--config", str(path), "--exp_root", str(tmp_path / "exp")]))
    want = get_default_cfg(dit3d=is_dit3d)
    assert ("dit3d" in cfg) == is_dit3d
    assert cfg.trainer.opt.beta1 == want.trainer.opt.beta1
    assert cfg.ddpm.ema == want.ddpm.ema


def tiny_run(fault=None, keys=None):
    _, conf, _ = harness.cell_of(harness.manifest(), CELL)
    family = harness.family_of(conf)
    keys = {**family.TINY, **(keys or {})}
    if fault is None:
        return family, harness.run_cell(CELL, 2 ** 31 + 91, 0.05, False,
                                        device="cpu", keys=keys,
                                        readings=True)
    with family.FAULTS[fault]("train_dit"):
        return family, harness.run_cell(CELL, 2 ** 31 + 91, 0.05, False,
                                        device="cpu", keys=keys,
                                        readings=True)


@pytest.mark.parametrize("fault", [None, "half_batch", "unapplied",
                                   "window_as_global"])
def test_family_tiny_cell(fault):
    family, r = tiny_run(fault)
    assert set(r["checks"]) == {"loss", "grad", "change", "plain_calls"}
    if fault is None:
        assert r["correct"] is True, r["checks"]
        assert r["attempted"] >= 1 and r["failed"] == 0
        assert set(r["metrics"]) == {"setup_s", "prior_train_samples_per_s"}
        return
    assert fault in family.OF_KIND["train_dit"]
    assert r["correct"] is False, r["checks"]
