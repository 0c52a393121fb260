"""Data parallel over torch.distributed on the CPU (parallel/dist.py): two
spawned ranks in a gloo group (tests/_torch_dist_worker.py, which imports
the port only) against lion_tpu's one-device steps and samples, computed
here.

- The collectives: the gradient mean is the same bytes on every rank, the
  rows gather in rank order, rank 0's parameters and flag reach every
  rank; without a group every helper is the identity of a world of one.
- The two-prior step on 2 x 4 rows against lion_tpu's one-device 8-row
  step on the same draws (lion_tpu's, re-made from its key): the loss at
  rtol 1e-4 / atol 1e-6, the averaged gradients per tensor within 1e-3 and
  over all within 1e-4 (tests/test_torch_port_train.py's bounds), the
  parameters after Adam within rtol 1e-4 / atol 1e-5 wherever lion_tpu's
  gradient is more than rounding noise (there Adam's first step may flip
  sign: 2 lr, as in tests/test_torch_port_vae_train.py); parameters, EMA
  and gradients `torch.equal` across the ranks.
- The stage-1 step the same way, on the released `l1_sum` loss: each rank
  sums its rows and the ranks are averaged, as the reference's per-GPU
  scripts do, so it equals lion_tpu's 8-row step with the reconstruction
  weighted by 1 / world.
- `sample_chunked(group=)` under `given_noise` against lion_tpu's
  `sample_chunked` on its own draws (tests/test_sharding.py:113-149's
  rtol 1e-4 / atol 1e-4); each rank's local prior sees its 4 rows only;
  without given noise the ranks draw different rows.
- `eval_sample`: `num_gen` clouds gathered and scored on rank 0, None on
  rank 1; NO_REFS on both without references; `run_eval`'s fallback.
- `train_dist --distributed_init` for 2 steps at world size 2: one
  experiment, written by rank 0 alone, equal parameters on both ranks.
- Without a group (and in a group of one) the step is the one-process
  step, bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.models import LION as JaxLION
from lion_tpu.models.vae import VAE as JaxVAE
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.steps import make_prior_train_step as jax_prior_step
from lion_tpu.trainers.steps import make_vae_train_step as jax_vae_step

from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.config.view import as_view
from lion_tpu_torch.models import LION
from lion_tpu_torch.models.vae import VAE
from lion_tpu_torch.nn import init_weights
from lion_tpu_torch.parallel import dist as pdist
from lion_tpu_torch.trainers import (make_prior_train_step,
                                     warmup_cosine_schedule)

import _torch_dist_worker as worker
from test_torch_port_cli import stage1_argv
from test_torch_port_sample import (one_torch_thread,  # noqa: F401
                                    tiny_cfg, to_jax_tree)
from test_torch_port_stage2 import _chain_noise, stage2_cfg
from test_torch_port_train import (N, STYLE, _encode_jax, _flat,
                                   _grad_bounds, _rho, noise, train_cfg)
from test_torch_port_trainer import data_root  # noqa: F401
from test_torch_port_vae_train import EMA_DECAY, SCHED, TOTAL_ITER, vae_cfg

WORLD, B = 2, 8
SEED = 5


def _capture_then(opt):
    """optax: pass the gradients on to `opt` and keep them as the state of
    the chain's first link."""
    capture = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))
    return optax.chain(capture, opt)


def _params_close(got, want, want_g, lr, label):
    """Parameters after one Adam step: within rtol 1e-4 / atol 1e-5, or
    2 lr where lion_tpu's gradient is rounding noise (<= 1e-6 of the
    whole gradient's norm), where the first step's sign may differ."""
    g_norm = float(torch.cat([g.reshape(-1) for g in want_g.values()])
                   .norm())
    for k, w in want.items():
        d = (got[k] - w).abs()
        tol = 1e-5 + 1e-4 * w.abs()
        noisy = want_g[k].abs() <= 1e-6 * g_norm
        tol = torch.where(noisy, torch.maximum(tol, torch.full_like(
            tol, 2 * lr + 1e-6)), tol)
        assert bool((d <= tol).all()), (label, k, float(d.max()))


# ------------------------------------------------------------- helpers
def test_helpers_without_a_group_are_a_world_of_one():
    assert not pdist.initialized()
    assert (pdist.rank(), pdist.world()) == (0, 1)
    assert pdist.fold_seed(100, 13) == 113
    t = torch.arange(6.0).reshape(3, 2)
    assert pdist.gather_rows(t) is t
    assert pdist.broadcast_flag(True) is True
    assert pdist.broadcast_flag(0) is False


def test_collectives_on_two_ranks(tmp_path):
    got = worker.spawn_ranks("helpers", WORLD, tmp_path, {})
    for r, out in enumerate(got):
        assert (out["rank"], out["world"], out["seed"]) == (r, WORLD, 113 + r)
        # the mean of 10 (r + 1) x over the ranks, the same on both
        assert torch.equal(out["grads"][0], torch.full((3, 2), 15.0))
        assert torch.equal(out["grads"][1], torch.arange(5.0) * 15.0)
        assert torch.equal(out["values"], torch.tensor([0.5, 2.0]))
        # rank 0's parameters everywhere; the rows in rank order
        assert torch.equal(out["params"][0], torch.ones(3, 2))
        assert torch.equal(out["params"][1], torch.arange(5.0))
        assert torch.equal(out["rows"], torch.tensor([[0.0] * 3] * 2
                                                     + [[1.0] * 3] * 2))
        assert out["flag_true"] is True and out["flag_false"] is False


# ---------------------------------------------------------------- steps
def test_prior_step_on_two_ranks_matches_lion_tpu(tmp_path):
    cfg = train_cfg(get_default_cfg())
    jcfg = train_cfg(jax_default_cfg())
    for c in (cfg, jcfg):
        c.sde.ema_decay = EMA_DECAY
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    jlion = JaxLION(jcfg)
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))
    x = noise(10, B, N, 3, scale=0.3)
    o = jcfg.trainer.opt
    opt = _capture_then(joptim.make_optimizer(
        joptim.warmup_cosine_schedule(*SCHED), o.beta1, o.beta2,
        o.weight_decay, jcfg.sde.grad_clip_max_norm))
    state = joptim.create_train_state(
        {"global_prior": jlion.params["global_prior"],
         "local_prior": jlion.params["local_prior"]}, opt, EMA_DECAY)
    step = jax.jit(jax_prior_step(jlion.vae, jlion.global_prior,
                                  jlion.local_prior, jlion.diffusion, opt,
                                  jcfg))
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, jlion.params["vae"], jnp.asarray(x),
                              rng)
    # the draws of the JAX step (steps.py:137, discrete.py:68-69)
    rng_enc, rng_t, rng_n0, rng_n1, _ = jax.random.split(rng, 5)
    eps, _, latent_list = _encode_jax(jlion, x, rng_enc)
    t = (jax.random.uniform(rng_t, (B,)) * jlion.diffusion.num_steps
         ).astype(jnp.int32) + 1
    draws = {"rho": _rho(latent_list),
             "timestep": torch.from_numpy(np.array(t)),
             "noise": (torch.from_numpy(np.array(
                           jax.random.normal(rng_n0, (B, STYLE)))),
                       torch.from_numpy(np.array(jax.random.normal(
                           rng_n1, (B, eps.shape[1] - STYLE)))))}
    got = worker.spawn_ranks("prior_step", WORLD, tmp_path, {
        "cfg": cfg, "seed": SEED, "sched": SCHED, "x": torch.from_numpy(x),
        "draws": draws})

    for k in ("params", "grads"):
        assert all(torch.equal(got[0][k][n], got[1][k][n])
                   for n in got[0][k]), k
    assert all(torch.equal(a, b) for a, b in zip(got[0]["ema"],
                                                 got[1]["ema"]))
    assert got[0]["metrics"] == got[1]["metrics"]
    for k in ("loss", "train/p_loss_0", "train/p_loss_1"):
        np.testing.assert_allclose(got[0]["metrics"][k], float(metrics[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want_g = {**_flat(new_state.opt_state[0]["global_prior"],
                      "global_prior."),
              **_flat(new_state.opt_state[0]["local_prior"],
                      "local_prior.")}
    _grad_bounds(got[0]["grads"], want_g)
    want_p = {**_flat(new_state.params["global_prior"], "global_prior."),
              **_flat(new_state.params["local_prior"], "local_prior.")}
    _params_close(got[0]["params"], want_p, want_g, SCHED[0], "params")
    want_e = {**_flat(new_state.ema_params["global_prior"],
                      "global_prior."),
              **_flat(new_state.ema_params["local_prior"], "local_prior.")}
    _params_close(dict(zip(got[0]["params"], got[0]["ema"])), want_e,
                  want_g, SCHED[0], "ema")


def test_vae_step_on_two_ranks_matches_lion_tpu(tmp_path):
    cfg = vae_cfg(get_default_cfg())
    jcfg = vae_cfg(jax_default_cfg())
    # each rank sums its rows' l1 and the ranks average: the global sum
    # over the world size
    jcfg.weight_recont = cfg.weight_recont / WORLD
    vae = VAE(cfg)
    init_weights(vae, torch.Generator().manual_seed(SEED))
    jvae = JaxVAE(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(vae))
    x = noise(32, B, N, 3, scale=0.3)
    opt = _capture_then(joptim.make_optimizer(
        joptim.warmup_cosine_schedule(*SCHED)))
    state = joptim.create_train_state(params, opt, EMA_DECAY)
    step = jax.jit(jax_vae_step(jvae, opt, as_view(jcfg.to_dict()),
                                TOTAL_ITER))
    rng = jax.random.PRNGKey(33)
    new_state, metrics = step(state, jnp.asarray(x), rng)
    rng_s, _ = jax.random.split(rng)
    _, _, latent_list = jax.jit(lambda p, xx: jvae.apply(
        {"params": p}, xx, method=JaxVAE.encode,
        rngs={"sample": rng_s}))(params, jnp.asarray(x))
    got = worker.spawn_ranks("vae_step", WORLD, tmp_path, {
        "cfg": cfg, "seed": SEED, "sched": SCHED, "total_iter": TOTAL_ITER,
        "x": torch.from_numpy(x), "rho": _rho(latent_list)})

    for k in ("params", "grads"):
        assert all(torch.equal(got[0][k][n], got[1][k][n])
                   for n in got[0][k]), k
    m = got[0]["metrics"]
    assert m == got[1]["metrics"]
    for k in ("loss", "print/kl_glb", "print/kl_pt", "print/kl_feat",
              "msg/kl", "print/kl_weight"):
        np.testing.assert_allclose(m[k], float(metrics[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k in ("print/loss_0", "msg/rec"):
        np.testing.assert_allclose(m[k], float(metrics[k]) / WORLD,
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want_g = _flat(new_state.opt_state[0])
    _grad_bounds(got[0]["grads"], want_g)
    _params_close(got[0]["params"], _flat(new_state.params), want_g,
                  SCHED[0], "params")
    _params_close(dict(zip(got[0]["params"], got[0]["ema"])),
                  _flat(new_state.ema_params), want_g, SCHED[0], "ema")


def test_step_without_a_group_is_the_one_process_step(tmp_path, monkeypatch):
    """No group: the step is the one before data parallelism (here
    replayed by hand: objective, backward, zero-fill, Adam, EMA), bit for
    bit; in a gloo group of one it is the same step again."""
    cfg = train_cfg(get_default_cfg())
    x = torch.from_numpy(noise(12, 4, N, 3, scale=0.3))

    def fresh():
        lion = LION(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(SEED))
        return lion, make_prior_train_step(
            lion, warmup_cosine_schedule(*SCHED), device="cpu")

    lion, step = fresh()
    assert not step.distributed
    m1 = step(x, torch.Generator().manual_seed(1))
    ref_lion, ref = fresh()
    ref.optimizer.zero_grad()
    loss, m2 = ref.objective(x, torch.Generator().manual_seed(1))
    loss.backward()
    for p in ref.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    ref.optimizer.step()
    ref.ema.update()
    ref.after_update()
    assert {k: float(v) for k, v in m1.items()} == \
        {k: float(v.detach()) for k, v in m2.items()}
    assert all(torch.equal(a, b) for a, b in zip(step.params, ref.params))
    assert all(torch.equal(a, b) for a, b in zip(step.ema.shadow,
                                                 ref.ema.shadow))

    import torch.distributed as dist
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    pdist.init_from_env("cpu", "file://" + str(tmp_path / "store"))
    try:
        one, step1 = fresh()
        assert step1.distributed and pdist.world() == 1
        m3 = step1(x, torch.Generator().manual_seed(1))
    finally:
        dist.destroy_process_group()
    assert {k: float(v) for k, v in m3.items()} == \
        {k: float(v) for k, v in m1.items()}
    assert all(torch.equal(a, b) for a, b in zip(step1.params, step.params))


# -------------------------------------------------------------- sampling
def test_sample_chunked_over_two_ranks_matches_lion_tpu(tmp_path):
    steps, chunks = 4, 2
    cfg = tiny_cfg(get_default_cfg(), N, steps)
    lion = LION(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(SEED))
    jlion = JaxLION(tiny_cfg(jax_default_cfg(), N, steps))
    jlion.params = jax.tree_util.tree_map(jnp.asarray, to_jax_tree(lion))
    rng = jax.random.PRNGKey(7)
    want = jlion.sample_chunked(B, rng, chunks=chunks)
    # lion_tpu's draws (models/lion.py:170-208): the global init and
    # chain from the first split, then the local ones, (B, N, C)
    rng, r_init = jax.random.split(rng)
    init_g = np.array(jax.random.normal(r_init, (B, STYLE)))
    steps_g = _chain_noise(rng, steps, (B, STYLE))
    for _ in range(steps):
        rng, _ = jax.random.split(rng)
    rng, r_init = jax.random.split(rng)
    shape_l = (B, N, lion.point_channels)
    init_l = np.array(jax.random.normal(r_init, shape_l))
    steps_l = _chain_noise(rng, steps, shape_l)
    given = ((torch.from_numpy(init_g), steps_g),
             (torch.from_numpy(init_l), steps_l))
    got = worker.spawn_ranks("sample_chunked", WORLD, tmp_path, {
        "cfg": cfg, "state": lion.state_dict(), "given": given, "n": B,
        "chunks": chunks})

    for k in ("z_global", "z_local", "points"):
        assert torch.equal(got[0]["out"][k], got[1]["out"][k]), k
        np.testing.assert_allclose(
            got[0]["out"][k].numpy(),
            np.asarray(want[k]).reshape(got[0]["out"][k].shape),
            rtol=1e-4, atol=1e-4, err_msg=k)
    # each rank ran its own rows through the priors: a local batch of 4
    assert got[0]["local_batches"] == got[1]["local_batches"] == [B // WORLD]
    free = got[0]["free"]
    assert torch.equal(free, got[1]["free"]) and free.shape == (B, N, 3)
    assert not torch.equal(free[:B // WORLD], free[B // WORLD:])
    assert got[0]["refused_odd"] and got[1]["refused_odd"]


# ------------------------------------------------------------- trainers
def test_eval_sample_gathers_to_rank_zero(tmp_path, data_root):  # noqa: F811
    save_dir = str(tmp_path / "exp")
    cfg = stage2_cfg(get_default_cfg(), save_dir, data_root)
    got = worker.spawn_ranks("eval_sample", WORLD, tmp_path, {
        "cfg": cfg, "data_root": data_root, "save_dir": save_dir,
        "num_gen": 6})
    # rank 0 scored the 6 gathered clouds against the 4 test clouds
    assert got[0]["results"] is not None and got[1]["results"] is None
    assert np.isfinite(got[0]["results"]["1-NN-CD-acc"])
    samples = torch.load(os.path.join(save_dir, "samples_3.pt"))
    assert samples.shape == (6, 32, 3) and torch.isfinite(samples).all()
    # rank 1's three rows come from its own seeds
    assert not torch.equal(samples[:3], samples[3:])
    # without references: NO_REFS on both, and run_eval's fallback
    assert got[0]["no_refs"] and got[1]["no_refs"]
    assert got[0]["run_eval"] is None and got[1]["run_eval"] is None
    # each rank read its half of the 8 training clouds
    assert [g["shard"] for g in got] == [0, 1]
    assert [g["loader_len"] for g in got] == [1, 1]
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        tags = [json.loads(line)["tag"] for line in f]
    assert tags.count("eval/sample_abs_mean") == 1


def test_train_dist_distributed_init_two_ranks(tmp_path,
                                               data_root):  # noqa: F811
    exp = tmp_path / "exp"
    argv = stage1_argv(exp, data_root) + ["trainer.epochs", "2"]
    got = worker.spawn_ranks("train_dist", WORLD, tmp_path, {"argv": argv})
    assert [g["step"] for g in got] == [2, 2]
    assert got[0]["save_dir"] == got[1]["save_dir"]
    assert all(torch.equal(a, b) for a, b in zip(got[0]["params"],
                                                 got[1]["params"]))
    # one experiment, written by rank 0 alone: each record once
    assert os.listdir(exp) == [os.path.basename(got[0]["save_dir"])]
    d = got[0]["save_dir"]
    assert os.path.exists(os.path.join(d, "cfg.yml"))
    assert os.path.exists(os.path.join(d, "checkpoints", "final.npz"))
    with open(os.path.join(d, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    keys = [(r["tag"], r["step"]) for r in records]
    assert len(keys) == len(set(keys))
    assert sum(t == "train/loss" for t, _ in keys) == 2
