"""The weighted bf16 two-prior step against the JAX package on the CPU.

One step under `tpu.bf16 = True` with the continuous diffusion (ll_iw),
mixed prediction, the spectral norm (lion_tpu's power-iteration state
carried across) and the mixing-logit penalty, on the same weights, batch
and draws as lion_tpu's bf16 step (re-made from its key). The port's float32
step on the same weights and draws (held to lion_tpu's float32 step by
test_torch_port_weighted.py) is the reference both bf16 steps are measured
against, as in test_torch_port_bf16_steps.py.

The Jacobian and kinetic regularizers under bf16 have no lion_tpu
counterpart: with either on, its bf16 step fails to trace (it takes the
prior's VJP, and the loss's gradient transposes the float32
weight-gradient conv of the bf16 conv's VJP, lion_tpu/ops/pallas/
conv3d.py:594-600, against a bf16 operand). The port's step runs, K10 in
bf16 inside the second-order graph; its terms are held to the float32
step's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lion_tpu.diffusion import continuous as jcont
from lion_tpu.trainers import optim as joptim
from lion_tpu.trainers.steps import make_prior_train_step as jax_step
from lion_tpu.utils.spectral_norm import init_sn_state as jinit_sn_state

from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.models import LION
from lion_tpu_torch.trainers import make_prior_train_step
from lion_tpu_torch.utils.spectral_norm import sn_state_from_jax

from test_torch_port_sample import one_torch_thread  # noqa: F401
from test_torch_port_stage2 import _named
from test_torch_port_train import run_in_bf16
from test_torch_port_weighted import (B, LR, N, _jax_draws, _lr_schedule,
                                      _names, _pair, weighted_cfg)
from test_torch_port_bf16_steps import _hold

OVER = {"sde__ode_sample": 1, "sde__weight_decay_norm_dae": 1e-2,
        "sde__regularize_mlogit": 1.0, "sde__regularize_mlogit_margin": 1.0}
JAC = {"sde__ode_sample": 1, "sde__jac_reg_coeff": 1.0,
       "sde__kin_reg_coeff": 1.0, "sde__jac_reg_samples": 1}


def _port_step(lion, bf16, x, draws, over=OVER, sn_state=None):
    """One port step of a copy of `lion` in bf16 or float32 -> (metrics,
    gradients (Adam's first moment over 1 - beta1), updated parameters)."""
    m = LION(weighted_cfg(get_default_cfg(), **over, tpu__bf16=bf16),
             device="cpu")
    m.load_state_dict(lion.state_dict())
    step = make_prior_train_step(m, _lr_schedule(), device="cpu")
    if sn_state is not None:
        step.sn_state = sn_state_from_jax(sn_state)

    def run():
        return step(torch.from_numpy(x), **draws)
    metrics = run_in_bf16([m.local_prior], run) if bf16 else run()
    beta1 = float(m.cfg.trainer.opt.beta1)
    names = _names(m)
    grads = {n: mu / (1.0 - beta1)
             for n, mu in zip(names, step.optimizer.moments()[0])}
    return metrics, grads, {n: p.detach().clone()
                            for n, p in zip(names, step.params)}


def test_weighted_bf16_step_matches_lion_tpu():
    """Measured: the losses 1.1e-5 apart (bound 1e-4; the weighted loss is
    dominated by the float32 weights and targets), the spectral norm
    within 1e-5 of lion_tpu's (float32 on float32 parameters); the
    flattened gradient 0.043 from the float32 reference, where lion_tpu's
    bf16 gradient is 0.099 from it, and 0.093 from lion_tpu's; updates
    within 2 lr, 3.8% of them more than lr / 100 apart (bound 10%)."""
    lion, jlion = _pair(**OVER, tpu__bf16=True)
    jcfg = jlion.cfg
    sde = jcfg.sde
    opt_cfg = jcfg.trainer.opt
    opt = joptim.make_optimizer(
        joptim.warmup_cosine_schedule(LR, LR, 0, 2, 0, 1), opt_cfg.beta1,
        opt_cfg.beta2, opt_cfg.weight_decay, sde.grad_clip_max_norm)
    params = {"global_prior": jlion.params["global_prior"],
              "local_prior": jlion.params["local_prior"]}
    state = joptim.create_train_state(params, opt, sde.ema_decay)
    state = state.replace(sn_state=jinit_sn_state(params))
    step = jax.jit(jax_step(jlion.vae, jlion.global_prior,
                            jlion.local_prior, jcont.make_diffusion(sde), opt,
                            jcfg))
    x = (np.random.RandomState(10).randn(B, N, 3) * 0.3).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    new_state, metrics = step(state, jlion.params["vae"], jnp.asarray(x),
                              rng)
    draws = _jax_draws(jlion, x, rng, True, True)
    del draws["jac_probes"]
    sn = jax.device_get(state.sn_state)
    got, g16, p16 = _port_step(lion, True, x, draws, sn_state=sn)
    ref, g32, _ = _port_step(lion, False, x, draws, sn_state=sn)
    assert set(got) == set(metrics)
    np.testing.assert_allclose(float(got["train/dae_norm_loss"]),
                               float(metrics["train/dae_norm_loss"]),
                               rtol=1e-5)
    adam = new_state.opt_state[-1][0]
    beta1 = float(opt_cfg.beta1)
    want_g = {k: v / (1.0 - beta1) for k, v in _named(adam.mu).items()}
    _hold(sorted(g16), g16, g32, want_g, p16, _named(new_state.params),
          float(got["loss"]), float(metrics["loss"]), (1e-4, 0.1), LR)
    assert all(p.dtype == torch.float32 for p in p16.values())


def test_weighted_bf16_jacobian_step_runs_where_lion_tpu_cannot_trace():
    """The Jacobian and kinetic regularizers under bf16: lion_tpu's step
    raises while tracing; the port's step runs (K10 in bf16 in the
    second-order graph, its plain version here) and its Jacobian and
    kinetic terms stay within 0.1 of the float32 step's on the same draws
    (measured 5.1e-2 on the local prior's Jacobian term, a squared norm of
    a gradient, J^T v, which carries the gradients' bf16 noise)."""
    lion, jlion = _pair(**JAC, tpu__bf16=True)
    jcfg = jlion.cfg
    opt = joptim.make_optimizer(
        joptim.warmup_cosine_schedule(LR, LR, 0, 2, 0, 1))
    state = joptim.create_train_state(
        {"global_prior": jlion.params["global_prior"],
         "local_prior": jlion.params["local_prior"]}, opt, 0.0)
    step = jax.jit(jax_step(jlion.vae, jlion.global_prior,
                            jlion.local_prior,
                            jcont.make_diffusion(jcfg.sde), opt, jcfg))
    x = (np.random.RandomState(10).randn(B, N, 3) * 0.3).astype(np.float32)
    rng = jax.random.PRNGKey(11)
    with pytest.raises(TypeError, match="same dtypes"):
        step(state, jlion.params["vae"], jnp.asarray(x), rng)
    draws = _jax_draws(jlion, x, rng, True, True)
    draws["jac_probes"] = tuple(p[:1] for p in draws["jac_probes"])
    got, g16, p16 = _port_step(lion, True, x, draws, over=JAC)
    ref, _, _ = _port_step(lion, False, x, draws, over=JAC)
    for k in ("train/jac_reg_0", "train/jac_reg_1", "train/kin_reg_0",
              "train/kin_reg_1"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=0.1,
                                   err_msg=k)
    assert all(torch.isfinite(g).all() for g in g16.values())
    assert all(p.dtype == torch.float32 for p in p16.values())
