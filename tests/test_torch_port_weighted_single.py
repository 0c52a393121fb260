"""The port's single-prior trainer under the weighted objective against
lion_tpu's on the CPU.

lion_tpu's `train_prior.Trainer` at its build state is saved and resumed
by the port's, whose power-iteration state is carried across from
lion_tpu's; both take one `train_iter` on the same batch, the port on
lion_tpu's draws re-made from its key (lion_tpu/trainers/train_prior.py:
88-100: rng_enc's posterior noises, rng_t's uniforms, rng_n's diffusion
noise). The single prior's weighted objective is its own: the
spectral-norm and norm-scale terms and the mixing-logit penalty on its one
logit enter once, and it takes no Jacobian or kinetic term
(train_prior.py:126-142). Cases: the continuous VPSDE and the discrete
DDPM with the p2 weight, each with mixed prediction. The metrics agree
within 1e-5, the Adam moments and updated parameters as
test_torch_port_weighted's `_assert_adam_step` holds them, the EMA as
`assert_ema_step` does, the new power-iteration vectors within 1e-5.
Dropout is 0.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lion_tpu_torch.trainers.train_prior import Trainer as SinglePrior
from lion_tpu_torch.utils.spectral_norm import sn_state_from_jax

from test_torch_port_sample import one_torch_thread  # noqa: F401
from test_torch_port_stage2 import (JaxSinglePrior, _encode_jax, _jax,
                                    _named, _port)
from test_torch_port_train import _rho
from test_torch_port_trainer import data_root  # noqa: F401
from test_torch_port_weighted import _assert_adam_step, assert_ema_step

WEIGHTED = {"latent_pts__pvd_mse_loss": 0, "sde__mixed_prediction": True,
            "sde__weight_decay_norm_dae": 1e-2,
            "sde__regularize_mlogit": 1.0,
            "sde__regularize_mlogit_margin": 1.0}
CASES = {"continuous": {"sde__ode_sample": 1, "sde__iw_sample_p": "ll_iw"},
         "discrete_p2": {"ddpm__use_p2_weight": 1}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_prior_weighted_step_after_resume_matches_lion_tpu(
        tmp_path, data_root, case):  # noqa: F811
    over = {**WEIGHTED, **CASES[case]}
    jt = _jax(JaxSinglePrior, str(tmp_path / "jax"), data_root, **over)
    assert jt.state.sn_state is not None
    jt.save(tag="init")
    pt = _port(SinglePrior, tmp_path / "port", data_root, **over)
    assert pt.resume(os.path.join(jt.ckpt_dir, "init.npz"))
    assert pt.step_fn.sn_state is not None
    pt.step_fn.sn_state = sn_state_from_jax(
        jax.device_get(jt.state.sn_state))
    before = {n: p.detach().clone()
              for n, p in zip(pt.param_names, pt.step_fn.params)}
    batch = next(iter(pt.train_loader))
    x = np.asarray(batch["tr_points"], np.float32)
    b = x.shape[0]
    _, sub = jax.random.split(jt.rng)
    rng_enc, rng_t, rng_n, _ = jax.random.split(sub, 4)
    eps, _, latent_list = _encode_jax(jt, x, rng_enc)
    u = jax.random.uniform(rng_t, (b,))
    draws = {"rho": _rho(latent_list),
             "noise": torch.from_numpy(np.array(
                 jax.random.normal(rng_n, eps.shape)))}
    if pt.cfg.sde.ode_sample:
        draws["iw_rho"] = torch.from_numpy(np.array(u))
    else:
        draws["timestep"] = torch.from_numpy(np.array(
            (u * pt.cfg.ddpm.num_steps).astype(jnp.int32) + 1))
    want = jt.train_iter(batch, 0)
    got = pt.train_iter(batch, 0, **draws)
    assert set(got) == set(want) == {"loss", "train/dae_norm_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    assert set(_named(jt.state.params)) == set(pt.param_names)
    _assert_adam_step(pt.param_names, pt.step_fn, before, jt.state,
                      pt.cfg.trainer.opt)
    assert_ema_step(pt, jt.state)
    want_sn = sn_state_from_jax(jax.device_get(jt.state.sn_state))
    assert set(want_sn) == set(pt.step_fn.sn_state)
    for k, (u_, v_) in want_sn.items():
        for a, w in zip(pt.step_fn.sn_state[k], (u_, v_)):
            np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
