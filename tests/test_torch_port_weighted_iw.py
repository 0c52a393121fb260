"""The port's weighted two-prior step on the continuous VPSDE under each
importance-sampling mode (`sde.iw_sample_p`), against lion_tpu's on the
same weights, batch and draws: test_torch_port_weighted.py's check, split
off for the suite's time (each case compiles lion_tpu's step)."""
import pytest

from test_torch_port_sample import one_torch_thread  # noqa: F401
from test_torch_port_weighted import check_weighted_step

IW_MODES = ("ll_uniform", "ll_iw", "drop_all_uniform", "drop_all_iw",
            "drop_sigma2t_iw", "drop_sigma2t_uniform", "rescale_iw")


@pytest.mark.parametrize("mode", IW_MODES)
def test_weighted_continuous_step_matches_lion_tpu(mode):
    check_weighted_step({"sde__ode_sample": 1, "sde__iw_sample_p": mode}, 0)
