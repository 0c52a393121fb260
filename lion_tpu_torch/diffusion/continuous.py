"""Continuous-time VPSDE and probability-flow ODE sampling (port of
lion_tpu/diffusion/continuous.py).

`DiffusionVPSDE` holds the linear-beta VPSDE on t in [0, 1]: its
coefficients, the importance-sampled training quantities `iw_quantities`
(seven modes), and the probability-flow ODE

    dx/dt = f(t) x + g2(t) / 2 * eps(x, t) / sqrt(var(t)),

integrated from t = 1 to ode_eps to sample (`sample_model_ode`) or from
ode_eps to 1 to encode (`compute_ode_encode`). Both return (y, nfe).

The solvers: the embedded Runge-Kutta engine (`odeint_adaptive`) with the
five tableaus dopri5 (alias dopri45, the default), dopri8, bosh3,
fehlberg2 and adaptive_heun; the fixed-grid euler, midpoint, heun2 and rk4
(`odeint_fixed`); and the explicit 4-step Adams-Bashforth
(`odeint_adams_bashforth4`). The JAX package runs each as one device loop;
here the adaptive engine is a Python loop that keeps t, h, the error norm
and the step factor as float32 0-d tensors on the state's device, with the
JAX package's clip, accept and done rules, and reads one 0-d flag (done)
to the host a step. Every coefficient meets the float32 state as the JAX
package's weakly typed Python scalars do: rounded to float32 once where it
meets a tensor, after any arithmetic among Python scalars in float64.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from .discrete import get_mixed_prediction, randn


def make_diffusion(sde_cfg):
    """The continuous diffusion of cfg.sde (only 'vpsde' exists)."""
    if sde_cfg.sde_type == "vpsde":
        return DiffusionVPSDE(sde_cfg)
    raise ValueError(f"Unrecognized sde type: {sde_cfg.sde_type}")


def _f32(x, device=None) -> torch.Tensor:
    """A float32 tensor of x: a Python scalar rounds once, as a JAX weak
    scalar does where it becomes an array."""
    if torch.is_tensor(x):
        return x
    return torch.tensor(x, dtype=torch.float32, device=device)


class DiffusionVPSDE:
    """VPSDE with beta(t) = beta_start + (beta_end - beta_start) t.

    The coefficient functions take a Python float (computed in float64, as
    the JAX package's Python arithmetic is) or a float32 tensor."""

    def __init__(self, sde_cfg):
        self.sigma2_0 = float(sde_cfg.sigma2_0)
        self.beta_start = float(sde_cfg.beta_start)
        self.beta_end = float(sde_cfg.beta_end)
        self.time_eps = float(sde_cfg.time_eps)
        self.sde_type = "vpsde"
        # constants of the 'drop_all_iw' importance sampling
        delta_beta_half = 0.5 * (self.beta_end - self.beta_start)
        beta_frac = self.beta_start / (self.beta_end - self.beta_start)
        self.delta_beta_half = delta_beta_half
        self.beta_frac = beta_frac
        self.const_aq = ((1.0 - self.sigma2_0) * math.exp(0.5 * beta_frac)
                         * math.sqrt(0.25 * math.pi / delta_beta_half))
        self.const_erf = math.erf(math.sqrt(delta_beta_half)
                                  * (self.time_eps + beta_frac))
        self.const_norm_2 = (math.erf(math.sqrt(delta_beta_half)
                                      * (1.0 + beta_frac)) - self.const_erf)
        self.const_norm = self.const_aq * self.const_norm_2

    # -- SDE coefficients -------------------------------------------------
    def f(self, t):
        return -0.5 * self.g2(t)

    def g2(self, t):
        return self.beta_start + (self.beta_end - self.beta_start) * t

    def var(self, t):
        return 1.0 - (1.0 - self.sigma2_0) * torch.exp(_f32(
            -self.beta_start * t
            - 0.5 * (self.beta_end - self.beta_start) * t * t))

    def e2int_f(self, t):
        return torch.exp(_f32(-0.5 * self.beta_start * t
                              - 0.25 * (self.beta_end - self.beta_start)
                              * t * t))

    def inv_var(self, var):
        c = torch.log((1.0 - var) / (1.0 - self.sigma2_0))
        a = self.beta_end - self.beta_start
        return (-self.beta_start
                + torch.sqrt(self.beta_start ** 2 - 2.0 * a * c)) / a

    def mixing_component(self, x_noisy, var_t, t):
        return torch.sqrt(var_t) * x_noisy

    @staticmethod
    def sample_q(x_init, noise, var_t, m_t):
        return m_t * x_init + torch.sqrt(var_t) * noise

    def cross_entropy_const(self, ode_eps):
        return 0.5 * (1.0 + torch.log(2.0 * math.pi * self.var(
            _f32(float(ode_eps)))))

    # -- importance-sampled training quantities ---------------------------
    def iw_quantities(self, size: int, time_eps: float, iw_sample_mode: str,
                      generator: Optional[torch.Generator] = None,
                      rho: Optional[torch.Tensor] = None, device=None):
        """rho ~ U[0, 1) (size,) from `generator` (on its device, moved to
        `device`), or the given `rho`; returns (t (B,), var_t, m_t,
        obj_weight_t_p, obj_weight_t_q, g2_t), the last five (B, 1)."""
        if rho is None:
            gdev = generator.device if generator is not None else device
            rho = torch.rand(size, generator=generator, device=gdev)
        rho = rho.to(device if device is not None else rho.device,
                     torch.float32)
        if iw_sample_mode == "ll_uniform":
            t = rho * (1.0 - time_eps) + time_eps
            var_t, m_t, g2_t = self.var(t), self.e2int_f(t), self.g2(t)
            obj_p = obj_q = g2_t / (2.0 * var_t)
        elif iw_sample_mode == "ll_iw":
            ones = torch.ones_like(rho)
            sigma2_1, sigma2_eps = self.var(ones), self.var(time_eps * ones)
            log_s1, log_se = torch.log(sigma2_1), torch.log(sigma2_eps)
            var_t = torch.exp(rho * log_s1 + (1.0 - rho) * log_se)
            t = self.inv_var(var_t)
            m_t, g2_t = self.e2int_f(t), self.g2(t)
            obj_p = obj_q = 0.5 * (log_s1 - log_se) / (1.0 - var_t)
        elif iw_sample_mode == "drop_all_uniform":
            t = rho * (1.0 - time_eps) + time_eps
            var_t, m_t, g2_t = self.var(t), self.e2int_f(t), self.g2(t)
            obj_p = torch.ones_like(t)
            obj_q = g2_t / (2.0 * var_t)
        elif iw_sample_mode == "drop_all_iw":
            t = (torch.sqrt(_f32(1.0 / self.delta_beta_half, rho.device))
                 * torch.special.erfinv(
                     rho * self.const_norm_2 + self.const_erf)
                 - self.beta_frac)
            var_t, m_t, g2_t = self.var(t), self.e2int_f(t), self.g2(t)
            obj_p = self.const_norm / (1.0 - var_t)
            obj_q = obj_p * g2_t / (2.0 * var_t)
        elif iw_sample_mode == "drop_sigma2t_iw":
            ones = torch.ones_like(rho)
            sigma2_1, sigma2_eps = self.var(ones), self.var(time_eps * ones)
            var_t = rho * sigma2_1 + (1.0 - rho) * sigma2_eps
            t = self.inv_var(var_t)
            m_t, g2_t = self.e2int_f(t), self.g2(t)
            obj_p = 0.5 * (sigma2_1 - sigma2_eps) / (1.0 - var_t)
            obj_q = obj_p / var_t
        elif iw_sample_mode == "drop_sigma2t_uniform":
            t = rho * (1.0 - time_eps) + time_eps
            var_t, m_t, g2_t = self.var(t), self.e2int_f(t), self.g2(t)
            obj_p = g2_t / 2.0
            obj_q = g2_t / (2.0 * var_t)
        elif iw_sample_mode == "rescale_iw":
            t = rho * (1.0 - time_eps) + time_eps
            var_t, m_t, g2_t = self.var(t), self.e2int_f(t), self.g2(t)
            obj_p = 0.5 / (1.0 - var_t)
            obj_q = g2_t / (2.0 * var_t)
        else:
            raise ValueError(
                f"Unrecognized importance sampling type: {iw_sample_mode}")
        return t, var_t[:, None], m_t[:, None], obj_p[:, None], \
            obj_q[:, None], g2_t[:, None]

    # -- probability-flow ODE ----------------------------------------------
    def _ode_func(self, model_fn: Callable, x_shape, mixing_logit):
        num_samples = x_shape[0]

        def ode_func(t, x):
            var = self.var(t)
            if torch.is_tensor(t):
                tt = t.to(x.device).reshape(1).expand(num_samples)
            else:
                tt = torch.full((num_samples,), t, dtype=torch.float32,
                                device=x.device)
            pred = model_fn(x, tt)
            if mixing_logit is not None:
                mix = self.mixing_component(x, var, t)
                pred = get_mixed_prediction(
                    pred, mixing_logit.reshape(x_shape[1:]), mix)
            return self.f(t) * x + 0.5 * self.g2(t) * pred / torch.sqrt(var)
        return ode_func

    def sample_model_ode(self, model_fn: Callable, num_samples: int, shape,
                         ode_eps: float = 1e-5, ode_solver_tol: float = 1e-5,
                         temp: float = 1.0, noise=None,
                         generator: Optional[torch.Generator] = None,
                         device=None, mixing_logit=None,
                         method: str = "dopri45", fixed_steps: int = 100):
        """Integrate the probability-flow ODE from t = 1 to ode_eps from
        `noise` (num_samples, *shape), or a standard normal draw of
        `generator` times `temp`. `method`: an adaptive solver (tolerance
        ode_solver_tol, relative and absolute), a fixed-grid one or
        'explicit_adams' over `fixed_steps` steps. Returns (samples, nfe)."""
        x_shape = (num_samples,) + tuple(shape)
        if noise is None:
            noise = randn(x_shape, generator, device) * temp
        noise = noise.reshape(x_shape)
        if device is not None:
            noise = noise.to(device)
        return _dispatch_ode(self._ode_func(model_fn, x_shape, mixing_logit),
                             noise, 1.0, ode_eps, method, fixed_steps,
                             ode_solver_tol)

    def compute_ode_encode(self, model_fn: Callable, eps,
                           ode_eps: float = 1e-5,
                           ode_solver_tol: float = 1e-5,
                           mixing_logit=None, method: str = "dopri45",
                           fixed_steps: int = 100):
        """The deterministic encode: the probability-flow ODE from
        t = ode_eps to 1, a clean latent to its noise-space point (the live
        part of the reference's compute_ode_nll). Returns (eps_T, nfe)."""
        return _dispatch_ode(
            self._ode_func(model_fn, tuple(eps.shape), mixing_logit), eps,
            ode_eps, 1.0, method, fixed_steps, ode_solver_tol)


def _dispatch_ode(func, y0, t0, t1, method, fixed_steps, tol):
    """Route an ODE solver's name to its integrator."""
    if method in _ADAPTIVE_TABLEAUS:
        return odeint_adaptive(func, y0, t0, t1, method, rtol=tol, atol=tol)
    if method in _FIXED_STAGES:
        return odeint_fixed(func, y0, t0, t1, fixed_steps, method)
    if method in ("adams", "explicit_adams", "ab4"):
        return odeint_adams_bashforth4(func, y0, t0, t1, fixed_steps)
    raise ValueError(
        f"unknown ODE method {method!r}; choose an adaptive solver "
        f"{sorted(_ADAPTIVE_TABLEAUS)}, a fixed-grid solver "
        f"{sorted(_FIXED_STAGES)}, or 'explicit_adams'")


# ------------------------------------------------------- fixed-grid RK
# name -> (stages (c, a row), b weights)
_FIXED_STAGES = {
    "euler": (((0.0, ()),), (1.0,)),
    "midpoint": (((0.0, ()), (0.5, (0.5,))), (0.0, 1.0)),
    "heun2": (((0.0, ()), (1.0, (1.0,))), (0.5, 0.5)),
    "rk4": (((0.0, ()), (0.5, (0.5,)), (0.5, (0.0, 0.5)),
             (1.0, (0.0, 0.0, 1.0))),
            (1 / 6, 1 / 3, 1 / 3, 1 / 6)),
}


def _step_time(t0: float, i: int, h: float, device) -> torch.Tensor:
    """t0 + i * h in float32 with i a float32 step index, as the JAX
    package's scans compute their step times."""
    return t0 + _f32(float(i), device) * h


def _rk_stages(func, y, t, h, stages):
    k = []
    for c, arow in stages:
        yi = y
        for a, kj in zip(arow, k):
            if a:
                yi = yi + h * a * kj
        k.append(func(t + c * h, yi))
    return k


def odeint_fixed(func, y0, t0: float, t1: float, num_steps: int,
                 method: str = "rk4"):
    """Fixed-grid explicit RK from t0 to t1 in num_steps steps. Returns
    (y(t1), nfe = num_steps * stages)."""
    stages, bw = _FIXED_STAGES[method]
    h = (t1 - t0) / num_steps
    y = y0
    for i in range(num_steps):
        k = _rk_stages(func, y, _step_time(t0, i, h, y0.device), h, stages)
        for b, ki in zip(bw, k):
            if b:
                y = y + h * b * ki
    return y, num_steps * len(stages)


def odeint_adams_bashforth4(func, y0, t0: float, t1: float,
                            num_steps: int):
    """Explicit 4-step Adams-Bashforth; RK4 bootstraps the first three
    steps (at float64 times, as the JAX package's Python loop computes
    them), one function evaluation a step after that."""
    if num_steps < 4:
        raise ValueError(
            f"adams-bashforth-4 needs num_steps >= 4 (got {num_steps}): "
            "the 3 RK4 bootstrap steps would integrate past t1")
    stages, bw = _FIXED_STAGES["rk4"]
    h = (t1 - t0) / num_steps

    def rk4_step(y, t):
        k = _rk_stages(func, y, t, h, stages)
        for b, ki in zip(bw, k):
            y = y + h * b * ki
        return y

    fs = [func(t0, y0)]
    y = y0
    for i in range(3):                        # bootstrap the f history
        y = rk4_step(y, t0 + i * h)
        fs.append(func(t0 + (i + 1) * h, y))
    f3, f2, f1, f0 = fs[3], fs[2], fs[1], fs[0]   # f3 the most recent
    for i in range(3, num_steps):
        y = y + h / 24.0 * (55.0 * f3 - 59.0 * f2 + 37.0 * f1 - 9.0 * f0)
        fn = func(t0 + (_f32(float(i), y0.device) + 1.0) * h, y)
        f3, f2, f1, f0 = fn, f3, f2, f1
    # nfe: the first f, 3 bootstrap RK4 steps of 4 evaluations and their
    # 3 f's, one evaluation an AB step
    return y, 1 + 3 * 5 + (num_steps - 3)


# ------------------------------------------------- adaptive RK family
# A tableau is (c, a rows, b of the solution, b of the error estimate
# (higher minus lower order), order): Dormand & Prince 1980/1981, Bogacki
# & Shampine 1989, Fehlberg 1969, Heun-Euler.
_DP5 = (
    (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0),
    (
        (),
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
        (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
    ),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0),
    (35 / 384 - 5179 / 57600, 0.0, 500 / 1113 - 7571 / 16695,
     125 / 192 - 393 / 640, -2187 / 6784 + 92097 / 339200,
     11 / 84 - 187 / 2100, -1 / 40),
    5,
)
_BOSH3 = (
    (0.0, 1 / 2, 3 / 4, 1.0),
    ((), (1 / 2,), (0.0, 3 / 4), (2 / 9, 1 / 3, 4 / 9)),
    (2 / 9, 1 / 3, 4 / 9, 0.0),
    (2 / 9 - 7 / 24, 1 / 3 - 1 / 4, 4 / 9 - 1 / 3, -1 / 8),
    3,
)
_FEHLBERG2 = (
    (0.0, 1 / 2, 1.0),
    ((), (1 / 2,), (1 / 256, 255 / 256)),
    (1 / 512, 255 / 256, 1 / 512),
    (-1 / 512, 0.0, 1 / 512),
    2,
)
_ADAPTIVE_HEUN = (
    (0.0, 1.0),
    ((), (1.0,)),
    (1 / 2, 1 / 2),
    (1 / 2, -1 / 2),
    2,
)
_DP8_C = (0.0, 1 / 18, 1 / 12, 1 / 8, 5 / 16, 3 / 8, 59 / 400, 93 / 200,
          5490023248 / 9719169821, 13 / 20, 1201146811 / 1299019798,
          1.0, 1.0, 1.0)
_DP8_A = (
    (),
    (1 / 18,),
    (1 / 48, 1 / 16),
    (1 / 32, 0, 3 / 32),
    (5 / 16, 0, -75 / 64, 75 / 64),
    (3 / 80, 0, 0, 3 / 16, 3 / 20),
    (29443841 / 614563906, 0, 0, 77736538 / 692538347,
     -28693883 / 1125000000, 23124283 / 1800000000),
    (16016141 / 946692911, 0, 0, 61564180 / 158732637,
     22789713 / 633445777, 545815736 / 2771057229, -180193667 / 1043307555),
    (39632708 / 573591083, 0, 0, -433636366 / 683701615,
     -421739975 / 2616292301, 100302831 / 723423059, 790204164 / 839813087,
     800635310 / 3783071287),
    (246121993 / 1340847787, 0, 0, -37695042795 / 15268766246,
     -309121744 / 1061227803, -12992083 / 490766935,
     6005943493 / 2108947869, 393006217 / 1396673457,
     123872331 / 1001029789),
    (-1028468189 / 846180014, 0, 0, 8478235783 / 508512852,
     1311729495 / 1432422823, -10304129995 / 1701304382,
     -48777925059 / 3047939560, 15336726248 / 1032824649,
     -45442868181 / 3398467696, 3065993473 / 597172653),
    (185892177 / 718116043, 0, 0, -3185094517 / 667107341,
     -477755414 / 1098053517, -703635378 / 230739211,
     5731566787 / 1027545527, 5232866602 / 850066563,
     -4093664535 / 808688257, 3962137247 / 1805957418, 65686358 / 487910083),
    (403863854 / 491063109, 0, 0, -5068492393 / 434740067,
     -411421997 / 543043805, 652783627 / 914296604,
     11173962825 / 925320556, -13158990841 / 6184727034,
     3936647629 / 1978049680, -160528059 / 685178525,
     248638103 / 1413531060, 0),
)
_DP8_BSOL = (14005451 / 335480064, 0, 0, 0, 0, -59238493 / 1068277825,
             181606767 / 758867731, 561292985 / 797845732,
             -1041891430 / 1371343529, 760417239 / 1151165299,
             118820643 / 751138087, -528747749 / 2220607170, 1 / 4)
_DP8_BLOW = (13451932 / 455176623, 0, 0, 0, 0, -808719846 / 976000145,
             1757004468 / 5645159321, 656045339 / 265891186,
             -3867574721 / 1518517206, 465885868 / 322736535,
             53011238 / 667516719, 2 / 45, 0)
_DP8 = (_DP8_C, _DP8_A, _DP8_BSOL,
        tuple(s - lo for s, lo in zip(_DP8_BSOL, _DP8_BLOW)), 8)

_ADAPTIVE_TABLEAUS = {
    "dopri45": _DP5, "dopri5": _DP5, "dopri8": _DP8, "bosh3": _BOSH3,
    "fehlberg2": _FEHLBERG2, "adaptive_heun": _ADAPTIVE_HEUN,
}


def odeint_adaptive(func, y0, t0: float, t1: float, method: str = "dopri5",
                    rtol: float = 1e-5, atol: float = 1e-5,
                    max_steps: int = 10000):
    """Adaptive embedded-RK integration from t0 to t1 (t1 < t0 too).
    A step is clipped not to pass t1, accepted when the RMS of the error
    over atol + rtol max(|y|, |y1|) is at most 1, and the next step is h
    times clip(0.9 (1 / max(err, 1e-10))^(1/order), 0.2, 5). Stops once
    |t - t1| < 1e-12 or after max_steps * stages evaluations. Returns
    (y(t1), nfe)."""
    c, a_rows, b_sol, b_err, order = _ADAPTIVE_TABLEAUS[method]
    ns = len(b_sol)
    sign = 1.0 if t1 >= t0 else -1.0
    h0 = sign * abs(t1 - t0) * 0.01
    t, h = _f32(t0, y0.device), _f32(h0, y0.device)
    y, nfe = y0, 0
    while nfe < max_steps * ns:
        h = torch.where(sign * (t + h - t1) > 0, t1 - t, h)
        k = []
        for i in range(ns):
            yi = y
            for a, kj in zip(a_rows[i], k):
                if a:
                    yi = yi + h * a * kj
            k.append(func(t + h * c[i], yi))
        y1 = y
        for b, ki in zip(b_sol, k):
            if b:
                y1 = y1 + h * b * ki
        err = torch.zeros_like(y)
        for b, ki in zip(b_err, k):
            if b:
                err = err + h * b * ki
        scale = atol + rtol * torch.maximum(torch.abs(y), torch.abs(y1))
        en = torch.sqrt(torch.mean(torch.square(err / scale)))
        accept = en <= 1.0
        t = torch.where(accept, t + h, t)
        y = torch.where(accept, y1, y)
        factor = torch.clamp(
            0.9 * (1.0 / torch.clamp_min(en, 1e-10)) ** (1.0 / order),
            0.2, 5.0)
        h = h * factor
        nfe += ns
        if bool(torch.abs(t - t1) < 1e-12):
            break
    return y, nfe
