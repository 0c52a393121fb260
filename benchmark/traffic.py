"""The traffic generator: what every kind of mix gives the harness
(`Traffic`), the seeded inputs and, for the LION family, one class per kind
of mix, driven by the parameters of a mix file
(`benchmark/mixes/<name>.json`). Another family's kinds subclass `Traffic`
in its own family file.

- `sample`: a closed loop of `LION.sample(batch, ddim_step=..., generator)`
  requests, back to back, each with its own generator seeded from the run's
  seed and its index (and, under CLIP, its own rows of the seeded feature
  pool). Each prior call's input and prediction are copied by forward
  hooks on the priors' modules (two small device copies a call) for the
  check of `correct`.
- `train_vae` / `train_prior`: closed-loop calls of the stage-1 or the
  two-prior training step on batches taken in turn from a seeded pool of
  clouds on the card (and CLIP rows), with one step in flight: the host
  waits for step k - 1 before it issues step k + 1, as a trainer that reads
  each step's loss one step late. Set-up drives the same step object
  through its first `check_steps` steps and records what the check needs
  (also the inputs of the stage after the encode: the priors' or the
  decoder's, copied by forward hooks that are removed before the
  window).

Every input is made on the device from the seed. Each traffic object holds
the system under test (the port's objects) and nothing of the reference.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

SEED_MASK = (1 << 62) - 1


def sub_seed(seed: int, *keys: int) -> int:
    """A 62-bit seed from the run's seed and small integers."""
    s = seed & SEED_MASK
    for k in keys:
        s = (s * 1000003 + k + 1) & SEED_MASK
    return s


def ellipsoid_clouds(n: int, points: int, seed: int, device) -> torch.Tensor:
    """(n, points, 3) float32: unit-sphere directions scaled by per-cloud
    axis lengths in [0.2, 0.5] plus 0.01 noise, each cloud recentred on its
    bounding box and scaled so its longest side spans [-1, 1] (the stage-1
    loader's per-shape normalization)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    v = torch.randn(n, points, 3, generator=gen, device=device)
    v = v / v.norm(dim=-1, keepdim=True)
    axes = torch.rand(n, 1, 3, generator=gen, device=device) * 0.3 + 0.2
    v = v * axes + 0.01 * torch.randn(n, points, 3, generator=gen,
                                      device=device)
    lo, hi = v.amin(dim=1, keepdim=True), v.amax(dim=1, keepdim=True)
    half = (hi - lo).amax(dim=-1, keepdim=True) / 2
    return ((v - (lo + hi) / 2) / half).contiguous()


def clip_rows(n: int, dim: int, seed: int, device) -> torch.Tensor:
    """(n, dim) unit-norm rows, as CLIP's normalized features are."""
    gen = torch.Generator(device=device).manual_seed(seed)
    f = torch.randn(n, dim, generator=gen, device=device)
    return f / f.norm(dim=-1, keepdim=True)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Traffic:
    """What every kind gives the harness: `setup()`, `window(seconds)`
    (-> records of the timed units), `traced(units)` (the units the
    profiler sees), `layer_windows()` (per-layer host-clock windows),
    `release()` (drops the program's state) and the readings the check
    needs (`readings`)."""

    def __init__(self, port_cfg, cfg: dict, mix: dict, state, seed: int,
                 device):
        self.port_cfg, self.cfg, self.mix = port_cfg, cfg, mix
        self.state, self.seed, self.device = state, seed, device
        self.readings: Dict = {}
        self.marks: Dict[str, float] = {}
        self.issue_s: List[float] = []

    def mark(self, name: str) -> None:
        """The host clock at the end of a part of set-up."""
        self.marks[name] = time.perf_counter()

    def layer_windows(self) -> Dict[str, float]:
        return {}


class LionTraffic(Traffic):
    """LION's kinds: the base with the configuration's CLIP switch."""

    def __init__(self, *args):
        super().__init__(*args)
        self.clip = bool(self.cfg["clipforge"]["enable"])


class SampleTraffic(LionTraffic):
    def setup(self):
        from lion_tpu_torch.models import LION
        self.batch, self.steps = self.mix["batch"], self.mix["ddim_step"]
        self.lion = LION(self.port_cfg, device=self.device)
        self.lion.load_state_dict(self.state, strict=True)
        self.lion.eval()
        self.mark("model")
        self.pool = None
        if self.clip:
            self.pool = clip_rows(self.mix["clip_pool"] * self.batch,
                                  self.cfg["clipforge"]["feat_dim"],
                                  sub_seed(self.seed, 1), self.device)
        for i in range(self.mix["warmup_requests"]):
            self._request(-1 - i)
        self.calls: Dict[str, List] = {"global": [], "local": []}
        self.outputs: List[Dict] = []
        self._hooks = [
            self.lion.global_prior.register_forward_hook(
                self._keep("global")),
            self.lion.local_prior.register_forward_hook(
                self._keep("local"))]

    def _keep(self, name):
        def hook(module, args, output):
            self.calls[name].append((args[0].detach().clone(), args[1],
                                     output.detach().clone()))
        return hook

    def request_seed(self, i: int) -> int:
        return sub_seed(self.seed, 2, i + 1000)

    def clip_of(self, i: int) -> Optional[torch.Tensor]:
        if self.pool is None:
            return None
        n = self.pool.shape[0] // self.batch
        j = i % n
        return self.pool[j * self.batch:(j + 1) * self.batch]

    def _request(self, i: int):
        gen = torch.Generator(device=self.device).manual_seed(
            self.request_seed(i))
        return self.lion.sample(self.batch, generator=gen,
                                ddim_step=self.steps,
                                clip_feat=self.clip_of(i))

    def window(self, seconds: float):
        """Requests back to back until `seconds` have passed; the last one
        runs to its end. -> [(start, end, shapes, stage_seconds)]."""
        recs = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            out = self._request(i)
            end = time.perf_counter()
            n_g, n_l = len(self.calls["global"]), len(self.calls["local"])
            self.outputs.append({"index": i, "calls": (n_g, n_l),
                                 "z_global": out["z_global"],
                                 "z_local": out["z_local"],
                                 "points": out["points"]})
            recs.append((start, end, self.batch, out["stage_seconds"]))
            i += 1
        return t0, recs

    def traced(self, units: int):
        """`units` further requests, outside the measured window; their
        captures are dropped."""
        for h in self._hooks:
            h.remove()
        for k in range(units):
            self._request(10 ** 6 + k)
        sync(self.device)

    def failed(self) -> int:
        return sum(not bool(torch.isfinite(o["points"]).all())
                   for o in self.outputs)

    def captures(self, k: int) -> Dict:
        """The program's inputs and outputs of finished request k: each
        prior's calls (x, t, eps) and the returned latents and points."""
        out = self.outputs[k]
        g_end, l_end = out["calls"]
        g0 = g_end - self.steps
        l0 = l_end - self.steps
        return {"index": out["index"], "seed": self.request_seed(
                    out["index"]),
                "clip": self.clip_of(out["index"]),
                "global": self.calls["global"][g0:g_end],
                "local": self.calls["local"][l0:l_end],
                "z_global": out["z_global"], "z_local": out["z_local"],
                "points": out["points"]}

    def release(self, keep: List[int]):
        """Keep the captures of the finished requests `keep` (indices into
        the window's requests) and drop the model and everything else."""
        kept = [self.captures(k) for k in keep]
        self.calls, self.outputs = {}, []
        del self.lion, self.pool
        return kept


class TrainTraffic(LionTraffic):
    def setup(self):
        from lion_tpu_torch.trainers import (make_prior_train_step,
                                             make_vae_train_step)
        mix, dev = self.mix, self.device
        self.batch = mix["batch"]
        n_pool = mix["pool_batches"] * self.batch
        self.pool = ellipsoid_clouds(
            n_pool, self.cfg["data"]["tr_max_sample_points"],
            sub_seed(self.seed, 3), dev)
        self.clip_pool = clip_rows(n_pool, self.cfg["clipforge"]["feat_dim"],
                                   sub_seed(self.seed, 4), dev) \
            if self.clip else None
        if mix["kind"] == "train_vae":
            from lion_tpu_torch.models.vae import VAE
            with torch.device(dev):
                model = VAE(self.port_cfg)
            model.load_state_dict(
                {k[4:]: v for k, v in self.state.items()
                 if k.startswith("vae.")}, strict=True)
            lr = float(self.cfg["trainer"]["opt"]["lr"])
            self.step = make_vae_train_step(
                model, lambda step: lr, num_total_iter=mix["total_iter"],
                device=dev)
            self.names = [f"vae.{n}" for n, _ in model.named_parameters()]
        else:
            from lion_tpu_torch.models import LION
            model = LION(self.port_cfg, device=dev)
            model.load_state_dict(self.state, strict=True)
            lr = float(self.cfg["sde"]["learning_rate_dae"])
            self.step = make_prior_train_step(model, lambda step: lr,
                                              device=dev)
            self.names = [f"{p}.{n}" for p in ("global_prior", "local_prior")
                          for n, _ in getattr(model, p).named_parameters()]
        self.model = model
        self.mark("model")
        self.gen = torch.Generator(device=dev).manual_seed(
            sub_seed(self.seed, 5))
        self.k = 0
        self._first_steps()

    def batch_of(self, k: int):
        j = k % self.mix["pool_batches"]
        rows = slice(j * self.batch, (j + 1) * self.batch)
        draws = {}
        if self.clip_pool is not None:
            draws["clip_feat"] = self.clip_pool[rows]
        return self.pool[rows], draws

    def _call(self):
        x, draws = self.batch_of(self.k)
        self.k += 1
        return self.step(x, self.gen, **draws)

    @torch.no_grad()
    def _first_steps(self):
        """The first `check_steps` steps through the window's own call, on
        batches that all differ: the generator's state before each, each
        step's loss, each parameter's gradient norm as Adam's first moment
        holds it after step 1, and each parameter's (and EMA's) change
        norm after the last."""
        n = self.mix["check_steps"]
        params = self.step.params
        start = [p.detach().clone() for p in params]
        beta1 = self.step.optimizer.opt.param_groups[0]["betas"][0]
        gen_states, losses, inputs = [], [], []
        hooks = self._input_hooks(inputs)
        for s in range(n):
            gen_states.append(self.gen.get_state())
            inputs.append({})
            with torch.enable_grad():
                losses.append(self._call()["loss"])
            if s == 0:
                mu, _ = self.step.optimizer.moments()
                grad_norms = torch.stack([m.norm() / (1.0 - beta1)
                                          for m in mu])
        for h in hooks:
            h.remove()
        sync(self.device)
        change = torch.stack([(p.detach() - p0).norm()
                              for p, p0 in zip(params, start)])
        ema = None
        if self.step.ema is not None:
            ema = torch.stack([(e - p0).norm() for e, p0 in
                               zip(self.step.ema.shadow, start)]).tolist()
        self.readings = {
            "gen_states": gen_states, "losses": [float(v) for v in losses],
            "grad_norms": grad_norms.tolist(), "change": change.tolist(),
            "ema_change": ema, "names": self.names,
            "batches": [self.batch_of(s) for s in range(n)],
            "inputs": inputs}
        del start

    def _input_hooks(self, inputs: List[Dict]):
        """Forward hooks that copy the current step's inputs of the stage
        after the encode into inputs[-1]: each prior's x_t and the local
        prior's condition (two-prior step), the decoder's latents (stage
        1)."""
        def keep(*names):
            def hook(module, args, kwargs, output):
                for name, a in zip(names, args):
                    if name:
                        inputs[-1][name] = a.detach().clone()
                if "condition_input" in kwargs:
                    inputs[-1]["condition"] = \
                        kwargs["condition_input"].detach().clone()
            return hook
        if self.mix["kind"] == "train_vae":
            mods = [(self.model.decoder, ("local", "style"))]
        else:
            mods = [(self.model.global_prior, ("global",)),
                    (self.model.local_prior, ("local", None, "condition"))]
        return [m.register_forward_hook(keep(*names), with_kwargs=True)
                for m, names in mods]

    def window(self, seconds: float):
        """Steps back to back until `seconds` have passed, one in flight;
        the window ends when the last has finished on the device.
        -> (t0, [(start, end, samples, None)]): a step's start is its
        issue, its end its completion as the host saw it."""
        recs, pending = [], []
        self.losses = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            metrics = self._call()
            self.issue_s.append(time.perf_counter() - start)
            ev = torch.cuda.Event() if torch.device(self.device).type \
                == "cuda" else None
            if ev is not None:
                ev.record()
            self.losses.append(metrics["loss"])
            pending.append((start, ev))
            if len(pending) > 1:
                s, e = pending.pop(0)
                if e is not None:
                    e.synchronize()
                recs.append((s, time.perf_counter(), self.batch, None))
        sync(self.device)
        for s, _ in pending:
            recs.append((s, time.perf_counter(), self.batch, None))
        return t0, recs

    def traced(self, units: int):
        for _ in range(units):
            self._call()
        sync(self.device)

    def failed(self) -> int:
        return sum(not bool(torch.isfinite(v)) for v in self.losses)

    def layer_windows(self) -> Dict[str, float]:
        """Host-clock ms of the step's forward alone (the loss, in train
        mode, its graph dropped) and, for the two-prior step, of the frozen
        encode alone, each over `layer_calls` calls on the next batches."""
        from lion_tpu_torch.trainers import prior_loss
        reps = self.mix["layer_calls"]
        out = {}

        def timed(fn):
            fn(0)
            sync(self.device)
            t = time.perf_counter()
            for r in range(reps):
                fn(r + 1)
            sync(self.device)
            return (time.perf_counter() - t) / reps * 1e3

        if self.mix["kind"] == "train_vae":
            out["forward_ms"] = timed(lambda r: self.step.loss(
                self.batch_of(self.k + r)[0], self.gen)["loss"])
        else:
            def fwd(r):
                x, draws = self.batch_of(self.k + r)
                return prior_loss(self.model, x, self.gen, **draws)[0]

            def enc(r):
                with torch.no_grad():
                    self.model.vae.eval()
                    return self.model.vae.encode(
                        self.batch_of(self.k + r)[0], self.gen)[0]
            out["forward_ms"] = timed(fwd)
            out["encode_ms"] = timed(enc)
        return out

    def release(self, keep=None):
        readings = self.readings
        self.step = self.model = self.pool = self.clip_pool = None
        self.losses = []
        return readings


KINDS = {"sample": SampleTraffic, "train_vae": TrainTraffic,
         "train_prior": TrainTraffic}
