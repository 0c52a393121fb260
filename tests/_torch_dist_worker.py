"""The child processes of tests/test_torch_port_dist.py.

`spawn_ranks` starts one process a rank with the `spawn` method; each
joins a gloo group through a file:// store (no TCP port), runs one
scenario of `lion_tpu_torch` with one PyTorch thread and saves what it
returns to `<out_dir>/rank<r>.pt`. This module imports the port only (no
JAX), so the children never load lion_tpu; the parent test compares what
they saved with lion_tpu's reference.
"""
import datetime
import multiprocessing
import os
import traceback

import numpy as np
import torch

TIMEOUT_S = 150     # the group's collectives; the parent waits longer


def spawn_ranks(scenario, world, tmp_path, payload, timeout=240.0):
    """Run `scenario` on `world` spawned ranks -> the list of what each
    saved; fails (after killing every child) on a child's error or when a
    child outlives `timeout` seconds."""
    out_dir = str(tmp_path / f"{scenario}_out")
    os.makedirs(out_dir, exist_ok=True)
    store = "file://" + str(tmp_path / f"{scenario}_store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(scenario, r, world, store,
                                           out_dir, payload))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout)
    try:
        for p in procs:
            left = (deadline - datetime.datetime.now()).total_seconds()
            p.join(max(left, 0.1))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    errors = {}
    for r in range(world):
        err = os.path.join(out_dir, f"rank{r}.err")
        if os.path.exists(err):
            errors[r] = open(err).read()
    if alive or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(
            f"{scenario}: children alive after {timeout} s: "
            f"{[procs.index(p) for p in alive]}; exit codes "
            f"{[p.exitcode for p in procs]}; errors {errors}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def run(scenario, rank, world, store, out_dir, payload):
    """A child: the group through `store`, then the scenario."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from lion_tpu_torch.parallel import dist as pdist
    try:
        if scenario != "train_dist":
            pdist.init_from_env("cpu", init_method=store,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        result = SCENARIOS[scenario](rank, world, payload, store)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rows(rank, world, t):
    n = t.shape[0] // world
    return t[rank * n:(rank + 1) * n]


def _helpers(rank, world, payload, store):
    """The collectives themselves."""
    from lion_tpu_torch.parallel import dist as pdist
    ps = [torch.full((3, 2), float(rank + 1)),
          torch.arange(5, dtype=torch.float32) * (rank + 1)]
    for p in ps:
        p.grad = p.detach() * 10
    pdist.average_gradients(ps)
    vals = pdist.average_values([torch.tensor(float(rank)),
                                 torch.tensor(2.0 * rank + 1)])
    pdist.broadcast_params(ps)
    rows = pdist.gather_rows(torch.full((2, 3), float(rank)))
    return {"rank": pdist.rank(), "world": pdist.world(),
            "seed": pdist.fold_seed(100, 13),
            "grads": [p.grad for p in ps], "params": [p.detach() for p in ps],
            "values": torch.stack(vals), "rows": rows,
            "flag_true": pdist.broadcast_flag(rank == 0),
            "flag_false": pdist.broadcast_flag(rank != 0)}


def _prior_step(rank, world, payload, store):
    """One two-prior step on this rank's rows of x and the draws."""
    from lion_tpu_torch.models import LION
    from lion_tpu_torch.trainers import (make_prior_train_step,
                                         warmup_cosine_schedule)
    lion = LION(payload["cfg"], device="cpu")
    lion.init_params(torch.Generator().manual_seed(payload["seed"]))
    # other priors on rank 1 (the frozen VAE is every rank's own): the step
    # broadcasts rank 0's
    with torch.no_grad():
        for p in list(lion.global_prior.parameters()) + \
                list(lion.local_prior.parameters()):
            p.add_(0.01 * rank)
    step = make_prior_train_step(
        lion, warmup_cosine_schedule(*payload["sched"]), device="cpu")
    d = payload["draws"]
    draws = {"rho": tuple(_rows(rank, world, t) for t in d["rho"]),
             "timestep": _rows(rank, world, d["timestep"]),
             "noise": tuple(_rows(rank, world, t) for t in d["noise"])}
    for k in ("class_label",):
        if k in d:
            draws[k] = _rows(rank, world, d[k])
    metrics = step(_rows(rank, world, payload["x"]), **draws)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {f"{pre}.{k}": p.detach().clone()
                       for pre in ("global_prior", "local_prior")
                       for k, p in getattr(lion, pre).named_parameters()},
            "grads": {f"{pre}.{k}": p.grad.clone()
                      for pre in ("global_prior", "local_prior")
                      for k, p in getattr(lion, pre).named_parameters()},
            "ema": [e.clone() for e in step.ema.shadow]}


def _vae_step(rank, world, payload, store):
    """One stage-1 step on this rank's rows of x and the draws."""
    from lion_tpu_torch.models.vae import VAE
    from lion_tpu_torch.nn import init_weights
    from lion_tpu_torch.trainers import (make_vae_train_step,
                                         warmup_cosine_schedule)
    vae = VAE(payload["cfg"])
    init_weights(vae, torch.Generator().manual_seed(payload["seed"] + rank))
    step = make_vae_train_step(vae, warmup_cosine_schedule(
        *payload["sched"]), payload["total_iter"], device="cpu")
    rho = tuple(_rows(rank, world, t) for t in payload["rho"])
    metrics = step(_rows(rank, world, payload["x"]), rho=rho)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: p.detach().clone()
                       for k, p in vae.named_parameters()},
            "grads": {k: p.grad.clone() for k, p in vae.named_parameters()},
            "ema": [e.clone() for e in step.ema.shadow]}


def _sample_chunked(rank, world, payload, store):
    """sample_chunked over the group, with and without given noise; the
    local prior's inputs recorded to show each rank's own rows."""
    import torch.distributed as dist
    from lion_tpu_torch.models import LION
    lion = LION(payload["cfg"], device="cpu")
    lion.load_state_dict(payload["state"])
    seen = []
    lion.local_prior.register_forward_hook(
        lambda module, args, out: seen.append(args[0].shape[0]))
    group = dist.group.WORLD
    given = payload["given"]
    out = lion.sample_chunked(payload["n"], chunks=payload["chunks"],
                              given_noise=given, group=group)
    batches = sorted(set(seen))
    seen.clear()
    try:    # the rows must divide over the ranks
        lion.sample_chunked(payload["n"] + 1, chunks=payload["chunks"],
                            group=group)
        refused_odd = False
    except ValueError:
        refused_odd = True
    free = lion.sample_chunked(payload["n"], torch.Generator().manual_seed(3),
                               chunks=payload["chunks"], group=group)
    return {"out": {k: out[k] for k in ("z_global", "z_local", "points")},
            "free": free["points"], "local_batches": batches,
            "refused_odd": refused_odd}


def _stage2_trainer(cfg, data_root, save_dir):
    """The two-prior trainer of `cfg` on the CPU."""
    import types
    from lion_tpu_torch.trainers.train_2prior import Trainer
    args = types.SimpleNamespace(save_dir=save_dir, data_root=data_root)
    return Trainer(cfg, args, device="cpu")


def _eval_sample(rank, world, payload, store):
    """eval_sample with references (the test split) and without; the
    fallback sampling of run_eval."""
    tr = _stage2_trainer(payload["cfg"], payload["data_root"],
                         payload["save_dir"])
    res = tr.eval_sample(step=3, num_gen=payload["num_gen"], metric2=None)
    tr.test_loader = None
    no_refs = tr.eval_sample(step=4, num_gen=payload["num_gen"],
                             metric2=None, save_samples=False)
    from lion_tpu_torch.trainers.train_2prior import NO_REFS
    score = tr.run_eval()
    tr.writer.close()
    return {"results": None if res is None else
            {k: float(np.asarray(v)) for k, v in res.items()
             if np.ndim(v) == 0},
            "no_refs": no_refs is NO_REFS, "run_eval": score,
            "loader_len": len(tr.train_loader),
            "shard": int(tr.train_loader.shard_id)}


def _train_dist(rank, world, payload, store):
    """The CLI with --distributed_init over the file:// store."""
    from lion_tpu_torch import train_dist
    from lion_tpu_torch.parallel import dist as pdist
    tr = train_dist.main(["--distributed_init", "--dist_url", store]
                         + payload["argv"])
    assert not pdist.initialized()      # main leaves the group it joined
    return {"step": tr.step, "save_dir": tr.save_dir,
            "params": [p.detach().clone() for p in tr.step_fn.params]}


SCENARIOS = {"helpers": _helpers, "prior_step": _prior_step,
             "vae_step": _vae_step, "sample_chunked": _sample_chunked,
             "eval_sample": _eval_sample, "train_dist": _train_dist}
