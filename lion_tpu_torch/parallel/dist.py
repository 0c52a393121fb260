"""Data parallelism over torch.distributed, one process a device (port of
lion_tpu/parallel/mesh.py).

The JAX package shards the batch over a device mesh and lets pjit insert
the gradient psum. Here each process holds the whole model and its own
rows; the training step reduces the gradients once after the backward, in
the reference LION's manner (utils/utils.py `average_gradients`: one flat
buffer, all_reduce(SUM), a division by the world size). Every helper works
without a process group as the one process of a world of one.

    device = init_from_env("cuda")   # torchrun's RANK, WORLD_SIZE, ...
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

# how long a collective (and the rendezvous) may wait for the other ranks
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if initialized() else 0


def world() -> int:
    """The number of processes; 1 without a process group."""
    return dist.get_world_size() if initialized() else 1


def init_from_env(device="cuda", init_method: str = "env://",
                  timeout: datetime.timedelta = DEFAULT_TIMEOUT,
                  backend: Optional[str] = None) -> torch.device:
    """Join the process group that torchrun describes: RANK, WORLD_SIZE,
    LOCAL_RANK and, for the default `env://` rendezvous, MASTER_ADDR and
    MASTER_PORT. A CUDA `device` becomes cuda:LOCAL_RANK with NCCL; a CPU
    one uses gloo (`backend` overrides either). Returns this process's
    device."""
    missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_from_env: {missing} not set; start the "
                           "processes with torchrun")
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank_,
                            world_size=world_, timeout=timeout)
    return dev


def fold_seed(seed: int, offset: int = 0) -> int:
    """A generator seed of this process: seed + offset + rank (the
    counterpart of `fold_rng_per_host`, fold_in(rng, process_index +
    offset)), so rank 0 keeps the one-process seed."""
    return seed + offset + rank()


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a tensor goes for a collective: gloo gathers only host tensors
    and NCCL only CUDA ones."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


@torch.no_grad()
def average_gradients(params: Sequence[torch.Tensor]) -> None:
    """Every parameter's gradient becomes the mean over the ranks: one flat
    buffer in the order of `params`, one all_reduce(SUM), a division by the
    world size, copied back. Every rank receives the same bytes."""
    grads = [p.grad for p in params]
    flat = _flat(grads)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat.div_(world())
    _unflat(flat, grads)


@torch.no_grad()
def average_values(values: Sequence[torch.Tensor]) -> list:
    """0-d tensors -> their means over the ranks (one all_reduce)."""
    flat = torch.stack([v.detach().float().reshape(()) for v in values])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return list((flat / world()).unbind())


@torch.no_grad()
def broadcast_params(params: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank `src`'s values of `params` on every rank (one flat
    broadcast)."""
    flat = _flat(params)
    dist.broadcast(flat, src=src)
    _unflat(flat, params)


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows, in rank order, on every rank of `group` (the
    default group when None; the counterpart of
    `multihost_utils.process_allgather`); each rank gives the same shape.
    The tensor crosses through host memory under gloo."""
    if not initialized():
        return t
    src = t.contiguous()
    dev = src.device
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(dev)


def broadcast_flag(flag: bool, src: int = 0) -> bool:
    """Rank `src`'s flag on every rank (the counterpart of
    `broadcast_one_to_all`)."""
    if not initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    t = t.to(_comm_device(t))
    dist.broadcast(t, src=src)
    return bool(t.item())
