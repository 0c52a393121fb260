"""Data parallelism over torch.distributed (port of lion_tpu/parallel)."""
from .dist import (average_gradients, broadcast_flag, broadcast_params,
                   fold_seed, gather_rows, init_from_env, initialized, rank,
                   world)

__all__ = ["average_gradients", "broadcast_flag", "broadcast_params",
           "fold_seed", "gather_rows", "init_from_env", "initialized",
           "rank", "world"]
