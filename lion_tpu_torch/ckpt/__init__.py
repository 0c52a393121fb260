from .from_jax import flatten, state_dict_from_jax
from .io import (has_snapshot, load_checkpoint, load_snapshot,
                 save_checkpoint, save_snapshot)

__all__ = ["flatten", "state_dict_from_jax", "has_snapshot",
           "load_checkpoint", "load_snapshot", "save_checkpoint",
           "save_snapshot"]
