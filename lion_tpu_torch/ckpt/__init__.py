from .from_jax import flatten, state_dict_from_jax
from .io import (export_torch_checkpoint, has_snapshot, load_checkpoint,
                 load_snapshot, save_checkpoint, save_snapshot)
from .torch_import import (export_state_dict, import_state_dict,
                           load_lion_checkpoint)

__all__ = ["flatten", "state_dict_from_jax", "export_torch_checkpoint",
           "has_snapshot", "load_checkpoint", "load_snapshot",
           "save_checkpoint", "save_snapshot", "export_state_dict",
           "import_state_dict", "load_lion_checkpoint"]
