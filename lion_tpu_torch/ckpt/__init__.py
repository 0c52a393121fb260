from .from_jax import flatten, state_dict_from_jax

__all__ = ["flatten", "state_dict_from_jax"]
