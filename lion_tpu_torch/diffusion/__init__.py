from .discrete import DiffusionDiscretized, get_mixed_prediction
from .schedules import make_beta_schedule

__all__ = ["DiffusionDiscretized", "get_mixed_prediction",
           "make_beta_schedule"]
