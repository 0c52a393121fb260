from .encoders import LatentPointDecPVC
from .lion import LION
from .priors import GlobalPrior, LocalPrior
from .registry import build_global_prior, build_local_prior
from .vae import VAE

__all__ = ["LatentPointDecPVC", "LION", "GlobalPrior", "LocalPrior",
           "build_global_prior", "build_local_prior", "VAE"]
