from .dit3d import DiT3D
from .encoders import LatentPointDecPVC
from .lion import LION
from .priors import GlobalPrior, LocalPrior
from .registry import build_dit3d, build_global_prior, build_local_prior
from .vae import VAE

__all__ = ["DiT3D", "LatentPointDecPVC", "LION", "GlobalPrior", "LocalPrior",
           "build_dit3d", "build_global_prior", "build_local_prior", "VAE"]
