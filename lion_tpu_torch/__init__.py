"""LION on PyTorch and CUDA: a port of `lion_tpu` to one NVIDIA H100.

It mirrors the JAX package's layout and names and keeps its channels-last
layouts at every public function: points (B, N, C), voxel grids
(B, R, R, R, C), conv weights (3, 3, 3, Ci, Co). It imports torch and never
JAX. This slice covers fp32 ancestral DDPM sampling of the whole hierarchy
(`models.lion.LION.sample`).

Layout:
  config/    yacs-compatible config tree (copy of lion_tpu/config)
  diffusion/ beta schedules and the discrete DDPM sampler
  ops/       point-cloud ops; the six hand-written CUDA kernels (csrc/)
             each sit beside a plain PyTorch version
  nn/        AdaGN, SharedMLP, PVConv (eval flow), SA/FP modules, U-Net
  models/    global and local priors, the VAE decoder, the LION API
  ckpt/      JAX param tree -> the port's state_dict
"""

__version__ = "0.1.0"
