"""LION on PyTorch and CUDA: a port of `lion_tpu` to one NVIDIA H100.

It mirrors the JAX package's layout and names and keeps its channels-last
layouts at every public function: points (B, N, C), voxel grids
(B, R, R, R, C), conv weights (3, 3, 3, Ci, Co). It imports torch and never
JAX. It covers ancestral DDPM sampling of the whole hierarchy
(`models.lion.LION.sample`) in fp32 and, with `cfg.tpu.bf16 = True`, in
bf16 (the U-Nets compute in bf16, parameters and the DDPM chain stay fp32),
and the stage-2 training step of the two priors on the frozen VAE in fp32
(`trainers.make_prior_train_step`). Its entry points run on the card
unless the caller passes `device="cpu"`.

Layout:
  config/    yacs-compatible config tree (copy of lion_tpu/config)
  diffusion/ beta schedules and the discrete DDPM sampler
  ops/       point-cloud ops; the eleven hand-written CUDA kernels (csrc/)
             each sit beside a plain PyTorch version; the ops the training
             step differentiates are autograd.Functions
  nn/        AdaGN, SharedMLP, PVConv (eval flow, its fused bf16 branches
             and the training flow), SA/FP modules, U-Net, dropout
  models/    global and local priors, the VAE (encoders, decoder), the
             LION API
  trainers/  Adam, the warmup-cosine schedule, EMA, the two-prior step
  ckpt/      JAX param tree -> the port's state_dict
"""

__version__ = "0.1.0"
