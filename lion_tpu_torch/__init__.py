"""LION on PyTorch and CUDA: a port of `lion_tpu` to one NVIDIA H100.

It mirrors the JAX package's layout and names and keeps its channels-last
layouts at every public function: points (B, N, C), voxel grids
(B, R, R, R, C), conv weights (3, 3, 3, Ci, Co). It imports torch and never
JAX. It covers sampling of the whole hierarchy (`models.lion.LION.sample`:
ancestral DDPM, DDIM and the probability-flow ODE) in fp32 and, with
`cfg.tpu.bf16 = True`, in bf16 (the U-Nets compute in bf16, parameters and
the chains stay fp32); both training stages (the VAE, then the two priors
on the frozen VAE, and the single-prior and interpolation trainers) in
fp32 and bf16; scoring against a reference set; and the user entry
points: `python -m lion_tpu_torch.train_dist` (the training and
evaluation CLI, which `scripts/train_vae.sh` and `train_prior.sh` run) and
`python -m lion_tpu_torch.demo`; data-parallel training over
torch.distributed (one process a GPU, `torchrun ... --distributed_init`);
class conditioning (data.cond_on_cat) and CLIP conditioning
(clipforge.enable, `demo --text`); and the Mitsuba scene export. Its
entry points run on the card unless the caller passes `device="cpu"`
(`--device cpu` on the command line).

Layout:
  config/     yacs-compatible config tree (copy of lion_tpu/config)
  diffusion/  beta schedules, the discrete DDPM and DDIM samplers, the
              continuous VPSDE and its ODE solvers
  ops/        point-cloud ops; the fifteen hand-written CUDA kernels
              (csrc/*.cu) each sit beside a plain PyTorch version; the ops
              the training steps differentiate are autograd.Functions
  nn/         AdaGN, SharedMLP, PVConv (eval flow, its fused bf16 branches
              and the training flow), SA/FP modules, U-Net, dropout
  models/     global and local priors, the VAE (encoders, decoder), the
              LION API
  trainers/   Adam, the warmup-cosine schedule, EMA, the stage-1 and
              stage-2 steps and the trainers `get_trainer` names
  eval/       pairwise CD / EMD, MMD / COV / 1-NNA, JSD, compute_score
  data/       the ShapeNet15k loader over the native .npy reader
              (csrc/npy_loader.cpp, built with g++)
  ckpt/       `.npz` checkpoints in lion_tpu's layout both ways, the
              released `.pt` schema both ways, JAX param tree -> state_dict
  parallel/   data parallel over torch.distributed: the process group from
              torchrun's environment, the gradient mean, row gathers
  utils/      losses, spectral norm, the metrics writer, visualization,
              experiment naming, shape checks, CLIP features, Mitsuba
              scene export
  scripts/    the released training recipes over train_dist
"""

__version__ = "0.1.0"
