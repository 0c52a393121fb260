#!/bin/bash
# Stage-2 two-prior training on a frozen VAE on the port: the JAX
# package's scripts/train_prior.sh (the reference's script/train_prior.sh
# settings), run from the repo root.
# Usage: [NGPU=N] bash lion_tpu_torch/scripts/train_prior.sh VAE_CKPT DATA_ROOT [CATE]
VAE_CKPT=${1:?usage: train_prior.sh VAE_CKPT DATA_ROOT [CATE]}
DATA_ROOT=${2:?need DATA_ROOT}
CATE=${3:-car}
# NGPU above 1: data parallel, one process a GPU, through torchrun
LAUNCH=(python -m)
DIST=()
if [ "${NGPU:-1}" -gt 1 ]; then
    LAUNCH=(torchrun --standalone --nproc_per_node="$NGPU" -m)
    DIST=(--distributed_init)
fi
"${LAUNCH[@]}" lion_tpu_torch.train_dist "${DIST[@]}" --data_root "$DATA_ROOT" \
    trainer.type trainers.train_2prior \
    data.cates "$CATE" \
    sde.vae_checkpoint "$VAE_CKPT" \
    sde.learning_rate_dae 2e-4 sde.learning_rate_min_dae 2e-4 \
    trainer.epochs 18000 sde.num_cell_per_scale_dae 8 \
    sde.num_channels_dae 2048 sde.train_vae False \
    latent_pts.pvd_mse_loss 1 \
    shapelatent.log_sigma_offset 6.0 latent_pts.skip_weight 0.01 \
    latent_pts.ada_mlp_init_scale 0.1 \
    shapelatent.decoder_type models.latent_points_ada.LatentPointDecPVC \
    shapelatent.encoder_type models.latent_points_ada.PointTransPVC \
    shapelatent.latent_dim 1 \
    data.batch_size 10 data.tr_max_sample_points 2048 \
    data.recenter_per_shape False data.normalize_global True \
    viz.save_freq 1000 viz.val_freq 2000 \
    tpu.bf16 True
