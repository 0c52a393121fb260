#!/bin/bash
# Stage-2 CLIP-conditioned prior training on a frozen VAE on the port: the
# JAX package's scripts/train_prior_clip.sh (the reference's
# script/train_prior_clip.sh settings), run from the repo root. The render
# views are read from data.clip_img_root (<root>/<synset>/<id>/img_choy2016);
# without CLIP weights (LION_CLIP_MODEL) the HashClip stand-in encodes them.
# Usage: [NGPU=N] bash lion_tpu_torch/scripts/train_prior_clip.sh VAE_CKPT DATA_ROOT [CATE]
VAE_CKPT=${1:?usage: train_prior_clip.sh VAE_CKPT DATA_ROOT [CATE]}
DATA_ROOT=${2:?need DATA_ROOT}
CATE=${3:-chair}
# NGPU above 1: data parallel, one process a GPU, through torchrun
LAUNCH=(python -m)
DIST=()
if [ "${NGPU:-1}" -gt 1 ]; then
    LAUNCH=(torchrun --standalone --nproc_per_node="$NGPU" -m)
    DIST=(--distributed_init)
fi
"${LAUNCH[@]}" lion_tpu_torch.train_dist "${DIST[@]}" --data_root "$DATA_ROOT" \
    data.cates "$CATE" \
    latent_pts.pvd_mse_loss 1 \
    num_val_samples 24 \
    ddpm.ema 1 \
    ddpm.use_bn False ddpm.use_gn True \
    ddpm.time_dim 64 \
    ddpm.beta_T 0.02 \
    sde.vae_checkpoint "$VAE_CKPT" \
    sde.learning_rate_dae 2e-4 sde.learning_rate_min_dae 2e-4 \
    trainer.epochs 18000 \
    sde.num_channels_dae 2048 \
    sde.dropout 0.3 \
    sde.prior_model 'models.latent_points_ada_localprior.PVCNN2Prior' \
    sde.train_vae False \
    sde.embedding_scale 1.0 \
    viz.save_freq 1000 \
    data.batch_size 10 \
    trainer.type 'trainers.train_2prior' \
    clipforge.enable 1 \
    data.clip_forge_enable 1 \
    data.clip_model 'ViT-B/32' \
    clipforge.clip_model 'ViT-B/32' \
    latent_pts.style_prior 'models.score_sde.resnet.PriorSEClip'
