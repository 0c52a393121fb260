#!/bin/bash
# Stage-1 VAE training on the port: the JAX package's scripts/train_vae.sh
# (the reference's script/train_vae.sh settings), run from the repo root.
# Usage: [NGPU=N] bash lion_tpu_torch/scripts/train_vae.sh /path/to/ShapeNetCore.v2.PC15k [cate]
DATA_ROOT=${1:?usage: train_vae.sh DATA_ROOT [CATE]}
CATE=${2:-car}
# NGPU above 1: data parallel, one process a GPU, through torchrun
LAUNCH=(python -m)
DIST=()
if [ "${NGPU:-1}" -gt 1 ]; then
    LAUNCH=(torchrun --standalone --nproc_per_node="$NGPU" -m)
    DIST=(--distributed_init)
fi
"${LAUNCH[@]}" lion_tpu_torch.train_dist "${DIST[@]}" --data_root "$DATA_ROOT" \
    trainer.type trainers.hvae_trainer \
    data.cates "$CATE" \
    ddpm.input_dim 3 ddpm.num_steps 1 ddpm.ema 0 \
    latent_pts.ada_mlp_init_scale 0.1 \
    sde.kl_const_coeff_vada 1e-7 \
    trainer.anneal_kl 1 sde.kl_max_coeff_vada 0.5 \
    sde.kl_anneal_portion_vada 0.5 \
    shapelatent.log_sigma_offset 6.0 latent_pts.skip_weight 0.01 \
    trainer.opt.beta2 0.99 \
    ddpm.loss_weight_emd 1.0 \
    trainer.epochs 8000 data.random_subsample 1 \
    viz.viz_freq -400 viz.log_freq -1 viz.val_freq 200 \
    data.batch_size 32 viz.save_freq 2000 \
    shapelatent.decoder_type models.latent_points_ada.LatentPointDecPVC \
    shapelatent.encoder_type models.latent_points_ada.PointTransPVC \
    latent_pts.style_encoder models.shapelatent_modules.PointNetPlusEncoder \
    shapelatent.prior_type normal \
    shapelatent.latent_dim 1 trainer.opt.lr 1e-3 \
    shapelatent.kl_weight 0.5 \
    shapelatent.decoder_num_points 2048 \
    data.tr_max_sample_points 2048 data.te_max_sample_points 2048 \
    ddpm.loss_type l1_sum \
    data.recenter_per_shape False data.normalize_global True \
    tpu.bf16 True
