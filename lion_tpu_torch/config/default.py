"""Default config tree.

Key names, grouping and defaults mirror the reference `default_config.py:14-450`
exactly (that file IS the public config API: released checkpoints ship a
`cfg.yml` that must parse unchanged), but the tree here is built from plain
data instead of imperative assignments. Deprecated keys from the reference's
`register_deprecated_key` calls are registered too so old cfg.yml files load.
"""
from .cfg_node import CfgNode

_DEFAULTS = {
    "dpm_ckpt": "",
    "clipforge": {
        "clip_model": "ViT-B/32",
        "enable": 0,
        "feat_dim": 512,
    },
    "eval_trainnll": 0,
    "exp_name": "",
    "cmt": "",
    "hash": "",
    "ngpu": 1,
    "snapshot_min": 30,
    "bash_name": "",
    "set_detect_anomaly": 0,
    "weight_recont": 1.0,
    "use_checkpoint": 0,
    "num_val_samples": 16,
    "eval": {
        "need_denoise": 0,
        "load_other_vae_ckpt": 0,
    },
    "vis_latent_point": 0,
    "latent_pts": {
        "style_dim": 128,
        "ada_mlp_init_scale": 1.0,
        "style_mlp": "",
        "pts_sigma_offset": 0.0,
        "skip_weight": 0.1,
        "encoder_layer_out_dim": 32,
        "decoder_layer_out_dim": 32,
        "style_prior": "models.score_sde.resnet.PriorSEDrop",
        "mask_out_extra_latent": 0,
        "normalization": "bn",
        "pvd_mse_loss": 0,
        "hid": 64,
        "latent_dim_ext": [64],
        "weight_kl_pt": 1.0,
        "weight_kl_feat": 1.0,
        "weight_kl_glb": 1.0,
        "style_encoder": "models.shapelatent_modules.PointNetPlusEncoder",
        "use_linear_for_adagn": 0,
    },
    "has_shapelatent": 1,
    "shapelatent": {
        "local_emb_agg": "mean",
        "freeze_vae": 0,
        "eps_z_global_only": 1,
        "model": "flow",
        "residual": 1,
        "encoder_type": "pointnet",
        "prior_type": "flow",
        "decoder_type": "PointwiseNet",
        "loss0_weight": 1.0,
        "latent_dim": 256,
        "kl_weight": 1e-3,
        "decoder_num_points": -1,
        "log_sigma_offset": 0.0,
    },
    "sde": {
        "ode_sample": 0,
        "train_dae": 1,
        "init_t": 1.0,
        "nhead": 4,
        "local_prior": "same_as_global",
        "drop_inactive_var": 0,
        "learn_mixing_logit": 1,
        "regularize_mlogit_margin": 0.0,
        "share_mlogit": 0,
        "hypara_mixing_logit": 0,
        "bound_mlogit": 0,
        "bound_mlogit_value": -5.42,
        "regularize_mlogit": 0,
        "attn_mhead": 0,
        "attn_mhead_local": -1,
        "pos_embed": "none",
        "hier_prior": 0,
        "is_continues": 0,
        "time_emb_scales": 1.0,
        "time_eps": 1e-2,
        "ode_eps": 1e-5,
        # eval-time RK45 tolerance (the reference hardcodes 1e-5 in
        # sample_model_ode's signature, diffusion_continuous.py:178);
        # exposed as a key so tests/serving can trade NFE for accuracy
        "ode_solver_tol": 1e-5,
        "sde_type": "vpsde",
        "sigma2_0": 0.0,
        "sigma2_max": 0.99,
        "sigma2_min": 1e-4,
        "beta_start": 0.1,
        "beta_end": 20.0,
        "iw_sample_p": "ll_iw",
        "iw_subvp_like_vp_sde": False,
        "prior_model": "models.latent_points_ada_localprior.PVCNN2Prior",
        "update_q_ema": False,
        "iw_sample_q": "reweight_p_samples",
        "kl_anneal_portion_vada": 0.1,
        "kl_const_portion_vada": 0.0,
        "kl_const_coeff_vada": 0.7,
        "kl_balance_vada": False,
        "grad_clip_max_norm": 0.0,
        "cont_kl_anneal": True,
        "mixing_logit_init": -6,
        "weight_decay_norm_vae": 0.0,
        "weight_decay_norm_dae": 0.0,
        "train_vae": True,
        "jac_reg_coeff": 0,
        "jac_reg_freq": 1,
        "kin_reg_coeff": 0,
        # Hutchinson-probe count / weight-drop knobs consumed by
        # utils/utils.py:1202-1213 as args.jac_reg_samples /
        # args.jac_kin_reg_drop_weights but MISSING from the reference's
        # config (enabling jac_reg there AttributeErrors); defaults follow
        # the upstream LSGM codebase the function was lifted from.
        "jac_reg_samples": 1,
        "jac_kin_reg_drop_weights": False,
        "learning_rate_mlogit": -1.0,
        "learning_rate_dae_local": 3e-4,
        "learning_rate_min_dae_local": 3e-4,
        "learning_rate_dae": 3e-4,
        "learning_rate_min_dae": 3e-4,
        "learning_rate_min_vae": 1e-5,
        "learning_rate_vae": 1e-4,
        "epochs": 800,
        "warmup_epochs": 20,
        "weight_decay": 3e-4,
        "use_adamax": False,
        "use_adam": True,
        "mixed_prediction": False,
        "vae_checkpoint": "",
        "dae_checkpoint": "",
        "embedding_scale": 1.0,
        "embedding_type": "positional",
        "train_ode_solver_tol": 1e-5,
        "num_scales_dae": 2,
        "autocast_train": False,
        "diffusion_steps": 1000,
        "embedding_dim": 128,
        "num_channels_dae": 256,
        "num_cell_per_scale_dae": 8,
        "num_cell_per_scale_dae_local": 0,
        "dropout": 0.2,
        "num_preprocess_blocks": 2,
        "num_latent_scales": 1,
        "fir": False,
        "progressive": "none",
        "progressive_input": "none",
        "progressive_combine": "sum",
        "dataset": "shape",
        "denoising_stddevs": "beta",
        "ema_decay": 0.9999,
        "kl_max_coeff_vada": 1.0,
        "condition_add": 1,
        "condition_cat": 0,
        "global_prior_ckpt": "",
        "pool_feat_cat": 0,
        "ddim_skip_type": "uniform",
        "ddim_kappa": 1.0,
    },
    "ddpm": {
        "use_p2_weight": 0,
        "p2_k": 1.0,
        "p2_gamma": 1.0,
        "use_new_timeemb": 0,
        "input_dim": 3,
        "dropout": 0.1,
        "num_layers_classifier": 3,
        "use_bn": True,
        "add_point_feat": True,
        "use_gn": False,
        "time_dim": 64,
        "ema": 1,
        "with_se": 0,
        "use_global_attn": 0,
        "num_steps": 1000,
        "beta_1": 1e-4,
        "beta_T": 2e-2,
        "sched_mode": "linear",
        "model_var_type": "fixedlarge",
        "clip_denoised": 0,
        "model_mean_type": "eps",
        "loss_type": "mse",
        "loss_type_0": "",
        "loss_weight_emd": 0.02,
        "loss_weight_cdnorm": 1.0,
        "attn": [0, 1, 0, 0],
        "ncenter": [1024, 256, 64, 16],
        "ddim_step": 200,
    },
    "data": {
        "nclass": 55,
        "cond_on_cat": 0,
        "cond_on_voxel": 0,
        "eval_test_split": 0,
        "voxel_size": 0.1,
        "noise_std": 0.1,
        "noise_type": "normal",
        "noise_std_min": -1.0,
        "clip_forge_enable": 0,
        "clip_model": "ViT-B/32",
        # render-image root (reference hardcodes this in
        # datasets/data_path.py:18 get_path('clip_forge_image'))
        "clip_img_root": "./data/shapenet_render/",
        "type": "datasets.pointflow_datasets",
        "dataset_type": "shapenet15k",
        "num_workers": 12,
        "train_drop_last": 1,
        "cates": "chair",
        "tr_max_sample_points": 2048,
        "te_max_sample_points": 2048,
        "data_dir": "data/ShapeNetCore.v2.PC15k",
        "batch_size": 12,
        "batch_size_test": 10,
        "dataset_scale": 1,
        "normalize_per_shape": False,
        "normalize_shape_box": False,
        "normalize_global": False,
        "normalize_std_per_axis": False,
        "normalize_range": False,
        "recenter_per_shape": True,
        "sample_with_replacement": 1,
        "random_subsample": 1,
        "input_dim": -1,
        "is_encode_whole_dataset_trainer": 0,
    },
    "test_size": 660,
    "viz": {
        "log_freq": 10,
        "viz_freq": 400,
        "save_freq": 200,
        "val_freq": -1,
        "viz_order": [2, 0, 1],
        "vis_sample_ddim_step": 0,
    },
    "trainer": {
        "apply_loss_weight_1_kl": 0,
        "kl_free": [0, 0],
        "use_kl_free": 0,
        "type": "trainers.ddpm_trainer",
        "epochs": 10000,
        "warmup_epochs": 0,
        "seed": 1,
        "use_grad_scalar": 0,
        "opt": {
            "type": "adam",
            "lr": 1e-4,
            "lr_min": 1e-4,
            "start_ratio": 0.6,
            "beta1": 0.9,
            "beta2": 0.999,
            "momentum": 0.9,
            "weight_decay": 0.0,
            "ema_decay": 0.9999,
            "grad_clip": -1.0,
            "scheduler": "",
            "step_decay": 0.998,
            "vae_lr_warmup_epochs": 0,
        },
        "anneal_kl": 0,
        "kl_balance": 0,
        "rec_balance": 0,
        "loss1_weight_anneal_v": "quad",
        "kl_ratio": [1.0, 1.0],
        "kl_ratio_apply": 0,
        "sn_reg_vae": 0,
        "sn_reg_vae_weight": 0.0,
    },
    "log_name": "",
    "save_dir": "",
    "log_dir": "",
    "comet_key": "",
    "voxel2pts": {
        "init_weight": "",
        "diffusion_steps": [0],
    },
    "dpm": {
        "train_encoder_only": 0,
    },
    "num_ref": 0,
    "eval_ddim_step": 0,
    "model_config": "",
    # lion_tpu extension group (not in the reference config; additive only,
    # so released cfg.yml files still parse)
    "tpu": {
        "vres_mult": 1.0,     # scales PVConv voxel resolutions (tests)
        "ncenter_mult": 1.0,  # scales SA center counts (tests)
        "bf16": False,        # bf16 activations on the compute path
        # U-Net architecture overrides (nested lists, yaml-safe); empty ->
        # use the reference specs. Lets users define custom architectures
        # and lets the multichip dryrun compile a small net fast.
        "sa_blocks": [],
        "fp_blocks": [],
        # class-conditional embedding width (data.cond_on_cat). The
        # reference's cond_on_cat path is broken (vae_adain.py:66 uses an
        # undefined `class_embedding`); here it works, with this new knob
        # for the embedding size since the reference never defined one.
        "cls_emb_dim": 64,
        # interpolation-trainer noise modes (interpolate_latent.py used
        # hard-coded 'interpolate' global / 'freeze' local)
        "interp_mode_global": "interpolate",
        "interp_mode_local": "freeze",
    },
}

# reference default_config.py register_deprecated_key calls (kept so released
# cfg.yml files that still carry these keys parse without error)
_DEPRECATED = [
    "eval.other_vae_ckpt_path",
    "latent_pts.class_embed_layer",
    "latent_pts.perturb_input",
    "latent_pts.perturb_input_scale",
    "latent_pts.outlier_input",
    "latent_pts.encoder_nneighbor",
    "latent_pts.decoder_nneighbor",
    "latent_pts.latent_as_pts",
    "latent_pts.knn",
    "latent_pts.n5layer",
    "latent_pts.dgcnn_last_hid",
    "sde.is_train_vae",
    "ddpm.pointnet_plus",
    "ddpm.pointnet_pp",
    "ddpm.pointnet_luo",
    "ddpm.use_pvc",
    "ddpm.pvc",
    "ddpm.pvc.use_small_model",
    "ddpm.pvc.mlp_after_pvc",
    "data.load_point_stat",
    "data.is_load_pointflow2NS",
    "data.data_path",
    "data.augment",
    "data.aug_translate",
    "data.aug_scale",
    "data.sub_train_set",
    "cls",
    "cls.classifier_type",
    "cls.train_on_eps",
    "cond_prior",
    "cond_prior.grid_emb_resolution",
    "cond_prior.emb_dim",
    "cond_prior.use_voxel_feat",
    "cond_encoder_prior",
    "cond_prior.pvcconv_concat_3d_feat_input",
    "generate_mode_global",
    "generate_mode_local",
    "normals",
    "normals.model_type",
    "save_sample_seq_and_quit",
    "lns_loss_weight",
    "normal_pred_checkpoint",
    "lns",
    "lns.override_config",
    "lns.wandb_checkpoint",
    "lns.num_input_points",
    "lns.num_simulate",
    "lns.split_simulate",
    "with_lns",
    "normal_predictor_yaml",
    "pointtransformer",
    "pointtransformer.blocks",
    "shapelatent.refiner_bp",
    "shapelatent.loss_weight_refiner",
    "shapelatent.refiner_type",
    "shapelatent.encoder_weight_std",
    "shapelatent.encoder_weight_norm",
    "shapelatent.encoder_weight_uniform",
    "shapelatent.key_point_gen",
    "shapelatent.add_sub_loss",
    "shapelatent.local_decoder_type",
    "shapelatent.local_decoder_type_1",
    "shapelatent.local_encoder_ball_radius",
    "shapelatent.local_encoder_ap_ball_radius",
    "shapelatent.local_encoder_type",
    "shapelatent.local_encoder_type_1",
    "shapelatent.local_loss_weight_max",
    "shapelatent.num_neighbors",
    "shapelatent.extra_centers",
    "shapelatent.latent_flow_depth",
    "shapelatent.latent_flow_hidden_dim",
    "shapelatent.bp_to_l0",
    "shapelatent.global_only_epochs",
    "shapelatent.center_local_points",
    "shapelatent.hvae",
    "shapelatent.hvae.loss_wrt_ori",
    "shapelatent.add_voxel2z_global",
    "shapelatent.query_output_local_from_enc",
    "shapelatent.query_local_feat_layer",
    "shapelatent.query_local_feat_dim",
    "shapelatent.query_center_emd_from_enc",
    "shapelatent.prog_dec_gf",
    "shapelatent.prog_dec_gf_list",
    "shapelatent.prog_dec_ne",
    "shapelatent.num_neighbors_per_level",
    "shapelatent.num_level",
    "shapelatent.x0_target_fps",
    "shapelatent.downsample_input_ratio",
    "shapelatent.local_enc_input",
    "shapelatent.local_encoder_condition_z0",
    "shapelatent.local_decoder_output_offset",
    "shapelatent.local_prior_need_coords",
    "sde.transformer_temb2interlayer",
    "sde.transformer_norm_type",
    "data.has_normal",
    "data.has_color",
    "data.cls_data_ratio",
    "data.sample_curvature",
    "data.ratio_c",
]


# DiT-3D (github.com/DiT-3D/DiT-3D, the DiT-XL/2 entry of its model table
# on its 32^3 voxel grid): the `dit3d` node, which a tree has only for a
# DiT-3D run (`get_default_cfg(dit3d=True)`), so LION's trees and their
# dumps stay the reference's. DiT-3D's other settings live in the keys the
# trees share: ddpm.* (PVD's linear betas, 1000 steps), trainer.opt (Adam
# at 1e-4, betas (0.5, 0.999), step_decay per epoch, no clip, no weight
# decay), ddpm.ema (0: no EMA), data.* (the ShapeNet split),
# sde.ddim_skip_type / ddim_kappa for DDIM sampling.
DIT3D_TRAINER = "trainers.dit3d_trainer"
_DIT3D = {
    "hidden_size": 1152,
    "depth": 28,
    "num_heads": 16,
    "mlp_ratio": 4.0,
    "patch_size": 2,
    "voxel_size": 32,
    "window_size": 4,
    # the blocks that attend within windows; the rest attend globally
    "window_blocks": [0, 3, 6, 9, 12, 15, 18, 21, 24, 27],
    "num_classes": 1,
    "class_dropout_prob": 0.1,
    "frequency_embedding_size": 256,
    # TF32 products in the GEMMs and the attention (the benchmark's
    # control); DiT-3D trains in float32
    "tf32": False,
}


def get_default_cfg(dit3d: bool = False) -> CfgNode:
    """Build a fresh default config tree (not shared / not frozen); with
    `dit3d`, DiT-3D's: the `dit3d` node, its trainer and its optimizer's
    betas, no EMA."""
    cfg = CfgNode(_DEFAULTS)
    for key in _DEPRECATED:
        cfg.register_deprecated_key(key)
    if dit3d:
        cfg.dit3d = CfgNode(_DIT3D)
        cfg.trainer.type = DIT3D_TRAINER
        cfg.trainer.opt.beta1 = 0.5
        cfg.ddpm.ema = 0
    return cfg


def default_cfg_for(tree: dict = None, opts=()) -> CfgNode:
    """The defaults a run merges its config file (`tree`, as parsed) and
    its `key value` override pairs (`opts`) over: DiT-3D's when the
    trainer.type they set is DIT3D_TRAINER (the pairs after the file, as
    they are merged), LION's otherwise."""
    kind = ((tree or {}).get("trainer") or {}).get("type")
    opts = list(opts)
    for key, value in zip(opts[::2], opts[1::2]):
        if key == "trainer.type":
            kind = value
    return get_default_cfg(dit3d=kind == DIT3D_TRAINER)
