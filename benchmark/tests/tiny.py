"""Small sizes for the benchmark's CPU tests: every code path of the
released configurations (three U-Net stages, attention, both SA kinds, the
style encoder) on 32-point clouds, 16-wide priors and r = 4 grids."""

SA = [[[8, 1, 16], [256, 0.2, 4, [8, 16]]],
      [[16, 1, 16], [64, 0.4, 4, [16, 16]]],
      [None, [16, 0.8, 4, [16, 16]]]]
FP = [[[16, 16], [16, 1, 16]], [[16, 16], [16, 1, 16]],
      [[16, 8], [8, 1, 16]]]

KEYS = {"data.tr_max_sample_points": 32,
        "tpu.sa_blocks": SA, "tpu.fp_blocks": FP,
        "tpu.ncenter_mult": 1 / 32, "tpu.vres_mult": 1 / 4,
        "sde.num_channels_dae": 16, "sde.num_cell_per_scale_dae": 2,
        "sde.embedding_dim": 8}
