"""LION (nv-tlabs/LION): the hierarchical VAE with the SE global prior and
the PVCNN2 local prior, unconditional or CLIP-conditioned; DDIM sampling
and both training stages. Its plain reference is `benchmark/reference/`,
its traffic `benchmark/traffic.py`, its check `benchmark/check.py`, its
weights `benchmark/weights.py` and its faults `benchmark/faults.py`; the
contract is `benchmark/families/__init__.py`'s."""
from benchmark import check as _check
from benchmark import faults, reference, traffic, weights

REFERENCE = "reference"
KINDS = traffic.KINDS
check = _check.check
work_of = reference.work_of
# the check's control: the program's own bf16 path, the nearest precision
# below the configurations' float32
CONTROL = {"tpu.bf16": True}
FAULTS, OF_KIND = faults.FAULTS, faults.OF_KIND

# Small sizes for the CPU tests: every code path of the released
# configurations (three U-Net stages, attention, both SA kinds, the style
# encoder) on 32-point clouds, 16-wide priors and r = 4 grids.
_SA = [[[8, 1, 16], [256, 0.2, 4, [8, 16]]],
       [[16, 1, 16], [64, 0.4, 4, [16, 16]]],
       [None, [16, 0.8, 4, [16, 16]]]]
_FP = [[[16, 16], [16, 1, 16]], [[16, 16], [16, 1, 16]],
       [[16, 8], [8, 1, 16]]]
TINY = {"data.tr_max_sample_points": 32,
        "tpu.sa_blocks": _SA, "tpu.fp_blocks": _FP,
        "tpu.ncenter_mult": 1 / 32, "tpu.vres_mult": 1 / 4,
        "sde.num_channels_dae": 16, "sde.num_cell_per_scale_dae": 2,
        "sde.embedding_dim": 8}


def port_config(cfg: dict):
    """The program's config tree: its defaults with the file's values."""
    from lion_tpu_torch.config import CfgNode, get_default_cfg
    node = get_default_cfg()
    node.merge_from_other_cfg(CfgNode(cfg))
    return node


def make_weights(cfg: dict, seed: int, device):
    """The released initializers from the seed, the style posterior's head
    damped (at random weights the full-width one overflows exp())."""
    return weights.make_weights(cfg, seed, device, damp_style_head=0.01)
