"""Scoring orchestration (port of lion_tpu/eval/eval_helper.py).

`compute_score` loads a sample set and a reference set (.pt files),
denormalizes both with the reference's training-set stats (ref * s + m) or
applies the shape-bbox `norm_box`, runs the metric suite and the JSD on the
device, and appends the reference's TSV line to results/eval_out.csv.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .metrics import (compute_all_metrics, emd_cd_paired,
                      jsd_between_point_cloud_sets)

# reference set registry (reference utils/eval_helper.py)
NUM_TEST = {
    "animal": 100, "airplane": 405, "airplane_ps": 405, "chair": 662,
    "chair_ps": 662, "car": 352, "car_ps": 352, "all": 1000, "mug": 22,
    "bottle": 43,
}
NUM_TEST_LUO = {"airplane": 607, "chair": 989, "car": 528}
ALL_CATS = ["airplane", "chair", "car", "all", "animal", "mug", "bottle"]


def get_ref_num(cats: str, luo_split: bool = False) -> int:
    table = NUM_TEST_LUO if luo_split else NUM_TEST
    assert cats in table, f"not found: {cats} in {table}"
    return table[cats]


def get_cats(cats: str) -> str:
    for c in ALL_CATS:
        if c in cats or c == cats:
            return c
    raise AssertionError(f"not found cats for {cats} in {ALL_CATS}")


def get_ref_pt(cats: str, data_type: str = "datasets.pointflow_datasets",
               root: str = "./datasets/test_data/") -> Optional[str]:
    cats = get_cats(cats)
    if "pointflow" in data_type:
        ref = f"ref_val_{cats}.pt"
    elif "neuralspline_datasets" in data_type:
        ref = f"ref_ns_val_{cats}.pt"
    else:
        return None
    return os.path.join(root, ref)


def normalize_point_clouds(pcs: np.ndarray) -> np.ndarray:
    """shape_bbox normalization: per cloud, center the bbox and scale by
    half the longest bbox side."""
    out = []
    for pc in pcs:
        pc = np.array(pc, np.float32)
        pc_min = pc[:, :3].min(0, keepdims=True)
        pc_max = pc[:, :3].max(0, keepdims=True)
        shift = (pc_min + pc_max) / 2.0
        scale = (pc_max - pc_min).max() / 2.0
        pc[:, :3] = (pc[:, :3] - shift) / scale
        out.append(pc)
    return np.stack(out)


def _load_pt(path: str):
    return torch.load(path, map_location="cpu", weights_only=False)


def compute_score(output_name: str, ref_name: str, norm_box: bool = False,
                  skip_write: bool = False, metric2: Optional[str] = "EMD",
                  results_dir: str = "./results", device="cuda",
                  rng: Optional[np.random.RandomState] = None,
                  **print_kwargs) -> Dict[str, float]:
    """Score a generated sample .pt (a tensor, or a dict with "ref")
    against a reference .pt ({"ref", "mean", "std"}). When the samples
    have more points than the refs, a random subset of them is kept,
    drawn from `rng` (numpy's global state by default)."""
    ref = _load_pt(ref_name)
    ref_pcs = np.asarray(ref["ref"])[:, :, :3]
    m_pcs = np.asarray(ref["mean"])
    s_pcs = np.asarray(ref["std"])
    gen = _load_pt(output_name)
    gen_pcs = np.asarray(gen["ref"] if isinstance(gen, dict) else gen)

    if gen_pcs.shape[1] > ref_pcs.shape[1]:
        draw = np.random if rng is None else rng
        perm = draw.permutation(gen_pcs.shape[1])[:ref_pcs.shape[1]]
        gen_pcs = gen_pcs[:, perm]

    n_ref = ref_pcs.shape[0]
    m_pcs, s_pcs = m_pcs[:n_ref], s_pcs[:n_ref]
    gen_pcs = gen_pcs[:n_ref]
    if gen_pcs.shape[2] == 6:
        gen_pcs = gen_pcs[:, :, :3]

    if norm_box:
        ref_pcs = 0.5 * normalize_point_clouds(ref_pcs)
        gen_pcs = 0.5 * normalize_point_clouds(gen_pcs)
        print_kwargs["dataset"] = print_kwargs.get("dataset", "") + "-normbox"
    else:
        # denormalize with the training set's stats
        ref_pcs = ref_pcs * s_pcs + m_pcs
        gen_pcs = gen_pcs * s_pcs + m_pcs

    results = compute_all_metrics(gen_pcs.astype(np.float32),
                                  ref_pcs.astype(np.float32),
                                  metric2=metric2, device=device)
    results["jsd"] = jsd_between_point_cloud_sets(gen_pcs, ref_pcs,
                                                  device=device)
    print_results(results, **print_kwargs)
    if not skip_write:
        os.makedirs(results_dir, exist_ok=True)
        write_results(os.path.join(results_dir, "eval_out.csv"), results,
                      **print_kwargs)
    return results


def compute_nll_metric(gen_pcs, ref_pcs, batch_size: int = 200,
                       device="cuda") -> Dict:
    """Reconstruction CD / EMD of row-aligned sets."""
    metrics = emd_cd_paired(gen_pcs, ref_pcs, batch_size=batch_size,
                            reduced=False, device=device)
    results = {"score_detail": metrics["MMD-CD"]}
    for k in list(metrics):
        results[k] = float(np.mean(metrics[k]))
    return results


# ---------------------------------------------------------------- report
def formulate_results(results, dataset="-", hash="-", step="", epoch=""):
    """The reference's table: a head row and one value row."""
    reported = f"S{step}E{epoch}"
    reported = "" if reported == "SE" else reported
    msg_head, msg_oneline = "", ""
    if dataset != "-":
        msg_head += "Dataset "
        msg_oneline += f"{dataset} "
    if hash != "-":
        msg_head += "Model "
        msg_oneline += f"{hash} "
    if step != "" or epoch != "":
        msg_head += "reported "
        msg_oneline += f"{reported} "
    msg_head += ("MMD-CDx0.001↓ MMD-EMDx0.01↓ COV-CD%↑ "
                 "COV-EMD%↑ 1-NNA-CD%↓ 1-NNA-EMD%↓ JSD↓")
    msg_oneline += (
        f"{results.get('lgan_mmd-CD', 0) * 1000:.4f} "
        f"{results.get('lgan_mmd-EMD', 0) * 100:.4f} "
        f"{results.get('lgan_cov-CD', 0) * 100:.2f} "
        f"{results.get('lgan_cov-EMD', 0) * 100:.2f} "
        f"{results.get('1-NN-CD-acc', 0) * 100:.2f} "
        f"{results.get('1-NN-EMD-acc', 0) * 100:.2f} "
        f"{results.get('jsd', 0):.2f}")
    if results.get("url") is not None:
        msg_head += " url"
        msg_oneline += f" {results.get('url', '-')}"
    return msg_head.split(" "), msg_oneline.split(" ")


def _tabulate(rows, head, sep):
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(head)]
    fmt = sep.join("{:<%d}" % w for w in widths)
    lines = [fmt.format(*head)] + [fmt.format(*r) for r in rows]
    return "\n".join(lines)


def print_results(results, **kwargs) -> str:
    head, line = formulate_results(results, **kwargs)
    msg = _tabulate([line], head, "  ")
    print(msg)
    return msg


def write_results(out_file, results, **kwargs) -> str:
    head, line = formulate_results(results, **kwargs)
    content = _tabulate([line], head, "\t")
    with open(out_file, "a") as f:
        f.write(content + "\n")
    return content
