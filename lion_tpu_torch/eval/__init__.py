"""Evaluation: pairwise CD / approximate-EMD matrices on the device,
MMD / COV / 1-NNA, JSD, and `compute_score` (port of lion_tpu/eval)."""
from .eval_helper import (compute_nll_metric, compute_score,
                          formulate_results, get_cats, get_ref_num,
                          get_ref_pt, normalize_point_clouds, print_results,
                          write_results)
from .metrics import (compute_all_metrics, emd_cd_paired,
                      jsd_between_point_cloud_sets, knn_accuracy,
                      lgan_mmd_cov, pairwise_cd, pairwise_emd)

__all__ = [
    "compute_all_metrics", "emd_cd_paired", "jsd_between_point_cloud_sets",
    "knn_accuracy", "lgan_mmd_cov", "pairwise_cd", "pairwise_emd",
    "compute_nll_metric", "compute_score", "formulate_results", "get_cats",
    "get_ref_num", "get_ref_pt", "normalize_point_clouds", "print_results",
    "write_results",
]
