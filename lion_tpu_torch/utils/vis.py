"""Point-cloud visualization (port of lion_tpu/utils/vis.py).

Matplotlib 3D scatter grids on the Agg backend: no display is needed.
matplotlib is imported inside the functions, so the package imports
without it.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def plot_points(pts: np.ndarray, output_name: str,
                titles: Optional[Sequence[str]] = None,
                bound: float = 1.0, viz_order=(2, 0, 1)) -> str:
    """pts: (B, N, 3) -> grid of 3D scatters saved to output_name."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pts = np.asarray(pts)
    if pts.ndim == 2:
        pts = pts[None]
    b = pts.shape[0]
    cols = min(b, 4)
    rows = (b + cols - 1) // cols
    fig = plt.figure(figsize=(3 * cols, 3 * rows))
    for i in range(b):
        ax = fig.add_subplot(rows, cols, i + 1, projection="3d")
        p = pts[i]
        ax.scatter(p[:, viz_order[0]], p[:, viz_order[1]],
                   p[:, viz_order[2]], s=1)
        ax.set_xlim(-bound, bound)
        ax.set_ylim(-bound, bound)
        ax.set_zlim(-bound, bound)
        ax.axis("off")
        if titles is not None and i < len(titles):
            ax.set_title(titles[i], fontsize=8)
    fig.tight_layout()
    fig.savefig(output_name, dpi=120)
    plt.close(fig)
    return output_name


def visualize_point_clouds_3d(pcl_lst, title_lst=None,
                              bound: float = 1.0) -> np.ndarray:
    """Render a list of clouds side by side -> HWC uint8 image
    (vis_helper.py visualize_point_clouds_3d)."""
    import io

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    title_lst = title_lst or [""] * len(pcl_lst)
    fig = plt.figure(figsize=(3 * len(pcl_lst), 3))
    for i, (pc, title) in enumerate(zip(pcl_lst, title_lst)):
        pc = np.asarray(pc)
        ax = fig.add_subplot(1, len(pcl_lst), i + 1, projection="3d")
        ax.scatter(pc[:, 2], pc[:, 0], pc[:, 1], s=1)
        ax.set_xlim(-bound, bound)
        ax.set_ylim(-bound, bound)
        ax.set_zlim(-bound, bound)
        ax.axis("off")
        ax.set_title(title, fontsize=8)
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=100)
    plt.close(fig)
    buf.seek(0)
    import matplotlib.image as mpimg
    img = mpimg.imread(buf)
    return (img[:, :, :3] * 255).astype(np.uint8)
