"""Offline Mitsuba scene export for paper-quality point-cloud renders (the
port's copy of lion_tpu/utils/render_mitsuba.py).

The counterpart of the reference's offline renderers
(`utils/render_mitsuba_pc.py:100-239,319-420` in nv-tlabs/LION): each point
cloud becomes a Mitsuba scene of small spheres over a rough-plastic ground
plane with an area light, written as scene XML. The reference drives a
locally built mitsuba2 binary and converts EXR output; here the scene is
made with numpy and string templates alone, and `render_scene` runs a
`mitsuba` executable only when one is on PATH (the reference's subprocess
flow, `render_mitsuba_pc.py:385-400`).

Figure tooling only: nothing in training or evaluation depends on it.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import List, Optional, Sequence

import numpy as np

# Scene template: perspective camera looking at the origin, fov 25, a
# low-discrepancy sampler, HDR film; rough-plastic white floor material.
# Mirrors the scene structure of render_mitsuba_pc.py:100-131.
_SCENE_HEAD = """\
<scene version="0.6.0">
    <integrator type="path">
        <integer name="maxDepth" value="-1"/>
    </integrator>
    <sensor type="perspective">
        <float name="farClip" value="100"/>
        <float name="nearClip" value="0.1"/>
        <transform name="toWorld">
            <lookat origin="{ox},{oy},{oz}" target="0,0,0" up="0,0,1"/>
        </transform>
        <float name="fov" value="25"/>
        <sampler type="ldsampler">
            <integer name="sampleCount" value="{spp}"/>
        </sampler>
        <film type="hdrfilm">
            <integer name="width" value="{width}"/>
            <integer name="height" value="{height}"/>
            <rfilter type="gaussian"/>
        </film>
    </sensor>

    <bsdf type="roughplastic" id="surfaceMaterial">
        <string name="distribution" value="ggx"/>
        <float name="alpha" value="0.05"/>
        <float name="intIOR" value="1.46"/>
        <rgb name="diffuseReflectance" value="1,1,1"/>
    </bsdf>
"""

# One sphere per point.  material_id selects the sphere BSDF, following the
# reference's xml_ball_segment variants (render_mitsuba_pc.py:133-218):
# 0 = diffuse, 1 = rough plastic, 2 = plastic (glossy).
_SPHERE = {
    0: """\
    <shape type="sphere">
        <float name="radius" value="{r}"/>
        <transform name="toWorld">
            <translate x="{x}" y="{y}" z="{z}"/>
        </transform>
        <bsdf type="diffuse">
            <rgb name="reflectance" value="{cr},{cg},{cb}"/>
        </bsdf>
    </shape>
""",
    1: """\
    <shape type="sphere">
        <float name="radius" value="{r}"/>
        <transform name="toWorld">
            <translate x="{x}" y="{y}" z="{z}"/>
        </transform>
        <bsdf type="roughplastic">
            <string name="distribution" value="ggx"/>
            <float name="alpha" value="0.05"/>
            <float name="intIOR" value="1.46"/>
            <rgb name="diffuseReflectance" value="{cr},{cg},{cb}"/>
        </bsdf>
    </shape>
""",
    2: """\
    <shape type="sphere">
        <float name="radius" value="{r}"/>
        <transform name="toWorld">
            <translate x="{x}" y="{y}" z="{z}"/>
        </transform>
        <bsdf type="plastic">
            <float name="intIOR" value="1.9"/>
            <rgb name="diffuseReflectance" value="{cr},{cg},{cb}"/>
        </bsdf>
    </shape>
""",
}

# Ground plane + area light (render_mitsuba_pc.py:220-239).
_SCENE_TAIL = """\
    <shape type="rectangle">
        <ref name="bsdf" id="surfaceMaterial"/>
        <transform name="toWorld">
            <scale x="10" y="10" z="1"/>
            <translate x="0" y="0" z="-0.5"/>
        </transform>
    </shape>

    <shape type="rectangle">
        <transform name="toWorld">
            <scale x="10" y="10" z="1"/>
            <lookat origin="-1,1,20" target="0,0,0" up="0,0,1"/>
        </transform>
        <emitter type="area">
            <rgb name="radiance" value="6,6,6"/>
        </emitter>
    </shape>
</scene>
"""


def standardize_bbox(pcl: np.ndarray, return_center_scale: bool = False):
    """Center by bbox midpoint and scale the longest bbox edge to 1, mapping
    the cloud into [-0.5, 0.5]^3 (render_mitsuba_pc.py:261-276)."""
    pcl = np.asarray(pcl, dtype=np.float64)
    mins, maxs = pcl.min(axis=0), pcl.max(axis=0)
    center = (mins + maxs) / 2.0
    scale = float((maxs - mins).max())
    out = ((pcl - center) / scale).astype(np.float32)
    if return_center_scale:
        return out, center, scale
    return out


def position_colormap(pts: np.ndarray) -> np.ndarray:
    """Per-point RGB from normalized position (render_mitsuba_pc.py:251-258):
    clamp shifted coords to [0.001, 1] and L2-normalize the color vector."""
    vec = np.clip(pts + 0.5, 0.001, 1.0)
    norm = np.sqrt((vec ** 2).sum(axis=-1, keepdims=True))
    return vec / norm


def _prepare(pts: np.ndarray, do_transform: bool) -> np.ndarray:
    """The reference's PointFlow-orientation fixup (render_mitsuba_pc.py:57-63):
    standardize, swap to (z, x, y), flip the first axis, lift slightly off
    the floor."""
    pts = standardize_bbox(pts)
    if do_transform:
        pts = pts[:, [2, 0, 1]]
        pts = pts * np.array([-1.0, 1.0, 1.0], dtype=np.float32)
        pts = pts + np.array([0.0, 0.0, 0.0125], dtype=np.float32)
    return pts


def point_cloud_scene_xml(pts,
                          colors=None,
                          ball_size: float = 0.025,
                          sample_count: int = 256,
                          width: int = 1600,
                          height: int = 1200,
                          lookat: Sequence[float] = (3.0, 3.0, 3.0),
                          material_id: int = 0,
                          do_transform: bool = True,
                          use_loc_color: bool = True,
                          colorm: Sequence[int] = (24, 107, 239)) -> str:
    """Build the full Mitsuba scene XML for one (N, 3) point cloud.

    colors: optional (N, 3) float RGB in [0, 1]; default is the positional
    colormap when use_loc_color else the constant `colorm` (0-255 ints),
    matching pts2png's options (render_mitsuba_pc.py:319-384).
    """
    pts = np.asarray(pts, dtype=np.float32)
    assert pts.ndim == 2 and pts.shape[1] == 3, f"expect (N,3), got {pts.shape}"
    pts = _prepare(pts, do_transform)
    if colors is None:
        if use_loc_color:
            colors = position_colormap(pts)
        else:
            colors = np.tile(np.asarray(colorm, np.float32) / 255.0,
                             (pts.shape[0], 1))
    colors = np.asarray(colors, dtype=np.float32)
    tmpl = _SPHERE[material_id]
    parts = [_SCENE_HEAD.format(ox=lookat[0], oy=lookat[1], oz=lookat[2],
                                spp=sample_count, width=width, height=height)]
    for p, c in zip(pts, colors):
        parts.append(tmpl.format(r=ball_size, x=p[0], y=p[1], z=p[2],
                                 cr=c[0], cg=c[1], cb=c[2]))
    parts.append(_SCENE_TAIL)
    return "".join(parts)


def write_scenes(input_pts,
                 out_files: List[str],
                 **kwargs) -> List[str]:
    """Write one scene XML per cloud in a (B, N, 3) batch.  out_files are the
    target image names as in the reference's pts2png; the XML lands next to
    each with an .xml suffix and the paths are returned."""
    input_pts = np.asarray(input_pts)
    assert input_pts.ndim == 3, f"expect (B,N,3), got {input_pts.shape}"
    assert len(out_files) == input_pts.shape[0]
    xml_paths = []
    for pts, name in zip(input_pts, out_files):
        xml_path = os.path.splitext(name)[0] + ".xml"
        os.makedirs(os.path.dirname(os.path.abspath(xml_path)), exist_ok=True)
        with open(xml_path, "w") as f:
            f.write(point_cloud_scene_xml(pts, **kwargs))
        xml_paths.append(xml_path)
    return xml_paths


def render_scene(xml_path: str, out_image: str,
                 mitsuba_bin: Optional[str] = None) -> bool:
    """Render a scene XML with a local mitsuba binary if one exists
    (the reference hardcodes a mitsuba2 build path,
    render_mitsuba_pc.py:24,385-400).  Returns False when no renderer is
    available; scene XML generation above still succeeded."""
    binpath = mitsuba_bin or shutil.which("mitsuba")
    if binpath is None:
        return False
    subprocess.run([binpath, xml_path, "-o", out_image], check=True)
    return True


def pts2scenes(input_pts, file_name: List[str], **kwargs) -> List[str]:
    """Reference-named convenience wrapper (pts2png surface): generates
    scenes, renders them when a mitsuba binary is on PATH."""
    xmls = write_scenes(input_pts, file_name, **kwargs)
    for xml_path, img in zip(xmls, file_name):
        render_scene(xml_path, img)
    return xmls
