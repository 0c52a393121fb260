"""Offline Mitsuba mesh and voxel-cube scene export (the port's copy of
lion_tpu/utils/render_mitsuba_mesh.py; figure tooling).

The counterpart of the reference's mesh and cube renderers
(`utils/render_mitsuba_mesh.py`, `utils/render_voxel_cubes.py`,
`utils/_render_mitsuba_cubes.py` in nv-tlabs/LION), which drive
open3d/trimesh/kaolin/mitsuba; this module needs numpy alone:

- minimal PLY I/O (`read_ply` / `write_ply`: ascii and
  binary_little_endian, the two formats the pipeline produces);
- `reformat_ply` reproduces the reference's coordinate chain
  (render_mitsuba_mesh.py:41-70: the optional mesh-frame flip, bbox
  standardization to [-0.5, 0.5], the axis shuffle [2,0,1] with an x
  flip, the +0.0125 and floor-offset z shifts, the -r*pi/2 z rotation);
- `mesh_scene_xml` turns the reference's 8 material templates
  (render_mitsuba_mesh.py:150-300 xml_shape_segment[0..7]) into one table;
- `cubes_to_mesh` replaces kaolin's voxelgrids_to_cubic_meshes for the
  voxel-cube figures (render_voxel_cubes.py:52-100): a unit cube at each
  occupied center, normalized as convert_cube_2_mesh:63-100 does and
  0.9*voxel_size/scale wide;
- `render_scene` runs a `mitsuba` binary when one exists; else the scene
  XML is the output.

Nothing in training or evaluation depends on it.
"""
from __future__ import annotations

import os
import struct
from typing import Optional, Sequence, Tuple

import numpy as np

from .render_mitsuba import _SCENE_HEAD, _SCENE_TAIL, standardize_bbox

# ---------------------------------------------------------------- PLY I/O

_PLY_DTYPES = {
    "float": ("f", 4), "float32": ("f", 4), "double": ("d", 8),
    "uchar": ("B", 1), "uint8": ("B", 1), "char": ("b", 1),
    "short": ("h", 2), "ushort": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4), "uint": ("I", 4), "uint32": ("I", 4),
}


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal PLY reader -> (vertices (V, 3) f64, faces (F, 3) i64).

    Supports ascii 1.0 and binary_little_endian 1.0 with x/y/z leading the
    vertex properties and list-typed face indices (what write_ply and
    common exporters emit)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(type, name) or ('list', ct, t, n)])
        while True:
            line = f.readline().split(b"//")[0].strip()
            if line == b"end_header":
                break
            toks = line.decode().split()
            if not toks:
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                elements.append((toks[1], int(toks[2]), []))
            elif toks[0] == "property":
                if toks[1] == "list":
                    elements[-1][2].append(("list", toks[2], toks[3],
                                            toks[4]))
                else:
                    elements[-1][2].append((toks[1], toks[2]))
        verts, faces = [], []
        for name, count, props in elements:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    verts = [[float(r[i]) for i in range(3)] for r in rows]
                elif name == "face":
                    faces = [[int(x) for x in r[1:1 + int(r[0])]]
                             for r in rows]
            elif fmt == "binary_little_endian":
                if name == "vertex":
                    fmts = "".join(_PLY_DTYPES[t][0] for t, _ in props)
                    size = struct.calcsize("<" + fmts)
                    raw = f.read(size * count)
                    for i in range(count):
                        row = struct.unpack_from("<" + fmts, raw, i * size)
                        verts.append(row[:3])
                else:
                    for _ in range(count):
                        (ct, it) = (props[0][1], props[0][2])
                        n = struct.unpack(
                            "<" + _PLY_DTYPES[ct][0],
                            f.read(_PLY_DTYPES[ct][1]))[0]
                        idx = struct.unpack(
                            "<" + _PLY_DTYPES[it][0] * n,
                            f.read(_PLY_DTYPES[it][1] * n))
                        if name == "face":
                            faces.append(list(idx))
            else:
                raise ValueError(f"{path}: unsupported PLY format {fmt}")
    v = np.asarray(verts, np.float64).reshape(-1, 3)
    fc = np.asarray([t[:3] for t in faces], np.int64).reshape(-1, 3) \
        if faces else np.zeros((0, 3), np.int64)
    return v, fc


def write_ply(path: str, vertices: np.ndarray, faces: np.ndarray = None,
              ascii: bool = True) -> str:
    """Write (V, 3) vertices and optional (F, 3) faces as PLY."""
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    faces = None if faces is None or len(faces) == 0 \
        else np.asarray(faces, np.int32).reshape(-1, 3)
    fmt = "ascii 1.0" if ascii else "binary_little_endian 1.0"
    head = [f"ply\nformat {fmt}\nelement vertex {len(vertices)}",
            "property float x\nproperty float y\nproperty float z"]
    if faces is not None:
        head.append(f"element face {len(faces)}")
        head.append("property list uchar int vertex_indices")
    head.append("end_header\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write("\n".join(head).encode())
        if ascii:
            for v in vertices:
                f.write(f"{v[0]:f} {v[1]:f} {v[2]:f}\n".encode())
            if faces is not None:
                for t in faces:
                    f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
        else:
            f.write(vertices.astype("<f4").tobytes())
            if faces is not None:
                for t in faces:
                    f.write(struct.pack("<Biii", 3, *t))
    return path


# -------------------------------------------------- mesh reformat + scene

def standardize_to_same_range(ref_ply: str, src: np.ndarray) -> np.ndarray:
    """Rescale src points per-axis into the range of the reference mesh's
    vertices (render_mitsuba_mesh.py:24-38)."""
    pcl, _ = read_ply(ref_ply)
    out = np.array(src, np.float64)
    for i in range(3):
        lo, hi = pcl[:, i].min(), pcl[:, i].max()
        c = out[:, i]
        c = (c - c.min()) / max(c.max() - c.min(), 1e-12)
        out[:, i] = c * (hi - lo) + lo
    return out


def _mesh_frame_transform(pcl: np.ndarray, r: float = 0,
                          is_point_flow_data: bool = False) -> np.ndarray:
    """The reference's mesh-to-scene coordinate chain
    (render_mitsuba_mesh.py:41-63)."""
    pcl = np.array(pcl, np.float64)
    if not is_point_flow_data:
        pcl[:, 0] *= -1
        pcl = pcl[:, [2, 1, 0]]
    pcl = standardize_bbox(pcl)
    pcl = pcl[:, [2, 0, 1]]
    pcl[:, 0] *= -1
    pcl[:, 2] += 0.0125
    pcl[:, 2] += -0.475 - pcl[:, 2].min()
    if r:
        a = -r * np.pi / 2
        rot = np.array([[np.cos(a), -np.sin(a), 0],
                        [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        pcl = pcl @ rot.T
    return pcl


def reformat_ply(input_path: str, output_path: str, r: float = 0,
                 is_point_flow_data: bool = False,
                 ascii: bool = True) -> str:
    """Normalize a mesh PLY into the render frame (standardized bbox,
    floor-aligned, optionally rotated) and rewrite it."""
    verts, faces = read_ply(input_path)
    verts = _mesh_frame_transform(verts, r, is_point_flow_data)
    return write_ply(output_path, verts, faces, ascii=ascii)


# Material table replacing xml_shape_segment[0..7]
# (render_mitsuba_mesh.py:150-300): (bsdf type, intIOR, alpha, uses_color).
_MESH_MATERIALS = {
    0: ("roughplastic", 1.46, 0.2, True),
    1: ("roughplastic", 1.6, 0.2, True),
    2: ("vertex_color", None, None, False),   # diffuse w/ vertex colors
    4: ("roughplastic", 1.6, 0.2, True),
    5: ("roughplastic", 1.7, 0.2, True),
    6: ("plastic", 1.9, None, True),
    7: ("roughplastic", 1.9, 0.2, True),
}


def _mesh_shape_xml(mesh_path: str, material_id: int,
                    color: Sequence[float]) -> str:
    kind, ior, alpha, uses_color = _MESH_MATERIALS[material_id]
    if kind == "vertex_color":
        return f"""
    <shape type="ply" id="mesh">
        <string name="filename" value="{mesh_path}"/>
        <bsdf type="diffuse">
            <texture type="mesh_attribute" name="reflectance">
                <string name="name" value="vertex_color"/>
            </texture>
        </bsdf>
    </shape>
"""
    rgb = ",".join(f"{c:g}" for c in color)
    dist = '<string name="distribution" value="ggx"/>\n        ' \
        f'<float name="alpha" value="{alpha}"/>\n        ' if alpha else ""
    return f"""
    <shape type="ply" id="mesh">
        <string name="filename" value="{mesh_path}"/>
        <bsdf type="{kind}" id="surfaceMaterialshape">
        <float name="intIOR" value="{ior}"/>
        {dist}<rgb name="diffuseReflectance" value="{rgb}"/>
        </bsdf>
    </shape>
"""


def mesh_scene_xml(mesh_path: str, material_id: int = 0,
                   colorm: Sequence[int] = (24, 107, 239),
                   lookat: Sequence[float] = (3, 3, 3),
                   sample_count: int = 256, width: int = 1600,
                   height: int = 1200) -> str:
    """Full scene XML for one mesh (render_mitsuba_mesh.py:482-520 main)."""
    color = [c / 255.0 for c in colorm]
    head = _SCENE_HEAD.format(ox=lookat[0], oy=lookat[1], oz=lookat[2],
                              spp=sample_count, width=width, height=height)
    return head + _mesh_shape_xml(mesh_path, material_id, color) \
        + _SCENE_TAIL


def render_mesh(mesh_ply: str, out_png: str, xml_path: Optional[str] = None,
                **scene_kwargs) -> str:
    """Write the scene XML and render it if a mitsuba binary exists;
    returns the png path (rendered) or the xml path (export only)."""
    xml_path = xml_path or out_png.rsplit(".", 1)[0] + ".xml"
    os.makedirs(os.path.dirname(os.path.abspath(xml_path)), exist_ok=True)
    with open(xml_path, "w") as f:
        f.write(mesh_scene_xml(mesh_ply, **scene_kwargs))
    from .render_mitsuba import render_scene
    return out_png if render_scene(xml_path, out_png) else xml_path


# ------------------------------------------------------------ voxel cubes

_UNIT_CUBE_V = np.array(
    [[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
     for z in (-0.5, 0.5)], np.float64)
# 12 triangles, outward-facing, over the (x, y, z)-bit vertex index
_UNIT_CUBE_F = np.array([
    [0, 1, 3], [0, 3, 2],      # x = -0.5
    [4, 7, 5], [4, 6, 7],      # x = +0.5
    [0, 5, 1], [0, 4, 5],      # y = -0.5
    [2, 3, 7], [2, 7, 6],      # y = +0.5
    [0, 2, 6], [0, 6, 4],      # z = -0.5
    [1, 5, 7], [1, 7, 3],      # z = +0.5
], np.int64)


def cubes_to_mesh(centers: np.ndarray, voxel_size: float,
                  rotate: Optional[float] = None
                  ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Occupied voxel centers (K, 3) -> one merged cube mesh in the render
    frame (convert_cube_2_mesh, render_voxel_cubes.py:63-100): normalize
    centers to the unit bbox, shuffle axes [2,0,1] with x-flip, floor
    offset, optional z rotation; each cube spans 0.9*voxel_size/scale.

    Returns (vertices, faces, cube_edge)."""
    pcl = np.asarray(centers, np.float64).reshape(-1, 3)
    mins, maxs = pcl.min(0), pcl.max(0)
    center = (mins + maxs) / 2.0
    scale = float((maxs - mins).max())
    pcl = (pcl - center) / max(scale, 1e-12)
    pcl = pcl[:, [2, 0, 1]]
    pcl[:, 0] *= -1
    pcl[:, 2] += -0.475 - pcl[:, 2].min()
    if rotate is not None:
        a = -rotate * np.pi / 2
        rot = np.array([[np.cos(a), -np.sin(a), 0],
                        [np.sin(a), np.cos(a), 0], [0, 0, 1]])
        pcl = pcl @ rot.T
    edge = 0.9 * voxel_size / max(scale, 1e-12)
    k = len(pcl)
    verts = (_UNIT_CUBE_V[None] * edge + pcl[:, None, :]).reshape(-1, 3)
    faces = (_UNIT_CUBE_F[None] + 8 * np.arange(k)[:, None, None]
             ).reshape(-1, 3)
    return verts, faces, edge


def render_voxel_cubes(centers: np.ndarray, voxel_size: float,
                       out_png: str, colorm: Sequence[int] = (93, 64, 211),
                       rotate: Optional[float] = None,
                       **scene_kwargs) -> str:
    """Voxel-cube figure: centers -> merged cube mesh PLY -> scene ->
    render (render_voxel_cubes.py convert_cube_2_mesh + render_cubes2png)."""
    verts, faces, _ = cubes_to_mesh(centers, voxel_size, rotate)
    ply = out_png.rsplit(".", 1)[0] + "_cubes.ply"
    write_ply(ply, verts, faces, ascii=False)
    return render_mesh(ply, out_png, colorm=colorm, **scene_kwargs)
