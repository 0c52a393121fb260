"""The port's copies of the pure-numpy figure and shape tools against the
JAX package's: the Mitsuba scene XML and the PLY bytes of
`utils/render_mitsuba*.py` for the same clouds, meshes and cubes, and the
shape asserts of `utils/checker.py` firing where lion_tpu's fire."""
import os

import numpy as np
import pytest

from lion_tpu.utils import checker as jchecker
from lion_tpu.utils import render_mitsuba as jrm
from lion_tpu.utils import render_mitsuba_mesh as jrmm

from lion_tpu_torch.utils import checker
from lion_tpu_torch.utils import render_mitsuba as rm
from lion_tpu_torch.utils import render_mitsuba_mesh as rmm


def _clouds(seed=0, b=2, n=48):
    return (np.random.RandomState(seed).randn(b, n, 3) * 0.4).astype(
        np.float32)


@pytest.mark.parametrize("kwargs", [
    {}, {"material_id": 1, "ball_size": 0.02, "use_loc_color": False},
    {"material_id": 2, "do_transform": False, "lookat": (2.0, 1.0, 3.0),
     "sample_count": 64, "width": 320, "height": 240}])
def test_point_cloud_scene_xml_equals_lion_tpu(kwargs):
    pts = _clouds()[0]
    assert rm.point_cloud_scene_xml(pts, **kwargs) == \
        jrm.point_cloud_scene_xml(pts, **kwargs)
    colors = np.random.RandomState(1).rand(len(pts), 3).astype(np.float32)
    assert rm.point_cloud_scene_xml(pts, colors=colors, **kwargs) == \
        jrm.point_cloud_scene_xml(pts, colors=colors, **kwargs)


def test_write_scenes_bytes_equal_lion_tpu(tmp_path):
    pts = _clouds(2)
    outs = {}
    for name, mod in (("port", rm), ("jax", jrm)):
        files = [str(tmp_path / name / f"s{i}.png") for i in range(2)]
        xmls = mod.pts2scenes(pts, files)
        assert [os.path.basename(p) for p in xmls] == ["s0.xml", "s1.xml"]
        outs[name] = [open(p, "rb").read() for p in xmls]
    assert outs["port"] == outs["jax"]
    # no mitsuba binary here: the scene is the output
    assert rm.render_scene(str(tmp_path / "port" / "s0.xml"),
                           str(tmp_path / "x.png"),
                           mitsuba_bin=None) == (
        jrm.render_scene(str(tmp_path / "jax" / "s0.xml"),
                         str(tmp_path / "y.png")))


def test_standardize_and_colormap_equal_lion_tpu():
    pts = _clouds(3)[0]
    a, ca, sa = rm.standardize_bbox(pts, return_center_scale=True)
    b, cb, sb = jrm.standardize_bbox(pts, return_center_scale=True)
    assert np.array_equal(a, b) and np.array_equal(ca, cb) and sa == sb
    assert np.array_equal(rm.position_colormap(a), jrm.position_colormap(b))


def _mesh():
    rs = np.random.RandomState(4)
    verts = rs.rand(30, 3) * 2 - 1
    faces = rs.randint(0, 30, size=(20, 3))
    return verts, faces


@pytest.mark.parametrize("ascii_ply", [True, False])
def test_ply_bytes_and_reformat_equal_lion_tpu(tmp_path, ascii_ply):
    verts, faces = _mesh()
    got, want = str(tmp_path / "p.ply"), str(tmp_path / "j.ply")
    rmm.write_ply(got, verts, faces, ascii=ascii_ply)
    jrmm.write_ply(want, verts, faces, ascii=ascii_ply)
    assert open(got, "rb").read() == open(want, "rb").read()
    for a, b in zip(rmm.read_ply(got), jrmm.read_ply(want)):
        assert np.array_equal(a, b)
    for r, pf in ((0, False), (1, True)):
        out_p = rmm.reformat_ply(got, str(tmp_path / f"rp{r}.ply"), r=r,
                                 is_point_flow_data=pf, ascii=ascii_ply)
        out_j = jrmm.reformat_ply(want, str(tmp_path / f"rj{r}.ply"), r=r,
                                  is_point_flow_data=pf, ascii=ascii_ply)
        assert open(out_p, "rb").read() == open(out_j, "rb").read()
    src = np.random.RandomState(5).randn(40, 3)
    assert np.array_equal(rmm.standardize_to_same_range(got, src),
                          jrmm.standardize_to_same_range(want, src))


@pytest.mark.parametrize("material_id", [0, 1, 2, 4, 5, 6, 7])
def test_mesh_scene_xml_equals_lion_tpu(material_id):
    kw = dict(material_id=material_id, colorm=(10, 200, 30),
              lookat=(3, 2, 3), sample_count=32, width=64, height=48)
    assert rmm.mesh_scene_xml("mesh.ply", **kw) == \
        jrmm.mesh_scene_xml("mesh.ply", **kw)


def test_voxel_cubes_equal_lion_tpu(tmp_path):
    centers = np.random.RandomState(6).randint(0, 8, size=(12, 3)) * 0.1
    for rot in (None, 1.0):
        va, fa, ea = rmm.cubes_to_mesh(centers, 0.1, rot)
        vb, fb, eb = jrmm.cubes_to_mesh(centers, 0.1, rot)
        assert np.array_equal(va, vb) and np.array_equal(fa, fb) and ea == eb
    got = rmm.render_voxel_cubes(centers, 0.1, str(tmp_path / "p" / "c.png"))
    want = jrmm.render_voxel_cubes(centers, 0.1,
                                   str(tmp_path / "j" / "c.png"))
    assert got.endswith("c.xml") and want.endswith("c.xml")
    for suffix in ("c.xml", "c_cubes.ply"):
        a = open(str(tmp_path / "p" / suffix), "rb").read()
        b = open(str(tmp_path / "j" / suffix), "rb").read()
        assert a == b.replace(str(tmp_path / "j").encode(),
                              str(tmp_path / "p").encode()), suffix


@pytest.mark.parametrize("name,args", [
    ("CHECK2D", ((2, 3),)), ("CHECK3D", ((2, 3, 4),)),
    ("CHECK4D", ((2, 3, 4, 5),)), ("CHECK5D", ((1, 2, 3, 4, 5),)),
    ("CHECKDIM", ((2, 3, 4), 2, 4)),
    ("CHECKSIZE", ((2, 3, 4), (2, 3, [3, 4]))),
])
def test_checker_fires_as_lion_tpus(name, args):
    """Each assert passes on its shape and fires on another rank or size
    where lion_tpu's does, with the same error and message."""
    shape, *rest = args
    probes = (shape, shape[:-1], shape + (1,),
              tuple(s + 1 for s in shape))
    fired = []
    for probe in probes:
        x = np.zeros(probe)
        outcomes = []
        for mod in (checker, jchecker):
            try:
                getattr(mod, name)(x, *rest)
                outcomes.append(None)
            except (AssertionError, IndexError) as err:
                outcomes.append((type(err).__name__, str(err)))
        assert outcomes[0] == outcomes[1], (name, probe)
        fired.append(outcomes[0] is not None)
    assert fired[0] is False and any(fired[1:]), (name, fired)
    checker.CHECKEQ(3, 3)
    with pytest.raises(AssertionError, match="expect 3 == 4"):
        checker.CHECKEQ(3, 4)


def test_new_modules_import_no_jax():
    """The data-parallel, conditioning and figure modules import neither
    JAX nor lion_tpu, and transformers only when a real CLIP encoder is
    built."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, lion_tpu_torch.parallel.dist, "
            "lion_tpu_torch.utils.clip_helper, lion_tpu_torch.utils.checker, "
            "lion_tpu_torch.utils.render_mitsuba, "
            "lion_tpu_torch.utils.render_mitsuba_mesh, "
            "lion_tpu_torch.trainers.train_2prior;"
            "bad = [m for m in ('jax', 'flax', 'lion_tpu', 'transformers') "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
