"""The port's native `.npy` reader (data/native.py over its own copy of the
C++ source, lion_tpu_torch/csrc/npy_loader.cpp, built with g++) against
lion_tpu's reader and `np.load` on the CPU: float32 and float64 files, row
truncation, several thread counts, the files the reader refuses (numpy
reads them) and a missing file; the build (keyed by the source, a failed
build raising with g++'s output, apart from the CUDA kernels' library);
and the ShapeNet15k loader's batches over the reader, bit-equal to
lion_tpu's with its reader on.
"""
from pathlib import Path

import numpy as np
import pytest

from lion_tpu.config import get_default_cfg as jax_default_cfg
from lion_tpu.data import native as jnative
from lion_tpu.data import shapenet as jshapenet

from lion_tpu_torch.config import get_default_cfg
from lion_tpu_torch.data import native, shapenet
from lion_tpu_torch.ops import _cuda

from test_torch_port_sample import one_torch_thread, ROOT  # noqa: F401
from test_torch_port_trainer import trainer_cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seven clouds of 300 x 3: float32, one float64, one of 500 rows."""
    d = tmp_path_factory.mktemp("npy")
    rs = np.random.RandomState(0)
    paths = []
    for i in range(7):
        rows = 500 if i == 4 else 300
        a = rs.randn(rows, 3) * 0.3
        a = a if i == 2 else a.astype(np.float32)
        paths.append(str(d / f"{i}.npy"))
        np.save(paths[-1], a)
    return paths


def _np_batch(paths, n, dims=3):
    return np.stack([np.load(p)[:n, :dims].astype(np.float32)
                     for p in paths])


@pytest.mark.parametrize("threads", [0, 1, 3, 16])
@pytest.mark.parametrize("n", [300, 128])
def test_load_npy_batch_equals_lion_tpu_and_numpy(files, threads, n):
    got = native.load_npy_batch(files, n, n_threads=threads)
    assert got.dtype == np.float32 and got.shape == (7, n, 3)
    assert np.array_equal(got, jnative.load_npy_batch(files, n,
                                                      n_threads=threads))
    assert np.array_equal(got, _np_batch(files, n))


def test_files_the_reader_refuses_are_read_by_numpy(tmp_path, files):
    """Fewer rows than asked for is refused by the reader (numpy then
    fails as lion_tpu's does); an int file, a Fortran-order file and other
    columns are read by numpy, as lion_tpu reads them."""
    rs = np.random.RandomState(1)
    odd = {"int": rs.randint(-5, 5, (300, 3)),
           "fortran": np.asfortranarray(rs.randn(300, 3).astype(np.float32)),
           "wide": rs.randn(300, 5).astype(np.float32)}
    for name, a in odd.items():
        p = str(tmp_path / f"{name}.npy")
        np.save(p, a)
        paths = files[:2] + [p]
        got = native.load_npy_batch(paths, 300)
        assert np.array_equal(got, jnative.load_npy_batch(paths, 300))
        assert np.array_equal(got, _np_batch(paths, 300))
    assert native.npy_shape(str(tmp_path / "int.npy")) is None
    assert native.npy_shape(str(tmp_path / "wide.npy")) == (300, 5)
    assert native.npy_shape(files[4]) == (500, 3)
    with pytest.raises(ValueError):
        native.load_npy_batch(files, 400)
    with pytest.raises(ValueError):
        jnative.load_npy_batch(files, 400)


def test_a_missing_file_raises_as_in_lion_tpu(tmp_path, files):
    paths = files[:3] + [str(tmp_path / "missing.npy")]
    for load in (native.load_npy_batch, jnative.load_npy_batch):
        with pytest.raises(FileNotFoundError):
            load(paths, 100, n_threads=2)
    assert native.npy_shape(paths[-1]) is None


def test_the_reader_is_built_from_the_ports_source(monkeypatch, tmp_path):
    lib = native.build()
    assert lib == native.library_path() and lib.exists()
    assert lib.parent == Path(ROOT).resolve() / "build" / "lion_tpu_torch"
    # the port's copy: the JAX package's reader below its header
    src = native.SOURCE.read_text()
    jax_src = (Path(ROOT) / "csrc" / "npy_loader.cpp").read_text()
    body = "// Exposed C ABI"
    assert src[src.index(body):] == jax_src[jax_src.index(body):]
    # the CUDA kernels' library neither builds nor hashes it
    assert native.SOURCE.parent == _cuda.CSRC
    assert all(s.suffix in (".cu", ".cuh") for s in _cuda._sources())
    # another source is another library, and a failed build raises with
    # the compiler's output
    bad = tmp_path / "npy_loader.cpp"
    bad.write_text(src + "\nint broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert native.library_path() != lib
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed .*error"):
        native.build()
    assert not (tmp_path / "build" / native.library_path().name).exists()


def _tree(root, dtype):
    rs = np.random.RandomState(2)
    for split, count in [("train", 8), ("val", 4), ("test", 4)]:
        d = root / "02691156" / split
        d.mkdir(parents=True)
        for i in range(count):
            np.save(str(d / f"mesh{i}.npy"),
                    (rs.randn(2048, 3) * 0.2 + 0.05).astype(dtype))
    return str(root)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_loader_over_the_reader_equals_lion_tpus(tmp_path, dtype):
    """The datasets' clouds and the loaders' batches bit-equal to
    lion_tpu's with its reader on, over float32 and float64 files (the
    reader casts float64 to float32 before the normalization)."""
    root = _tree(tmp_path / "data", dtype)
    assert jnative.native_available()
    cfgs = [trainer_cfg(c, str(tmp_path), root)
            for c in (get_default_cfg(), jax_default_cfg())]
    for cfg in cfgs:
        cfg.data.recenter_per_shape = False
        cfg.data.normalize_global = True
    got = shapenet.get_data_loaders(cfgs[0].data, seed=3)
    want = jshapenet.get_data_loaders(cfgs[1].data, seed=3)
    gds, wds = got["train_loader"].dataset, want["train_loader"].dataset
    assert gds.all_points.dtype == np.float32
    assert np.array_equal(gds.all_points, wds.all_points)
    assert np.array_equal(gds.all_points_std, wds.all_points_std)
    for name in ("train_loader", "test_loader"):
        for g, w in zip(got[name], want[name]):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
