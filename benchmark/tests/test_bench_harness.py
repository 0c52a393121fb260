"""CPU tests of the benchmark's harness: the manifest's form, that every
cell's files are found by name, the window arithmetic, the trace reduction,
the import rule, and that a run without a card fails."""
import json
import re
import subprocess
import sys

import pytest
import torch

from benchmark import harness, trace
from benchmark.harness import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def test_manifest_names_and_units():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in MAN["configs"]]
    names += [w["name"] for w in MAN["workloads"]]
    names += [w["traffic"] for w in MAN["workloads"]]
    for c in MAN["configs"]:
        names += c["reduced"]
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    names += [m["name"] for m in metrics]
    for n in names:
        assert NAME.match(n), n
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in MAN[group]]
        assert len(seen) == len(set(seen))
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_metrics_name_their_cells_and_moves():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(cell):
    c, conf, mix = harness.cell_of(MAN, cell)
    cfg = harness.config_of(conf)
    family = harness.family_of(conf)
    assert conf["file"].startswith("benchmark/configs/")
    assert mix["kind"] in family.KINDS
    assert mix["limits"], "a cell's mix states its limits"
    for trace_on in (False, True):
        ms = harness.metrics_for(MAN, cell, trace_on)
        assert ms
        for m in ms:
            assert callable(harness.reader(m["name"]))
    assert family.port_config(cfg) is not None


def test_config_files_hold_the_released_widths():
    lion = [c for c in MAN["configs"]
            if harness.config_file(c).get("family", "lion") == "lion"]
    assert lion
    for conf in lion:
        cfg = harness.config_of(conf)
        assert cfg["data"]["tr_max_sample_points"] == 2048
        assert harness.family_of(conf).port_config(cfg) \
            .sde.num_channels_dae == 2048
        assert cfg["sde"]["num_channels_dae"] == 2048
        assert cfg["latent_pts"]["style_dim"] == 128
        assert cfg["tpu"]["bf16"] is False
        assert not cfg["tpu"]["sa_blocks"] and not cfg["tpu"]["fp_blocks"]
        assert cfg["tpu"]["vres_mult"] == cfg["tpu"]["ncenter_mult"] == 1.0


def test_rate_and_p95_over_a_window_with_a_stall():
    # nine requests of 1 s, one stalled for 10 s, back to back from t0 = 0
    recs, t = [], 0.0
    for i in range(10):
        d = 10.0 if i == 4 else 1.0
        recs.append((t, t + d, 32, {"local": d}))
        t += d
    w = harness.window_numbers(0.0, recs)
    assert w["window_s"] == 19.0
    assert w["rate"] == pytest.approx(320 / 19.0)
    # the tail sees the stall: the 95th percentile of ten latencies lies
    # between the 9th and the 10th order statistics
    assert w["p95_s"] == pytest.approx(1.0 + 0.55 * 9.0)
    w["kind"], w["mix"] = "sample", {"ddim_step": 25}
    assert harness.reader("sample_shapes_per_s")(w) == w["rate"]
    assert harness.reader("sample_request_p95_s")(w) == w["p95_s"]
    # the manifest, not the reader, routes a metric to its cells
    sampling = [m["name"] for m in harness.metrics_for(
        MAN, "uncond-sample-ddim25-b64", False)]
    assert "vae_train_samples_per_s" not in sampling
    assert "sample_shapes_per_s" in sampling


def test_idle_share_from_a_synthetic_trace():
    dev = [("conv3d_brick_f32<64, 2, true>", 0.0, 1.0),
           ("void at::native::vectorized_elementwise_kernel", 0.5, 2.0),
           ("fps_kernel", 3.0, 4.0),
           ("sm90_xmma_wgrad_fp32", 6.0, 7.0)]
    host = [("aten::conv3d", -0.1, 0.1), ("cudaStreamSynchronize", 2.1, 2.9),
            ("aten::randn", 4.5, 4.6)]
    out = trace.reduce(dev, host, 0.0, 8.0)
    assert out["busy_s"] == pytest.approx(4.0)
    assert out["window_s"] == 8.0
    assert out["conv_s"] == pytest.approx(2.0)
    # each gap is labelled by the host event begun last before it
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"aten::conv3d": 1.0,            # 2 .. 3
         "cudaStreamSynchronize": 2.0,   # 4 .. 6
         "aten::randn": 1.0})            # 7 .. 8
    ops = dict(out["device_ops"])
    assert ops["K4 conv3d_3x3_fused"] == 1.0
    assert ops["cuDNN wgrad"] == 1.0
    w = {"kind": "sample", "trace": out, "unit_rate": 0.5,
         "work_of_unit": {"conv_least_s": 0.5, "model_flops": 67e12}}
    out["units"] = 2
    assert harness.reader("device.idle_share.sample")(w) == \
        pytest.approx(50.0)
    assert harness.reader("conv3d_roofline.sample")(w) == \
        pytest.approx(50.0)
    assert harness.reader("mfu.sample")(w) == pytest.approx(50.0)
    # a reader that finds nothing to read returns nothing
    assert harness.reader("device.idle_share.vae_train")({}) is None
    assert harness.reader("conv3d_roofline.vae_train")({}) is None
    assert harness.reader("mfu.vae_train")({}) is None


def test_kernel_groups():
    assert trace.group("void conv3d_brick_f32<32, 8, false>(...)") == \
        "K10 conv3d_3x3_same"
    assert trace.group("void conv3d_brick_f32<32, 8, true>(...)") == \
        "K4 conv3d_3x3_fused"
    # cuBLAS's GEMMs are not the convolutions' kernels
    assert trace.group("sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n") == \
        "cuBLAS matmul"
    assert trace.group("sm90_xmma_wgrad_implicit_gemm_indexed") == \
        "cuDNN wgrad"
    assert trace.group("cudnn::engines_precompiled::nchwToNhwcKernel") == \
        "cuDNN other"
    # the port's own weight gradient of K10 (csrc/conv3d_wgrad.cu), one of
    # the convolutions' groups
    for name in ("void k10_wgrad_tile<64, 32, float>(Wgrad)",
                 "void k10_wgrad_sum<float>(float const*, int, int)"):
        assert trace.group(name) == "K10 wgrad"
    assert "K10 wgrad" in trace.CONV_GROUPS


def test_import_rule_compares_whole_top_level_names():
    ok = {"lion_tpu_torch": 0, "lion_tpu_torch.ops": 0, "torch": 0,
          "jaxtyping": 0, "flaxen": 0}
    assert harness.forbidden_loaded(ok) == []
    bad = dict(ok, **{"lion_tpu.ops": 0, "jax.numpy": 0, "flax": 0,
                      "jaxlib": 0})
    assert harness.forbidden_loaded(bad) == ["flax", "jax", "jaxlib",
                                             "lion_tpu"]


def test_the_benchmark_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.run, "
            "benchmark.harness, benchmark.check, benchmark.traffic, "
            "benchmark.work, benchmark.calibrate, benchmark.spread, "
            "benchmark.readers, benchmark.families.lion, "
            "lion_tpu_torch.models, "
            "lion_tpu_torch.trainers; from benchmark.harness import "
            "forbidden_loaded; print(forbidden_loaded())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def reference_sources(family):
    """The .py files of a family's plain reference."""
    ref = harness.reference_path(family)
    return sorted(ref.rglob("*.py")) if ref.is_dir() else [ref]


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (BENCH / "families").glob("*.py")
    if p.stem != "__init__"))
def test_reference_imports_nothing_of_the_program(name):
    sources = reference_sources(harness.load_family(name))
    assert sources
    for path in sources:
        src = path.read_text()
        # lion_tpu_torch (the program) and lion_tpu (the JAX package)
        assert "lion_tpu" not in src, path
        assert "import jax" not in src and "from jax" not in src, path


def test_a_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "uncond-sample-ddim25-b64", "--seed", "3", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0
    assert "no fallback to the CPU" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_spread_reads_the_card_inside_the_window(tmp_path):
    from datetime import datetime
    from benchmark import spread
    smi = tmp_path / "run.smi"
    smi.write_text("2026/10/18 13:00:00.000, 1755, 690.5, 60, 0x4\n"
                   "2026/10/18 13:00:01.000, 1980, 440.0, 55, 0x0\n"
                   "2026/10/18 13:00:02.000, 1980, 450.0, 57, 0x0\n"
                   "No devices were found\n")
    t0 = datetime(2026, 10, 18, 13, 0, 0, 500000).timestamp()
    card = spread.card_readings(smi, spread.FIELDS + ["reasons"], t0,
                                t0 + 2.0)
    assert card == {"samples": 2, "sm_mhz_mean": 1980.0,
                    "sm_mhz_min": 1980.0, "power_w_mean": 445.0,
                    "temp_c_max": 57.0, "reasons": ["0x0"]}
    # the interquartile range over the median, as the bounds are set
    assert spread.spread([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]) == \
        pytest.approx((5.25 - 1.75) / 3.5)
