"""A model family plugs into the benchmark as new files only.

- A toy family held in `benchmark/tests/toy/` (a two-layer MLP denoiser of
  points with its own plain reference, weights, traffic kind, check, work
  counter and kernel group) runs end to end through `harness.run_cell` on
  the CPU; the test hands the harness the toy's manifest and its directory,
  found before the benchmark's own.
- LION, through its family file, gives at small sizes on the CPU exactly
  the numbers the harness gave before the families: the weights of one
  seed, every number the check reads in a sampling and a training run, and
  the work counters (pinned from that harness, two PyTorch threads).
- One roofline formula: on a synthetic trace `readers.roofline` over the
  convolutions' groups is `conv_roofline`, and a family's kernel pattern
  wins over the library kernels' fallbacks.
"""
import hashlib
import json
from pathlib import Path

import pytest

from benchmark import harness, readers, trace, work
from benchmark.harness import BENCH, run_cell

TOY = Path(__file__).resolve().parent / "toy"
DIRS = (TOY, BENCH)
TOY_MAN = json.loads((TOY / "manifest.json").read_text())
CELL = "toy-mlp.denoise"
MAN = harness.manifest()


def toy_family():
    return harness.family_of(harness.cell_of(TOY_MAN, CELL, DIRS)[1],
                             dirs=DIRS)


def toy_run(trace_on=False, keys=None):
    return run_cell(CELL, 2 ** 31 + 123, 0.05, trace_on, device="cpu",
                    keys=keys, readings=True, man=TOY_MAN, dirs=DIRS)


@pytest.mark.parametrize("trace_on", [False, True])
def test_a_new_family_runs_end_to_end(trace_on):
    r = toy_run(trace_on)
    assert r["correct"] is True, r["checks"]
    assert list(r) == ["correct", "attempted", "failed", "metrics",
                       "device"] + (["breakdown"] if trace_on else []) \
        + ["readings", "check_s", "diag", "checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"sample_gap", "plain_calls"}
    if trace_on:
        # the CPU has no device time: the roofline finds nothing to read
        assert r["metrics"] == {}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        # setup_s is the benchmark's own reader, the rate the toy's
        assert set(r["metrics"]) == {"setup_s", "toy_shapes_per_s"}
    assert harness.forbidden_loaded() == []


@pytest.mark.parametrize("fault", ["control", "altered"])
def test_a_new_familys_control_and_faults_fail(fault):
    family = toy_family()
    if fault == "control":
        r = toy_run(keys=family.CONTROL)
    else:
        with family.FAULTS[fault]("toy_denoise"):
            r = toy_run()
    assert r["correct"] is False
    assert r["checks"]["sample_gap"]["value"] > \
        10 * r["checks"]["sample_gap"]["limit"]


def test_a_new_familys_counter_beside_the_models_flops():
    _, conf, mix = harness.cell_of(TOY_MAN, CELL, DIRS)
    cfg = harness.config_of(conf)
    w = work.unit_work(cfg, mix, toy_family())
    # 2 x (4h + 3h) multiply-adds a point and step
    closed = 2 * mix["batch"] * cfg["points"] * 7 * cfg["hidden"] \
        * mix["steps"]
    assert w["model_flops"] == w["mlp_flops"] == closed
    assert w["conv_flops"] == 0 and w["mlp_least_s"] > 0


def test_a_new_family_is_new_files_only():
    # every file of the toy's cell is found in its own directory, laid out
    # as the benchmark's; the benchmark's readers serve the rest
    for sub, name in (("families", "toy.py"), ("mixes", "toy-denoise.json"),
                      ("metrics", "toy_shapes_per_s.py"),
                      ("metrics", "toy_mlp_roofline.py")):
        assert harness.find(sub, name, DIRS).parent.parent == TOY
    assert harness.find("metrics", "setup_s.py", DIRS).parent.parent == BENCH
    # and nothing of the benchmark outside them names the toy
    ours = {Path(__file__).resolve()}
    for path in BENCH.rglob("*"):
        if path.suffix not in (".py", ".json") or TOY in path.parents \
                or path.resolve() in ours:
            continue
        assert "toy" not in path.read_text(), path


def test_an_unknown_family_exits_naming_it(tmp_path):
    (tmp_path / "x.json").write_text(json.dumps(
        {"family": "no_such_family", "cfg": {}}))
    with pytest.raises(SystemExit, match="no_such_family"):
        harness.family_of({"name": "x", "file": "x.json"}, root=tmp_path)


def test_a_config_without_a_family_is_lion():
    for conf in MAN["configs"]:
        assert "family" not in harness.config_file(conf)
        family = harness.family_of(conf)
        assert Path(family.__file__) == BENCH / "families" / "lion.py"


def test_the_toy_reference_imports_nothing_of_its_program():
    src = harness.reference_path(toy_family()).read_text()
    assert "program" not in src and "lion_tpu" not in src
    assert "import jax" not in src and "from jax" not in src


# what the harness gave before the families (the same seeds and sizes)
LION_WEIGHTS_SHA256 = \
    "fa4d09257ba86fbfe0c8bc7b5f2272e43414c8f9f0983e90effbb8fdbf967378"
LION_READINGS = {
    "uncond-sample-ddim25-b64": {
        "global_eps": 0.0, "local_eps": 0.022633815184235573,
        "ddim_update": 1.3998845815876848e-07,
        "decode": 1.5848761449888116e-06,
        "chain_gap": 0.022633815184235573, "plain_calls": 0.0},
    "clip-train-prior-b40": {
        "loss": 2.1403005538455744e-07, "loss_step1": 0.0,
        "loss1_program": 2.2630298137664795,
        "loss1_reference": 2.2630298137664795,
        "grad": 1.0941147109020699e-05,
        "change": 0.00014473667798921516,
        "change_median": 4.67720489824257e-06,
        "prior_inputs": 9.044606485986151e-07,
        "ema_change": 9.867517631457626e-05,
        "ema_change_median": 1.0063760970380037e-07, "plain_calls": 0.0}}
LION_WORK = {
    "uncond-sample-ddim25-b64": {
        "model_flops": 17249558528.0, "conv_flops": 15783690240.0,
        "conv_bytes": 141269248.0, "conv_least_s": 0.00023557746626865766,
        "conv_calls": 260},
    "clip-train-prior-b40": {
        "model_flops": 5638840320.0, "conv_flops": 5179023360.0,
        "conv_bytes": 33712544.0, "conv_least_s": 7.729885611940304e-05,
        "conv_calls": 45},
    "uncond-train-vae-b32": {
        "model_flops": 11055820800.0, "conv_flops": 10165616640.0,
        "conv_bytes": 60568512.0, "conv_least_s": 0.00015172562149253746,
        "conv_calls": 76}}


def lion_tiny(cell):
    _, conf, mix = harness.cell_of(MAN, cell)
    family = harness.family_of(conf)
    return family, harness.set_keys(harness.config_of(conf),
                                    family.TINY), mix


def test_lion_weights_are_as_before():
    family, cfg, _ = lion_tiny("clip-train-prior-b40")
    state = family.make_weights(cfg, 2 ** 31 + 5, "cpu")
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(state[k].contiguous().numpy().tobytes())
    assert len(state) == 651
    assert h.hexdigest() == LION_WEIGHTS_SHA256


@pytest.mark.parametrize("cell", sorted(LION_READINGS))
def test_lion_check_numbers_are_as_before(cell):
    family, _, _ = lion_tiny(cell)
    r = run_cell(cell, 2 ** 31 + 77, 0.001, False, device="cpu",
                 keys=family.TINY, readings=True)
    assert r["readings"] == LION_READINGS[cell]


@pytest.mark.parametrize("cell", sorted(LION_WORK))
def test_lion_work_counts_are_as_before(cell):
    family, cfg, mix = lion_tiny(cell)
    assert work.unit_work(cfg, mix, family) == LION_WORK[cell]


def test_one_roofline_formula_and_family_groups():
    dev = [("void conv3d_brick_f32<64, 2, true>(Brick)", 0.0, 1.0),
           ("void k10_wgrad_tile<64, 32, float>(Wgrad)", 1.0, 1.5),
           ("void k10_wgrad_sum<float>(float const*, int, int)", 1.5, 1.6),
           ("sm90_xmma_wgrad_implicit_gemm_indexed", 2.0, 2.25),
           ("toy_mlp_gemm_kernel", 3.0, 3.5),
           ("sm90_xmma_gemm_f32f32_f32_nn_n", 4.0, 4.2)]
    groups = toy_family().GROUPS
    out = trace.reduce(dev, [], 0.0, 5.0, groups=groups)
    out["units"] = 2
    g = out["group_s"]
    assert g["K10 wgrad"] == pytest.approx(0.6)
    assert g["cuDNN wgrad"] == 0.25
    # the family's pattern wins over the fallback its name would meet
    assert g["toy mlp"] == 0.5 and g["cuBLAS matmul"] == pytest.approx(0.2)
    without = trace.reduce(dev, [], 0.0, 5.0)["group_s"]
    assert "toy mlp" not in without
    assert without["cuBLAS matmul"] == pytest.approx(0.7)
    # group_s holds every group; conv_s is its convolutions' share
    assert out["conv_s"] == sum(v for k, v in g.items()
                                if k in trace.CONV_GROUPS)
    assert len(g) == 5
    w = {"trace": out, "work_of_unit": {"conv_least_s": 0.3,
                                        "mlp_least_s": 0.1}}
    conv = readers.roofline(w, "conv_least_s", trace.CONV_GROUPS)
    assert conv == readers.conv_roofline(w) == \
        harness.reader("conv3d_roofline.sample")(w) == \
        100.0 * 0.3 * 2 / out["conv_s"]
    assert harness.reader("toy_mlp_roofline", DIRS)(w) == \
        pytest.approx(100.0 * 0.1 * 2 / 0.5)
    # a formula that finds nothing to read returns nothing
    assert readers.roofline(w, "attn_least_s", ("toy mlp",)) is None
    assert readers.roofline(w, "mlp_least_s", ("no such group",)) is None
    assert readers.roofline({}, "mlp_least_s", ("toy mlp",)) is None


def test_family_groups_come_after_the_ports_kernels():
    # a pattern that also matches a port kernel leaves it in its group
    assert trace.group("fps_kernel", {"fps": "mine"}) == "K1 fps"
    assert trace.group("my_fps_gemm", {"my_fps": "mine"}) == "mine"
