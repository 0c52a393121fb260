"""The benchmark's tests on the card (marker `gpu`; skipped without CUDA):
each cell at its own size comes out correct for a short window, and its
control (its family's `CONTROL`: for LION the program's bf16 path) fails
the check on three seeds.

    python -m pytest benchmark/tests/test_bench_gpu.py -m gpu
"""
import pytest
import torch

from benchmark.harness import cell_of, family_of, manifest, run_cell

MAN = manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(cell):
    _card()
    r = run_cell(cell, 2 ** 31 + 4242, 3.0, False)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["failed"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    _card()
    control = family_of(cell_of(MAN, cell)[1]).CONTROL
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        r = run_cell(cell, seed, 0.001, False, keys=control)
        assert r["correct"] is False, r["checks"]
