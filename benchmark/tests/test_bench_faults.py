"""The check of `correct` has to fail what it guards against. Each test
runs a cell at small sizes on the CPU (the harness's look for a card is
skipped; the port runs its kernels' plain versions) with the timed path
broken underneath, and sees `correct` come out false with a number far
above both its limit and the same run's reading without the fault:

- every fault the cell's kind can have (`benchmark.faults.OF_KIND`): a step
  that returns its state unchanged; Adam's moments formed but the
  parameters left unchanged (a learning rate of 0); half of the batch left out, the loss
  the mean over the rest; an answer altered where it is produced;
- the control: the program's own bf16 path (`tpu.bf16`), the nearest
  precision below the configurations' float32.
"""
import contextlib

import pytest

from benchmark.faults import FAULTS, OF_KIND
from benchmark.harness import cell_of, manifest, run_cell
from benchmark.tests.tiny import KEYS

MAN = manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
CASES = [(cell, fault) for cell in CELLS
         for fault in OF_KIND[cell_of(MAN, cell)[2]["kind"]] + ("control",)]
_SOUND = {}


def _run(cell, fault=None):
    kind = cell_of(MAN, cell)[2]["kind"]
    keys = dict(KEYS, **({"tpu.bf16": True} if fault == "control" else {}))
    ctx = FAULTS[fault](kind) if fault in FAULTS else \
        contextlib.nullcontext()
    with ctx:
        return run_cell(cell, 2 ** 31 + 77, 0.001, False, device="cpu",
                        keys=keys, readings=True)


def sound(cell):
    if cell not in _SOUND:
        _SOUND[cell] = _run(cell)
    return _SOUND[cell]


@pytest.mark.parametrize("cell,fault", CASES)
def test_check_fails_the_fault(cell, fault):
    base = sound(cell)["readings"]
    bad = _run(cell, fault)
    assert bad["correct"] is False
    over = [k for k, c in bad["checks"].items()
            if c["value"] > c["limit"] and c["value"] > 10 * base[k]]
    assert over, (bad["checks"], base)
