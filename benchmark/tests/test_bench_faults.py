"""The check of `correct` has to fail what it guards against. Each test
runs a cell at small sizes on the CPU (the harness's look for a card is
skipped; the port runs its kernels' plain versions) with the timed path
broken underneath, and sees `correct` come out false with a number far
above both its limit and the same run's reading without the fault:

- every fault the cell's kind can have (its family's `OF_KIND`; LION's
  `benchmark.faults`): a step that returns its state unchanged; Adam's
  moments formed but the parameters left unchanged (a learning rate of 0);
  half of the batch left out, the loss the mean over the rest; an answer
  altered where it is produced;
- the control (its family's `CONTROL`): for LION the program's own bf16
  path (`tpu.bf16`), the nearest precision below the configurations'
  float32.
"""
import contextlib

import pytest

from benchmark.harness import cell_of, family_of, manifest, run_cell

MAN = manifest()
CELLS = [w["name"] for w in MAN["workloads"]]


def _family(cell):
    _, conf, mix = cell_of(MAN, cell)
    return family_of(conf), mix["kind"]


CASES = [(cell, fault) for cell in CELLS
         for family, kind in [_family(cell)]
         for fault in family.OF_KIND[kind] + ("control",)]
_SOUND = {}


def _run(cell, fault=None):
    family, kind = _family(cell)
    keys = dict(family.TINY,
                **(family.CONTROL if fault == "control" else {}))
    ctx = family.FAULTS[fault](kind) if fault in family.FAULTS else \
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
