"""The check catches a broken timed path: each fault that a cell can have
is planted under a run (``faults.py``) and ``correct`` comes out false;
the program itself comes out correct. On the card the control, the
reference in the precision below the configuration's in the program's
place, comes out not correct at the cells' own sizes."""

import pytest

from conftest import SMALL

from portbench import readings

FAULTS = {"omniglot-5w5s-serve-b64": ("answer", "half_batch", "one_slot"),
          "omniglot-5w5s-train-fused": ("unchanged", "half_batch", "lr"),
          "particles2d-vpg-serve-b64": ("answer", "half_batch", "one_slot")}
CASES = [(cell, fault) for cell, faults in sorted(FAULTS.items())
         for fault in faults]


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_program_is_correct(cell):
    out = readings.read(cell, 2 ** 31 + 3, "program", 0.3, device="cpu",
                        overrides=SMALL[cell])
    assert out["correct"], out


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    out = readings.read(cell, 2 ** 31 + 3, fault, 0.3, device="cpu",
                        overrides=SMALL[cell])
    assert not out["correct"], out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_control_fails_on_the_card(cell, card):
    for seed in (3000000001, 3000000002, 3000000003):
        program = readings.read(cell, seed, "program", 1.0)
        control = readings.read(cell, seed, "control", 1.0)
        assert program["correct"], program
        assert not control["correct"], control
