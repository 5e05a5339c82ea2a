"""The plain reference against the port on the tiny towers, and the check's verdict on a broken
timed path: whole runs of each cell on the CPU (the run's look for a card skipped)."""

from __future__ import annotations

import pytest

from portbench import faults, harness
from portbench.tests import tiny

CELLS = ["clipfsar_vitb16.train_bank", "clipfsar_rn50.train_bank", "clipfsar_vitb16.test_bank", "clipfsar_rn50.test_bank"]
SEED = 2**31 + 977  # past 32 signed bits: a run takes any seed a 64-bit generator takes


@pytest.fixture(scope="module")
def splits(tmp_path_factory):
    return tiny.write_splits(str(tmp_path_factory.mktemp("splits")))


def run(cell: str, splits: str, fp32: bool = False, precision: str = "fp32", fault=None) -> dict:
    readings: dict = {}
    out = harness.run_cell(cell, SEED, 1.0, False, "cpu", config_file=tiny.config(cell.split(".")[0], splits, fp32),
                           precision=precision, fault=fault, readings_out=readings)
    return {"correct": out["correct"], **readings}


# float32 program against the float32 reference: summation order apart, the same numbers.  The RN
# tower's gradient reads 1e-3 to 1e-2 on its stem's BatchNorm bias: the port's variance is the fast
# E[x^2] - E[x]^2 (models/clip/model.py), the reference's the two-pass one.
FP32_TOLERANCE = {"loss_gap": 1e-5, "grad_gap": 1e-5, "moment_gap": 1e-5, "descent_gap": 1e-5, "logit_gap": 1e-5}
FP32_TOLERANCE_RN = {"loss_gap": 1e-5, "grad_gap": 2e-2, "moment_gap": 2e-2, "moment_norm_gap": 1e-4, "descent_gap": 1e-3,
                     "logit_gap": 1e-5}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_matches_the_port_in_fp32(cell, splits):
    got = run(cell, splits, fp32=True)
    tol = FP32_TOLERANCE_RN if "rn50" in cell else FP32_TOLERANCE
    for key, limit in tol.items():
        if key in got:
            assert got[key] <= limit, (key, got[key])
    assert got["bad_rows"] == 0


@pytest.mark.parametrize("cell", ["clipfsar_vitb16.train_bank", "clipfsar_rn50.test_bank"])
def test_control_reads_far_above_the_program(cell, splits):
    """The fp8 control in the program's place reads three times the bf16 program or more."""
    program, control = run(cell, splits), run(cell, splits, precision="fp8")
    keys = ["loss_gap", "grad_gap"] if "train" in cell else ["logit_gap"]
    for key in keys:
        assert control[key] >= 3 * program[key], (key, program[key], control[key])


TRAIN_FAULTS, TEST_FAULTS = faults.TRAIN, faults.TEST
# The RN50 cell does not compare the update's direction (bf16 rounding sets the sign of its first
# Adam update where gradients cancel); the ViT cell holds the shared optimizer to it.
TRAIN_CASES = [(c, f) for c in ("clipfsar_vitb16.train_bank", "clipfsar_rn50.train_bank") for f in sorted(TRAIN_FAULTS)
               if (c, f) != ("clipfsar_rn50.train_bank", "reversed_update")]


@pytest.fixture(scope="module")
def sound():
    """The unbroken run of each cell in float32, once: every number near 0, so what a fault flips is its own doing."""
    cache: dict = {}

    def get(cell: str, splits: str) -> dict:
        if cell not in cache:
            cache[cell] = run(cell, splits, fp32=True)
        return cache[cell]

    return get


def flipped(cell: str, sound_run: dict, broken: dict) -> list:
    """The numbers that the unbroken run passes and the broken one fails."""
    limits = harness.cell_spec(harness.benchmark(), cell)["limits"]
    return [k for k, lim in limits.items() if sound_run[k] <= lim < broken[k]]


@pytest.mark.parametrize("cell,fault", TRAIN_CASES)
def test_a_broken_train_step_is_not_correct(cell, fault, splits, sound):
    broken = run(cell, splits, fp32=True, fault=TRAIN_FAULTS[fault])
    assert broken["correct"] is False and flipped(cell, sound(cell, splits), broken)


@pytest.mark.parametrize("fault", sorted(TEST_FAULTS))
def test_a_broken_eval_step_is_not_correct(fault, splits, sound):
    cell = "clipfsar_rn50.test_bank"
    broken = run(cell, splits, fp32=True, fault=TEST_FAULTS[fault])
    assert broken["correct"] is False and flipped(cell, sound(cell, splits), broken)
