"""The controls of ``correct`` at a size a test run holds: the reference
computed in float8 in the program's place reads far above the program
(bf16 products), on three seeds.  At the cells' own size the readings
come from ``calibrate.py`` on the card (PERF.md)."""
import pytest
import torch

from benchlib import bench, compare

CPU = torch.device("cpu")
SEEDS = (7, 2 ** 31 + 1, 2 ** 32 + 9)


@pytest.mark.parametrize("moe", [False, True])
def test_learner_control_fails_far_above_program(train_cell, moe):
    drv = bench.load_module(bench.HERE / "drivers" / "learner.py",
                            "pb_control")
    cell = train_cell(dtype="bfloat16", moe=moe)
    for seed in SEEDS:
        ref = drv.reference(cell, seed, CPU)
        prog = compare.train_numbers(drv.program_readings(cell, seed, CPU),
                                     ref)
        ctrl = compare.train_numbers(
            drv.reference(cell, seed, CPU, "fp8"), ref)
        assert max(ctrl[k] / max(prog[k], 1e-12) for k in ctrl) >= 3.0, \
            (seed, prog, ctrl)


def test_rollout_control_fails_far_above_program(rollout_cell):
    drv = bench.load_module(bench.HERE / "drivers" / "rollout.py",
                            "pb_control_r")
    cell = rollout_cell(dtype="bfloat16")
    for seed in SEEDS:
        got = dict(drv.calibrate(cell, seed, CPU, True, 0.3))
        assert got["fp8"]["token_gap"] >= 3.0 * got["program"]["token_gap"], \
            (seed, got)
