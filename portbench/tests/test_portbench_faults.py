"""A run with the timed path broken underneath comes out not correct,
under each cell kind's own limits (``portbench/limits``), while the
sound run at the same size comes out correct."""
import pytest
import torch

from benchlib import bench

CPU = torch.device("cpu")


def _limits(kind):
    b = bench.benchmark()
    for w in b["workloads"]:
        c = bench.cell(b, w["name"])
        if c["traffic"]["driver"] == kind:
            return c["limits"]
    pytest.skip(f"no {kind} cell in BENCHMARK.json")


def _drv(kind):
    return bench.load_module(bench.HERE / "drivers" / f"{kind}.py",
                             f"pb_fault_{kind}")


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_learner_faults(train_cell, fault):
    cell = train_cell(limits=_limits("learner"))
    out = _drv("learner").run(cell, 2 ** 31 + 11, 0.2, False, CPU, 0.0,
                              fault=fault)
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "token_altered",
                                   "state_unchanged"])
def test_rollout_faults(rollout_cell, fault):
    cell = rollout_cell(limits=_limits("rollout"))
    out = _drv("rollout").run(cell, 2 ** 31 + 13, 1.0, False, CPU, 0.0,
                              fault=fault)
    assert out["correct"] is (fault is None), out["checks"]
