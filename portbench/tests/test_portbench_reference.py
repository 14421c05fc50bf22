"""The plain reference against the port at a tiny size on the CPU (the
port's plain versions): float32 on both sides agrees to rounding."""
import numpy as np
import pytest
import torch

from benchlib import bench

CPU = torch.device("cpu")


def _learner():
    return bench.load_module(bench.HERE / "drivers" / "learner.py",
                             "pb_learner")


@pytest.mark.parametrize("moe", [False, True])
def test_learner_reference_matches_port(train_cell, moe):
    drv = _learner()
    cell = train_cell(moe=moe)
    for seed in (1, 2 ** 31 + 5):
        from benchlib import compare
        got = compare.train_numbers(drv.program_readings(cell, seed, CPU),
                                    drv.reference(cell, seed, CPU))
        assert max(got.values()) < 1e-5, got


def test_threefry_matches_port():
    from repro_torch.core import prng
    from reference import threefry
    k = prng.fold_in(prng.fold_in(prng.key(3000000007 & 0xFFFFFFFF), 17), 513)
    want = prng.gumbel(k, (1000,))
    got = threefry.token_noise(3000000007, 17, 513, 1000, CPU)
    assert torch.allclose(got, want, atol=1e-5, rtol=0)


def test_served_tokens_match_reference(rollout_cell):
    drv = bench.load_module(bench.HERE / "drivers" / "rollout.py",
                            "pb_rollout")
    out = drv.run(rollout_cell(), 3000000007, 0.5, False, CPU, 0.0)
    assert out["correct"], out["checks"]
    assert out["checks"]["token_gap"]["value"] < 1e-4
    assert np.isfinite(out["e2e"]["itl_p95_ms"])
