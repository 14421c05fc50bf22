"""One run of each cell on the card through the benchmark's command,
at the benchmark's own window (a shorter one finishes no rollout request
to judge); skips without a card."""
import json
import subprocess
import sys

import pytest

from benchlib import bench


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  bench.benchmark()["workloads"]])
def test_cell_runs_on_the_card(card, name):
    import torch
    b = bench.benchmark()
    chips = bench.cell(b, name)["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"{name} needs {chips} cards")
    out = subprocess.run(
        [sys.executable, str(bench.HERE / "run.py"), "--workload", name,
         "--seed", "4000000001", "--seconds", str(b["run_seconds"]),
         "--trace", "0"],
        cwd=bench.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
