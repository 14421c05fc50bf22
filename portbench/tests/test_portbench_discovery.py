"""Cells, traffic mixes, configurations and metrics are found by name."""
import json
import shutil

from benchlib import bench


def test_every_cell_resolves():
    b = bench.benchmark()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        c = bench.cell(b, w["name"])
        drv = bench.driver(c["traffic"])
        assert callable(drv.run) and callable(drv.calibrate)
        assert c["config"]["name"] == w["config"]
        assert set(c["limits"]) <= {"loss1_gap", "grad_gap", "update1_gap",
                                    "token_gap"}
        names = {m["name"] for m in c["end_to_end"]}
        assert "setup_s" in names and len(names) >= 2
        for m in c["per_layer"]:
            assert m["moves"] in e2e and m["moves"] in names
            assert callable(bench.reader(m["name"]))


def test_new_files_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "portbench"
    b = bench.benchmark()
    w = b["workloads"][0]
    base = bench.cell(b, w["name"])
    (here / "configs" / "new-config.json").write_text(json.dumps(
        dict(base["config"], name="new-config")))
    (here / "traffic" / "new-mix.json").write_text(json.dumps(
        dict(base["traffic"], why="a new mix")))
    (here / "limits" / "new-config.new-mix.json").write_text(
        json.dumps(base["limits"]))
    (here / "metrics" / "new_metric.x.py").write_text(
        "def read(view):\n    return 42.0\n")
    b2 = dict(b, configs=b["configs"] + [
        {"name": "new-config", "source": "https://example.org/x",
         "file": "portbench/configs/new-config.json", "reduced": [],
         "why": "a test"}],
        workloads=b["workloads"] + [
        {"name": "new-config.new-mix", "config": "new-config",
         "traffic": "new-mix", "chips": 1, "why": "a test"}],
        per_layer=b["per_layer"] + [
        {"name": "new_metric.x", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "setup_s", "workloads": ["new-config.new-mix"]}])
    c = bench.cell(b2, "new-config.new-mix", here=here)
    assert c["traffic"]["why"] == "a new mix"
    assert [m["name"] for m in c["per_layer"]] == ["new_metric.x"]
    assert bench.reader("new_metric.x", here=here)(None) == 42.0
    assert bench.driver(c["traffic"], here=here).run
