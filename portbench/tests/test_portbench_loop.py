"""The closed loop is driven by completions: a seed gives one schedule."""
import torch

from benchlib import bench

CPU = torch.device("cpu")


def _schedule(cell, seed, steps=40):
    drv = bench.load_module(bench.HERE / "drivers" / "rollout.py",
                            "pb_loop")
    eng = drv.build(cell, seed, CPU)
    loop = drv.Loop(eng, drv.Actors(seed, cell["traffic"], 128))
    loop.start()
    for _ in range(steps):
        loop.step()
    return (loop.prefills, [len(k) for k in loop.decodes],
            [(r.rid, len(r.prompt), list(r.tokens)) for r in loop.done])


def test_same_seed_same_schedule(rollout_cell):
    cell = rollout_cell()
    a, b = _schedule(cell, 2 ** 31 + 3), _schedule(cell, 2 ** 31 + 3)
    assert a == b
    assert a[2], "no request finished"


def test_seeds_share_the_work_of_a_block(rollout_cell):
    cell = rollout_cell()
    drv = bench.load_module(bench.HERE / "drivers" / "rollout.py",
                            "pb_loop2")
    tr = cell["traffic"]
    per_seed = []
    for seed in (1, 2, 2 ** 32 + 7):
        act = drv.Actors(seed, tr, 128)
        reqs = [act.next(0.0) for _ in range(3 * tr["actors"])]
        per_seed.append((sorted(len(r.prompt) for r in reqs),
                         sorted(r.max_new for r in reqs),
                         [len(r.prompt) for r in reqs]))
    assert per_seed[0][:2] == per_seed[1][:2] == per_seed[2][:2]
    assert per_seed[0][2] != per_seed[1][2]
