"""The Labyrinth experiment (paper §5.2.4) at small scale: A3C on
procedurally generated GridMaze, a new random maze every episode, apples
(+1) and a portal (+10, respawn), as ``examples/labyrinth_maze.py``.

  PYTHONPATH=src python -m repro_torch.examples.labyrinth_maze \\
      [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import agents, async_runner, prng
from repro_torch.envs import make
from repro_torch.envs.api import flatten_obs
from repro_torch.models import atari as nets


def main():
    from repro_torch.device import resolve
    from repro_torch.examples._cli import parse
    args = parse(__doc__.splitlines()[0])
    env = flatten_obs(make("gridmaze"))
    algo = agents.ALGORITHMS["a3c"](beta=0.01)
    params = nets.init_mlp_agent_params(
        prng.key(0), env.obs_shape[0], env.n_actions, hidden=128,
        device=resolve(args.device))
    cfg = async_runner.RunnerConfig(n_workers=8, t_max=5, lr0=7e-3,
                                    total_frames=10**9)
    init_state, round_fn = async_runner.make_runner(algo, env, params, cfg)
    st = init_state(prng.key(1))
    for i in range(5001):
        st, m = round_fn(st)
        if i % 500 == 0:
            print(f"frames={st['frames']:6d}  "
                  f"avg_episode_return={float(m['ep_ret']):6.1f}")


if __name__ == "__main__":
    main()
