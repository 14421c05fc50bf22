"""All four asynchronous methods (paper §4) on one environment, the Fig. 1
learning-speed comparison at small scale, plus the DQN-replay baseline,
as ``examples/four_methods_shootout.py``.

  PYTHONPATH=src python -m repro_torch.examples.four_methods_shootout \\
      [frames] [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import agents, async_runner, dqn_replay, prng
from repro_torch.envs import make
from repro_torch.envs.api import flatten_obs
from repro_torch.models import atari as nets


def run_async(algo_name, env, frames, device):
    algo = agents.ALGORITHMS[algo_name]()
    params = nets.init_mlp_agent_params(
        prng.key(0), env.obs_shape[0], env.n_actions, hidden=64,
        device=device)
    cfg = async_runner.RunnerConfig(n_workers=8, t_max=5, lr0=1e-2,
                                    total_frames=10**9)
    init_state, round_fn = async_runner.make_runner(algo, env, params, cfg)
    st = init_state(prng.key(1))
    ema = 0.0
    while st["frames"] < frames:
        st, m = round_fn(st)
        ema = 0.98 * ema + 0.02 * float(m["ep_ret"])
    return ema


def run_dqn(env, frames, device):
    params = nets.init_mlp_agent_params(
        prng.key(0), env.obs_shape[0], env.n_actions, hidden=64,
        device=device)
    init_state, step_fn = dqn_replay.make_dqn(env, params,
                                              dqn_replay.DQNConfig())
    st = init_state(prng.key(1))
    ema = 0.0
    for _ in range(frames):
        st = step_fn(st)
        ema = 0.999 * ema + 0.001 * float(st["last_ep_ret"][0])
    return ema


def main():
    from repro_torch.device import resolve
    from repro_torch.examples._cli import parse
    args = parse(__doc__.splitlines()[0], ("frames", int, 40_000))
    dev = resolve(args.device)
    env = flatten_obs(make("catch"))
    print(f"{'method':18s} score@{args.frames} frames")
    for algo in ["a3c", "n_step_q", "one_step_q", "one_step_sarsa"]:
        print(f"{algo:18s} {run_async(algo, env, args.frames, dev):+.2f}")
    print(f"{'dqn_replay':18s} {run_dqn(env, args.frames, dev):+.2f}")


if __name__ == "__main__":
    main()
