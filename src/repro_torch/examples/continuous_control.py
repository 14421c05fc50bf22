"""Continuous-action A3C (paper §5.2.3): Gaussian policy heads on the
MuJoCo-proxy point-mass domain, as ``examples/continuous_control.py``.

  PYTHONPATH=src python -m repro_torch.examples.continuous_control \\
      [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import agents, async_runner, prng
from repro_torch.envs import make
from repro_torch.models import atari as nets


def main():
    from repro_torch.device import resolve
    from repro_torch.examples._cli import parse
    args = parse(__doc__.splitlines()[0])
    env = make("pointmass")
    algo = agents.ALGORITHMS["a3c"](continuous=True)
    params = nets.init_mlp_agent_params(
        prng.key(0), env.obs_shape[0], env.n_actions, hidden=128,
        continuous=True, device=resolve(args.device))
    cfg = async_runner.RunnerConfig(n_workers=8, t_max=5, lr0=3e-3,
                                    total_frames=10**9)
    init_state, round_fn = async_runner.make_runner(algo, env, params, cfg)
    st = init_state(prng.key(1))
    for i in range(3001):
        st, m = round_fn(st)
        if i % 500 == 0:
            print(f"frames={st['frames']:6d}  "
                  f"avg_episode_return={float(m['ep_ret']):+7.1f}")
    print("\n(point-mass: random ~ -70; reaching-and-holding ~ > -30)")


if __name__ == "__main__":
    main()
