"""Quickstart: asynchronous advantage actor-critic (A3C) on Catch, as
``examples/quickstart.py``.

The paper's core loop at small scale: 8 parallel actor-learners with
Hogwild-style staleness (T1), Shared RMSProp, per-worker exploration,
t_max = 5 forward-view updates, 4001 rounds.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

from repro_torch.core import agents, async_runner, prng
from repro_torch.device import resolve
from repro_torch.envs import make
from repro_torch.envs.api import flatten_obs
from repro_torch.models import atari as nets

ROUNDS = 4001
PASS = 0.5          # final average return it must beat (random ~ -0.6)


def build(device=None):
    """The configuration's (init_state, round_fn), its parameters on
    ``device`` (the card unless given)."""
    env = flatten_obs(make("catch"))
    algo = agents.ALGORITHMS["a3c"]()
    params = nets.init_mlp_agent_params(
        prng.key(0), env.obs_shape[0], env.n_actions, hidden=64,
        device=resolve(device))
    cfg = async_runner.RunnerConfig(
        n_workers=8, t_max=5, lr0=1e-2, total_frames=10**9,
        mode="hogwild", optimizer="shared_rmsprop")
    return async_runner.make_runner(algo, env, params, cfg)


def train(device=None, log_every: int = 500):
    """Runs the configuration for ROUNDS rounds; returns (final average
    return, the last round's metrics, the state)."""
    init_state, round_fn = build(device)
    st = init_state(prng.key(1))
    for i in range(ROUNDS):
        st, m = round_fn(st)
        if log_every and i % log_every == 0:
            print(f"frames={st['frames']:6d}  "
                  f"avg_episode_return={float(m['ep_ret']):+.2f}  "
                  f"entropy={float(m['entropy']):.3f}")
    return float(m["ep_ret"]), m, st


def main():
    from repro_torch.examples._cli import parse
    args = parse(__doc__.splitlines()[0])
    final, _, _ = train(args.device)
    print(f"\nfinal avg return: {final:+.2f}  "
          f"(random ~= -0.6, perfect = +1.0)")
    assert final > PASS, "did not learn — check the setup"


if __name__ == "__main__":
    main()
