"""Environments of the port, as ``repro/envs``: the paper's proxies
(Catch, GridMaze, PointMass, Pendulum), batched over workers, and the
token-level MDP of the LLM learner (``envs.token_mdp``)."""
from repro_torch.envs.api import Env  # noqa: F401
from repro_torch.envs import catch, continuous, gridmaze, token_mdp  # noqa: F401

REGISTRY = {
    "catch": lambda: catch.make(),
    "gridmaze": lambda: gridmaze.make(),
    "pointmass": lambda: continuous.make_pointmass(),
    "pendulum": lambda: continuous.make_pendulum(),
}


def make(name: str) -> Env:
    return REGISTRY[name]()
