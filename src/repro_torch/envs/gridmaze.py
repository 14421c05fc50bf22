"""GridMaze, the Labyrinth proxy (paper §5.2.4), as
``repro/envs/gridmaze.py``, batched.

A random maze each episode: walls, apples (+1, consumed) and one portal
(+10; the agent respawns and the apples regenerate); the episode is
time-limited.  The observation is the grid as a (H, W, 4) one-hot image
(walls, apples, portal, agent).  The apples are ``prng.choice`` without
replacement (a Gumbel top-k), the portal, start and respawn cells
``prng.categorical`` over log(free + 1e-9).  The JAX package draws the
respawn cell on every step, used or not; the port draws it from the same
key on the steps where some worker enters the portal.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import prng
from repro_torch.envs.api import Env, auto_reset


class MazeState(NamedTuple):
    walls: torch.Tensor     # (K, H, W) bool
    apples: torch.Tensor    # (K, H, W) bool
    portal: torch.Tensor    # (K, 2)
    pos: torch.Tensor       # (K, 2)
    apples0: torch.Tensor   # (K, H, W) bool, regenerated on portal entry
    t: torch.Tensor         # (K,)


def make(size: int = 9, wall_density: float = 0.2, n_apples: int = 5,
         episode_len: int = 200) -> Env:
    hw = size

    def _random_free_cell(keys, walls):
        """A cell per worker, biased away from walls."""
        k1 = prng.split(keys)[:, 0]
        flat_free = (~walls).reshape(walls.shape[0], -1).float()
        idx = prng.categorical(k1, torch.log(flat_free + 1e-9))
        return torch.stack([idx // hw, idx % hw], dim=-1)

    def _cells(w, cells):
        return w, cells[:, 0], cells[:, 1]

    def reset(keys):
        k = prng.split(keys, 4)
        n = keys.shape[0]
        w = torch.arange(n, device=keys.device)
        walls = prng.bernoulli(k[:, 0], wall_density, (hw, hw))
        apple_logits = torch.where(walls.reshape(n, -1), -1e9, 0.0)
        apple_idx = prng.choice(k[:, 1], hw * hw, (n_apples,),
                                replace=False,
                                p=torch.softmax(apple_logits, dim=-1))
        apples = torch.zeros((n, hw * hw), dtype=torch.bool,
                             device=keys.device)
        apples[w[:, None], apple_idx] = True
        apples = apples.reshape(n, hw, hw)
        portal = _random_free_cell(k[:, 2], walls | apples)
        pos = _random_free_cell(k[:, 3], walls)
        walls[_cells(w, pos)] = False
        walls[_cells(w, portal)] = False
        state = MazeState(walls, apples, portal, pos, apples,
                          torch.zeros_like(w))
        return state, _obs(state)

    def _obs(s: MazeState):
        n = s.pos.shape[0]
        w = torch.arange(n, device=s.pos.device)
        agent = torch.zeros_like(s.walls)
        agent[_cells(w, s.pos)] = True
        portal = torch.zeros_like(s.walls)
        portal[_cells(w, s.portal)] = True
        return torch.stack([s.walls, s.apples, portal, agent],
                           dim=-1).float()

    def step(s: MazeState, action, keys):
        moves = torch.tensor([[-1, 0], [1, 0], [0, -1], [0, 1]],
                             device=s.pos.device)
        w = torch.arange(s.pos.shape[0], device=s.pos.device)
        nxt = torch.clamp(s.pos + moves[action], 0, hw - 1)
        blocked = s.walls[_cells(w, nxt)]
        pos = torch.where(blocked[:, None], s.pos, nxt)

        got_apple = s.apples[_cells(w, pos)]
        apples = s.apples.clone()
        apples[_cells(w, pos)] = False
        got_portal = (pos == s.portal).all(dim=-1)

        # portal: respawn agent at a random cell, apples regenerate (the
        # cell is drawn from this step's key, on steps where some worker
        # entered the portal)
        if bool(got_portal.any()):
            respawn = _random_free_cell(keys, s.walls)
            pos = torch.where(got_portal[:, None], respawn, pos)
            apples = torch.where(got_portal[:, None, None], s.apples0,
                                 apples)

        reward = got_apple.float() + 10.0 * got_portal
        t = s.t + 1
        done = t >= episode_len
        s2 = MazeState(s.walls, apples, s.portal, pos, s.apples0, t)
        return s2, _obs(s2), reward, done

    return Env(name=f"gridmaze{size}", reset=reset,
               step=auto_reset(reset, step), obs_shape=(hw, hw, 4),
               n_actions=4, max_episode_len=episode_len)
