"""The learner's batches: behaviour rollouts on the token-level MDP.

A copy of the generator of ``repro_torch/data/pipeline.py`` (with the
reward of ``repro_torch/envs/token_mdp.py``), drawn with a
``torch.Generator`` on the device instead of the port's threefry on the
host: row b starts at a random token, position t is the successor of the
first token advanced by t, or with probability 0.3 a uniform random
token; the reward of position t is 1 where token t + 1 is token t's
successor (mod V) and 0 at the last position; the discounts are
gamma * (1 - done), done at the end of each episode of ``episode_len``
positions (one episode a row by default).  Step i's batch is drawn from
(seed, i) alone, so the rows of every step differ and any process draws
the same batch.
"""
from __future__ import annotations

import torch

from benchlib import weights

NOISE_P = 0.3


def batch(seed: int, step: int, *, rows: int, seq: int, vocab: int,
          device, gamma: float = 0.99, episode_len: int = 0) -> dict:
    g = weights.generator(device, seed, 2, step)
    first = torch.randint(0, vocab, (rows, 1), generator=g, device=device)
    noise = torch.rand((rows, seq), generator=g, device=device) < NOISE_P
    rand = torch.randint(0, vocab, (rows, seq), generator=g, device=device)
    steps = torch.arange(seq, device=device)[None]
    tokens = torch.where(noise, rand, (first + steps) % vocab)
    nxt = torch.roll(tokens, -1, dims=1)
    rewards = (nxt == (tokens + 1) % vocab).float()
    rewards[:, -1] = 0.0
    ep = episode_len or seq
    done = ((steps + 1) % ep == 0).float().expand(rows, seq)
    return {"tokens": tokens, "rewards": rewards,
            "discounts": gamma * (1.0 - done)}


def rows_of(b: dict, lo: int, hi: int) -> dict:
    return {k: v[lo:hi] for k, v in b.items()}
