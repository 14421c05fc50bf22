"""Synthetic token data for the LLM-scale A3C learner, as
``repro/data/pipeline.py``.

Each batch is a set of behaviour rollouts of a noisy successor policy, so
rewards are informative but imperfect: a random first token, then each
position is the successor of the first token advanced by its index, or,
with probability 0.3, a uniformly random token.  Rewards are
``TokenMDP.reward_for_sequence`` of the tokens and discounts are
gamma * (1 - done).  The random numbers are torch's own (``jax.random``'s
cannot be reproduced); a stream is keyed by (seed, step).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve
from repro_torch.envs.token_mdp import TokenMDP

NOISE_P = 0.3


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    gamma: float = 0.99
    episode_len: int = 0            # 0 = one episode per sequence
    device: Optional[str] = None    # None: the card

    def generator(self, seed: int, step: int = 0) -> torch.Generator:
        """The stream of batch ``step`` under ``seed``."""
        mixed = np.random.SeedSequence([seed, step]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator(device=resolve(self.device))
        gen.manual_seed(int(mixed) & 0x7FFF_FFFF_FFFF_FFFF)
        return gen

    def batch(self, gen_or_seed: Union[torch.Generator, int],
              step: int = 0) -> dict:
        """One training batch {"tokens" (B, S) int64, "rewards" (B, S) f32,
        "discounts" (B, S) f32}.  An int seed draws from the stream of
        (seed, step); a generator is drawn from as it stands."""
        gen = (gen_or_seed if isinstance(gen_or_seed, torch.Generator)
               else self.generator(gen_or_seed, step))
        dev = gen.device
        b, s = self.global_batch, self.seq_len
        first = torch.randint(0, self.vocab, (b, 1), generator=gen,
                              device=dev)
        noise = torch.rand((b, s), generator=gen, device=dev) < NOISE_P
        rand = torch.randint(0, self.vocab, (b, s), generator=gen,
                             device=dev)
        steps = torch.arange(s, device=dev)[None]
        succ = (first + steps) % self.vocab
        tokens = torch.where(noise, rand, succ)

        rewards = TokenMDP(self.vocab, s, s).reward_for_sequence(tokens)
        ep = self.episode_len or s
        done = ((steps + 1) % ep == 0).float().expand(b, s)
        discounts = self.gamma * (1.0 - done)
        return {"tokens": tokens, "rewards": rewards, "discounts": discounts}
