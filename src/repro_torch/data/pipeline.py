"""Synthetic token data for the LLM-scale A3C learner, as
``repro/data/pipeline.py``.

Each batch is a set of behaviour rollouts of a noisy successor policy, so
rewards are informative but imperfect: a random first token, then each
position is the successor of the first token advanced by its index, or,
with probability 0.3, a uniformly random token.  Rewards are
``TokenMDP.reward_for_sequence`` of the tokens and discounts are
gamma * (1 - done).  The draws are ``jax.random``'s (``core.prng``), key
for key, so a key gives the JAX package's batches exactly.

Over a mesh (``mesh``), every rank draws the global batch from the same
key and keeps its rows of the data axes (``sharding.shard_batch``: the
reference's ``batch_shardings``), so the ranks' rows together are the
single-process batch.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import prng
from repro_torch.device import resolve
from repro_torch.distributed import sharding
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
    mesh: Any = None                # a DeviceMesh: this rank's rows only

    def batch(self, key: torch.Tensor, step: int = 0) -> dict:
        """One training batch {"tokens" (B, S) int64, "rewards" (B, S) f32,
        "discounts" (B, S) f32} on the pipeline's device from a ``prng``
        key, drawn as ``repro/data/pipeline.py`` draws it:
        split(fold_in(key, step)), the first tokens by randint, the noise
        mask by bernoulli(0.3), the noise tokens by randint under
        fold_in(k2, 1).  The draws run on the host, which hashes a few
        thousand counters in milliseconds, where on the card each of the
        ten hashes would be some 140 elementwise launches; the batch (this
        rank's rows of it over a mesh) is copied over once."""
        dev = resolve(self.device)
        b, s = self.global_batch, self.seq_len
        k1, k2 = prng.split(prng.fold_in(key.cpu(), step))
        first = prng.randint(k1, (b, 1), 0, self.vocab)
        noise = prng.bernoulli(k2, NOISE_P, (b, s))
        rand = prng.randint(prng.fold_in(k2, 1), (b, s), 0, self.vocab)
        steps = torch.arange(s)[None]
        succ = (first + steps) % self.vocab
        tokens = torch.where(noise, rand, succ)

        rewards = TokenMDP(self.vocab, s, s).reward_for_sequence(tokens)
        ep = self.episode_len or s
        done = ((steps + 1) % ep == 0).float().expand(b, s)
        discounts = self.gamma * (1.0 - done)
        out = {"tokens": tokens, "rewards": rewards, "discounts": discounts}
        if self.mesh is not None:
            out = sharding.shard_batch(self.mesh, out)
        return {k: v.to(dev) for k, v in out.items()}
