"""TokenMDP: the token-level MDP that turns an LLM backbone into an A3C
policy (state = token prefix, action = next token), as
``repro/envs/token_mdp.py``.

Default task "successor": emitting token (prev + 1) mod V earns +1, a dense
reward, so n-step returns propagate as in the paper's Alg. 2/3.  States are
(B, S) token buffers advanced one position per step.  Tokens are int64,
torch's index type.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TokenMDPState(NamedTuple):
    tokens: torch.Tensor   # (B, S) rolling context buffer
    pos: torch.Tensor      # () current length (clipped at S)
    t: torch.Tensor        # () step in episode


class TokenMDP(NamedTuple):
    vocab: int
    context: int
    episode_len: int

    def reset(self, gen: torch.Generator, batch: int) -> TokenMDPState:
        """A random first token per row, drawn from ``gen`` on its device."""
        dev = gen.device
        first = torch.randint(0, self.vocab, (batch, 1), generator=gen,
                              device=dev)
        tokens = torch.zeros((batch, self.context), dtype=torch.int64,
                             device=dev)
        tokens[:, :1] = first
        return TokenMDPState(tokens, torch.ones((), dtype=torch.int64,
                                                device=dev),
                             torch.zeros((), dtype=torch.int64, device=dev))

    def step(self, state: TokenMDPState, actions: torch.Tensor):
        """actions (B,) emitted tokens -> (state, reward (B,) f32, done ()).
        The state's token buffer is copied, not written in place."""
        b = actions.shape[0]
        rows = torch.arange(b, device=actions.device)
        prev = state.tokens[rows, torch.clamp(state.pos - 1, min=0)]
        reward = (actions == (prev + 1) % self.vocab).float()
        pos = torch.clamp(state.pos, max=self.context - 1)
        tokens = state.tokens.clone()
        tokens[:, pos] = actions.to(tokens.dtype)
        t = state.t + 1
        done = t >= self.episode_len
        return TokenMDPState(tokens, pos + 1, t), reward, done

    def reward_for_sequence(self, tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced per-position rewards for a full (B, S) sequence:
        reward[t] = 1 iff tokens[t+1] == tokens[t] + 1 (mod V), and 0 at the
        last position."""
        nxt = torch.roll(tokens, -1, dims=1)
        r = (nxt == (tokens + 1) % self.vocab).float()
        r[:, -1] = 0.0
        return r
