"""Faults planted in the program underneath a run, for the tests that
see ``correct`` come out false.  No benchmark run plants one.

Learner (``train_step``): ``state_unchanged`` returns the parameters and
state it was given (its loss still computed); ``half_batch`` trains on
the first half of the rows, the mean over them.

Engine (``plant``): ``token_altered`` adds one (mod V) to every token a
decode step draws; ``state_unchanged`` puts back every
page pool after each decode step, so that no decoded token's K and V are
kept.
"""
from __future__ import annotations


def train_step(step, fault: str, cfg, rows: int):
    from repro_torch.core import llm_a3c
    from benchlib import tokenmdp

    def unchanged(params, state, batch, i):
        _, met = llm_a3c.loss_grads(cfg, params, batch)
        return params, state, met

    def half(params, state, batch, i):
        return step(params, state, tokenmdp.rows_of(batch, 0, rows // 2), i)

    return {"state_unchanged": unchanged, "half_batch": half}[fault]


def plant(eng, fault: str) -> None:
    import torch
    serve_step = eng.serve_step
    vocab = eng.cfg.vocab_size

    def altered(params, cache, batch, pos, key, sids=None, finite=None):
        tok, value, cache = serve_step(params, cache, batch, pos, key, sids,
                                       finite)
        tok = (tok + 1) % vocab
        return tok, value, cache

    def unchanged(params, cache, batch, pos, key, sids=None, finite=None):
        saved = [{k: t.clone() for k, t in layer.items()
                  if isinstance(t, torch.Tensor) and k != "pt"}
                 for layer in cache["layers"]]
        tok, value, cache = serve_step(params, cache, batch, pos, key, sids,
                                       finite)
        for layer, old in zip(cache["layers"], saved):
            for k, t in old.items():
                layer[k].copy_(t)
        return tok, value, cache
    eng.serve_step = {"token_altered": altered,
                      "state_unchanged": unchanged}[fault]
