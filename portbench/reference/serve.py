"""The served tokens' reference: the plain model's float32 logits over
each sampled request's prompt and served tokens, one forward a request,
and how far each served token lies below the reference's best.

A served token t at logical position L of request r was drawn as the
argmax of the program's logits plus the noise g = gumbel(r, L) of the
engine's key (``reference/threefry.py``).  Its gap is max(ref + g) -
(ref + g)[t]: zero where the reference, given the same noise, draws the
same token, and at most the program's error in the logits otherwise.
For a greedy token g is zero and this is the usual logit gap.
"""
from __future__ import annotations

import torch

from reference import model as ref_model
from reference import threefry


def _logits(model, f, seq, lowp=None):
    toks = torch.as_tensor(seq[None], device=next(iter(f.values())).device)
    return ref_model.forward(model, f, toks.long(), lowp=lowp)["logits"][0]


@torch.no_grad()
def gaps(model: dict, f: dict, requests, engine_seed: int, *,
         lowp=None) -> dict:
    """``requests``: (rid, prompt, served tokens).  Returns {"served": the
    widest gap of a served token, "tokens": how many were judged}; with
    ``lowp`` also {"control": the widest gap, in the float32 reference,
    of the token that the lower precision draws at each of the same
    positions}."""
    ref_model.exact()
    ff = {k: v.float() for k, v in f.items()}
    worst, worst_low, n = 0.0, 0.0, 0
    for rid, prompt, served in requests:
        seq = list(prompt) + list(served)
        plen = len(prompt)
        ref = _logits(model, ff, torch.tensor(seq[:-1]))[plen - 1:]
        low = _logits(model, ff, torch.tensor(seq[:-1]), lowp)[plen - 1:] \
            if lowp is not None else None
        for j, tok in enumerate(served):
            g = threefry.token_noise(engine_seed, rid, plen + j,
                                     ref.shape[-1], ref.device)
            s = ref[j] + g
            best = float(s.max())
            worst = max(worst, best - float(s[int(tok)]))
            if low is not None:
                pick = int(torch.argmax(low[j] + g))
                worst_low = max(worst_low, best - float(s[pick]))
            n += 1
    out = {"served": worst, "tokens": n}
    if lowp is not None:
        out["control"] = worst_low
    return out
