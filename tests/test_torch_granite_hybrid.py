"""Granite-4.0-H-Small's mechanisms in the port, at a reduced size on the
CPU, against the plain float32 reference ``torch_ref/granite_hybrid.py``
(seeded random weights): the forward and the learner step; the engine's
admission of ragged prompts by chunks, with the Mamba-2 states carried
into the slots beside the paged KV, then decode; the dropless MoE with
its held share and shared expert; which configurations pad admissions to
``n_slots``; and the ``model.ssm`` and ``model.moe`` spans.

Tolerances.  The program and the reference both compute in float32 on the
CPU; they differ in the order of sums (the chunked scan against the
recurrence, per-expert products against grouped ones, the attention
kernels' plain versions against a dense softmax), so values agree to f32
rounding grown through a few layers: 1e-4 of the compared tensor's
largest magnitude (a lower precision, bf16's 2^-8, would be well past
it)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import llm_a3c  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from torch_ref import granite_hybrid as ref  # noqa: E402

CPU = torch.device("cpu")
REL = 1e-4                  # f32, sums in another order (module docstring)
PROMPTS = (21, 37, 50)      # over chunks of 16: none divides
CHUNK, N_SLOTS, CACHE, PS = 16, 4, 96, 16


def small(**kw):
    """The published configuration cut to a size a test holds: every
    mechanism (mamba2 + NoPE attention + dropless MoE with a shared expert,
    the four multipliers, eps 1e-5) kept, the widths small."""
    c = dataclasses.replace(
        get_config("granite_4_0_h_small"), n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, vocab_size=128,
        block_cycle=("mamba2", "attn", "mamba2"), n_experts=8, top_k=3,
        d_ff_expert=32, d_ff_shared=48, ssm_state=16, ssm_heads=4,
        ssm_head_dim=16, ssm_chunk=16, dtype="float32", remat=False)
    return dataclasses.replace(c, **kw)


def params_of(cfg, seed=0):
    """The port's init, with the table spread up so the logits are not
    all near zero after ``logits_scaling``."""
    p = M.init_params(cfg, seed, device=CPU)
    p["embed"]["table"] = p["embed"]["table"] * 10
    return p


def close(got, want, rel=REL):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    tol = rel * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    torch.set_num_threads(n)
    spans.clear()


# ---------------------------------------------------------------------------
# the forward and the learner step
# ---------------------------------------------------------------------------

def test_forward_matches_reference():
    cfg = small()
    p = params_of(cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 48),
                         generator=torch.Generator().manual_seed(1))
    out = M.forward(cfg, p, {"tokens": toks})
    want = ref.forward(dataclasses.asdict(cfg), M.flatten(p), toks)
    close(out["logits"], want["logits"])
    close(out["value"], want["value"])
    close(out["aux_loss"], want["aux"])


def _ref_loss(m, f, batch, beta=0.01, value_coef=0.5, aux_w=0.01):
    """The A3C token loss of ``llm_a3c.a3c_token_loss`` over the plain
    forward."""
    out = ref.forward(m, f, batch["tokens"])
    logits, values = out["logits"], out["value"]
    actions = torch.roll(batch["tokens"], -1, dims=1)
    rets = torch.empty_like(values)
    carry = values[:, -1].detach()
    for t in range(values.shape[1] - 1, -1, -1):
        carry = batch["rewards"][:, t] + batch["discounts"][:, t] * carry
        rets[:, t] = carry
    valid = torch.ones_like(values)
    valid[:, -1] = 0
    n = valid.sum()
    logp = torch.log_softmax(logits, -1)
    lp_a = logp.gather(-1, actions[..., None])[..., 0]
    ent = -(logp.exp() * logp).sum(-1)
    adv = (rets - values).detach()
    return (-(lp_a * adv * valid).sum() / n
            + value_coef * ((rets - values) ** 2 * valid).sum() / n
            - beta * (ent * valid).sum() / n + aux_w * out["aux"])


def test_learner_step_matches_reference():
    cfg = small()
    p = params_of(cfg, seed=3)
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), generator=g)
    batch = {"tokens": toks,
             "rewards": torch.randn(2, 32, generator=g),
             "discounts": torch.full((2, 32), 0.99)}
    grads, met = llm_a3c.loss_grads(cfg, p, batch)
    flat = {k: v.detach().clone().requires_grad_(True)
            for k, v in M.flatten(p).items()}
    loss = _ref_loss(dataclasses.asdict(cfg), flat, batch,
                     aux_w=cfg.aux_loss_weight)
    want = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    close(met["loss"], loss.detach())
    got = M.flatten(grads)
    med = float(np.median([float(w.norm()) for w in want.values()]))
    for k, w in want.items():
        # each leaf's gradient to REL of the larger of its own norm and
        # the median leaf's (a leaf whose gradient is nearly nought, as a
        # conv bias after a SiLU at zero, is held to the median's scale)
        gap = float((got[k] - w).norm()) / max(float(w.norm()), med)
        assert gap <= 10 * REL, (k, gap)


# ---------------------------------------------------------------------------
# the engine: ragged prompts admitted by chunks, then decode
# ---------------------------------------------------------------------------

def _engine(cfg, p, **kw):
    kw = {"n_slots": N_SLOTS, "cache_len": CACHE, "chunk": CHUNK,
          "sample": False, "page_size": PS, "kv_dtype": "f32",
          "device": CPU, **kw}
    return serve.ServeEngine(cfg, p, **kw)


def _requests(cfg, max_new=5):
    rng = np.random.default_rng(7)
    return [serve.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new=max_new,
        arrival=0.0) for i, n in enumerate(PROMPTS)]


def _admit(eng, reqs):
    for r in reqs:
        eng.enqueue(r)
    pairs = eng.schedule_admissions(0.0)
    assert [j for _, j in pairs] == list(range(len(reqs)))
    eng.admit(pairs, 0.0)


def test_engine_chunked_admission_and_decode_match_reference(monkeypatch):
    """Three ragged prompts admitted in one group by chunks of 16, then
    four decode steps: every prompt position's logits and every decode
    step's logits are the reference's full forward over the same tokens
    (greedy, so the served tokens are the program's own argmaxes); the
    token loop never runs."""
    cfg = small()
    p = params_of(cfg, seed=5)
    eng = _engine(cfg, p)
    assert eng.paged and eng.prefill_step is not None

    def no_loop(*a, **k):
        raise AssertionError("the token loop admitted a chunkable model")
    monkeypatch.setattr(serve.ServeEngine, "_prefill_loop", no_loop)
    chunks, steps = [], []
    prefill, decode = M.prefill_step, M.decode_step

    def spy_prefill(cfg_, params, cache, batch, pos0=0, true_len=None):
        out, cache = prefill(cfg_, params, cache, batch, pos0, true_len)
        chunks.append((pos0, out["logits"].detach().clone()))
        return out, cache

    def spy_decode(*a, **k):
        out, cache = decode(*a, **k)
        steps.append(out["logits"][:, -1].detach().clone())
        return out, cache
    monkeypatch.setattr(M, "prefill_step", spy_prefill)
    monkeypatch.setattr(M, "decode_step", spy_decode)
    reqs = _requests(cfg)
    _admit(eng, reqs)
    assert [c[0] for c in chunks] == [0, 16, 32, 48]
    assert all(c[1].shape[0] == len(PROMPTS) for c in chunks)
    for _ in range(4):
        eng.decode_step_all()
    m, f = dataclasses.asdict(cfg), M.flatten(eng.params)
    for i, r in enumerate(reqs):
        seq = torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]))
        want = ref.forward(m, f, seq[None].long())["logits"][0]
        plen = len(r.prompt)
        got = torch.cat([c[1][i] for c in chunks])[:plen]
        close(got, want[:plen])
        for s, logits in enumerate(steps):
            close(logits[i], want[plen + s])
        assert r.tokens[0] == int(torch.argmax(want[plen - 1]))


def test_chunked_states_equal_token_loop():
    """Each admitted slot's Mamba-2 ``h`` and conv state after a chunked
    admission are those the token loop (``_prefill_loop``) leaves."""
    cfg = small()
    p = params_of(cfg, seed=6)
    chunked = _engine(cfg, p)
    loop = _engine(cfg, p, paged=False, chunked_prefill=False)
    assert loop.prefill_step is None
    _admit(chunked, _requests(cfg))
    _admit(loop, _requests(cfg))
    n = len(PROMPTS)
    for kind, a, b in zip(cfg.layer_kinds(), chunked.cache["layers"],
                          loop.cache["layers"]):
        if kind != "mamba2":
            continue
        close(a["h"][:n], b["h"][:n])
        close(a["conv"][:n], b["conv"][:n])


def test_prefill_scan_row_blocks_change_nothing(monkeypatch):
    """A chunk's scan over blocks of one row (``ssm.SCAN_ELEMS`` cut to
    nothing) gives the whole block's outputs and states bit for bit: each
    row's scan is its own."""
    from repro_torch.models import ssm
    cfg = small()
    p = M.init_params(cfg, 13, device=CPU)["layers"][0]["mamba"]
    g = torch.Generator().manual_seed(14)
    x = torch.randn(3, 16, cfg.d_model, generator=g)
    h0 = torch.randn(3, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim,
                     generator=g)
    true_len = torch.tensor([32, 21, 0])      # at pos0 16: 16, 5, 0 real
    outs = []
    for elems in (ssm.SCAN_ELEMS, 1):
        monkeypatch.setattr(ssm, "SCAN_ELEMS", elems)
        state = ssm.init_mamba2_state(3, cfg, device=CPU)
        state["h"].copy_(h0)
        y = ssm.mamba2_prefill(p, x, state, cfg, 16, true_len)
        outs.append((y, state["h"].clone(), state["conv"].clone()))
    # the row with no real position keeps its state
    assert torch.equal(outs[0][1][2], h0[2])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the dropless MoE
# ---------------------------------------------------------------------------

def _moe_params(cfg, seed=8):
    return M.init_params(cfg, seed, device=CPU)["layers"][0]["moe"]


def test_dropless_row_does_not_depend_on_its_batch():
    cfg = small()
    p = _moe_params(cfg)
    x = torch.randn(8, 5, cfg.d_model,
                    generator=torch.Generator().manual_seed(9))
    kw = dict(top_k=cfg.top_k, act=cfg.act)
    batch, _ = moe_mod.moe_apply_dropless(p, x, **kw)
    for i in range(8):
        alone, _ = moe_mod.moe_apply_dropless(p, x[i:i + 1], **kw)
        # the CPU's per-expert products see other row counts in the batch,
        # and its BLAS may block them otherwise: f32 ulps, not bits
        close(alone[0], batch[i], rel=1e-6)


def test_dropless_one_expert_takes_every_token():
    """Every token's first choice is expert 3: it takes all T rows, none
    is dropped, and the layer is the reference's."""
    cfg = small()
    p = dict(_moe_params(cfg))
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 3] = 5.0
    p["router"][:, 1] = 2.0
    p["router"][:, 6] = 1.0
    x = torch.rand(2, 20, cfg.d_model,
                   generator=torch.Generator().manual_seed(10)) + 0.1
    seen = {}

    def on_counts(counts, kept):
        seen["counts"], seen["kept"] = counts.tolist(), int(kept)
    y, _ = moe_mod.moe_apply_dropless(p, x, top_k=cfg.top_k, act=cfg.act,
                                      on_counts=on_counts)
    t = x.shape[0] * x.shape[1]
    assert seen["counts"][3] == seen["counts"][1] == seen["counts"][6] == t
    assert seen["kept"] == t * cfg.top_k
    want, _ = ref.moe({f"m.{k}": v for k, v in p.items()}, "m.", x,
                      dataclasses.asdict(cfg))
    close(y, want)


def test_expert_halves_and_shared_add_up_to_the_whole_layer():
    """The two cards' shares (experts 0-3 and 4-7 of the router's 8), plus
    the shared expert counted once, are the uncut reference layer."""
    cfg = small()
    full = M.init_params(cfg, 11, device=CPU)["layers"][0]
    x = torch.randn(3, 7, cfg.d_model,
                    generator=torch.Generator().manual_seed(12))
    kw = dict(top_k=cfg.top_k, act=cfg.act)
    halves = []
    for first in (0, 4):
        share = {k: (v[first:first + 4] if k != "router" else v)
                 for k, v in full["moe"].items()}
        halves.append(moe_mod.moe_apply_dropless(share, x, first=first,
                                                 **kw)[0])
    flat = {f"l.moe.{k}": v for k, v in full["moe"].items()}
    flat.update({f"l.shared.{k}.w": v["w"]
                 for k, v in full["shared"].items()})
    m = dataclasses.asdict(cfg)
    want = ref.moe(flat, "l.moe.", x, m)[0] + ref.gated(flat, "l.shared.", x)
    from repro_torch.models import mlp
    got = halves[0] + halves[1] + mlp.gated_mlp(full["shared"], x)
    close(got, want)


@pytest.mark.parametrize("arch,rows", [
    ("granite-4.0-h-small", 2), ("granite-moe-1b-a400m", 5),
    ("llama4-scout-17b-a16e", 5), ("yi-6b", 2)])
def test_admission_rows_pad_only_capacity_routed(arch, rows):
    cfg = small() if arch.startswith("granite-4") else get_config(arch)
    assert serve._admission_rows(cfg, 2, 5) == rows


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

def _run_engine(cfg, p):
    eng = _engine(cfg, p)
    _admit(eng, _requests(cfg))
    eng.decode_step_all()


def test_ssm_and_moe_spans_only_under_a_profiler():
    cfg = small()
    p = params_of(cfg)
    _run_engine(cfg, p)
    assert not spans.records()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run_engine(cfg, p)
    names = {e.name for e in prof.events()}
    assert {"repro_torch.model.ssm", "repro_torch.model.moe"} <= names
    recs = spans.records()
    ssm = [r for r in recs if r.name == "model.ssm"]
    moe = [r for r in recs if r.name == "model.moe"]
    n_chunks = 4                                    # 50 positions by 16
    mamba_layers = cfg.layer_kinds().count("mamba2")
    assert len(ssm) == mamba_layers * (n_chunks + 1)
    assert len(moe) == cfg.n_layers * (n_chunks + 1)
    prefill = ssm[:n_chunks * mamba_layers]
    per_chunk = [len(PROMPTS) * CHUNK] * n_chunks
    real = [sum(int(np.clip(n - p0, 0, CHUNK)) for n in PROMPTS)
            for p0 in range(0, 64, CHUNK)]
    assert [r.counts["positions"] for r in prefill[::mamba_layers]] == \
        per_chunk
    assert [r.counts["masked"] for r in prefill[::mamba_layers]] == \
        [a - b for a, b in zip(per_chunk, real)]
    assert {r.counts["rows"] for r in prefill} == {len(PROMPTS)}
    assert ssm[-1].counts == {"rows": N_SLOTS, "positions": N_SLOTS,
                              "masked": 0}
    for r in moe:
        c = r.counts
        assert c["dropped"] == 0
        assert 0 < c["experts_hit"] <= cfg.n_held
        assert c["rows_max"] * c["experts_hit"] >= c["assignments"]
    # the decode step's blocks: every slot's top_k assignments, all held
    assert moe[-1].counts["assignments"] == N_SLOTS * cfg.top_k
