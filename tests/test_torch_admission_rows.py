"""The serve engine's admission prefill on the CPU: a dense configuration
runs its chunk chain on the admitted rows alone, and its first tokens and
the admitted slots' KV rows are those of the same prompts prefilled padded
to ``n_slots`` rows; a capacity-routed MoE configuration keeps its padding
rows, which its expert capacity counts."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import llm_a3c  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

N_SLOTS, CHUNK, PS, CACHE_LEN = 4, 8, 8, 64
PROMPTS = (11, 19, 6, 14)       # within three chunks of 8
TOL = dict(rtol=1e-5, atol=1e-5)
RING = dict(block_cycle=("attn", "attn_local"), sliding_window=8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Under MoE capacity the sink's duplicate writes need one thread (the
    engine tests' setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clear():
    spans.clear()
    yield
    spans.clear()


def _cfg(arch: str):
    if arch == "ring":
        return dataclasses.replace(get_config("yi-6b").reduced(), **RING)
    return get_config(arch).reduced()


def _engine(cfg, **kw):
    return serve.ServeEngine(cfg, M.init_params(cfg, 0, "cpu"),
                             n_slots=N_SLOTS, cache_len=CACHE_LEN,
                             chunk=CHUNK, sample=True, seed=3, page_size=PS,
                             device="cpu", **kw)


def _requests(cfg, lens, rid0=0):
    rng = np.random.default_rng(11 + rid0)
    return [serve.Request(rid=rid0 + i,
                          prompt=rng.integers(0, cfg.vocab_size,
                                              n).astype(np.int32),
                          max_new=8, arrival=0.0)
            for i, n in enumerate(lens)]


def _admit(eng, reqs):
    """Queue ``reqs`` and admit them in one group; returns the pairs."""
    for r in reqs:
        eng.enqueue(r)
    now = eng.now()
    pairs = eng.schedule_admissions(now)
    assert [r for r, _ in pairs] == reqs
    eng.admit(pairs, now)
    return pairs


def _chunk_counts(eng, reqs):
    eng.reset()
    eng.start_clock()
    with profile(activities=[ProfilerActivity.CPU]):
        _admit(eng, reqs)
    chunks = [r for r in spans.records() if r.name == "engine.prefill_chunk"]
    assert chunks
    return [r.counts for r in chunks]


def _real(lens):
    grid = serve._chunk_grid(max(lens), CHUNK, CACHE_LEN)
    return [int(np.clip(np.asarray(lens) - p0, 0, c).sum()) for p0, c in grid]


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_dense_admission_prefills_the_admitted_rows(paged, k):
    """Every chunk of a dense admission of ``k`` requests computes ``k``
    rows of the chunk, not ``n_slots``."""
    cfg = _cfg("yi-6b")
    lens = PROMPTS[:k]
    counts = _chunk_counts(_engine(cfg, paged=paged), _requests(cfg, lens))
    assert counts == [{"computed": k * CHUNK, "real": r} for r in _real(lens)]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m",
                                  "llama4-scout-17b-a16e"])
def test_moe_admission_keeps_n_slots_rows(arch, paged):
    """A capacity-routed MoE admission of one request still runs every
    chunk on ``n_slots`` rows, and the persistent group cache keeps what
    it wrote in every contiguous layer, ring layers too (padding rows read
    it at the next admission, as the JAX engine's do)."""
    cfg = _cfg(arch)
    assert cfg.n_experts
    lens = PROMPTS[:1]
    eng = _engine(cfg, paged=paged)
    counts = _chunk_counts(eng, _requests(cfg, lens))
    assert counts == [{"computed": N_SLOTS * CHUNK, "real": r}
                      for r in _real(lens)]
    kept = [layer["k"] for layer in eng._group_cache["layers"]
            if "k" in layer]
    assert all(k.shape[0] == N_SLOTS and k[0].abs().sum() > 0 for k in kept)


def _slot_rows(eng, j: int, layer: int, plen: int) -> dict:
    """Slot ``j``'s KV rows of ``layer`` at positions [0, plen) (a ring's
    last ``window`` of them, in ring order), under the contiguous names."""
    cache = eng.cache["layers"][layer]
    if "kp" in cache:
        pos = np.arange(plen)
        page = torch.as_tensor(eng.pt_host[j][pos // PS]).long()
        off = torch.as_tensor(pos % PS).long()
        return {n[0] + n[2:]: cache[n][page, off]
                for n in attn.pool_leaves(cache)}
    length = cache["k"].shape[1]
    idx = [p % length for p in range(max(0, plen - length), plen)]
    return {n: cache[n][j, idx] for n in attn.kv_leaves(cache)}


def _ref_rows(cache: dict, i: int, layer: int, plen: int) -> dict:
    leaves = cache["layers"][layer]
    length = leaves["k"].shape[1]
    idx = [p % length for p in range(max(0, plen - length), plen)]
    return {n: leaves[n][i, idx] for n in attn.kv_leaves(leaves)}


@pytest.mark.parametrize("arch,paged,kv", [
    ("yi-6b", True, "f32"), ("yi-6b", False, "f32"),
    ("yi-6b", True, "int8"), ("ring", True, "f32"), ("ring", False, "f32")])
def test_admission_matches_the_prefill_padded_to_n_slots(arch, paged, kv):
    """Two admissions (three requests, then one into the last slot, over
    rows the first left behind): each request's first token is the one the
    same group draws when prefilled padded to ``n_slots`` rows, and its
    slot holds that prefill's KV rows."""
    cfg = _cfg(arch)
    eng = _engine(cfg, paged=paged, kv_dtype=kv)
    eng.reset()
    eng.start_clock()
    groups = [_requests(cfg, PROMPTS[:3]), _requests(cfg, PROMPTS[3:], 3)]
    for reqs in groups:
        pairs = _admit(eng, reqs)
        prompts = [r.prompt for r in reqs]
        toks, plens, grid = serve._pad_group(prompts, N_SLOTS, CHUNK,
                                             CACHE_LEN)
        ref = M.init_cache(cfg, N_SLOTS, CACHE_LEN, dtype=eng.kv_dtype,
                           device="cpu")
        last, ref = serve._chunked_prefill(eng.prefill_step, eng.params, ref,
                                           toks, plens, grid, eng.device)
        rids = [r.rid for r in reqs] + [0] * (N_SLOTS - len(reqs))
        first = llm_a3c.sample_slot_tokens(
            torch.from_numpy(last), eng.base_key, sample=True,
            sids=torch.tensor(rids), pos=torch.tensor(plens))
        assert [r.tokens[0] for r in reqs] == \
            first[:len(reqs)].tolist()
        for i, (r, j) in enumerate(pairs):
            for layer in range(cfg.n_layers):
                got = _slot_rows(eng, j, layer, len(r.prompt))
                want = _ref_rows(ref, i, layer, len(r.prompt))
                assert got.keys() == want.keys()
                for n in want:
                    torch.testing.assert_close(got[n].float(),
                                               want[n].float(), **TOL)
    assert all(r is not None for r in eng.req_of)
