"""``make_serve_step`` against the JAX package's ``serve_step``.

The VLM's decode batch {"embeds": (B, 1, d), "positions": (3, B, 1)},
which the reference's serve step takes and ``specs.input_specs`` gives,
on reduced qwen2-vl-72b: the same greedy tokens (each choice winning by
at least 1e-3) and values within 2e-4 over a few steps, and the sampled
step's tokens the reference's draws (fold_in(key, row)), each draw's
margin above 1e-5 (``prng.margins``).  And the rows of a batch split over data
ranks: sampling row j of rank r's B rows as row r * B + j of the whole
batch draws what the whole batch's row draws.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.core import llm_a3c, prng  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

B, L, STEPS = 3, 16, 4
TOL = 2e-4


@pytest.fixture(scope="module")
def vlm():
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import model as JM
    cj = jax_config("qwen2-vl-72b").reduced()
    ct = torch_config("qwen2-vl-72b").reduced()
    pj = JM.init_params(cj, jax.random.key(0))
    pt = bridge.params_from_jax(ct, jax.tree.map(np.asarray, pj), "cpu")
    rng = np.random.default_rng(4)
    steps = [{"embeds": rng.standard_normal((B, 1, ct.d_model))
              .astype(np.float32),
              "positions": np.broadcast_to(np.arange(B, dtype=np.int32)[
                  None, :, None] + i, (3, B, 1)).copy()}
             for i in range(STEPS)]
    return cj, ct, pj, pt, steps


def test_vlm_batch_has_the_specs_keys(vlm):
    _, ct, _, _, _ = vlm
    _, inputs = specs.input_specs(ct, "decode_32k")
    assert set(inputs["batch"]) == {"embeds", "positions"}


@pytest.mark.parametrize("sample", [False, True])
def test_vlm_serve_step_matches_jax(vlm, sample):
    import jax
    import jax.numpy as jnp
    from repro.core import llm_a3c as jax_a3c
    from repro.models import model as JM
    cj, ct, pj, pt, steps = vlm
    jstep = jax.jit(jax_a3c.make_serve_step(cj, sample=sample))
    jdec = jax.jit(lambda c, b, p: JM.decode_step(cj, pj, c, b, p))
    step = llm_a3c.make_serve_step(ct, sample=sample)
    params = TM.cast_params(ct, pt)
    jcache = JM.init_cache(cj, B, L, dtype=jnp.float32)
    jcache2 = JM.init_cache(cj, B, L, dtype=jnp.float32)
    cache = TM.init_cache(ct, B, L, dtype=torch.float32, device="cpu")
    pos = np.array([2, 5, 7], np.int32)
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        for i, b in enumerate(steps):
            jb = {k: jnp.asarray(v) for k, v in b.items()}
            key = jax.random.fold_in(jax.random.key(0), i)
            tok_j, val_j, jcache = jstep(pj, jcache, jb, jnp.asarray(pos),
                                         key)
            out, jcache2 = jdec(jcache2, jb, jnp.asarray(pos))
            logits = np.asarray(out["logits"][:, -1], np.float64)
            tb = {k: torch.from_numpy(v) for k, v in b.items()}
            with prng.margins() as log:
                tok, val, cache = step(params, cache, tb,
                                       torch.from_numpy(pos),
                                       prng.fold_in(prng.key(0), i))
            np.testing.assert_allclose(val.numpy(), np.asarray(val_j),
                                       atol=TOL)
            if sample:
                # a draw repeats across frameworks where its decision
                # margin clears the logits' ~1e-6 difference
                assert log.smallest() > 1e-5
                np.testing.assert_array_equal(tok.numpy(), np.asarray(tok_j))
            else:
                top2 = np.sort(logits, axis=-1)[:, -2:]
                assert (top2[:, 1] - top2[:, 0] >= 1e-3).all()
                np.testing.assert_array_equal(tok.numpy(),
                                              np.asarray(tok_j))
            pos = pos + 1
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def test_row_offset_draws_the_whole_batch_rows():
    """Rank r of n data ranks samples its B / n rows as rows r B / n + j of
    the whole batch (``row0``)."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((8, 64)).astype(
        np.float32))
    key = prng.key(3)
    whole = llm_a3c.sample_slot_tokens(logits, key)
    parts = [llm_a3c.sample_slot_tokens(logits[r * 2:(r + 1) * 2], key,
                                        row0=r * 2) for r in range(4)]
    assert torch.equal(torch.cat(parts), whole)
