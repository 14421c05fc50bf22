"""The frozen arithmetic, pinned to the recorded bounds and step sizes."""
import pytest

from benchlib import bench, layout, roofline


def test_flash_bounds_at_yi_train_shape():
    # PERF.md's kernel table: kernel 3 bf16 0.0348 ms, kernel 5 0.0869 ms
    # at B 4, S 1024 on Yi-6B's heads (32 / 4, D 128)
    assert roofline.flash_fwd_s(4, 1024, 32, 4, 128) * 1e3 == \
        pytest.approx(0.0348, abs=5e-5)
    assert roofline.flash_bwd_s(4, 1024, 32, 4, 128) * 1e3 == \
        pytest.approx(0.0869, abs=5e-5)


def test_append_bound_at_serving_shape():
    # kernel 4 bf16: 4 slots, chunk 128 at pos0 512: 0.0049 ms
    rows = [(512, 128)] * 4
    assert roofline.append_s(rows, 32, 4, 128) * 1e3 == \
        pytest.approx(0.0049, abs=5e-5)


# Granite-3.0-1B-A400M's sizes: the MoE arithmetic, whose cell waits for
# the program to run the published model (PERF.md, open questions)
GRANITE = {"name": "granite-moe-1b-a400m", "family": "moe", "n_layers": 24,
           "d_model": 1024, "n_heads": 16, "n_kv_heads": 8, "head_dim": 64,
           "d_ff": 0, "vocab_size": 49155, "block_cycle": ["attn"],
           "n_experts": 32, "top_k": 8, "d_ff_expert": 512,
           "tie_embeddings": True, "value_head": True}


def _model(name):
    if name == GRANITE["name"]:
        return GRANITE
    return bench.load_json(bench.HERE / "configs" / f"{name}.json")["model"]


@pytest.mark.parametrize("name,rows,seq,n,tflop", [
    ("yi-6b-x16", 4, 2048, 3.03e9, 155.6),
    ("granite-moe-1b-a400m", 8, 2048, 4.29e8, 47.1),
    ("yi-6b", 16, 1024, 5.80e9, 583.0),
])
def test_step_flops(name, rows, seq, n, tflop):
    m = _model(name)
    params = layout.product_params(m)
    assert params == pytest.approx(n, rel=2e-3)
    got = roofline.train_step_flops(m, rows, seq, params) / 1e12
    assert got == pytest.approx(tflop, rel=2e-3)


def test_decode_least_time_reads_weights_once():
    m = _model("yi-6b")
    layers = layout.product_params(m) - m["d_model"] * (m["vocab_size"] + 1)
    head = m["d_model"] * (m["vocab_size"] + 1)
    t = roofline.decode_least_s(m, [1], layers, head, 2 * (layers + head))
    assert t == pytest.approx(2 * (layers + head) / roofline.HBM_BYTES,
                              rel=1e-3)
