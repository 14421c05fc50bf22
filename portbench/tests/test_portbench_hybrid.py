"""The hybrid cell's pieces on the CPU: its layout is the port's, the
layer-streamed reference is the whole one and agrees with the program's
forward, the new readers read synthetic traces and records, the shared
readers read the new driver's view as they read the Yi rollout's, a
config with a key the program has no field for is refused, and planted
faults (the shared expert left out, the gates not renormalised over the
top k, the state reset at a chunk boundary) come out not correct under
the cell's own limits while the sound run comes out correct."""
import copy
from types import SimpleNamespace

import pytest
import torch

from benchlib import bench, devtrace, linked, weights
from benchlib import layout as lay_mod
from benchlib import layout_hybrid as lay
from benchlib import roofline_hybrid as rh
from benchlib import spans as bspans

CPU = torch.device("cpu")
CELL = "granite-4.0-h-small-ep2.rollout-c64-long"
P = bspans.PREFIX


def tiny_model(**kw):
    """Every mechanism of the cell's model at a size a test holds; the
    logits' divisor 2 keeps them large enough for a fault to show."""
    m = {"name": "tiny-hybrid", "family": "hybrid", "n_layers": 3,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 0, "vocab_size": 128,
         "block_cycle": ["mamba2", "attn", "mamba2"],
         "rope_theta": 10000.0, "rope": False, "norm": "rmsnorm",
         "act": "silu", "tie_embeddings": True, "value_head": True,
         "dtype": "float32", "remat": False, "rms_norm_eps": 1e-5,
         "embedding_multiplier": 12.0, "attention_multiplier": 0.0625,
         "residual_multiplier": 0.22, "logits_scaling": 2.0,
         "n_experts": 8, "experts_held": 4, "top_k": 3, "d_ff_expert": 32,
         "capacity_factor": 0.0, "d_ff_shared": 48, "ssm_state": 16,
         "ssm_heads": 4, "ssm_head_dim": 16, "ssm_groups": 1,
         "ssm_conv_width": 4, "ssm_chunk": 16}
    m.update(kw)
    return m


def tiny_cell(limits=None, **kw):
    tr = {"driver": "rollout_hybrid", "actors": 4, "slots": 4,
          "cache_len": 256, "chunk": 32, "page_size": 32, "pages": 0,
          "prompt": [40, 100], "gen": [8, 24], "check_tokens": 32,
          "trace_seconds": 0.3}
    return {"name": "tiny.hybrid", "chips": 1,
            "config": {"model": tiny_model(**kw)}, "traffic": tr,
            "limits": limits or {"token_gap": 1e-3},
            "end_to_end": [], "per_layer": []}


def _drv():
    return bench.driver({"driver": "rollout_hybrid"})


def test_layout_is_the_ports_for_the_benchmark_config():
    from repro_torch.models import model as M
    cell = bench.cell(bench.benchmark(), CELL)
    m = cell["config"]["model"]
    cfg = _drv().port_config(m)
    want = {k: tuple(v) for k, v in M.param_shapes(cfg).items()}
    have = {k: tuple(s) for k, (s, _) in lay.layout(m).items()}
    assert want == have
    assert cfg.n_held == 36 and cfg.n_experts == 72
    assert cell["config"]["num_local_experts"] == 36
    assert cell["config"]["published"]["num_local_experts"] == 72


def test_unknown_model_key_is_refused():
    m = tiny_model(residual_multiplyer=0.22)
    with pytest.raises(ValueError, match="residual_multiplyer"):
        _drv().port_config(m)


def _seqs():
    g = torch.Generator().manual_seed(3)
    return [torch.randint(0, 128, (n,), generator=g) for n in (37, 21)]


def test_streamed_reference_is_the_whole_one(monkeypatch):
    """With chunks of the weight stream far smaller than a layer, so that
    layers straddle them, the layer-at-a-time draw gives the whole draw's
    forward exactly; the program's f32 forward agrees with it to f32
    rounding (1e-4 of the logits' largest: sums in another order)."""
    from reference import granite_hybrid as ref
    monkeypatch.setattr(weights, "CHUNK", 1000)
    m = tiny_model()
    flat = _drv().make_weights(m, 77, CPU)
    whole = ref.forward(m, flat, _seqs())
    part = ref.streamed(m, 77, CPU, _seqs(), torch.float32)
    for a, b in zip(whole, part):
        assert torch.equal(a["logits"], b["logits"])
    from repro_torch.models import model as M
    cfg = _drv().port_config(m)
    params = lay_mod.unflatten(flat)
    for seq, w in zip(_seqs()[:1], whole):
        pad = torch.cat([seq, seq.new_zeros(48 - len(seq))])
        got = M.forward(cfg, params, {"tokens": pad[None]})["logits"][0]
        gap = (got[:len(seq)] - w["logits"]).abs().max()
        assert float(gap) <= 1e-4 * float(w["logits"].abs().max())


def test_ssd_bound_arithmetic():
    m = bench.cell(bench.benchmark(), CELL)["config"]["model"]
    h, n, p = 128, 128, 64
    # a decode step: the f32 state read and written bounds it
    assert rh.ssd_s(m, 64, 64, 0) == pytest.approx(
        (2 * h * n * p * 4 * 64 + 64 * (h * p * 6 + 2 * n * 2 + h * 4))
        / 3.35e12)
    # padding is no work
    assert rh.ssd_s(m, 2, 512, 256) < rh.ssd_s(m, 2, 512, 0)


def test_link_pairs_kernels_with_their_launches():
    ev = [("cudaLaunchKernel", 10, 12, False, 7),
          ("cudaLaunchKernel", 20, 22, False, 8),
          (P + "model.ssm", 5, 15, False, 0),
          ("k_a", 100, 150, True, 7), ("k_b", 150, 180, True, 8),
          ("k_c", 200, 210, True, 0)]
    dev, host, at = linked.link(ev)
    assert [n for n, _, _ in dev] == ["k_a", "k_b", "k_c"]
    assert at == [10, 20, None]
    t = linked.LinkedTrace(dev, host, 0, 1000, at)
    # k_a ran long after its span closed: it is the span's all the same
    assert t.launched_in(("model.ssm",)) == [(100, 150)]
    assert t.busy_in(("model.ssm",)) == pytest.approx(50e-9)
    assert t.busy_s() == pytest.approx(90e-9)


def _rec(name, start, end, **counts):
    r = SimpleNamespace(name=name, start=start, end=end, counts=counts)
    return r


def test_new_readers_on_a_synthetic_trace(monkeypatch):
    m = bench.cell(bench.benchmark(), CELL)["config"]["model"]
    ev = [(P + "engine.decode", 0, 500, False, 0),
          (P + "model.ssm", 10, 20, False, 0),
          (P + "model.moe", 30, 40, False, 0),
          ("cudaLaunchKernel", 12, 13, False, 1),
          ("cudaLaunchKernel", 32, 33, False, 2),
          ("cudaLaunchKernel", 60, 61, False, 3),
          ("ssd", 100, 300, True, 1), ("experts", 300, 700, True, 2),
          ("other", 700, 800, True, 3)]
    t = linked.LinkedTrace(*linked.link(ev)[:2], 0, 1000,
                           linked.link(ev)[2])
    recs = [_rec("engine.decode", 0, 500),
            _rec("model.ssm", 10, 20, rows=64, positions=64, masked=0),
            _rec("model.moe", 30, 40, assignments=640, rows_max=30,
                 experts_hit=36),
            _rec("model.moe", 600, 700, assignments=100, rows_max=100,
                 experts_hit=1)]                   # outside every decode

    def records(trace, name):
        return [r for r in recs if r.name == name]
    monkeypatch.setattr(bspans, "records", records)
    view = SimpleNamespace(kind="rollout", model=m, trace=t, window_s=2.0,
                           hybrid_least_s=0.5)
    # busy 700 of the stretch: 200 launched in model.ssm, 400 in model.moe
    assert bench.reader("ssm_share.hybrid")(view) == pytest.approx(200 / 7)
    assert bench.reader("moe_share.hybrid")(view) == pytest.approx(400 / 7)
    assert bench.reader("expert_load_max.hybrid")(view) == \
        pytest.approx(30 * 36 / 640)
    assert bench.reader("ssd_roofline.hybrid")(view) == pytest.approx(
        100.0 * rh.ssd_s(m, 64, 64, 0) / 200e-9)
    assert bench.reader("mfu.hybrid")(view) == pytest.approx(25.0)
    bare = SimpleNamespace(kind="rollout", model=m, window_s=2.0,
                           trace=linked.LinkedTrace([], [], 0, 1000, []))
    for name in ("ssm_share.hybrid", "moe_share.hybrid",
                 "ssd_roofline.hybrid", "mfu.hybrid"):
        assert bench.reader(name)(bare) is None
    recs.clear()
    assert bench.reader("expert_load_max.hybrid")(view) is None


def test_shared_readers_read_the_hybrid_view_as_the_rollouts(rollout_cell):
    """The readers the new cell shares with the Yi rollout see the same
    quantities in both drivers' traced views (at a size a test run
    holds): the benchmark's admission time over the window, launches
    inside its decode spans per span, and the union of device
    intervals."""
    seed = 2 ** 31 + 19
    traced = (_drv().run(tiny_cell(), seed, 0.6, True, CPU, 0.0),
              bench.driver({"driver": "rollout"}).run(
                  rollout_cell(), seed, 0.6, True, CPU, 0.0))
    for out in traced:
        v = out["view"]
        assert isinstance(v.trace, devtrace.Trace)
        assert bench.reader("admission_share.rollout")(v) == \
            pytest.approx(100.0 * v.admit_s / v.window_s)
        dec = v.trace.spans("decode")
        assert dec
        assert bench.reader("kernels_per_decode_step.rollout")(v) == \
            v.trace.launches_in(dec) / len(dec)
        assert bench.reader("device_idle.rollout")(v) == \
            pytest.approx(100.0 * v.trace.idle_share())
    hv = traced[0]["view"]
    assert bench.reader("mfu.hybrid")(hv) > 0
    assert bench.reader("expert_load_max.hybrid")(hv) >= 1.0
    assert bench.reader("mfu.hybrid")(traced[1]["view"]) is None


def _fault_shared(monkeypatch):
    from repro_torch.models import mlp
    monkeypatch.setattr(mlp, "gated_mlp",
                        lambda p, x, act="silu": torch.zeros_like(x))


def _fault_gates(monkeypatch):
    from repro_torch.models import moe
    real = moe.gate_logits

    def raw(router, xf, top_k):
        g, e, lb = real(router, xf, top_k)
        probs = torch.softmax(xf.float() @ router.float(), -1)
        return probs.gather(1, e), e, lb
    monkeypatch.setattr(moe, "gate_logits", raw)


def _fault_reset(monkeypatch):
    from repro_torch.models import ssm
    real = ssm.mamba2_prefill

    def reset(p, xin, state, cfg, pos0, true_len):
        state["h"].zero_()
        state["conv"].zero_()
        return real(p, xin, state, cfg, pos0, true_len)
    monkeypatch.setattr(ssm, "mamba2_prefill", reset)


@pytest.mark.parametrize("fault", [None, _fault_shared, _fault_gates,
                                   _fault_reset])
def test_planted_faults_fail_under_the_cells_limits(monkeypatch, fault):
    """Prompts of 33-40 positions over chunks of 32 end just past a chunk
    boundary, where a reset state would still show in the first served
    tokens; the logits' divisor 0.1 gives them the spread of a trained
    model's, so that a fault moves the sampled tokens (at the spread the
    random weights give, Gumbel noise of spread 1.28 hides it)."""
    limits = bench.cell(bench.benchmark(), CELL)["limits"]
    cell = tiny_cell(limits=copy.deepcopy(limits), logits_scaling=0.1)
    cell["traffic"].update(prompt=[33, 40], gen=[16, 32], check_tokens=160)
    if fault is not None:
        fault(monkeypatch)
    out = _drv().run(cell, 2 ** 31 + 23, 2.0, False, CPU, 0.0)
    assert out["correct"] is (fault is None), out["checks"]
