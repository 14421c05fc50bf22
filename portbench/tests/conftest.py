"""The benchmark's own tests, run with ``python -m pytest portbench/tests``
from the repository root.  Tests marked ``card`` need an NVIDIA card and
skip elsewhere; whether there is one is decided inside the ``card``
fixture, never at import."""
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
for p in (HERE, HERE.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)


def _model(dtype="float32", moe=False, tie=False):
    m = {"name": "tiny", "family": "moe" if moe else "dense", "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
         "d_ff": 0 if moe else 128, "vocab_size": 128, "block_cycle": ["attn"],
         "rope_theta": 10000.0, "norm": "rmsnorm", "act": "silu",
         "tie_embeddings": tie or moe, "value_head": True, "dtype": dtype,
         "remat": True}
    if moe:
        m.update(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=1.25,
                 aux_loss_weight=0.01)
    return m


@pytest.fixture
def train_cell():
    """A learner cell at a size a test run holds, under the limits of the
    benchmark's learner cells' kind (``limits``)."""
    def make(dtype="float32", moe=False, limits=None):
        tr = {"driver": "learner", "rows": 4, "seq": 32, "gamma": 0.99,
              "lr0": 0.007, "total_steps": 1000000, "alpha": 0.99,
              "eps": 0.1, "ref_steps": 3, "trace_steps": 2}
        return {"name": "tiny.train", "chips": 1,
                "config": {"model": _model(dtype, moe)}, "traffic": tr,
                "limits": limits or {"loss_gap": 1e-4, "grad_gap": 1e-4,
                                     "update_gap": 1e-4},
                "end_to_end": [], "per_layer": []}
    return make


@pytest.fixture
def rollout_cell():
    def make(dtype="float32", limits=None):
        tr = {"driver": "rollout", "actors": 4, "slots": 4, "cache_len": 256,
              "chunk": 32, "page_size": 32, "pages": 0, "prompt": [40, 100],
              "gen": [8, 24], "check_tokens": 32, "trace_seconds": 0.2}
        return {"name": "tiny.rollout", "chips": 1,
                "config": {"model": dict(_model(dtype), remat=False)},
                "traffic": tr, "limits": limits or {"token_gap": 1e-3},
                "end_to_end": [], "per_layer": []}
    return make


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
