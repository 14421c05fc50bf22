"""The port stands alone: no jax, nothing of ``repro``, no silent CPU.

Every module of ``repro_torch`` imports in a fresh interpreter where
``import jax`` fails, and leaves no ``repro`` module loaded; no source of
the port (nor ``chip_smoke.py``) names jax or ``repro`` in an import.  An
entry point called without ``device`` on a machine with no CUDA device
raises and names ``device='cpu'``, and ``chip_smoke.py`` exits non-zero
with no result there, or when run away from the repository.
"""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None            # any `import jax` now raises
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "repro" or m.startswith("repro.")
                or m == "jax" and sys.modules[m] is not None)
print(len(names), leaked)
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and leaked == "[]", out.stdout


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")] +
    ["chip_smoke.py"]))
def test_no_jax_or_repro_import(path):
    roots = set(_imported_roots(ROOT / path))
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


_CP_MODULES = ("repro_torch.distributed", "repro_torch.distributed.ctx",
               "repro_torch.distributed.sharding",
               "repro_torch.launch.traffic")


@pytest.mark.parametrize("name", _CP_MODULES)
def test_context_parallel_modules_stand_alone(name):
    """The context-parallel decode's modules (process groups, rules, the
    combine's byte count) import alone with jax blocked, load nothing of
    ``repro``, and are among the sources the import check reads."""
    code = ("import sys; sys.modules['jax'] = None; import importlib; "
            f"importlib.import_module({name!r}); "
            "print(sorted(m for m in sys.modules if m == 'repro' or "
            "m.startswith('repro.')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    path = PORT.parent / (name.replace(".", "/") + ".py")
    if not path.exists():
        path = path.with_suffix("") / "__init__.py"
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-6b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_cache(cfg, 1, 8)
    params = M.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.ServeEngine(cfg, params, n_slots=1, cache_len=8)


def test_learner_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    """make_train_step's inputs (parameters, batches) and the train CLI,
    in both its modes, resolve no device to the card, and raise without
    one."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import model as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("yi-6b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        M.init_params(cfg)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipe.batch(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--mode", "llm", "--arch", "yi-6b", "--reduced",
                    "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--mode", "rl", "--frames", "40"])


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout


@pytest.mark.parametrize("module", ["repro_torch.models.moe",
                                    "repro_torch.examples.llm_policy_a3c"])
def test_moe_modules_are_among_the_checked_sources(module):
    """The MoE layer and the LLM example are walked by the import check
    (``pkgutil``), read by the source check, and import alone with jax
    blocked."""
    _check_module_stands_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.models.ssm",
                                    "repro_torch.models.xlstm",
                                    "repro_torch.models.encdec"])
def test_recurrent_and_encdec_modules_are_among_the_checked_sources(module):
    """Mamba2, xLSTM and the encoder-decoder are walked by the import
    check, read by the source check, and import alone with jax blocked."""
    _check_module_stands_alone(module)


@pytest.mark.parametrize("module", ["repro_torch.launch.mesh",
                                    "repro_torch.distributed.fsdp",
                                    "repro_torch.distributed.collectives",
                                    "repro_torch.models.moe_ep"])
def test_multirank_modules_are_among_the_checked_sources(module):
    """The mesh, the FSDP layout, the counted collectives and the
    expert-parallel MoE are walked by the import check, read by the source
    check, and import alone with jax blocked."""
    _check_module_stands_alone(module)


def _check_module_stands_alone(module):
    code = ("import sys, pkgutil; sys.modules['jax'] = None; "
            "import importlib, repro_torch; "
            "names = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]; "
            f"assert {module!r} in names, names; "
            f"importlib.import_module({module!r}); print('ok')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    path = ROOT / "src" / (module.replace(".", "/") + ".py")
    assert str(path.relative_to(ROOT)) in [
        str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}


def test_examples_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.examples import llm_policy_a3c
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llm_policy_a3c.main(["--steps", "1"])
