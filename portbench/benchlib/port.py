"""What the benchmark takes from the program: its configuration class,
built from a configuration file's ``model`` entry, and the check that its
parameter layout is the one the benchmark draws."""
from __future__ import annotations


def port_config(model: dict):
    from repro_torch.models.config import ModelConfig
    kw = {k: v for k, v in model.items()
          if k in ModelConfig.__dataclass_fields__}
    kw["block_cycle"] = tuple(kw["block_cycle"])
    return ModelConfig(**kw)


def check_layout(cfg, lay: dict) -> None:
    """The benchmark draws the port's leaves by name: the names and shapes
    must be the port's."""
    from repro_torch.models import model as M
    want = {k: tuple(v) for k, v in M.param_shapes(cfg).items()}
    have = {k: tuple(s) for k, (s, _) in lay.items()}
    if want != have:
        diff = sorted(set(want.items()) ^ set(have.items()))[:6]
        raise RuntimeError(f"the port's parameter layout is not the "
                           f"benchmark's: {diff}")
