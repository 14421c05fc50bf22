"""The paper's optimizers and learning-rate schedules."""
from repro_torch.optim import schedules  # noqa: F401
from repro_torch.optim.optimizers import OPTIMIZERS, apply_updates  # noqa: F401
