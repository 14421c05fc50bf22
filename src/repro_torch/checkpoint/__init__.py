"""npz checkpoints of parameter and optimizer-state trees."""
from repro_torch.checkpoint.io import restore, save  # noqa: F401
