"""The JAX package's examples (``examples/``) on the port, each run as
``python -m repro_torch.examples.<name> [--device cpu]``."""
