"""Plain float32 PyTorch references of architectures the JAX package does
not have, for the port's CPU tests; they import nothing of ``repro`` or
``repro_torch``."""
