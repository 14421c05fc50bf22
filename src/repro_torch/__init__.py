"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA H100.

Mirrors ``src/repro/``'s layout (``configs``, ``models``, ``kernels``,
``core``, ``launch``); the CUDA sources live in ``csrc``.  The package
imports ``torch`` and numpy only: never ``jax`` and nothing of ``repro``.
"""

import torch

# The port's numeric policy, set once for the process: matrix products run
# in full f32 where f32 is asked for (no TF32), so the card's f32 results
# can be held to the CPU's.  The bf16 weights on the serving path are
# unaffected.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
