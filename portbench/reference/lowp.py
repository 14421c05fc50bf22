"""The control's lower precision: the reference with the operands of its
products rounded as a lower-precision program would compute them.

``fp8``: float8 e4m3 with one scale a tensor (amax / 448), the common
recipe of fp8 training and serving; the rounding is seen by the forward,
and the backward's products take the rounded operands (a straight-through
estimator: the gradient of the rounding is one).  It is the step below
the configurations' bfloat16.

``bf16``: the operands rounded to bfloat16, the configurations' own
precision of products.  No control: a witness of what that rounding alone
does to the numbers compared, computed without any code of the program.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    r = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (r - t.detach()) if t.requires_grad else r


def bf16(t: torch.Tensor) -> torch.Tensor:
    r = t.detach().to(torch.bfloat16).to(t.dtype)
    return t + (r - t.detach()) if t.requires_grad else r


PRECISIONS = {"fp8": fp8, "bf16": bf16}
