"""Wrapper of the CUDA flash-attention backward (``csrc/flash_attention_bwd.cu``).

Replaces ``repro/kernels/flash_attention_bwd.py::flash_attention_bwd``.  A
CUDA tensor launches the kernel pair (dq with delta, then dk / dv) or
raises; a CPU tensor takes ``ref.flash_attention_bwd_ref``.  One call
counts one launch of the pair.  Two arms, chosen by dtype and counted
apart: bf16 on the tensor cores (``launches``), whose dkv grid splits each
kv head's q heads over blocks that write f32 partials into a scratch
summed by a third launch (one split writes dk and dv itself); f32 on the
exact SIMT bodies (``f32_launches``).  A call with ``q_offset`` (the
forward's query-offset arm) is counted apart again (``offset_launches``,
``offset_f32_launches``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention_cuda import (check_card_inputs,
                                                      check_train_inputs)

launches = 0        # bf16 (tensor-core) calls since the last reset
f32_launches = 0    # f32 (SIMT) calls since the last reset
offset_launches = 0       # the query-offset arm, bf16
offset_f32_launches = 0   # the query-offset arm, f32


def dkv_splits(hq: int, hkv: int, sq: int = 0, sk: int = 0) -> int:
    """Groups the bf16 dkv grid splits each kv head's G = hq / hkv query
    heads into: 2 heads a group where G is even, else one; a single group
    where the keys outnumber the queries (a sequence shard against the
    whole sequence), whose Sk / 64 key tiles fill the card alone."""
    if sk > sq:
        return 1
    g = hq // hkv
    return g // 2 if g % 2 == 0 else g


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        q_offset: Optional[int] = None):
    """q, o, do (B,S,Hq,D); k, v (B,S,Hkv,D), one dtype; lse (B,Hq,S) f32
    from the forward -> (dq, dk, dv) in the input dtype, dk and dv summed
    over each kv head's query heads.  With ``q_offset`` (the forward's
    shard: q, o, do (B,Sq,Hq,D), k, v (B,Sk,Hkv,D)) dq covers the Sq rows
    and dk, dv all Sk keys, zero where no query of the shard reaches a
    key."""
    what = "flash_attention_bwd"
    check_train_inputs(what, q, k, v, window, q_offset)
    b, s, hq, d = q.shape
    build.require(o.shape == q.shape and do.shape == q.shape and
                  o.dtype == q.dtype and do.dtype == q.dtype, what,
                  f"o {tuple(o.shape)} {o.dtype} / do {tuple(do.shape)} "
                  f"{do.dtype} do not match q {tuple(q.shape)} {q.dtype}")
    build.require(tuple(lse.shape) == (b, hq, s) and
                  lse.dtype == torch.float32, what,
                  f"want lse ({b}, {hq}, {s}) float32, got "
                  f"{tuple(lse.shape)} {lse.dtype}")
    build.require(len({t.device for t in (q, o, lse, do)}) == 1, what,
                  "inputs on different devices")
    off = q_offset or 0
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           q_offset=off)
    check_card_inputs(what, q, k, v, o, do)
    build.require(lse.is_contiguous(), what, "inputs must be contiguous")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(lse)       # rowsum(do * o), dq -> dkv kernel
    hkv, sk = k.shape[2], k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    # bf16: f32 partial dk, dv of each split of the q heads (dkv -> sum);
    # one split writes dk and dv itself
    n_split = dkv_splits(hq, hkv, s, sk) if bf16 else 0
    part = torch.empty((2, n_split, b, sk, hkv, d), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    rc = build.library().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        part.data_ptr() if part is not None else None, n_split, b, s, sk,
        off, hq, hkv, d, int(bool(causal)),
        int(window) if window is not None else 0,
        build.DTYPE_CODE[q.dtype], build.stream_of(q))
    build.check(rc, what)
    global launches, f32_launches, offset_launches, offset_f32_launches
    if q_offset is None and bf16:
        launches += 1
    elif q_offset is None:
        f32_launches += 1
    elif bf16:
        offset_launches += 1
    else:
        offset_f32_launches += 1
    return dq, dk, dv
