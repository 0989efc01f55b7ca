"""Model-layout wrappers around the kernels (the port of
``repro.kernels.ops``'s ``flash_attention``).

:func:`flash_attention` takes the layout of ``models.layers`` — q
(B, T, H, D), k/v (B, S, K, D) — transposes to the kernels' (B, H, T, D)
and back, and carries the gradient through :class:`_Flash`, the
counterpart of the reference's ``custom_vjp`` (``ops.py:43-64``). The
reference pads head_dim to 128 lanes for the TPU; the CUDA kernels take
any head_dim up to 128 as it is.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa


class _Flash(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse); backward runs the flash backward
    (the dK/dV and dQ kernels on the card)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal,
                                        sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = fa.flash_attention_bwd(
            q, k, v, o, lse, do.contiguous(), causal=ctx.causal,
            sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,T,H,D); k, v (B,S,K,D) -> (B,T,H,D) in q's type.

    ``q_offset`` and ``kv_len`` are not supported: the reference's
    ``flash_attention`` drops them silently, the port raises instead."""
    if q_offset != 0 or kv_len is not None:
        raise NotImplementedError(
            "flash_attention takes no q_offset/kv_len (cached decode "
            "reads go through kernels.flash_decode)")
    d = q.shape[-1]
    qt = q.transpose(1, 2).contiguous()          # (B,H,T,D)
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = _Flash.apply(qt, kt, vt, causal, 1.0 / float(np.sqrt(d)))
    return out.transpose(1, 2)
