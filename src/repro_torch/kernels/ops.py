"""Model-layout wrappers around the kernels (the port of
``repro.kernels.ops``'s ``flash_attention``, ``flash_decode``, ``ssd``,
``rmsnorm`` and ``int8_matmul``).

:func:`flash_attention` takes the layout of ``models.layers`` — q
(B, T, H, D), k/v (B, S, K, D) — transposes to the kernels' (B, H, T, D)
and back, and carries the gradient through :class:`_Flash`, the
counterpart of the reference's ``custom_vjp`` (``ops.py:43-64``). The
reference pads head_dim to 128 lanes for the TPU; the CUDA kernels take
any head_dim up to 128 as it is.

:func:`ssd` takes the layout of ``models.ssd`` and prepares the SSD
kernel's (``kernels/ssd.py``): f32 ``xdt = x·dt`` and ``a = dt·A`` with
heads leading, B and C as (B, G, T, N), T right-padded to a multiple of
the chunk (state-neutral: dt = 0 gives decay 1 and update 0). It adds the
skip term ``x·D`` and hands the state back as (B, H, P, N). The
reference also pads P and N to 128 lanes, a TPU layout step the CUDA
kernel does not need.

:func:`int8_matmul` flattens x's leading axes for the int8 kernel
(``kernels/quant_matmul.py``) and carries x's gradient through
:class:`_Int8Matmul`. The reference has no backward kernel: its x
gradient is XLA's transpose product, outside any Pallas kernel, so here
it is one ``torch.matmul`` on the f32 dequantized weight.

:func:`flash_decode` takes the models' cache layout — q (B, 1, H, D) or
(B, H, D), k/v (B, S, K, D) — and hands the dense decode kernel a
transposed view (the kernel reads through strides, so nothing is
copied); the reference's pad of head_dim to 128 lanes is a TPU layout
step and is not done.

:func:`rmsnorm` is the models' RMSNorm. On CUDA tensors it runs
:class:`_RMSNorm`: the forward is the RMSNorm kernel, the backward the
analytic gradient in plain torch ops (the reference has no backward
kernel: XLA differentiates its jnp form). On CPU tensors it is the plain
version, differentiated by autograd through its ops.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssdk


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


def flash_decode(q, k, v, lengths) -> torch.Tensor:
    """q (B, 1, H, D) or (B, H, D); k, v (B, S, K, D) cache; lengths (B,)
    int32 valid prefixes. Returns the normalized output shaped like q, in
    q's type."""
    squeeze = q.ndim == 4
    if squeeze:
        q = q[:, 0]
    d = q.shape[-1]
    out = fd.flash_decode(q.contiguous(), k.transpose(1, 2),
                          v.transpose(1, 2), lengths,
                          sm_scale=1.0 / float(np.sqrt(d)))
    return out[:, None] if squeeze else out


class _RMSNorm(torch.autograd.Function):
    """Forward: the RMSNorm kernel. Backward: ``rmsnorm_backward``, the
    analytic gradient on f32 with ``rstd`` recomputed from x."""

    @staticmethod
    def forward(ctx, x, w, eps: float):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rn.rmsnorm(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rn.rmsnorm_backward(x, w, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x (..., D)`` RMS-normalized and scaled by ``w (D,)``, in x's type,
    differentiable in both."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card runs the kernel, host memory the plain version with autograd through its ops
    if not x.is_cuda:
        return rn.rmsnorm_plain(x, w, eps)
    return _RMSNorm.apply(x.contiguous(), w.contiguous(), eps)


def ssd_inputs(x, B, C, dt, A, chunk: int,
               init_state: Optional[torch.Tensor] = None):
    """The SSD kernel's inputs from the model layout: contiguous f32
    (xdt (B,H,T',P), b, c (B,G,T',N), a (B,H,T'), init (B,H,N,P) or None)
    with T' = T right-padded to a multiple of the chunk the kernel takes,
    q = min(chunk, T), as the reference model pads: a chunk step shorter
    than ``chunk`` goes in at its own length. Padded positions come after
    the live ones with a = x = B = C = 0, so they change no live row and
    not the state."""
    t = x.shape[1]
    xk = (x.float() * dt[..., None]).transpose(1, 2)           # (B,H,T,P)
    bk = B.float().transpose(1, 2)                             # (B,G,T,N)
    ck = C.float().transpose(1, 2)
    a = (dt * A[None, None, :]).transpose(1, 2)                # (B,H,T)
    tpad = (-t) % min(chunk, t)
    if tpad:
        xk = F.pad(xk, (0, 0, 0, tpad))
        bk = F.pad(bk, (0, 0, 0, tpad))
        ck = F.pad(ck, (0, 0, 0, tpad))
        a = F.pad(a, (0, tpad))
    init = (None if init_state is None
            else init_state.float().transpose(2, 3).contiguous())
    return (xk.contiguous(), bk.contiguous(), ck.contiguous(),
            a.contiguous(), init)


def ssd(x, B, C, dt, A, D, chunk: int = 128,
        init_state: Optional[torch.Tensor] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``models.ssd.ssd_chunked_ref``: x (B,T,H,P),
    B/C (B,T,G,N), dt (B,T,H) f32, A (H,), D (H,), ``init_state``
    (B,H,P,N) f32 or None. Returns (y (B,T,H,P) in x's type, final state
    (B,H,P,N) f32)."""
    xk, bk, ck, a, init = ssd_inputs(x, B, C, dt, A, chunk, init_state)
    y, state = ssdk.ssd_chunked_kernel(xk, bk, ck, a, chunk=chunk,
                                       init_state=init)
    t = x.shape[1]
    y = y[:, :, :t].transpose(1, 2) + x.float() * D[None, None, :, None]
    return y.to(x.dtype), state.transpose(2, 3)               # (B,H,P,N)


class _Int8Matmul(torch.autograd.Function):
    """Forward: the int8 kernel. Backward: ``dx = dy @ Wᵀ`` with W the f32
    dequantized weight, in x's type; the frozen ``w_q`` and ``scale`` get
    no gradient."""

    @staticmethod
    def forward(ctx, x, w_q, scale, out_dtype):
        ctx.save_for_backward(w_q, scale)
        ctx.x_dtype = x.dtype
        return qmm.int8_matmul_kernel(x, w_q, scale, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dy):
        w_q, scale = ctx.saved_tensors
        w = qmm.dequantize_groups(w_q, scale)
        dx = torch.matmul(dy.to(torch.float32), w.T).to(ctx.x_dtype)
        return dx, None, None, None


def int8_matmul(x, w_q, scale, out_dtype: Optional[torch.dtype] = None
                ) -> torch.Tensor:
    """x (..., K) @ (w_q int8 (K, N) · scale f32 (K, G)) -> (..., N) in
    ``out_dtype`` (default x's type), differentiable in x."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    y = _Int8Matmul.apply(x2, w_q, scale, out_dtype or x.dtype)
    return y.reshape(*lead, y.shape[-1])
