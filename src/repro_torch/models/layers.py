"""Core layers: dense projection, RMSNorm, RoPE, SwiGLU, attention.

Plain functions on tensors with the JAX package's layouts and rounding
discipline (``repro.models.layers``): every product accumulates in f32
and rounds ONCE to its output type, and chains that feed more f32 math
(swiglu's gate, the q/k/v projection) stay real f32 until one final
rounding. Quantized (``QTensor``) and LoRA (``LoRATensor``) weights are
dispatched inside :func:`dense`, as in the reference.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch

from repro_torch.kernels.flash_attention import split_bf16
from repro_torch.peft.lora import LoRATensor
from repro_torch.quant.qtensor import QTensor

NEG_INF = -1e30


QMM_IMPLS = ("kernel", "ref")


def dense(x: torch.Tensor, w, n_in: int = 1, bias=None,
          out_dtype: Optional[torch.dtype] = None,
          qmm_impl: str = "kernel") -> torch.Tensor:
    """Contract the last ``n_in`` dims of ``x`` with the first ``n_in``
    dims of ``w``; the output gets ``w``'s remaining dims.

    Every product is exact and accumulates in f32, then is rounded once
    to ``out_dtype`` (default: the promoted input type);
    ``out_dtype=torch.float32`` keeps the f32 accumulator as the output.
    On the card, bf16 operands go to the tensor cores as they are
    (:func:`_dense_bf16`); on the CPU, and for an f32 operand, both widen
    exactly to f32 (:func:`_dense_f32`). The two differ only in the order
    of the f32 sums.
    ``bias`` is added after the rounding, in the output type, as the
    reference does.

    ``w`` may be a ``LoRATensor`` (``base(x) + scaling · b(a(x))``, then
    the bias once) or a ``QTensor``. An int8 ``QTensor`` goes to the int8
    kernel (``kernels.ops.int8_matmul``: the weight dequantized to f32)
    under ``qmm_impl="kernel"``; under ``"ref"`` it is dequantized to x's
    type first and takes the product above, the reference's ``dense``
    exactly. An nf4 ``QTensor`` is dequantized to x's type."""
    if isinstance(w, LoRATensor):
        y = dense(x, w.base, n_in, out_dtype=out_dtype, qmm_impl=qmm_impl)
        t = dense(x, w.a, n_in)                                 # (..., r)
        y = y + w.scaling * dense(t, w.b, 1, out_dtype=out_dtype)
        return y if bias is None else y + bias
    if isinstance(w, QTensor):
        # repro: allow[JIT-04] QTensor.kind is a static string field (the reference's pytree aux data), not a device value
        if w.kind == "int8" and qmm_impl == "kernel":
            return _int8_dense(x, w, n_in, bias, out_dtype)
        w = w.dequantize(x.dtype)
    in_shape = x.shape[:-n_in]
    k = int(np.prod(x.shape[-n_in:]))
    out_dims = tuple(w.shape[n_in:])
    x2 = x.reshape(*in_shape, k)
    w2 = w.reshape(k, int(np.prod(out_dims)))
    out_dt = out_dtype or torch.promote_types(x2.dtype, w2.dtype)
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card multiplies bf16 operands on the tensor cores, host memory keeps the f32 route
    if x2.is_cuda and tensor_core_route(x2.dtype, w2.dtype, out_dt):
        y = _dense_bf16(x2, w2, out_dt)
    else:
        y = _dense_f32(x2, w2, out_dt)
    y = y.reshape(*in_shape, *out_dims)
    if bias is not None:
        y = y + bias
    return y


def dense_batched(x: torch.Tensor, w: torch.Tensor,
                  out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """:func:`dense` batched over a leading axis: x (E, C, K) against w
    (E, K, N), one product per leading index (the reference's ``einsum(
    "ecd,edf->ecf", preferred_element_type=f32)``), by the same routes:
    bf16 operands on the card to the tensor cores (``torch.bmm``; an f32
    output through :class:`_BmmF32Out`, exact products summed in f32),
    an f32 operand and every product on the CPU widened to f32. Every
    route has its gradient (the MoE experts train)."""
    out_dt = out_dtype or torch.promote_types(x.dtype, w.dtype)
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata), as dense does
    if x.is_cuda and tensor_core_route(x.dtype, w.dtype, out_dt):
        if out_dt == torch.bfloat16:
            return torch.bmm(x, w)
        return _BmmF32Out.apply(x, w)
    return _dense_f32(x, w, out_dt)


def tensor_core_route(x_dtype: torch.dtype, w_dtype: torch.dtype,
                      out_dtype: torch.dtype) -> bool:
    """Whether a product on the card takes the tensor cores: both operands
    bf16 and the output bf16 or f32. Any f32 operand (swiglu's down
    projection reads the f32 gate chain, mamba2's ``out_proj`` the f32
    gated norm) keeps the f32 route: its products are not exact in bf16."""
    return (x_dtype == w_dtype == torch.bfloat16 and
            out_dtype in (torch.bfloat16, torch.float32))


def _dense_f32(x2, w2, out_dt) -> torch.Tensor:
    """The f32 route: both operands widened (exactly) to f32, one f32
    product, one rounding to ``out_dt``. Every product on the CPU, and
    the products with an f32 operand on the card."""
    acc = (torch.promote_types(torch.float32, out_dt)
           if out_dt.is_floating_point else out_dt)
    return torch.matmul(x2.to(acc), w2.to(acc)).to(out_dt)


def _dense_bf16(x2, w2, out_dt) -> torch.Tensor:
    """bf16 operands on the tensor cores, f32 accumulation (the card's
    numerics switches forbid reduced-precision reductions), one rounding:
    the f32 route's function up to the order of the f32 sums. A bf16
    output is a bf16 ``torch.matmul``; an f32 output is
    :class:`_MatmulF32Out`."""
    if out_dt == torch.bfloat16:
        return torch.matmul(x2, w2)
    lead = x2.shape[:-1]
    y = _MatmulF32Out.apply(x2.reshape(-1, x2.shape[-1]), w2)
    return y.reshape(*lead, w2.shape[1])


def _mm_f32(pairs) -> torch.Tensor:
    """The sum of ``a @ b`` over ``pairs`` of bf16 matrices, each product
    exact on the tensor cores and summed in f32 (``aten::mm.dtype``, then
    ``addmm.dtype`` adding each next product into the f32 result)."""
    y = None
    for a, b in pairs:
        y = (torch.mm(a, b, out_dtype=torch.float32) if y is None else
             torch.addmm(y, a, b, out_dtype=torch.float32))
    return y


class _MatmulF32Out(torch.autograd.Function):
    """``a @ b`` of bf16 matrices with an f32 output: exact products, f32
    sums, no rounding to bf16. The cotangent of an f32 output is f32 and
    not bf16-valued (RoPE and the swiglu product follow these
    projections), so the backward splits it into three bf16 parts
    (:func:`split_bf16`, within 2^-24 of it) and multiplies each on the
    tensor cores, the products summed in f32: the f32 route's gradient up
    to the order of the f32 sums, before the one rounding to the
    operand's type. (hi + lo alone, 2^-16, strays past one bf16 ulp
    wherever a gradient's sum cancels.)"""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32([(a, b)])

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        parts = split_bf16(g.float(), 3)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32([(p, b.t()) for p in parts]).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mm_f32([(a.t(), p) for p in parts]).to(b.dtype)
        return da, db


class _BmmF32Out(torch.autograd.Function):
    """:class:`_MatmulF32Out` batched over a leading axis: ``a @ b`` of
    bf16 (E, C, K) and (E, K, N) with an f32 output (``bmm.dtype``, which
    has no derivative on the card). The backward splits the f32
    cotangent into three bf16 parts and sums their exact products in
    f32, as :class:`_MatmulF32Out` does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        parts = split_bf16(g.float(), 3)
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.transpose(1, 2)
            da = sum(torch.bmm(p, bt, out_dtype=torch.float32)
                     for p in parts).to(a.dtype)
        if ctx.needs_input_grad[1]:
            at = a.transpose(1, 2)
            db = sum(torch.bmm(at, p, out_dtype=torch.float32)
                     for p in parts).to(b.dtype)
        return da, db


def _int8_dense(x, w, n_in: int, bias, out_dtype) -> torch.Tensor:
    """``dense`` of an int8 ``QTensor`` through the kernel. Its scales
    ``data.shape[:-1] + (1,)`` become (K, G) with G the product of the
    output dims before the last (the heads of ``wq``/``wk``/``wv``, 1
    elsewhere). Shapes come from ``data``: a per-layer slice keeps the
    stacked static ``shape``."""
    from repro_torch.kernels import ops as kops
    data = w.data
    if tuple(w.scale.shape) != tuple(data.shape[:-1]) + (1,):
        raise ValueError(f"int8 scales {tuple(w.scale.shape)} are not the "
                         f"last-axis absmax scales of {tuple(data.shape)}")
    in_shape = x.shape[:-n_in]
    k = int(np.prod(data.shape[:n_in]))
    out_dims = tuple(data.shape[n_in:])
    n = int(np.prod(out_dims))
    y = kops.int8_matmul(x.reshape(*in_shape, k), data.reshape(k, n),
                         w.scale.reshape(k, n // out_dims[-1]),
                         out_dtype=out_dtype or x.dtype)
    y = y.reshape(*in_shape, *out_dims)
    return y if bias is None else y + bias


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·w`` in f32, rounded once to x's type:
    ``kernels.ops.rmsnorm``, the RMSNorm kernel on the card (with its
    analytic backward) and the plain version on the CPU."""
    from repro_torch.kernels import ops as kops
    return kops.rmsnorm(x, w, eps)


def qk_headnorm(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Qwen3's per-head RMSNorm over head_dim: x (..., H, hd), w (hd,), in
    f32 and in x's type (the projections hand it real f32, which it keeps).
    It is :func:`rmsnorm` over the last axis: the RMSNorm kernel on the
    card (f32 in, f32 out), its plain version on the CPU."""
    return rmsnorm(x, w, eps)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def dense_row(x: torch.Tensor, w, ctx, n_in: int = 1,
              out_dtype: Optional[torch.dtype] = None,
              qmm_impl: str = "kernel") -> torch.Tensor:
    """Row-parallel :func:`dense`: the contracted dims of ``x`` and the
    leading ones of ``w`` are this rank's part of an axis the model axis
    of ``ctx`` (a ``parallel.sharding.ShardCtx``) splits. The local
    partial stays f32 (``out_dtype=float32``), is summed in f32 over the
    model axis and rounded ONCE to ``out_dtype`` (default: the promoted
    input type): rounding each partial first would round twice. The sum
    is ``ctx.exit_block``: in place while serving; under autograd
    Megatron's g, or under sequence parallelism the reduce-scatter to
    this rank's rows of T (the second axis of ``x``). With no ``ctx`` (or
    one rank) it is :func:`dense`. A zero-length contraction sums zeros
    on every rank, so it takes no collective."""
    if ctx is None or ctx.size == 1:
        return dense(x, w, n_in, out_dtype=out_dtype, qmm_impl=qmm_impl)
    out_dt = out_dtype or torch.promote_types(x.dtype, w.dtype)
    y = dense(x, w, n_in, out_dtype=torch.float32, qmm_impl=qmm_impl)
    if int(np.prod(x.shape[-n_in:])):
        y = ctx.exit_block(y)
    return y.to(out_dt)


def dense_column(x: torch.Tensor, ws, ctx,
                 out_dtype: Optional[torch.dtype] = None,
                 qmm_impl: str = "kernel", gather: bool = True
                 ) -> List[torch.Tensor]:
    """Column-parallel :func:`dense` of ``x`` (B, T, K) by each of ``ws``
    (this rank's columns of weights a model axis of ``ctx`` splits on
    their outputs), each as :func:`dense` computes it. In training
    (autograd, or under sequence parallelism) the products read ``x``
    through Megatron's f, or with ``gather`` under sequence parallelism
    through the all-gather of T (``x`` is then this rank's rows), and
    their input cotangent is one f32 sum: every product's f32 partial
    and every rank's, rounded ONCE to ``x``'s type
    (:class:`_ColumnParallel`). Serving's and one rank's products are
    plain :func:`dense` calls."""
    tp = ctx is not None and ctx.size > 1
    seq = tp and gather and ctx.sp
    # repro: allow[JIT-04] autograd's mode and requires_grad are host metadata of the tensor, not device values
    if seq or tp and torch.is_grad_enabled() and x.requires_grad:
        return list(_ColumnParallel.apply(x, ctx, out_dtype, seq, *ws))
    return [dense(x, w, out_dtype=out_dtype, qmm_impl=qmm_impl) for w in ws]


class _ColumnParallel(torch.autograd.Function):
    """The products of :func:`dense_column` behind Megatron's f (or the
    sequence all-gather): forward, ``dense(x, w, out_dtype)`` for each
    weight on the whole sequence; backward, each weight's gradient as
    :func:`dense`'s own backward makes it, and the input's as f32
    partials (on the card each cotangent split into three bf16 parts, as
    :class:`_MatmulF32Out` splits it, every product exact and summed in
    f32; on the CPU f32 products) summed over the weights and over the
    model axis (``ShardCtx.sum_column_grad``), then rounded once."""

    @staticmethod
    def forward(fctx, x, ctx, out_dtype, seq, *ws):
        h = ctx.seq_gather(x) if seq else x
        fctx.ctx, fctx.seq = ctx, seq
        fctx.save_for_backward(h, *ws)
        return tuple(dense(h, w, out_dtype=out_dtype) for w in ws)

    @staticmethod
    def backward(fctx, *gs):
        h, *ws = fctx.saved_tensors
        h2 = h.reshape(-1, h.shape[-1])
        tc = h2.is_cuda and tensor_core_route(h2.dtype, ws[0].dtype,
                                              gs[0].dtype)
        pairs, dws = [], []
        for w, g in zip(ws, gs):
            w2 = w.reshape(h2.shape[1], -1)
            g2 = g.reshape(-1, w2.shape[1])
            parts = (split_bf16(g2.float(), 3)
                     if tc and g2.dtype != torch.bfloat16 else (g2,))
            dws.append(_products_f32([(h2.t(), p) for p in parts], tc)
                       .to(w.dtype).reshape(w.shape))
            pairs += [(p, w2.t()) for p in parts]
        dx = fctx.ctx.sum_column_grad(
            _products_f32(pairs, tc).reshape(h.shape), fctx.seq)
        return (dx.to(h.dtype), None, None, None, *dws)


def _products_f32(pairs, tensor_cores: bool) -> torch.Tensor:
    """The f32 sum of ``a @ b`` over ``pairs``: on the tensor cores
    (:func:`_mm_f32`), else each product widened to f32, as
    :func:`_dense_f32` multiplies."""
    if tensor_cores:
        return _mm_f32(pairs)
    out = None
    for a, b in pairs:
        y = a.float() @ b.float()
        out = y if out is None else out + y
    return out


def swiglu(x, w_gate, w_up, w_down, qmm_impl: str = "kernel", ctx=None
           ) -> torch.Tensor:
    """The gate chain is real f32 with one rounding at the end. Under
    ``ctx`` the gate and up projections are column-parallel (this rank's
    part of the MLP width, :func:`dense_column`) and the down projection
    row-parallel (:func:`dense_row`, whose sum is ``ctx.exit_block``)."""
    g, u = dense_column(x, [w_gate, w_up], ctx, out_dtype=torch.float32,
                        qmm_impl=qmm_impl)
    h = silu(g) * u
    return dense_row(h, w_down, ctx, qmm_impl=qmm_impl).to(x.dtype)


def rope_frequencies(head_dim: int, fraction: float, theta: float):
    """Inverse frequencies (numpy f32, computed as the reference does)
    and the rotated width."""
    rot = int(head_dim * fraction)
    rot -= rot % 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float32) / rot))
    return inv.astype(np.float32), rot


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, fraction: float, theta: float,
                device: torch.device):
    """The inverse frequencies as a tensor on ``device``, built once: a
    fresh host-to-device copy per call would block the host on every
    layer of every step."""
    inv, _ = rope_frequencies(head_dim, fraction, theta)
    return torch.from_numpy(inv).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               fraction: float = 1.0, theta: float = 10000.0
               ) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) or (T,). Rotates the first
    ``fraction * hd`` dims (neox halves, f32 angles), passes the rest
    through."""
    hd = x.shape[-1]
    _, rot = rope_frequencies(hd, fraction, theta)
    if rot == 0:
        return x
    inv_t = _rope_table(hd, fraction, theta, x.device)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].float() * inv_t[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1f = xr[..., : rot // 2].float()
    x2f = xr[..., rot // 2:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def naive_attention(q, k, v, *, causal: bool = True, q_offset=0,
                    kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Materialized-score attention. q (B, T, H, hd), k/v (B, S, K, hd)
    with H = K * G. Query row i sits at position ``q_offset + i`` for the
    causal mask; ``kv_len`` (B,) masks keys at or past each row's length.
    Scores and softmax in f32; the probabilities are cast to v's type
    before the value product, as the reference does."""
    b, t, h, d = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, n_kv, h // n_kv, d)
    scale = float(np.float32(1.0 / np.sqrt(d)))
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) * scale
    kpos = torch.arange(s, device=q.device)
    mask = None
    if causal:
        qpos = torch.arange(t, device=q.device)[:, None] + q_offset
        mask = (qpos >= kpos[None, :])[None, None, None]         # (T, S)
    if kv_len is not None:
        live = (kpos[None, :] < kv_len[:, None])[:, None, None, None, :]
        mask = live if mask is None else mask & live
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype).float(),
                       v.float()).to(v.dtype)
    return out.reshape(b, t, h, d)


def attention(q, k, v, *, mode: str = "naive", causal: bool = True,
              q_offset=0, kv_len: Optional[torch.Tensor] = None
              ) -> torch.Tensor:
    """Attention, q (B, T, H, hd), k/v (B, S, K, hd).

    ``"naive"`` materializes the score matrix (:func:`naive_attention`,
    the reference's mode of the same name), with ``q_offset``/``kv_len``.
    ``"flash"`` is the counterpart of the reference's ``"pallas"`` mode:
    the flash kernels through ``kernels.ops.flash_attention``, with their
    gradient and the causal ``q_offset``; it takes no ``kv_len`` (cached
    decode reads go through ``kernels.ops.flash_decode``). The
    reference's ``"chunked"`` XLA scan is not ported."""
    if mode == "naive":
        return naive_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len)
    if mode == "flash":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len)
    raise ValueError(f"unknown attention mode {mode!r}")
