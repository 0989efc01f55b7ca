"""Int8 gradient compression with error feedback (the port of
``repro.parallel.compression``; beyond the paper: it cuts a DP
all-reduce's bytes 4x against f32 at the cost of one elementwise pass).

Scheme (1-bit-Adam family, simplified to int8):
  send = quantize(grad + error_carry)
  error_carry' = (grad + error_carry) - dequantize(send)
  allreduce(send) -> dequant -> optimizer

The reference's arithmetic, bit for bit: blocks of ``BLOCK`` values of
the flattened f32 gradient (zero-padded), one scale a block,
``max(absmax, 1e-12) / 127.0`` (a division, not a product with 1/127),
codes ``round(x / scale)`` with ``torch.round`` (half to even) clipped
to +-127. :func:`compressed_psum` sums each rank's dequantized codes in
f32 over the data axes (``ShardCtx.dp_all_reduce``), as the reference's
``local`` does under ``shard_map``.

Like the reference's, the training step never reads
``Technique.grad_compress`` (in the reference only ``core/config.py``
names it): the flag is inert, and a step with it equals the step
without it bit for bit. This module is the compressor, held against the
reference's on its own.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

BLOCK = 1024


def _enc(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    b = flat.reshape(-1, BLOCK).to(torch.float32)
    # repro: allow[NUM-01] bit-equal to the reference's _enc, which divides by 127.0; eager torch has no compilation to disagree with
    s = torch.clamp_min(b.abs().amax(dim=-1), 1e-12) / 127.0
    q = torch.clamp(torch.round(b / s[:, None]), -127, 127).to(torch.int8)
    return q, s


def _dec(q: torch.Tensor, s: torch.Tensor, shape,
         dtype: torch.dtype) -> torch.Tensor:
    flat = (q.to(torch.float32) * s[:, None]).reshape(-1)
    return flat[: math.prod(shape)].reshape(shape).to(dtype)


def compress_grad(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q, scales, new_error). Error feedback keeps the
    quantization bias out of the optimizer trajectory."""
    corrected = g.to(torch.float32) + err.to(torch.float32)
    q, s = _enc(corrected)
    recon = _dec(q, s, tuple(g.shape), torch.float32)
    return q, s, (corrected - recon).to(err.dtype)


def decompress_grad(q: torch.Tensor, s: torch.Tensor, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _dec(q, s, tuple(shape), dtype)


def init_error_state(grads_like):
    """f32 zeros shaped like each gradient leaf (a dict tree)."""
    from repro_torch.models.params import tree_map
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(ctx, g_local: torch.Tensor, err: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sum over the data axes of ``ctx`` (a
    ``parallel.sharding.ShardCtx``) of every rank's int8-compressed local
    gradient contribution ``g_local``: each rank's codes dequantized to
    f32, summed, cut to ``g_local``'s shape and type. Returns (the sum,
    this rank's new error carry)."""
    q, s, new_err = compress_grad(g_local, err)
    acc = q.to(torch.float32) * s[:, None]
    ctx.dp_all_reduce(acc)
    flat = acc.reshape(-1)[: g_local.numel()]
    return flat.reshape(g_local.shape).to(g_local.dtype), new_err
