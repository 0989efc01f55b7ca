"""Quantized weight tensors (the port of ``repro.quant.qtensor``): int8
row-wise and NF4 block-wise with double quantization.

* int8 - absmax over the last axis, so a weight ``(..., N)`` keeps codes
  of its own shape and f32 scales ``(..., 1)``; for a projection
  ``(K..., N...)`` these are one scale per K row (per K row and head for
  ``wq``/``wk``/``wv``), the form ``kernels.quant_matmul`` takes.
* nf4 - 4-bit NormalFloat codes packed two per byte, absmax per 64
  elements; the f32 block scales are themselves int8-quantized per 256
  (the QLoRA recipe).

Codes, scales and dequantized values equal the reference's bit for bit
on the same input: the same f32 arithmetic in the same order, ``/ 127.0``
included, and ``torch.round`` rounds half to even as ``jnp.round`` does.

A ``QTensor`` is a node of the port's parameter trees
(``models.params.tree_map``/``tree_paths`` walk ``data``, ``scale`` and
``scale2``), so slicing a stacked tree per layer slices it as
``lax.scan`` slices the reference's pytree: the fields are sliced and the
static ``shape`` is kept. An int8 ``shape`` therefore still names the
stacked shape after slicing; :meth:`QTensor.dequantize` never reads it
for int8, and callers take shapes from ``data``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.models.params import register_node, set_path, tree_paths

# NF4 quantiles (QLoRA paper, Appendix E)
NF4_CODE = (
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0)

NF4_BLOCK = 64
DQ_BLOCK = 256  # double-quant: scales quantized in blocks of 256


@dataclasses.dataclass
class QTensor:
    data: Any                 # int8 (int8 mode) or uint8 packed (nf4)
    scale: Any                # f32 row scales (int8) / int8 block scales (nf4)
    scale2: Any               # None (int8) | (f32 DQ-block scale, f32 mean)
    kind: str                 # "int8" | "nf4"
    shape: Tuple[int, ...]    # logical shape (nf4: per layer when stacked)
    dtype_orig: Any           # the quantized weight's dtype

    def dequantize(self, dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
        """The weight in ``dtype``. nf4: a leading stack axis is inferred
        from ``data.ndim``, so a per-layer slice dequantizes to the
        per-layer shape."""
        if self.kind == "int8":
            return (self.data.to(torch.float32)
                    * self.scale.to(torch.float32)).to(dtype)
        stacked = self.data.ndim == 2
        lead = (self.data.shape[0],) if stacked else ()
        lo = (self.data & 0x0F).long()
        hi = (self.data >> 4).long()
        codes = torch.stack([hi, lo], dim=-1).reshape(*lead, -1)
        vals = _nf4_code(self.data.device)[codes]
        s_q, (s_scale, s_mean) = self.scale, self.scale2
        nb = s_q.shape[-1]
        s2e = s_scale.repeat_interleave(DQ_BLOCK, dim=-1)[..., :nb]
        absmax = s_q.to(torch.float32) * s2e + s_mean
        w = vals.reshape(*lead, nb, NF4_BLOCK) * absmax[..., None]
        numel = math.prod(self.shape)            # drop block padding
        w = w.reshape(*lead, -1)[..., :numel]
        return w.reshape(*lead, *self.shape).to(dtype)


register_node(QTensor, ("data", "scale", "scale2"))


def _nf4_code(device) -> torch.Tensor:
    return torch.tensor(NF4_CODE, dtype=torch.float32, device=device)


def quantize_int8(w: torch.Tensor) -> QTensor:
    """Per-output-channel: absmax over the last axis."""
    wf = w.to(torch.float32)
    amax = wf.abs().amax(dim=-1, keepdim=True)
    # repro: allow[NUM-01] bit-equal to the reference's quantize_int8, which divides by 127.0; eager torch has no compilation to disagree with
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return QTensor(q, scale, None, "int8", tuple(w.shape), w.dtype)


def quantize_nf4(w: torch.Tensor, stacked: bool = False) -> QTensor:
    """Block-wise NF4 with double-quantized absmax scales. ``stacked``:
    dim 0 is a layer stack, quantized per row so a per-layer slice is a
    whole QTensor."""
    lead = (w.shape[0],) if stacked else ()
    row_shape = tuple(w.shape[1:]) if stacked else tuple(w.shape)
    f32 = torch.float32
    wf = w.to(f32).reshape(*lead, -1)
    pad = (-wf.shape[-1]) % NF4_BLOCK
    if pad:
        wf = torch.cat([wf, wf.new_zeros(*lead, pad)], dim=-1)
    blocks = wf.reshape(*lead, -1, NF4_BLOCK)
    absmax = torch.clamp_min(blocks.abs().amax(dim=-1), 1e-8)
    normed = blocks / absmax[..., None]
    dist = (normed[..., None] - _nf4_code(w.device)).abs()
    codes = torch.argmin(dist, dim=-1).to(torch.uint8)
    flat = codes.reshape(*lead, -1, 2)
    packed = (flat[..., 0] << 4) | flat[..., 1]
    # double quantization of the scales (per row)
    nb = absmax.shape[-1]
    pad2 = (-nb) % DQ_BLOCK
    am = (torch.cat([absmax, absmax.new_zeros(*lead, pad2)], dim=-1)
          if pad2 else absmax)
    mean = absmax.mean(dim=-1, keepdim=True)
    g = (am - mean).reshape(*lead, -1, DQ_BLOCK)
    # repro: allow[NUM-01] bit-equal to the reference's quantize_nf4, which divides by 127.0; eager torch has no compilation to disagree with
    s2 = torch.clamp_min(g.abs().amax(dim=-1), 1e-8) / 127.0
    s_q = torch.clamp(torch.round(g / s2[..., None]), -127, 127
                      ).to(torch.int8).reshape(*lead, -1)[..., :nb]
    return QTensor(packed, s_q, (s2, mean), "nf4", row_shape, w.dtype)


_QUANT_SKIP_NAMES = ("ln", "norm", "final_ln", "enc_final_ln", "bq", "bk",
                     "bv", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
                     "q_norm", "k_norm", "router")
QUANT_MIN_SIZE = 4096        # smaller weights stay in full precision


def quantize_tree(params, kind: str):
    """Quantize every large linear weight of a parameter tree (``kind``
    "int8" or "nf4"). Norms, biases, convs and routers stay in full
    precision; weights under ``blocks`` are stacked on a leading layer
    axis, which nf4 quantizes per layer."""
    out: dict = {}
    for path, leaf in tree_paths(params):
        name = path.rsplit("/", 1)[-1]
        stacked = path.startswith("blocks/")
        eff_ndim = leaf.ndim - (1 if stacked else 0)
        if (name in _QUANT_SKIP_NAMES or eff_ndim < 2
                or leaf.numel() < QUANT_MIN_SIZE):
            set_path(out, path, leaf)
        elif kind == "int8":
            set_path(out, path, quantize_int8(leaf))
        else:
            set_path(out, path, quantize_nf4(
                leaf, stacked=stacked and leaf.ndim >= 2))
    return out
