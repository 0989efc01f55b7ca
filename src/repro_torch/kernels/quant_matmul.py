"""Weight-only int8 matrix product: the CUDA kernel's wrapper and its
plain version (the port of ``repro.kernels.quant_matmul``).

``x (M, K) @ W`` with ``W = w_q (K, N) int8 · scale``: x bf16 or f32,
accumulated in f32 and written in ``out_dtype`` (default x's type).
``scale`` is f32 ``(K, G)``: G = 1 is the TPU kernel's ``(K, 1)`` row
scale; G > 1 gives each of G equal column groups of N its own scale, the
per-(row, head) scales of a ``(d, H, hd)`` projection
(``quant.qtensor.quantize_int8`` takes absmax over the last axis). Each
group computes the TPU kernel's function. The weight is dequantized to
f32 in both versions, never rounded to x's type.

On CUDA tensors :func:`int8_matmul_kernel` launches the hand-written
kernel of ``csrc/quant_matmul.cu`` (it replaces the TPU kernel
``_qmm_kernel``) or raises; it never falls back. On CPU tensors it runs
the plain version :func:`int8_matmul_plain`, which is also the kernel's
oracle on the card. Every launch adds one to
``LAUNCHES["int8_matmul"]``; nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel of this module
LAUNCHES: Counter = Counter()

_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def dequantize_groups(w_q: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """``w_q (K, N) · scale (K, G)`` in f32, column group ``n // (N/G)``
    scaled by ``scale[:, g]``."""
    k, n = w_q.shape
    g = scale.shape[1]
    return (w_q.to(torch.float32).reshape(k, g, n // g)
            * scale.to(torch.float32)[:, :, None]).reshape(k, n)


def int8_matmul_plain(x, w_q, scale, *,
                      out_dtype: Optional[torch.dtype] = None
                      ) -> torch.Tensor:
    """The kernel's function in plain torch: ``(x.float() @ W).to(out)``
    with W dequantized to f32."""
    return torch.matmul(x.to(torch.float32), dequantize_groups(w_q, scale)
                        ).to(out_dtype or x.dtype)


# ==========================================================================
# The CUDA kernel's wrapper
# ==========================================================================


def _check(cond: bool, msg: str) -> None:
    # repro: allow[JIT-04] the wrapper's checks read tensor metadata (device, dtype, shape, strides), never device values
    if not cond:
        raise ValueError(f"int8_matmul: {msg}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded on first use, with its
    ctypes signature set once."""
    fn = _build.load("quant_matmul").int8_matmul
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 4 + [ci] * 6 + [vp]
    fn.restype = ci
    return fn


def _qmm_cuda(x, w_q, scale, *, out_dtype: Optional[torch.dtype] = None):
    out_dtype = out_dtype or x.dtype
    _check(x.ndim == 2 and w_q.ndim == 2 and scale.ndim == 2,
           "x must be (M, K), w_q (K, N) and scale (K, G)")
    m, k = x.shape
    n = w_q.shape[1]
    g = scale.shape[1]
    _check(w_q.shape[0] == k and scale.shape[0] == k,
           f"x {tuple(x.shape)}, w_q {tuple(w_q.shape)} and scale "
           f"{tuple(scale.shape)} disagree on K")
    _check(m > 0 and n > 0 and k > 0 and g > 0 and n % g == 0,
           f"N={n} must split into G={g} equal groups (M={m}, K={k})")
    _check(x.dtype in _KINDS and out_dtype in _KINDS,
           f"x and out must be f32 or bf16, got {x.dtype} -> {out_dtype}")
    _check(w_q.dtype == torch.int8 and scale.dtype == torch.float32,
           f"w_q must be int8 and scale f32, got {w_q.dtype}, "
           f"{scale.dtype}")
    dev = x.device
    _check(dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}")
    for t in (x, w_q, scale):
        _check(t.device == dev, f"all tensors must be on {dev}, got "
               f"{t.device}")
        _check(t.is_contiguous(), "tensors must be contiguous")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                      out.data_ptr(), m, n, k, g, _KINDS[x.dtype],
                      _KINDS[out_dtype], stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {rc}")
    LAUNCHES["int8_matmul"] += 1
    return out


def int8_matmul_kernel(x, w_q, scale, *,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``x (M, K) @ (w_q (K, N) · scale (K, G))`` -> (M, N) in
    ``out_dtype`` (default x's type). CUDA tensors launch the kernel; CPU
    tensors run the plain version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if x.is_cuda:
        return _qmm_cuda(x, w_q, scale, out_dtype=out_dtype)
    return int8_matmul_plain(x, w_q, scale, out_dtype=out_dtype)
