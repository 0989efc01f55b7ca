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
``LAUNCHES["int8_matmul"]`` and to ``BODIES`` under the body it ran;
nothing else does.

The kernel has two bodies; :func:`qmm_body` says which one a shape takes.
The tensor-core body feeds every term to bf16 ``mma.sync`` as parts that
are exact: the f32 operand that carries the scale (``q·s``, or ``x·s``
where G = 1 and x is f32) split in three by
:func:`~repro_torch.kernels.flash_attention.split_bf16`, the other operand
as it is (bf16 x, int8 codes) or, for f32 x under the scale on the weight,
split too (six part products, those of weight >= 2^-16). The SIMT body
(f32 FMA) takes the shapes the tensor-core body does not.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import split_bf16

#: launches of the CUDA kernel of this module
LAUNCHES: Counter = Counter()
#: the same launches by the body they ran (:func:`qmm_body`'s names)
BODIES: Counter = Counter()

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


def _qmm_split_torch(x, w_q, scale, *, placement: str = "w",
                     hi_only: bool = False,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """The tensor-core body's arithmetic in plain torch (a model for the
    tests, no route of the models): the operand that carries the scale,
    ``q·s`` (``placement="w"``) or ``x·s`` (``"x"``, G = 1 only), formed
    in f32 and split into three bf16 parts by :func:`split_bf16`, which
    rebuild it exactly; the other operand as it is (bf16 x, or the codes,
    exact in bf16), or also split in three (f32 x under ``"w"``). The part
    products of weight >= 2^-16 (index sum <= 2) are each exact in f32 and
    are summed in f32; ``hi_only`` keeps the hi parts alone (the planted
    fault's build)."""
    f = torch.float32
    if placement == "w":
        a = ((x,) if x.dtype == torch.bfloat16 else split_bf16(x.to(f), 3))
        b = split_bf16(dequantize_groups(w_q, scale), 3)
    elif placement == "x":
        if scale.shape[1] != 1:
            raise ValueError("the scale goes on x only where G = 1")
        a = split_bf16(x.to(f) * scale[:, 0].to(f), 3)
        b = (w_q.to(torch.bfloat16),)
    else:
        raise ValueError(f"placement must be 'w' or 'x', got {placement!r}")
    top = 0 if hi_only else 2
    out = None
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            if i + j <= top:
                term = torch.matmul(ai.to(f), bj.to(f))
                out = term if out is None else out + term
    return out.to(out_dtype or x.dtype)


# ==========================================================================
# The CUDA kernel's wrapper
# ==========================================================================


def _check(cond: bool, msg: str) -> None:
    # repro: allow[JIT-04] the wrapper's checks read tensor metadata (device, dtype, shape, strides), never device values
    if not cond:
        raise ValueError(f"int8_matmul: {msg}")


@functools.lru_cache(maxsize=None)
def _entries(defines: Tuple[str, ...] = ()):
    """The kernel's C entry points, built and loaded on first use, with
    their ctypes signatures set once (``defines``: a variant build's
    macros, which only a planted fault's check uses)."""
    lib = _build.load("quant_matmul", defines)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.int8_matmul
    fn.argtypes = [vp] * 4 + [ci] * 6 + [vp]
    fn.restype = ci
    body, k_tile = lib.int8_matmul_body, lib.int8_matmul_k_tile
    for f in (body, k_tile):
        f.argtypes = [ci] * 5
        f.restype = ci
    return {"int8_matmul": fn, "body": body, "k_tile": k_tile}


#: int8_matmul_body's codes
_BODIES = {0: "simt", 1: "mma_w", 2: "mma_x"}


def qmm_body(x_dtype: torch.dtype, m: int, n: int, k: int, g: int) -> str:
    """Which body the kernel runs for 16-byte-aligned operands (every fresh
    allocation) of these shapes, as the library dispatches: ``"mma_w"``
    (bf16 tensor cores, the scale on the weight), ``"mma_x"`` (the scale on
    x: f32 x with G = 1) or ``"simt"`` (the f32 FMA body)."""
    code = _entries()["body"](_KINDS[x_dtype], m, n, k, g)
    _check(code in _BODIES, f"no body takes M={m} N={n} K={k} G={g}")
    return _BODIES[code]


def k_tile(x_dtype: torch.dtype, m: int, n: int, k: int, g: int) -> int:
    """The K tile the body :func:`qmm_body` names walks (64 for bf16 x on
    the tensor cores, 32 otherwise)."""
    tile = _entries()["k_tile"](_KINDS[x_dtype], m, n, k, g)
    _check(tile > 0, f"no body takes M={m} N={n} K={k} G={g}")
    return tile


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
    # the library's rule: a pointer off 16 bytes takes the SIMT body
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w_q, scale, out))
    body = qmm_body(x.dtype, m, n, k, g) if aligned else "simt"
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entries()["int8_matmul"](
            x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            m, n, k, g, _KINDS[x.dtype], _KINDS[out_dtype], stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"int8_matmul launch failed: CUDA error {rc}")
    LAUNCHES["int8_matmul"] += 1
    BODIES[body] += 1
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
