"""Fused RMSNorm: the CUDA kernel's wrapper, its plain version and the
analytic backward (the port of ``repro.kernels.rmsnorm``).

``x (..., D) · rsqrt(mean(x²) + eps) · w`` in f32, rounded once to x's
type; x and w bf16 or f32 each.

On CUDA tensors :func:`rmsnorm` launches the hand-written kernel of
``csrc/rmsnorm.cu`` (it replaces the TPU kernel ``_rmsnorm_kernel``) or
raises; it never falls back. On CPU tensors it runs the plain version
:func:`rmsnorm_plain`, the body of the models' ``layers.rmsnorm``, which
is also the kernel's oracle on the card. Every launch adds one to
``LAUNCHES["rmsnorm"]``; nothing else does.

The JAX package has no backward kernel (XLA differentiates the jnp
form); :func:`rmsnorm_backward` is the analytic gradient in plain torch
ops, recomputing ``rstd`` from x.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Tuple

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel of this module
LAUNCHES: Counter = Counter()

MAX_D = 8192                       # kMaxD in the kernel
_KINDS = {torch.float32: 0, torch.bfloat16: 1}


def _acc(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16 and f32 inputs (the models' types); f64 stays f64, so
    the gradient can be checked numerically."""
    return torch.promote_types(dtype, torch.float32)


def rmsnorm_plain(x: torch.Tensor, w: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain torch: ``layers.rmsnorm``'s body."""
    xf = x.to(_acc(x.dtype))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * w.to(xf.dtype)).to(x.dtype)


def rmsnorm_backward(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                     eps: float = 1e-5
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rmsnorm_plain` for the output gradient
    ``dy``: with ``r = rsqrt(mean(x²) + eps)`` and ``g = dy·w``,
    ``dx = r·(g - x·r²·mean(g·x))`` and ``dw = Σ_rows dy·(x·r)``, in
    f32, each rounded once to its input's type."""
    acc = _acc(x.dtype)
    xf, g = x.to(acc), dy.to(acc)
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gw = g * w.to(acc)
    dx = rstd * (gw - xf * (rstd * rstd)
                 * torch.mean(gw * xf, dim=-1, keepdim=True))
    dw = (g * (xf * rstd)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


# ==========================================================================
# The CUDA kernel's wrapper
# ==========================================================================


def _check(cond: bool, msg: str) -> None:
    # repro: allow[JIT-04] the wrapper's checks read tensor metadata (device, dtype, shape, strides), never device values
    if not cond:
        raise ValueError(f"rmsnorm: {msg}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded on first use, with its
    ctypes signature set once."""
    fn = _build.load("rmsnorm").rmsnorm
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ci, ci, ctypes.c_float, ci, ci, vp]
    fn.restype = ci
    return fn


def rows_per_block(rows: int, d: int, dtype: torch.dtype) -> int:
    """Rows of x that one block of the kernel normalizes at this shape, as
    the library launches it: 1 below 1,024 rows (a row spread over a
    block), else as many as a 256-thread block holds (8 at D 1,024 bf16)."""
    _check(0 < d <= MAX_D and rows > 0 and dtype in _KINDS,
           f"no launch for rows={rows} D={d} {dtype}")
    fn = _build.load("rmsnorm").rmsnorm_rows_per_block
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(rows, d, _KINDS[dtype])


def _rmsnorm_cuda(x, w, eps: float = 1e-5) -> torch.Tensor:
    _check(x.ndim >= 1 and w.ndim == 1 and w.shape[0] == x.shape[-1],
           f"x {tuple(x.shape)} and w {tuple(w.shape)}: w must be (D,) "
           f"with D the last axis of x")
    d = x.shape[-1]
    _check(0 < d <= MAX_D, f"D={d} must be in [1, {MAX_D}]")
    _check(x.dtype in _KINDS and w.dtype in _KINDS,
           f"x and w must be f32 or bf16, got {x.dtype}, {w.dtype}")
    dev = x.device
    _check(dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}")
    for t in (x, w):
        _check(t.device == dev, f"all tensors must be on {dev}, got "
               f"{t.device}")
        _check(t.is_contiguous(), "tensors must be contiguous")
    out = torch.empty_like(x)
    rows = x.numel() // d
    if rows == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d,
                      eps, _KINDS[x.dtype], _KINDS[w.dtype], stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"rmsnorm launch failed: CUDA error {rc}")
    LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x (..., D)`` normalized over D and scaled by ``w (D,)``, in x's
    type. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if x.is_cuda:
        return _rmsnorm_cuda(x, w, eps)
    return rmsnorm_plain(x, w, eps)
