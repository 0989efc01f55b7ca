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

:func:`rmsnorm_split` is the norm of a row split over ranks (the Mamba-2
gated norm under tensor parallelism): the kernel's partial-sum pass
(``LAUNCHES["rmsnorm_sumsq"]``), the caller's sum over the ranks, then
the kernel's scale pass (counted as ``rmsnorm``), with the plain
versions :func:`rmsnorm_sumsq_plain` and :func:`rmsnorm_scaled_plain`;
:func:`rmsnorm_split_backward` is its analytic gradient, whose one sum
over the ranks is each row's ``Σ dy·w·x`` (``kernels.ops.rmsnorm_split``
carries it under autograd).

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


def rmsnorm_sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """The partial-sum pass in plain torch: each row's sum of squares,
    ``(..., 1)`` in f32."""
    xf = x.to(_acc(x.dtype))
    return torch.sum(xf * xf, dim=-1, keepdim=True)


def rmsnorm_scaled_plain(x: torch.Tensor, w: torch.Tensor,
                         ss: torch.Tensor, n: int,
                         eps: float = 1e-5) -> torch.Tensor:
    """The scale pass in plain torch: ``x·rsqrt(ss/n + eps)·w`` with the
    row sums ``ss (..., 1)`` of a row ``n`` wide, rounded once to x's
    type."""
    xf = x.to(_acc(x.dtype))
    return (xf * torch.rsqrt(ss / n + eps) * w.to(xf.dtype)).to(x.dtype)


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


@functools.lru_cache(maxsize=None)
def _sumsq_entry():
    """The partial-sum pass's C entry point."""
    fn = _build.load("rmsnorm").rmsnorm_sumsq
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, ci, ci, ci, vp]
    fn.restype = ci
    return fn


@functools.lru_cache(maxsize=None)
def _scaled_entry():
    """The scale pass's C entry point."""
    fn = _build.load("rmsnorm").rmsnorm_scaled
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, vp, ci, ci, ci, ctypes.c_float, ci, ci, vp]
    fn.restype = ci
    return fn


def _split_checks(x, w=None, ss=None, n=None) -> None:
    d = x.shape[-1] if x.ndim else 0
    _check(x.ndim >= 1 and 0 < d <= MAX_D, f"x {tuple(x.shape)}: D={d} "
           f"must be in [1, {MAX_D}]")
    _check(x.dtype in _KINDS, f"x must be f32 or bf16, got {x.dtype}")
    if w is not None:
        _check(w.ndim == 1 and w.shape[0] == d and w.dtype in _KINDS,
               f"w {tuple(w.shape)} {w.dtype} must be (D,) f32 or bf16")
    if ss is not None:
        _check(ss.dtype == torch.float32 and
               tuple(ss.shape) == tuple(x.shape[:-1]) + (1,),
               f"ss {tuple(ss.shape)} {ss.dtype} must be f32 "
               f"{tuple(x.shape[:-1]) + (1,)}")
    if n is not None:
        _check(n >= d, f"the whole row's n={n} is narrower than the part "
               f"held, D={d}")
    dev = x.device
    for t in (x, w, ss):
        if t is not None:
            _check(t.device == dev, f"all tensors must be on {dev}, got "
                   f"{t.device}")
            _check(t.is_contiguous(), "tensors must be contiguous")
    _check(dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}")


def _sumsq_cuda(x: torch.Tensor) -> torch.Tensor:
    """The partial-sum pass: each row's f32 sum of squares, (..., 1)."""
    _split_checks(x)
    ss = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                     device=x.device)
    rows = x.numel() // x.shape[-1]
    # repro: allow[JIT-04] the row count is host metadata (the tensor's shape), not a device value
    if rows == 0:
        return ss
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _sumsq_entry()(x.data_ptr(), ss.data_ptr(), rows, x.shape[-1],
                            _KINDS[x.dtype], stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"rmsnorm_sumsq launch failed: CUDA error {rc}")
    LAUNCHES["rmsnorm_sumsq"] += 1
    return ss


def _scaled_cuda(x: torch.Tensor, w: torch.Tensor, ss: torch.Tensor,
                 n: int, eps: float = 1e-5) -> torch.Tensor:
    """The scale pass: x normalised by the row sums ``ss`` of rows ``n``
    wide."""
    _split_checks(x, w, ss, n)
    out = torch.empty_like(x)
    rows = x.numel() // x.shape[-1]
    # repro: allow[JIT-04] the row count is host metadata (the tensor's shape), not a device value
    if rows == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _scaled_entry()(x.data_ptr(), w.data_ptr(), ss.data_ptr(),
                             out.data_ptr(), rows, x.shape[-1], n, eps,
                             _KINDS[x.dtype], _KINDS[w.dtype], stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"rmsnorm scale pass failed: CUDA error {rc}")
    LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm_split(x: torch.Tensor, w: torch.Tensor, n: int, all_reduce,
                  eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMSNorm of rows split over ranks: ``x (..., D)`` is this rank's part
    of rows ``n`` wide and ``w (D,)`` its part of the weight. The f32 row
    sums of squares of each part are summed over the ranks by
    ``all_reduce`` (in place), then each rank scales its part by the
    whole row's rsqrt. CUDA tensors launch the kernel's two passes; CPU
    tensors run their plain versions. Returns the normed part and the
    whole rows' f32 sums of squares ``(..., 1)`` it was scaled by."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if x.is_cuda:
        ss = _sumsq_cuda(x)
        all_reduce(ss)
        return _scaled_cuda(x, w, ss, n, eps), ss
    ss = rmsnorm_sumsq_plain(x)
    all_reduce(ss)
    return rmsnorm_scaled_plain(x, w, ss, n, eps), ss


def rmsnorm_split_backward(x: torch.Tensor, w: torch.Tensor,
                           ss: torch.Tensor, dy: torch.Tensor, n: int,
                           all_reduce, eps: float = 1e-5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rmsnorm_split` on this rank's part for the
    output gradient ``dy``, from the whole rows' sums of squares ``ss``:
    with ``r = rsqrt(ss/n + eps)`` and ``g = dy·w``, each row's ``Σ g·x``
    over the whole row is this rank's f32 partial summed over the ranks
    by ``all_reduce`` (in place); ``dx = r·g - x·r³·Σ/n`` and ``dw =
    Σ_rows dy·x·r`` (this rank's channels), in f32, each rounded once to
    its input's type."""
    acc = _acc(x.dtype)
    xf, g = x.to(acc), dy.to(acc)
    rstd = torch.rsqrt(ss.to(acc) / n + eps)
    gw = g * w.to(acc)
    dot = all_reduce(torch.sum(gw * xf, dim=-1, keepdim=True))
    dx = rstd * gw - xf * (rstd * rstd * rstd) * (dot / n)
    dw = (g * (xf * rstd)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """``x (..., D)`` normalized over D and scaled by ``w (D,)``, in x's
    type. CUDA tensors launch the kernel; CPU tensors run the plain
    version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if x.is_cuda:
        return _rmsnorm_cuda(x, w, eps)
    return rmsnorm_plain(x, w, eps)
