"""Flash attention forward and backward, and their plain versions.

The port of ``repro.kernels.flash_attention``. Layout as in the
reference: q (B, H, T, D); k, v (B, K, S, D) with H = K * G (GQA: query
head h reads K/V head h // G). Causal masking is top-left aligned (query
row i sees key columns j <= i, no offset), masked scores are -1e30 and
never -inf.

- :func:`flash_attention_fwd` returns (o in q.dtype, lse f32 (B,H,T,1)).
- :func:`flash_attention_bwd` returns (dq in q.dtype, dk, dv in k.dtype);
  dk and dv are summed over the G query heads of a group in f32 before
  the cast, as the reference sums its per-head f32 buffers.

The reference's ``bq``/``bk`` arguments are the TPU's VMEM tiling and
have no counterpart here: the CUDA kernels pick their own tiles, which
change the summation order only.

On CUDA tensors the wrappers launch the hand-written kernels of
``csrc/flash_attention.cu`` (they replace the TPU kernels ``_fwd_kernel``,
``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``) or raise; they never fall
back. The forward and the backward of bf16 inputs at head_dim 64 or 128
run on the tensor cores with P (and dS) split into bf16 hi + lo
(:func:`_flash_fwd_split_torch` and :func:`_flash_bwd_split_torch` repeat
that arithmetic on the CPU); :func:`fwd_body` and :func:`bwd_body` say
which body a case takes. On CPU tensors they run
the plain versions :func:`_flash_fwd_torch` and :func:`_flash_bwd_torch`,
which repeat the kernels' arithmetic on the whole score matrix and are
the oracle the kernels are held against on the card.

Every launch adds one to ``LAUNCHES[name]`` for ``name`` in ``fwd``,
``bwd_dkv`` and ``bwd_dq``; nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: launches of each CUDA kernel of this module, by kernel name
LAUNCHES: Counter = Counter()

_DTYPE_KIND = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEAD_DIM = 128


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return sm_scale or 1.0 / float(np.sqrt(d))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for bf16/f32 inputs (the kernels' type); f64 stays f64 so the
    plain version can be gradient-checked."""
    return torch.promote_types(dtype, torch.float32)


# ==========================================================================
# Plain versions (CPU path, and the kernels' oracle on the card)
# ==========================================================================


def _scores(q, k, causal: bool, scale: float):
    """(B, K, G, T, S) scores of ``q·scale`` against k, masked to -1e30
    above the diagonal when causal."""
    b, h, t, d = q.shape
    n_kv, s = k.shape[1], k.shape[2]
    acc = _acc_dtype(q.dtype)
    qg = q.reshape(b, n_kv, h // n_kv, t, d).to(acc) * scale
    sc = torch.einsum("bkgtd,bksd->bkgts", qg, k.to(acc))
    if causal:
        keep = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s, device=q.device)[None, :])
        sc = torch.where(keep, sc, torch.full((), NEG_INF, dtype=acc,
                                              device=q.device))
    return sc


def _flash_fwd_torch(q, k, v, *, causal: bool = True,
                     sm_scale: Optional[float] = None):
    """The forward kernel's function on the whole score matrix: max,
    exp, sum and the value product in f32; ``o = acc / max(l, 1e-30)``
    and ``lse = m + log(max(l, 1e-30))``. Key tiles the kernel skips
    above the diagonal hold only masked scores, whose weight
    exp(-1e30 - m) is exactly 0 here."""
    b, h, t, d = q.shape
    acc = _acc_dtype(q.dtype)
    s = _scores(q, k, causal, _scale(d, sm_scale))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    o = torch.einsum("bkgts,bksd->bkgtd", p, v.to(acc)) / l
    lse = m + torch.log(l)
    return (o.reshape(b, h, t, d).to(q.dtype), lse.reshape(b, h, t, 1))


def _flash_bwd_torch(q, k, v, out, lse, do, *, causal: bool = True,
                     sm_scale: Optional[float] = None, part: str = "all"):
    """The backward kernels' function: ``p = exp(s - lse)``,
    ``delta = rowsum(dO∘O)``, ``ds = p·(dp - delta)·scale``; dq = ds·k,
    dk = dsᵀ·q and dv = pᵀ·dO, the last two summed over the G query heads
    of each K/V head in f32 before the cast.

    ``part`` is ``"all"``, ``"dkv"`` (the dK/dV kernel's function; dq is
    None) or ``"dq"`` (the dQ kernel's; dk and dv are None)."""
    b, h, t, d = q.shape
    n_kv = k.shape[1]
    g = h // n_kv
    acc = _acc_dtype(q.dtype)
    scale = _scale(d, sm_scale)
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, n_kv, g, t, 1).to(acc))
    dog = do.reshape(b, n_kv, g, t, d).to(acc)
    delta = (out.to(acc) * do.to(acc)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgtd,bksd->bkgts", dog, v.to(acc))
    ds = p * (dp - delta.reshape(b, n_kv, g, t, 1)) * scale
    dq = dk = dv = None
    if part in ("all", "dq"):
        dq = torch.einsum("bkgts,bksd->bkgtd", ds, k.to(acc))
        dq = dq.reshape(b, h, t, d).to(q.dtype)
    if part in ("all", "dkv"):
        qg = q.reshape(b, n_kv, g, t, d).to(acc)
        dk = torch.einsum("bkgts,bkgtd->bksd", ds, qg).to(k.dtype)
        dv = torch.einsum("bkgts,bkgtd->bksd", p, dog).to(v.dtype)
    return dq, dk, dv


def split_bf16(x: torch.Tensor, parts: int = 2):
    """f32 ``x`` as ``parts`` bf16 tensors, each the bf16 rounding of what
    the ones before it leave: ``hi = bf16(x)``, ``lo = bf16(x - hi)``, ...
    Every remainder is exact in f32 and each rounding keeps 8 bits, so the
    parts sum to ``x`` within 2^(-8·parts) |x|: 2^-16 for hi + lo, 2^-24
    (an f32 rounding) for three parts."""
    out = []
    rest = x
    for i in range(parts):
        out.append(rest.to(torch.bfloat16))
        if i + 1 < parts:
            rest = rest - out[-1].float()
    return tuple(out)


def _flash_fwd_split_torch(q, k, v, *, causal: bool = True,
                           sm_scale: Optional[float] = None):
    """The tensor-core forward body's arithmetic, for bf16 inputs: S = q·k
    from the bf16 values (f32 sums), then ``S·scale`` masked; ``m``, ``p =
    exp(S·scale - m)`` and ``l = sum(p)`` in f32, then ``p`` split into
    bf16 hi + lo (:func:`split_bf16`) and each half multiplied by v in f32,
    the two products summed: ``o = (p_hi·v + p_lo·v) / max(l, 1e-30)``
    rounded once to the inputs' type, ``lse = m + log(max(l, 1e-30))``.
    The plain version's function to within 2^-16 relative per ``p``
    element (and, at a scale that is not a power of two, one f32 rounding
    per score). The kernel takes m and the split per key tile (online);
    this takes them over the whole row, which moves only roundoff."""
    b, h, t, d = q.shape
    n_kv, s_len = k.shape[1], k.shape[2]
    g = h // n_kv
    f = torch.float32
    qg = q.reshape(b, n_kv, g, t, d).to(f)
    sc = torch.einsum("bkgtd,bksd->bkgts", qg, k.to(f)) * _scale(d, sm_scale)
    if causal:
        keep = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s_len, device=q.device)[None, :])
        sc = torch.where(keep, sc, torch.full((), NEG_INF, device=q.device))
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = torch.clamp_min(p.sum(-1, keepdim=True), 1e-30)
    p_hi, p_lo = (x.float() for x in split_bf16(p))
    o = (torch.einsum("bkgts,bksd->bkgtd", p_hi, v.to(f))
         + torch.einsum("bkgts,bksd->bkgtd", p_lo, v.to(f))) / l
    lse = m + torch.log(l)
    return (o.reshape(b, h, t, d).to(q.dtype), lse.reshape(b, h, t, 1))


def _flash_bwd_split_torch(q, k, v, out, lse, do, *, causal: bool = True,
                           sm_scale: Optional[float] = None):
    """The tensor-core backward body's arithmetic, for bf16 inputs: S =
    q·k and dP = dO·v from the bf16 values (f32 sums), ``S·scale`` into
    ``p = exp(· - lse)`` and ``ds = p·(dp - delta)·scale`` in f32, then
    ``p`` and ``ds`` split into bf16 hi + lo (:func:`split_bf16`) and
    each half multiplied in f32, the two products summed: dv = p_hiᵀ·dO
    + p_loᵀ·dO, dk = ds_hiᵀ·q + ds_loᵀ·q, dq = ds_hi·k + ds_lo·k. The
    plain version's function to within 2^-16 relative per ``p`` and
    ``ds`` element, before the one rounding to the inputs' type."""
    b, h, t, d = q.shape
    n_kv, s_len = k.shape[1], k.shape[2]
    g = h // n_kv
    scale = _scale(d, sm_scale)
    f = torch.float32
    qg = q.reshape(b, n_kv, g, t, d).to(f)
    dog = do.reshape(b, n_kv, g, t, d).to(f)
    sc = torch.einsum("bkgtd,bksd->bkgts", qg, k.to(f)) * scale
    if causal:
        keep = (torch.arange(t, device=q.device)[:, None]
                >= torch.arange(s_len, device=q.device)[None, :])
        sc = torch.where(keep, sc, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(sc - lse.reshape(b, n_kv, g, t, 1).to(f))
    delta = (out.to(f) * do.to(f)).sum(-1, keepdim=True)
    dp = torch.einsum("bkgtd,bksd->bkgts", dog, v.to(f))
    ds = p * (dp - delta.reshape(b, n_kv, g, t, 1)) * scale
    p_hi, p_lo = (x.float() for x in split_bf16(p))
    ds_hi, ds_lo = (x.float() for x in split_bf16(ds))
    dq = (torch.einsum("bkgts,bksd->bkgtd", ds_hi, k.to(f))
          + torch.einsum("bkgts,bksd->bkgtd", ds_lo, k.to(f)))
    dk = (torch.einsum("bkgts,bkgtd->bksd", ds_hi, qg)
          + torch.einsum("bkgts,bkgtd->bksd", ds_lo, qg))
    dv = (torch.einsum("bkgts,bkgtd->bksd", p_hi, dog)
          + torch.einsum("bkgts,bkgtd->bksd", p_lo, dog))
    return (dq.reshape(b, h, t, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ==========================================================================
# The CUDA kernels' wrappers
# ==========================================================================


def _check(cond: bool, msg: str) -> None:
    # repro: allow[JIT-04] the wrapper's checks read tensor metadata (device, dtype, shape, strides), never device values
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


@functools.lru_cache(maxsize=None)
def _entries(defines: Tuple[str, ...] = ()):
    """The kernels' C entry points, built and loaded on first use, with
    their ctypes signatures set once (``defines``: a variant build's
    macros, which only a planted fault's check uses)."""
    lib = _build.load("flash_attention", defines)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dims = [ci] * 7                  # kind, B, H, K, T, S, D
    fwd = lib.flash_attention_fwd
    fwd.argtypes = [vp] * 5 + dims + [ci, cf, vp]
    bwd_dkv = lib.flash_attention_bwd_dkv
    bwd_dkv.argtypes = [vp] * 8 + dims + [ci, cf, vp]
    bwd_dq = lib.flash_attention_bwd_dq
    bwd_dq.argtypes = [vp] * 8 + dims + [ci, cf, vp]
    fwd_body = lib.flash_attention_fwd_body
    bwd_body = lib.flash_attention_bwd_body
    for fn in (fwd_body, bwd_body):
        fn.argtypes = [ci, ci]
    for fn in (fwd, bwd_dkv, bwd_dq, fwd_body, bwd_body):
        fn.restype = ci
    return {"fwd": fwd, "bwd_dkv": bwd_dkv, "bwd_dq": bwd_dq,
            "fwd_body": fwd_body, "bwd_body": bwd_body}


def fwd_body(dtype: torch.dtype, d: int) -> str:
    """Which body the forward kernel runs for inputs of ``dtype`` and
    head_dim ``d`` on the card, as the library dispatches: ``"mma"`` (bf16
    tensor-core tiles, D 64 or 128) or ``"simt"`` (the f32 FMA body)."""
    return "mma" if _entries()["fwd_body"](_DTYPE_KIND[dtype], d) else \
        "simt"


def bwd_body(dtype: torch.dtype, d: int) -> str:
    """Which body the backward kernels run for inputs of ``dtype`` and
    head_dim ``d`` on the card, as the library dispatches: ``"mma"`` (bf16
    tensor-core tiles, D 64 or 128) or ``"simt"`` (the f32 FMA body)."""
    return "mma" if _entries()["bwd_body"](_DTYPE_KIND[dtype], d) else \
        "simt"


def _check_qkv(q, k, v) -> Tuple[int, int, int, int, int, int]:
    _check(q.ndim == 4 and k.ndim == 4 and v.ndim == 4,
           "q, k, v must be (B, H, T, D) and (B, K, S, D)")
    b, h, t, d = q.shape
    _, n_kv, s, dk = k.shape
    _check(q.dtype in _DTYPE_KIND and k.dtype == q.dtype and
           v.dtype == q.dtype, f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: "
           f"q, k, v must share one of bf16/f32")
    _check(tuple(v.shape) == tuple(k.shape) and k.shape[0] == b,
           f"k {tuple(k.shape)} / v {tuple(v.shape)} do not fit q "
           f"{tuple(q.shape)}")
    _check(dk == d and 0 < d <= _MAX_HEAD_DIM,
           f"head_dim {dk} vs q {d}, must match and be <= {_MAX_HEAD_DIM}")
    _check(n_kv > 0 and h % n_kv == 0, f"{h} heads over {n_kv} kv heads")
    return b, h, n_kv, t, s, d


def _check_device(dev, tensors) -> None:
    _check(dev.type == "cuda", f"the kernels take CUDA tensors, got {dev}")
    for x in tensors:
        _check(x.device == dev, f"all tensors must be on {dev}, got "
               f"{x.device}")
        _check(x.is_contiguous(), "tensors must be contiguous")


def _launch(name: str, *args) -> None:
    rc = _entries()[name](*args)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"flash_attention {name} launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES[name] += 1


def _fwd_cuda(q, k, v, *, causal: bool, sm_scale: Optional[float]):
    b, h, n_kv, t, s, d = _check_qkv(q, k, v)
    dev = q.device
    _check_device(dev, (q, k, v))
    o = torch.empty_like(q)
    lse = torch.empty((b, h, t, 1), dtype=torch.float32, device=dev)
    if b * h * t == 0:
        return o, lse
    _check(s > 0, "no keys to attend")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _launch("fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                o.data_ptr(), lse.data_ptr(), _DTYPE_KIND[q.dtype], b, h,
                n_kv, t, s, d, int(causal), _scale(d, sm_scale), stream)
    return o, lse


def _delta(out, do):
    """rowsum(dO∘O) in f32, (B,H,T,1): computed outside the kernels, as
    the reference does, for the FMA body (the tensor-core dQ kernel
    computes it itself)."""
    return (out.float() * do.float()).sum(-1, keepdim=True)


def _bwd_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool, scale: float):
    """(dk, dv): one launch of the dK/dV kernel, on inputs
    :func:`_bwd_cuda` has checked."""
    b, h, t, d = q.shape
    n_kv, s = k.shape[1], k.shape[2]
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("bwd_dkv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), _DTYPE_KIND[q.dtype], b, h,
                n_kv, t, s, d, int(causal), scale, stream)
    return dk, dv


def _bwd_dq_cuda(q, k, v, do, lse, delta, *, causal: bool, scale: float,
                 out=None):
    """dq: one launch of the dQ kernel, on inputs :func:`_bwd_cuda` has
    checked. Given ``out`` (the tensor-core body only), the kernel computes
    delta = rowsum(dO∘O) itself and writes it into ``delta``; else it reads
    ``delta``."""
    b, h, t, d = q.shape
    n_kv, s = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch("bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
                do.data_ptr(), None if out is None else out.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                _DTYPE_KIND[q.dtype], b, h, n_kv, t, s, d, int(causal),
                scale, stream)
    return dq


def _bwd_cuda(q, k, v, out, lse, do, *, causal: bool,
              sm_scale: Optional[float]):
    b, h, n_kv, t, s, d = _check_qkv(q, k, v)
    _check(out.dtype == q.dtype and tuple(out.shape) == tuple(q.shape) and
           do.dtype == q.dtype and tuple(do.shape) == tuple(q.shape),
           "out and do must be like q")
    _check(lse.dtype == torch.float32 and
           tuple(lse.shape) == (b, h, t, 1), f"lse must be f32 "
           f"{(b, h, t, 1)}, got {lse.dtype} {tuple(lse.shape)}")
    _check_device(q.device, (q, k, v, out, lse, do))
    if b * h * t == 0 or s == 0:
        return (torch.zeros_like(q), torch.zeros_like(k),
                torch.zeros_like(v))
    scale = _scale(d, sm_scale)
    if bwd_body(q.dtype, d) == "mma":   # the dQ kernel writes delta
        delta = torch.empty((b, h, t, 1), dtype=torch.float32,
                            device=q.device)
        dq = _bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal,
                          scale=scale, out=out)
    else:
        delta = _delta(out, do)
        dq = _bwd_dq_cuda(q, k, v, do, lse, delta, causal=causal,
                          scale=scale)
    dk, dv = _bwd_dkv_cuda(q, k, v, do, lse, delta, causal=causal,
                           scale=scale)
    return dq, dk, dv


# ==========================================================================
# Public entry points
# ==========================================================================


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        sm_scale: Optional[float] = None):
    """(o, lse) of attention over q (B,H,T,D), k/v (B,K,S,D). CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if q.is_cuda:
        return _fwd_cuda(q, k, v, causal=causal, sm_scale=sm_scale)
    return _flash_fwd_torch(q, k, v, causal=causal, sm_scale=sm_scale)


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = True,
                        sm_scale: Optional[float] = None):
    """(dq, dk, dv) from the forward's inputs, its (out, lse) and the
    output gradient ``do``. CUDA tensors launch the two kernels (dQ, then
    dK/dV); CPU tensors run the plain version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernels, host memory runs the plain version
    if q.is_cuda:
        return _bwd_cuda(q, k, v, out, lse, do, causal=causal,
                         sm_scale=sm_scale)
    return _flash_bwd_torch(q, k, v, out, lse, do, causal=causal,
                            sm_scale=sm_scale)
