"""Mamba-2 SSD chunked scan: the CUDA kernel's wrapper and its plain
version (the port of ``repro.kernels.ssd``).

Layout as in the reference kernel (``kernels.ops.ssd`` prepares it):
xdt (B, H, T, P) f32, already dt-scaled; b, c (B, G, T, N) f32, group
h // (H/G) shared by its heads; a (B, H, T) f32 = dt·A (the log decay,
<= 0). T is a multiple of the chunk Q = min(chunk, T).
:func:`ssd_chunked_kernel` returns (y (B, H, T, P) f32, final state
(B, H, N, P) f32), starting from ``init_state`` (B, H, N, P) f32 or
from zero. Unlike the TPU kernel, which always starts from zero, the
port's takes ``init_state``, so a carried state (chunked prefill) runs
the kernel too.

Each version computes the per-chunk cumulative decay of ``a`` itself: the
kernel with a scan inside its block, the plain version with one
``torch.cumsum``.

On CUDA tensors :func:`ssd_chunked_kernel` launches the hand-written
kernel of ``csrc/ssd.cu`` (it replaces the TPU kernel ``_ssd_kernel``) or
raises; it never falls back. On CPU tensors it runs the plain version
:func:`ssd_chunked_plain`, which is also the kernel's oracle on the card.
Every launch adds one to ``LAUNCHES["ssd"]``; nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel of this module
LAUNCHES: Counter = Counter()

_MAX_DIM = 128            # N and P the kernel takes (N a multiple of 4)


def ssd_chunked_plain(xdt, b, c, a, *, chunk: int,
                      init_state: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain torch, all f32, per chunk of
    Q = min(chunk, T): y = ((C Bᵀ) ∘ L) x + (C ∘ e^cums) S_prev and
    S = e^total S_prev + (B ∘ e^(total − cums))ᵀ x, with L's exponent
    taken only on and below the diagonal."""
    bsz, h, t, p = xdt.shape
    g, n = b.shape[1], b.shape[3]
    q = min(chunk, t)
    if t % q:
        raise ValueError(f"ssd: T={t} is not a multiple of the chunk {q}")
    nc = t // q
    f32 = torch.float32
    cums = torch.cumsum(a.to(f32).reshape(bsz, h, nc, q), dim=-1)
    xc = xdt.to(f32).reshape(bsz, h, nc, q, p)
    # each head reads its group's B and C
    bh = b.to(f32).repeat_interleave(h // g, dim=1).reshape(bsz, h, nc, q, n)
    ch = c.to(f32).repeat_interleave(h // g, dim=1).reshape(bsz, h, nc, q, n)

    seg = cums[..., :, None] - cums[..., None, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    lmat = torch.exp(torch.where(tri, seg, torch.full(
        (), -torch.inf, dtype=f32, device=xdt.device)))
    scores = ch @ bh.transpose(-1, -2)                         # (B,H,nc,Q,Q)
    y = (scores * lmat) @ xc                                   # (B,H,nc,Q,P)

    total = cums[..., -1]                                      # (B,H,nc)
    b_dec = bh * torch.exp(total[..., None] - cums)[..., None]
    upd = b_dec.transpose(-1, -2) @ xc                         # (B,H,nc,N,P)
    if init_state is None:
        s = torch.zeros((bsz, h, n, p), dtype=f32, device=xdt.device)
    else:
        s = init_state.to(f32)
    s_prev = []
    for ci in range(nc):
        s_prev.append(s)
        s = s * torch.exp(total[:, :, ci])[..., None, None] + upd[:, :, ci]
    s_prev = torch.stack(s_prev, dim=2)                        # (B,H,nc,N,P)
    y = y + (ch * torch.exp(cums)[..., None]) @ s_prev
    return y.reshape(bsz, h, t, p), s


# ==========================================================================
# The CUDA kernel's wrapper
# ==========================================================================


def _check(cond: bool, msg: str) -> None:
    # repro: allow[JIT-04] the wrapper's checks read tensor metadata (device, dtype, shape, strides), never device values
    if not cond:
        raise ValueError(f"ssd: {msg}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded on first use, with its
    ctypes signature set once."""
    fn = _build.load("ssd").ssd_chunk_scan
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 7 + [ci] * 7 + [vp]
    fn.restype = ci
    return fn


def _ssd_cuda(xdt, b, c, a, *, chunk: int,
              init_state: Optional[torch.Tensor] = None):
    _check(xdt.ndim == 4 and b.ndim == 4 and c.ndim == 4 and a.ndim == 3,
           "xdt must be (B, H, T, P), b and c (B, G, T, N), a (B, H, T)")
    bsz, h, t, p = xdt.shape
    g, n = b.shape[1], b.shape[3]
    _check(tuple(b.shape) == (bsz, g, t, n) and
           tuple(c.shape) == tuple(b.shape),
           f"b {tuple(b.shape)} / c {tuple(c.shape)} do not fit xdt "
           f"{tuple(xdt.shape)}")
    _check(tuple(a.shape) == (bsz, h, t),
           f"a {tuple(a.shape)} does not fit xdt {tuple(xdt.shape)}")
    _check(g > 0 and h % g == 0, f"{h} heads over {g} groups")
    _check(0 < n <= _MAX_DIM and 0 < p <= _MAX_DIM,
           f"state {n} and head dim {p} must be in [1, {_MAX_DIM}]")
    _check(n % 4 == 0, f"state {n} must be a multiple of 4")
    _check(chunk > 0, f"chunk {chunk} must be positive")
    q = min(chunk, t)
    _check(t > 0 and t % q == 0,
           f"T={t} must be a positive multiple of the chunk {q}")
    tensors = [xdt, b, c, a]
    if init_state is not None:
        _check(tuple(init_state.shape) == (bsz, h, n, p),
               f"init_state {tuple(init_state.shape)} must be "
               f"{(bsz, h, n, p)}")
        tensors.append(init_state)
    dev = xdt.device
    _check(dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}")
    for x in tensors:
        _check(x.dtype == torch.float32, f"inputs must be f32, got {x.dtype}")
        _check(x.device == dev, f"all tensors must be on {dev}, got "
               f"{x.device}")
        _check(x.is_contiguous(), "tensors must be contiguous")
    y = torch.empty_like(xdt)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(xdt.data_ptr(), b.data_ptr(), c.data_ptr(),
                      a.data_ptr(),
                      None if init_state is None else init_state.data_ptr(),
                      y.data_ptr(), state.data_ptr(), bsz, h, g, t, q, n, p,
                      stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {rc}")
    LAUNCHES["ssd"] += 1
    return y, state


def ssd_chunked_kernel(xdt, b, c, a, *, chunk: int,
                       init_state: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B,H,T,P) f32, final state (B,H,N,P) f32). CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if xdt.is_cuda:
        return _ssd_cuda(xdt, b, c, a, chunk=chunk, init_state=init_state)
    return ssd_chunked_plain(xdt, b, c, a, chunk=chunk,
                             init_state=init_state)
