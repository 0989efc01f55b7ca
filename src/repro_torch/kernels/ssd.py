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
kernel with a scan inside its blocks, the plain version with one
``torch.cumsum``.

On CUDA tensors :func:`ssd_chunked_kernel` launches the hand-written
kernel of ``csrc/ssd.cu`` (it replaces the TPU kernel ``_ssd_kernel``) or
raises; it never falls back. The kernel has two bodies; :func:`ssd_body`
says which one a shape takes. The tensor-core body (N and P multiples of
16) runs every product as six bf16 part products of exact three-part
splits (:func:`_ssd_split_torch` is its arithmetic in plain torch) and
cuts the serial chunk walk into a state pass between two chunk-parallel
phases: :func:`kernels_per_call` CUDA kernels a call. The FMA body takes
the other shapes, in one. On CPU tensors it runs the plain version
:func:`ssd_chunked_plain`, which is also the kernel's oracle on the card.
Every call that launches adds one to ``LAUNCHES["ssd"]``, and to
``BODIES`` under the body it ran; nothing else does.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import split_bf16
from repro_torch.kernels.flash_decode import _sm_count

#: calls of the CUDA kernel of this module (one per call, whatever number
#: of CUDA kernels the call launches)
LAUNCHES: Counter = Counter()
#: the same calls by the body they ran (:func:`ssd_body`'s names)
BODIES: Counter = Counter()

_MAX_DIM = 128            # N and P the kernel takes (N a multiple of 4)
_ROWS = 64                # positions a tensor-core block's tile holds


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


def _mm_parts(x: torch.Tensor, w: torch.Tensor, parts: int) -> torch.Tensor:
    """``x @ w`` as the tensor-core body forms it: both f32 operands split
    by :func:`split_bf16` into ``parts`` bf16 parts, and the part products
    x_i·w_j with i + j <= min(2, parts - 1) each taken in f32 and summed:
    with 3 parts the six of weight >= 2^-16 (the kernel's), with 2 hi·hi,
    hi·lo and lo·hi (the flash kernels' split of P), with 1 hi·hi (the
    ``SSD_PLANT_HI_ONLY`` build)."""
    xs = [v.float() for v in split_bf16(x, parts)]
    ws = [v.float() for v in split_bf16(w, parts)]
    top = min(2, parts - 1)
    return sum(xs[i] @ ws[j] for i in range(parts) for j in range(parts)
               if i + j <= top)


def _ssd_split_torch(xdt, b, c, a, *, chunk: int,
                     init_state: Optional[torch.Tensor] = None,
                     parts: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core body's arithmetic in plain torch, all f32: the
    plain version's cumulative decays, and each of its four products (C
    Bᵀ, the masked and decayed scores times x, (B ∘ e^(total − cums))ᵀ x
    and C S_prev, scaled by e^cums after the product) through
    :func:`_mm_parts`. With ``parts=3`` (the kernel's) every term is the
    f32 product to within about 2^-24; the kernel's sums run in another
    order and through truncating tensor-core accumulators a 16-deep k step
    at a time, which this does not model."""
    bsz, h, t, p = xdt.shape
    g, n = b.shape[1], b.shape[3]
    q = min(chunk, t)
    nc = t // q
    f32 = torch.float32
    cums = torch.cumsum(a.to(f32).reshape(bsz, h, nc, q), dim=-1)
    xc = xdt.to(f32).reshape(bsz, h, nc, q, p)
    bh = b.to(f32).repeat_interleave(h // g, dim=1).reshape(bsz, h, nc, q, n)
    ch = c.to(f32).repeat_interleave(h // g, dim=1).reshape(bsz, h, nc, q, n)
    seg = cums[..., :, None] - cums[..., None, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    lmat = torch.exp(torch.where(tri, seg, torch.full(
        (), -torch.inf, dtype=f32, device=xdt.device)))
    scores = _mm_parts(ch, bh.transpose(-1, -2), parts)
    y = _mm_parts(scores * lmat, xc, parts)
    total = cums[..., -1]
    b_dec = bh * torch.exp(total[..., None] - cums)[..., None]
    upd = _mm_parts(b_dec.transpose(-1, -2), xc, parts)
    s = (torch.zeros((bsz, h, n, p), dtype=f32, device=xdt.device)
         if init_state is None else init_state.to(f32))
    s_prev = []
    for ci in range(nc):
        s_prev.append(s)
        s = s * torch.exp(total[:, :, ci])[..., None, None] + upd[:, :, ci]
    s_prev = torch.stack(s_prev, dim=2)
    y = y + torch.exp(cums)[..., None] * _mm_parts(ch, s_prev, parts)
    return y.reshape(bsz, h, t, p), s


# ==========================================================================
# The CUDA kernel's wrapper
# ==========================================================================


def _check(cond: bool, msg: str) -> None:
    # repro: allow[JIT-04] the wrapper's checks read tensor metadata (device, dtype, shape, strides), never device values
    if not cond:
        raise ValueError(f"ssd: {msg}")


@functools.lru_cache(maxsize=None)
def _entries(defines: Tuple[str, ...] = ()):
    """The kernel's C entry point, built and loaded on first use, with its
    ctypes signature set once (``defines``: a variant build's macros,
    which only a planted fault's check uses)."""
    fn = _build.load("ssd", defines).ssd_chunk_scan
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 8 + [ci] * 9 + [vp]
    fn.restype = ci
    return fn


_BODY_CODES = {"fma": 0, "mma": 1}


def ssd_body(n: int, p: int) -> str:
    """The body the kernel runs at state size ``n`` and head dim ``p``:
    ``"mma"`` (bf16 mma.sync on three-part splits) when both are
    multiples of 16, else ``"fma"`` (f32 FMA chains)."""
    return "mma" if n % 16 == 0 and p % 16 == 0 else "fma"


def kernels_per_call(t: int, q: int, n: int, p: int) -> int:
    """CUDA kernels one call launches at T=``t``, chunk ``q``: the
    tensor-core body's state, pass and output kernels (one fused launch
    when T is one chunk); the FMA body's one."""
    return 3 if ssd_body(n, p) == "mma" and t // q > 1 else 1


def p_split(blocks: int, p: int, n_sm: int) -> int:
    """Slices of P the tensor-core body's blocks take, given its
    ``blocks`` output blocks at one slice (B·H·chunks·64-row tiles): it
    doubles while those number fewer than the ``n_sm`` SMs and the
    slice stays a multiple of 16."""
    s = 1
    while blocks * s < n_sm and p % (32 * s) == 0:
        s *= 2
    return s


def _ssd_cuda(xdt, b, c, a, *, chunk: int,
              init_state: Optional[torch.Tensor] = None,
              body: Optional[str] = None):
    """One call of the kernel (``body``: ``"mma"`` or ``"fma"`` to force
    one, default :func:`ssd_body`)."""
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
    _check(body in (None, *_BODY_CODES),
           f"body {body!r} is not one of {tuple(_BODY_CODES)}")
    body = body or ssd_body(n, p)
    _check(body == "fma" or ssd_body(n, p) == "mma",
           f"the mma body takes N and P multiples of 16, got N={n}, P={p}")
    tensors = [xdt, b, c, a]
    if init_state is not None:
        _check(tuple(init_state.shape) == (bsz, h, n, p),
               f"init_state {tuple(init_state.shape)} must be "
               f"{(bsz, h, n, p)}")
        tensors.append(init_state)
    for x in tensors:
        _check(x.is_contiguous(), "tensors must be contiguous")
        _check(x.data_ptr() % 16 == 0, "tensors must be 16-byte aligned")
    dev = xdt.device
    _check(dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}")
    for x in tensors:
        _check(x.dtype == torch.float32, f"inputs must be f32, got {x.dtype}")
        _check(x.device == dev, f"all tensors must be on {dev}, got "
               f"{x.device}")
    nc = t // q
    split = 1
    scratch = None
    if body == "mma":
        split = p_split(bsz * h * nc * -(-q // _ROWS), p, _sm_count(dev))
        if nc > 1:                # U_c / S_prev per chunk, then the totals
            scratch = torch.empty(bsz * h * nc * (n * p + 1),
                                  dtype=torch.float32, device=dev)
    y = torch.empty_like(xdt)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entries()(xdt.data_ptr(), b.data_ptr(), c.data_ptr(),
                        a.data_ptr(),
                        None if init_state is None else init_state.data_ptr(),
                        y.data_ptr(), state.data_ptr(),
                        None if scratch is None else scratch.data_ptr(),
                        bsz, h, g, t, q, n, p, _BODY_CODES[body], split,
                        stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"ssd launch failed: CUDA error {rc}")
    LAUNCHES["ssd"] += 1
    BODIES[body] += 1
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
