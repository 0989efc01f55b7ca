"""Paged multi-query and dense-cache decode attention partials, and the
plain helpers around them (the port of ``repro.kernels.flash_decode``).

**Paged read** (the serving engine's). One wrapper,
:func:`paged_flash_prefix_partial`, serves every window width T: fused
decode (:func:`paged_flash_decode_partial`, T=1) and chunked prefill
(T=chunk) both go through it, so the T=1 read is the decode read bit for
bit by construction.

On CUDA tensors the wrapper launches the hand-written kernel
``csrc/paged_attention.cu`` (it replaces the TPU kernel
``flash_decode.py::_paged_mq_pallas``; it splits each row's live table
columns over :func:`paged_splits` blocks and merges their partials in the
same launch) or raises; it never falls back. On CPU tensors it runs the
plain version :func:`_paged_prefix_torch`, which mirrors the reference's
``_paged_prefix_xla`` column loop (and, given ``n_split``, the kernel's
spans and merge, :func:`page_spans`) and is the oracle the kernel is held
against on the card.

Every launch adds one to ``LAUNCHES["paged_attention"]``; nothing else
does, so a run can show that its main path went through the kernel.

**Dense-cache decode** (the models' ``decode_step``, which speculative
decoding's draft model runs). :func:`flash_decode_partial` reads one query
token per row against a dense ``(B, K, S, D)`` cache: on CUDA tensors the
hand-written kernel ``csrc/dense_decode.cu`` (it replaces the TPU kernel
``flash_decode.py::_decode_kernel``; it splits each row's positions over
:func:`dense_splits` blocks and merges their partials in the same launch),
counted in ``LAUNCHES["dense_decode"]``, one per call; on CPU tensors the
plain version :func:`_dense_decode_torch`, which mirrors
``_decode_kernel``'s block loop (and, given ``n_split``, the kernel's
split and merge). :func:`flash_decode` normalizes the partials.
"""
from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: launches of each CUDA kernel of this module, by kernel name
LAUNCHES: Counter = Counter()

_KV_KIND = {torch.bfloat16: 0, torch.int8: 1}
_MAX_HEAD_DIM = 128
_PAGED_MIN_COLS = 4        # live table columns per split, at least
_PAGED_MAX_SPLITS = 64
_PAGED_BLOCKS_PER_SM = 6  # chip_smoke times the two read shapes beside it
_PAGED_SMEM = 200 * 1024   # kMaxDynSmem in the kernel


def _scale(d: int, sm_scale: Optional[float]) -> float:
    return sm_scale or 1.0 / float(np.sqrt(d))


# ==========================================================================
# Plain version (CPU path, and the kernel's oracle on the card)
# ==========================================================================


def _live_cols(lengths: torch.Tensor, bs: int, mb: int) -> int:
    """Leading table columns any row can still touch: ceil(max(len)/bs).
    Every later column is fully masked for every row, a bitwise no-op in
    the online-softmax recurrence, so the loop stops there."""
    if lengths.shape[0] == 0:
        return 0
    # repro: allow[JIT-03] plain path: the wrapper routes only host tensors here, so the max is read from host memory
    mx = int(lengths.max())
    return min(mb, (mx + bs - 1) // bs)


def _paged_prefix_torch(q, k_pages, v_pages, table, lengths, k_scale,
                        v_scale, *, sm_scale=None, n_split: int = 1):
    """Column loop over the block table: one (B, bs, K, hd) page tile is
    gathered per step and reused by all T rows; f32 online softmax.

    ``n_split > 1`` computes the kernel's split arithmetic instead: split
    i of row b takes the table columns of :func:`page_spans`, each split's
    partial comes from the column loop over its own columns, and the
    partials are rescaled to their common max and summed in split order
    (:func:`merge_split_partials`)."""
    if n_split > 1:
        return merge_split_partials([
            _paged_span_torch(q, k_pages, v_pages, table, lengths, k_scale,
                              v_scale, sm_scale, span)
            for span in page_spans(lengths, k_pages.shape[1],
                                   table.shape[1], n_split)])
    return _paged_span_torch(q, k_pages, v_pages, table, lengths, k_scale,
                             v_scale, sm_scale, None)


def page_spans(lengths, bs: int, mb: int, n_split: int):
    """The kernel's table-column ranges: per split i, (lo, hi) int tensors
    of shape (B,) with lo = min(i·c, n), hi = min(lo + c, n), c =
    ceil(n / s), s = max(1, min(n_split, ceil(n / 4))) the row's own split
    count, n = ceil(min(len, mb·bs) / bs) the row's live columns (len
    clamped at 0). With ``n_split`` from :func:`paged_splits` (at most one
    split per 4 table columns) s does not depend on the table width, so a
    row's spans, and its read, are the same whichever rows share its
    step."""
    ln = torch.clamp(lengths.long(), 0, mb * bs)
    n = (ln + bs - 1) // bs
    s = torch.clamp((n + _PAGED_MIN_COLS - 1) // _PAGED_MIN_COLS, 1, n_split)
    c = (n + s - 1) // s
    spans = []
    for i in range(n_split):
        lo = torch.minimum(i * c, n)
        spans.append((lo, torch.minimum(lo + c, n)))
    return spans


def _paged_span_torch(q, k_pages, v_pages, table, lengths, k_scale,
                      v_scale, sm_scale, span):
    """The column loop over table columns [lo, hi) of each row (``span``),
    or over every live column when ``span`` is None. A column outside a
    row's span is masked like a position past its length: a bitwise no-op
    of the recurrence."""
    b, tq, h, d = q.shape
    _, bs, n_kv, _ = k_pages.shape
    g = h // n_kv
    mb = table.shape[1]
    dev = q.device
    qg = q.reshape(b, tq, n_kv, g, d).float() * _scale(d, sm_scale)
    m = torch.full((b, tq, n_kv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, tq, n_kv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, tq, n_kv, g, d), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    for j in range(_live_cols(lengths, bs, mb)):
        blk = table[:, j].long()
        k = k_pages[blk].float()                           # (B, bs, K, hd)
        v = v_pages[blk].float()
        if k_scale is not None:
            k = k * k_scale[blk]
            v = v * v_scale[blk]
        s = torch.einsum("btkgd,bskd->btkgs", qg, k)        # (B,T,K,G,bs)
        kpos = j * bs + torch.arange(bs, device=dev)
        valid = kpos[None, :] < lengths[:, None]
        if span is not None:
            valid = valid & ((span[0] <= j) & (j < span[1]))[:, None]
        valid = valid[:, None, None, None, :]
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        # mask p explicitly: a row with no valid position yet would give
        # exp(NEG_INF - NEG_INF) = 1 weight to garbage
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=dev))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("btkgs,bskd->btkgd", p, v)
        m = m_new
    return (acc.reshape(b, tq, h, d), m.reshape(b, tq, h, 1),
            l.reshape(b, tq, h, 1))


# ==========================================================================
# The CUDA kernel's wrapper
# ==========================================================================


def _check(cond: bool, msg: str, kernel: str = "paged_attention") -> None:
    # repro: allow[JIT-04] the wrapper's checks read tensor metadata (device, dtype, shape, strides), never device values
    if not cond:
        raise ValueError(f"{kernel}: {msg}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The kernel's C entry point, built and loaded on first use, with its
    ctypes signature set once."""
    fn = _build.load("paged_attention").paged_attention_partial
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ci] + [vp] * 9 + [ci] * 9 + [ctypes.c_float,
                                                           vp]
    fn.restype = ci
    return fn


def _paged_smem(bs: int, d: int, elt: int, quant: bool) -> int:
    """Dynamic shared memory of the paged kernel at its largest row tile
    (``smem_bytes`` there): a ring of two granules of pages (a granule: up
    to 4 pages and 64 positions, or one longer page; rows padded by 16
    bytes), then the row tile's scores, row state and q."""
    gpg = 1 if bs >= 64 else min(4, 64 // bs)
    slot = (2 * bs * (d * elt + 16) + (8 * bs if quant else 0) + 15) // 16 * 16
    rt = 64 if d <= 64 else 32
    scores = max(rt * (gpg * bs + 1), _PAGED_MAX_SPLITS)
    return 2 * gpg * slot + 4 * (scores + 3 * rt + rt * (d + 4))


def paged_splits(b: int, n_kv: int, mb: int, n_sm: int) -> int:
    """Blocks the paged kernel splits each (b, kh) pair's live table
    columns over on a card of ``n_sm`` SMs: about ``_PAGED_BLOCKS_PER_SM``
    blocks per SM over the B·K pairs (a block's per-granule phases are
    latency-bound, so several share an SM), at most one per
    ``_PAGED_MIN_COLS`` columns of the table (``mb``) and at most
    ``_PAGED_MAX_SPLITS``. It reads shapes only: never the window width T
    (so row t of a T-wide read is the T=1 read) and never ``lengths`` (no
    host read; the kernel divides each row's live columns on the card,
    over at most one split per ``_PAGED_MIN_COLS`` of them, so a row's
    spans do not follow the table width: :func:`page_spans`)."""
    want = -(-_PAGED_BLOCKS_PER_SM * n_sm // max(1, b * n_kv))
    return max(1, min(want, mb // _PAGED_MIN_COLS, _PAGED_MAX_SPLITS))


def _pool_heads(t: torch.Tensor) -> int:
    """The heads a position of the pool that ``t`` (n_blocks, bs, K,
    inner) views: K where ``t`` is contiguous, else the width of the
    contiguous pool of which it is a window of K heads (a rank that holds
    every KV head reads those its q heads map to, with no copy); 0 for
    any other layout."""
    # repro: allow[JIT-04] strides and contiguity are host metadata of the tensor, not device values
    if t.is_contiguous():
        return t.shape[2]
    st, inner = t.stride(), t.shape[-1]
    ks = st[1] // inner if inner else 0
    window = (t.shape[1] * ks * inner, ks * inner, inner, 1)
    # repro: allow[JIT-04] strides and contiguity are host metadata of the tensor, not device values
    return ks if st == window and ks >= t.shape[2] else 0


def _paged_mq_cuda(q, k_pages, v_pages, table, lengths, k_scale, v_scale,
                   *, sm_scale=None, n_split: Optional[int] = None):
    """One launch of the paged kernel over ``n_split`` column splits a
    (b, kh) pair (default :func:`paged_splits` for this card). The pages
    (and scales) may be a window of the KV heads of a contiguous pool."""
    b, tq, h, d = q.shape
    nb, bs, n_kv, dk = k_pages.shape
    mb = table.shape[1]
    dev = q.device
    quant = k_scale is not None
    pages = [k_pages, v_pages] + ([k_scale, v_scale] if quant else [])
    for t in [q, table, lengths] + pages:
        _check(t.device == dev, f"all tensors must be on {dev}, got "
               f"{t.device}")
    for t in (q, table, lengths):
        _check(t.is_contiguous(), "q, table and lengths must be contiguous")
    ks = _pool_heads(k_pages) if k_pages.ndim == 4 else 0
    # repro: allow[JIT-04] strides and contiguity are host metadata of the tensor, not device values
    _check(ks > 0 and all(t.ndim == 4 and _pool_heads(t) == ks
                          for t in pages),
           "pages and scales must be contiguous, or one window of the KV "
           "heads of a contiguous pool")
    _check(q.dtype == torch.bfloat16, f"q dtype {q.dtype} is not bf16")
    _check(k_pages.dtype in _KV_KIND and v_pages.dtype == k_pages.dtype,
           f"page dtypes {k_pages.dtype}/{v_pages.dtype} not one of "
           f"bf16/int8")
    _check(v_pages.shape == k_pages.shape, "k/v page shapes differ")
    _check(dk == d and 0 < d <= _MAX_HEAD_DIM and d % 16 == 0,
           f"head_dim {dk} vs q {d}, must match, be a multiple of 16 and "
           f"be <= {_MAX_HEAD_DIM}")
    _check(n_kv > 0 and h % n_kv == 0, f"{h} heads over {n_kv} kv heads")
    _check(quant == (k_pages.dtype == torch.int8) and
           (v_scale is not None) == quant,
           "int8 pages need k_scale and v_scale, other pages none")
    if quant:
        for sc in (k_scale, v_scale):
            _check(sc.dtype == torch.float32 and
                   tuple(sc.shape) == (nb, bs, n_kv, 1),
                   f"scales must be f32 {(nb, bs, n_kv, 1)}, got "
                   f"{sc.dtype} {tuple(sc.shape)}")
    _check(table.dtype == torch.int32 and table.shape[0] == b and mb > 0,
           f"table must be int32 ({b}, max_blocks)")
    _check(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
           f"lengths must be int32 ({b},)")
    _check(_paged_smem(bs, d, k_pages.element_size(), quant) <= _PAGED_SMEM,
           f"block_size {bs} x head_dim {d}: the kernel's page ring does "
           f"not fit in shared memory")
    # repro: allow[JIT-04] page addresses are host metadata of the tensors, not device values
    _check(k_pages.data_ptr() % 16 == 0 and v_pages.data_ptr() % 16 == 0,
           "pages must be 16-byte aligned")
    _check(dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}")
    o = torch.empty((b, tq, h, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, tq, h, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, tq, h, 1), dtype=torch.float32, device=dev)
    if b * tq * h * d == 0:
        return o, m, l
    if n_split is None:
        n_split = paged_splits(b, n_kv, mb, _sm_count(dev))
    _check(1 <= n_split <= _PAGED_MAX_SPLITS, f"n_split {n_split} out of "
           f"range")
    counters = _split_counters(dev, b * n_kv, _PAGED_COUNTERS,
                               "paged_attention")
    ws = torch.empty(b * n_kv * n_split * tq * (h // n_kv) * (d + 2),
                     dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _entry()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                      _KV_KIND[k_pages.dtype],
                      k_scale.data_ptr() if quant else None,
                      v_scale.data_ptr() if quant else None,
                      table.data_ptr(), lengths.data_ptr(),
                      o.data_ptr(), m.data_ptr(), l.data_ptr(),
                      ws.data_ptr(), counters.data_ptr(),
                      b, tq, h, n_kv, ks, d, bs, mb, n_split,
                      _scale(d, sm_scale), stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {rc}")
    LAUNCHES["paged_attention"] += 1
    return o, m, l


# ==========================================================================
# Public entry points
# ==========================================================================


def paged_flash_prefix_partial(q, k_pages, v_pages, table, lengths, *,
                               k_scale=None, v_scale=None,
                               sm_scale: Optional[float] = None):
    """Attention partials of a T-token window against ONE layer's paged KV.

    q: (B, T, H, D); k_pages/v_pages: (n_blocks, block, K, hd) storage
    (bf16, or int8 with (n_blocks, block, K, 1) f32 scales); table:
    (B, max_blocks) int32; lengths: (B,) int32 valid prefix lengths. Every
    row of the window attends the same [0, lengths[b]) prefix; the
    window's own tokens are merged in by :func:`causal_self_partial` and
    :func:`merge_partials`. Returns unnormalized (o (B,T,H,D) f32,
    m (B,T,H,1), l (B,T,H,1)).

    CUDA tensors launch the kernel; CPU tensors run the plain version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if q.is_cuda:
        return _paged_mq_cuda(q, k_pages, v_pages, table, lengths, k_scale,
                              v_scale, sm_scale=sm_scale)
    return _paged_prefix_torch(q, k_pages, v_pages, table, lengths, k_scale,
                               v_scale, sm_scale=sm_scale)


def paged_flash_decode_partial(q, k_pages, v_pages, table, lengths, *,
                               k_scale=None, v_scale=None,
                               sm_scale: Optional[float] = None):
    """Single-token read: q (B, H, D) -> (o (B,H,D), m (B,H,1), l (B,H,1)).
    The T=1 case of :func:`paged_flash_prefix_partial`, same kernel."""
    o, m, l = paged_flash_prefix_partial(
        q[:, None].contiguous(), k_pages, v_pages, table, lengths,
        k_scale=k_scale, v_scale=v_scale, sm_scale=sm_scale)
    return o[:, 0], m[:, 0], l[:, 0]


def merge_partials(parts):
    """LSE-merge a list of (o, m, l) partials (cache + fresh window) and
    normalize."""
    os_, ms, ls = zip(*parts)
    m_glob = ms[0]
    for m_ in ms[1:]:
        m_glob = torch.maximum(m_glob, m_)
    o = sum(o_ * torch.exp(m_ - m_glob) for o_, m_ in zip(os_, ms))
    l = sum(l_ * torch.exp(m_ - m_glob) for l_, m_ in zip(ls, ms))
    return o / torch.clamp_min(l, 1e-30)


def causal_self_partial(q, k, v, *, sm_scale: Optional[float] = None):
    """Unnormalized causal self-attention partials of a fresh T-token
    window: row i attends columns j <= i. q (B,T,H,D), k/v (B,T,K,hd)
    already storage-roundtripped; returns (o f32, m, l) shaped like
    :func:`paged_flash_prefix_partial`. For T=1: m = q.k*scale, l = 1,
    o = v."""
    b, t, h, d = q.shape
    n_kv = k.shape[2]
    g = h // n_kv
    dev = q.device
    qg = q.reshape(b, t, n_kv, g, d).float()
    s = torch.einsum("bikgd,bjkd->bikgj", qg, k.float()) * _scale(d, sm_scale)
    idx = torch.arange(t, device=dev)
    mask = (idx[:, None] >= idx[None, :])[None, :, None, None, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=dev))
    m = s.amax(-1, keepdim=True)                    # the diagonal is live
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=dev))
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bikgj,bjkd->bikgd", p, v.float())
    return (o.reshape(b, t, h, d), m.reshape(b, t, h, 1),
            l.reshape(b, t, h, 1))


# ==========================================================================
# Dense-cache decode: one query token per row against a (B, K, S, D) cache
# ==========================================================================

_DENSE_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_DENSE_MAX_G = 8            # kMaxG in csrc/dense_decode.cu
_DENSE_MIN_SPLIT = 64       # positions of S per split, at least
_DENSE_MAX_SPLITS = 64


def _dense_decode_torch(q, k, v, lengths, *, sm_scale=None, bk: int = 256,
                       n_split: int = 1):
    """The plain version: ``_decode_kernel``'s block loop in torch. Blocks
    of ``bk`` positions (the last one ragged when ``bk`` does not divide
    S) update an f32 online softmax; a block runs for row b only while it
    starts before ``lengths[b]``, so a zero-length row keeps o = 0, l = 0,
    m = -1e30. Every block is visited (a shape-static loop, no host read
    of ``lengths``).

    ``n_split > 1`` computes the kernel's split arithmetic instead: split
    i of row b covers positions [i·c, min((i+1)·c, len)) with c =
    ceil(len / n_split), each split's partial comes from the block loop
    over its own positions, and the partials are rescaled to their common
    max and summed in split order (:func:`merge_split_partials`)."""
    if n_split > 1:
        return merge_split_partials([
            _dense_decode_span(q, k, v, lengths, sm_scale, bk, span)
            for span in split_spans(lengths, k.shape[2], n_split)])
    return _dense_decode_span(q, k, v, lengths, sm_scale, bk, None)


def split_spans(lengths, s: int, n_split: int):
    """The kernel's position ranges: per split i, (lo, hi) int tensors of
    shape (B,) with lo = min(i·c, len), hi = min(lo + c, len), c =
    ceil(len / n_split), len = clamp(lengths, 0, S)."""
    ln = torch.clamp(lengths.long(), 0, s)
    c = (ln + n_split - 1) // n_split
    spans = []
    for i in range(n_split):
        lo = torch.minimum(i * c, ln)
        spans.append((lo, torch.minimum(lo + c, ln)))
    return spans


def merge_split_partials(parts):
    """(o, m, l) partials over disjoint position ranges -> one partial:
    each rescaled to the common max and summed in the given order, as the
    kernel's last block does. Empty partials (m = -1e30, l = 0, o = 0)
    weigh 0 beside a live one and leave an all-empty row empty."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    o = torch.zeros_like(parts[0][0])
    l = torch.zeros_like(parts[0][2])
    for oi, mi, li in parts:
        f = torch.exp(mi - m)
        o = o + oi * f
        l = l + li * f
    return o, m, l


def _dense_decode_span(q, k, v, lengths, sm_scale, bk, span):
    """The block loop over positions [lo, hi) of each row (``span``), or
    [0, lengths) when ``span`` is None."""
    b, h, d = q.shape
    n_kv, s = k.shape[1], k.shape[2]
    g = h // n_kv
    dev = q.device
    qg = q.reshape(b, n_kv, g, d).float() * _scale(d, sm_scale)
    m = torch.full((b, n_kv, g, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, n_kv, g, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, n_kv, g, d), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    if span is None:
        lo = torch.zeros_like(lengths.long())[:, None, None, None]
        hi = lengths.long()[:, None, None, None]
    else:
        lo, hi = (x[:, None, None, None] for x in span)
    for j0 in range(0, s, bk):
        kb = k[:, :, j0:j0 + bk].float()                    # (B, K, bk, D)
        vb = v[:, :, j0:j0 + bk].float()
        sc = torch.einsum("bkgd,bksd->bkgs", qg, kb)
        kpos = j0 + torch.arange(kb.shape[2], device=dev)
        sc = torch.where((kpos >= lo) & (kpos < hi), sc, neg)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        run = (j0 < hi) & (j0 + kb.shape[2] > lo)
        l = torch.where(run, l * corr + p.sum(-1, keepdim=True), l)
        acc = torch.where(run, acc * corr
                          + torch.einsum("bkgs,bksd->bkgd", p, vb), acc)
        m = torch.where(run, m_new, m)
    return (acc.reshape(b, h, d), m.reshape(b, h, 1), l.reshape(b, h, 1))


@functools.lru_cache(maxsize=None)
def _dense_entry():
    """The dense decode kernel's C entry point, built and loaded on first
    use, with its ctypes signature set once."""
    fn = _build.load("dense_decode").dense_decode_partial
    vp, ci = ctypes.c_void_p, ctypes.c_int
    strides = ctypes.POINTER(ctypes.c_longlong)
    fn.argtypes = [vp] * 9 + [ci] * 5 + [strides, strides, ci, ci,
                                         ctypes.c_float, ci, vp]
    fn.restype = ci
    return fn


def dense_splits(b: int, n_kv: int, s: int, n_sm: int) -> int:
    """Blocks the dense decode kernel splits each (b, kh) row's positions
    over on a card of ``n_sm`` SMs: about two blocks per SM over the B·K
    pairs, at most
    one per ``_DENSE_MIN_SPLIT`` positions of S (the host does not read
    ``lengths``: S bounds them) and at most ``_DENSE_MAX_SPLITS``."""
    want = -(-2 * n_sm // max(1, b * n_kv))
    return max(1, min(want, s // _DENSE_MIN_SPLIT, _DENSE_MAX_SPLITS))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


# the split merge's arrival counters, per device: the dense decode
# kernel's and the paged kernel's, each a buffer of its own
_COUNTERS: dict = {}
_PAGED_COUNTERS: dict = {}


def _split_counters(dev: torch.device, n: int, store: dict = _COUNTERS,
                    kernel: str = "dense_decode") -> torch.Tensor:
    """The per-(b, kh) arrival counters of a kernel's split merge, one
    buffer per device in ``store``, zeroed once: each call leaves them
    zero (the merging block resets its pair's), so the kernel replays
    inside a CUDA graph. Grown outside a graph capture only."""
    buf = store.get(dev)
    # repro: allow[JIT-04] the buffer's size is host metadata, not a device value
    if buf is None or buf.numel() < n:
        _check(not torch.cuda.is_current_stream_capturing(),
               f"the split counters must hold {n} pairs before a graph "
               f"capture: call the kernel once at this shape first", kernel)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=dev)
        store[dev] = buf
    return buf


def _dcheck(cond: bool, msg: str) -> None:
    _check(cond, msg, "dense_decode")


def _dense_decode_cuda(q, k, v, lengths, *, sm_scale=None,
                       n_split: Optional[int] = None):
    """One launch of the dense decode kernel over ``n_split`` position
    splits a row (default :func:`dense_splits` for this card)."""
    _dcheck(q.ndim == 3 and k.ndim == 4 and v.shape == k.shape,
           f"q must be (B, H, D) and k/v (B, K, S, D), got "
           f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, d = q.shape
    bk_, n_kv, s, dk = k.shape
    _dcheck(q.dtype in _DENSE_KINDS and k.dtype == q.dtype and
           v.dtype == q.dtype,
           f"q, k and v must all be bf16 or all f32, got {q.dtype}, "
           f"{k.dtype}, {v.dtype}")
    _dcheck(bk_ == b and dk == d and 0 < d <= _MAX_HEAD_DIM,
           f"k {tuple(k.shape)} against q {tuple(q.shape)}: batch and "
           f"head_dim must match, head_dim <= {_MAX_HEAD_DIM}")
    _dcheck(n_kv > 0 and h % n_kv == 0 and h // n_kv <= _DENSE_MAX_G,
           f"{h} heads over {n_kv} kv heads: G must be <= {_DENSE_MAX_G}")
    _dcheck(q.is_contiguous() and k.stride(3) == 1 and v.stride(3) == 1,
           "q must be contiguous and k/v contiguous along head_dim")
    _dcheck(lengths.dtype == torch.int32 and tuple(lengths.shape) == (b,),
           f"lengths must be int32 ({b},)")
    dev = q.device
    _dcheck(dev.type == "cuda", f"the kernel takes CUDA tensors, got {dev}")
    for t in (k, v, lengths):
        _dcheck(t.device == dev, f"all tensors must be on {dev}, got "
               f"{t.device}")
    o = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    m = torch.empty((b, h, 1), dtype=torch.float32, device=dev)
    l = torch.empty((b, h, 1), dtype=torch.float32, device=dev)
    if b == 0:
        return o, m, l
    if n_split is None:
        n_split = dense_splits(b, n_kv, s, _sm_count(dev))
    _dcheck(1 <= n_split <= 65535, f"n_split {n_split} out of range")
    counters = _split_counters(dev, b * n_kv)
    ws = (torch.empty(b * n_kv * n_split * (h // n_kv) * (d + 2),
                      dtype=torch.float32, device=dev)
          if n_split > 1 else o)
    epl = 16 // q.element_size()         # elements in one 16-byte load
    vec = int(d % epl == 0 and all(x.data_ptr() % 16 == 0 and
                                   all(x.stride(i) % epl == 0
                                       for i in range(3)) for x in (k, v)))
    ks = (ctypes.c_longlong * 3)(*(k.stride(i) for i in range(3)))
    vs = (ctypes.c_longlong * 3)(*(v.stride(i) for i in range(3)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _dense_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            lengths.contiguous().data_ptr(), o.data_ptr(),
                            m.data_ptr(), l.data_ptr(), ws.data_ptr(),
                            counters.data_ptr(), b, h, n_kv, s, d, ks, vs,
                            n_split, vec, _scale(d, sm_scale),
                            _DENSE_KINDS[q.dtype], stream)
    # repro: allow[JIT-04] rc is the C int cudaGetLastError() returned to the host, not a device value
    if rc != 0:
        raise RuntimeError(f"dense_decode launch failed: CUDA error {rc}")
    LAUNCHES["dense_decode"] += 1
    return o, m, l


def flash_decode_partial(q, k, v, lengths, *,
                         sm_scale: Optional[float] = None):
    """Single-token decode partials against a dense cache: q (B, H, D),
    k/v (B, K, S, D) (any strides with D contiguous, e.g. a transposed
    view of the models' (B, S, K, D) cache), lengths (B,) int32 valid
    prefixes. Returns unnormalized (o (B, H, D) f32, m (B, H, 1),
    l (B, H, 1)). CUDA tensors launch the kernel; CPU tensors run the
    plain version."""
    # repro: allow[JIT-04] dispatch on where the tensor lives (host metadata): the card launches the kernel, host memory runs the plain version
    if q.is_cuda:
        return _dense_decode_cuda(q, k, v, lengths, sm_scale=sm_scale)
    return _dense_decode_torch(q, k, v, lengths, sm_scale=sm_scale)


def flash_decode(q, k, v, lengths, *, sm_scale: Optional[float] = None):
    """:func:`flash_decode_partial` normalized, in q's type."""
    o, _, l = flash_decode_partial(q, k, v, lengths, sm_scale=sm_scale)
    return (o / torch.clamp_min(l, 1e-30)).to(q.dtype)
