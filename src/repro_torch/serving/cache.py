"""Paged KV cache with a token-granular block allocator.

The port of ``repro.serving.cache``. Device memory is carved into fixed
blocks of ``block_size`` tokens; a sequence owns a *block table* (a list
of block ids) instead of a contiguous span.

The storage is a plain dict ``{"k", "v"[, "k_scale", "v_scale"]}`` of
tensors shaped (L, n_blocks + 1, block, K, hd) (scales (..., 1)). The
extra block at index ``n_blocks`` is the **null block**: the reference
routes inactive batch slots and padded chunk positions to block id
``n_blocks`` and lets its scatter drop them (``mode="drop"``); a torch
``index_put_`` has no drop mode and would fault on CUDA, so here those
writes land in the null block, which no block table ever names. The pool
proper, the reference's storage, is ``[:, :n_blocks]``
(:meth:`PagedKVCache.pool`). Updates happen in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class PagedKVConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    n_blocks: int            # total device blocks (the null block excluded)
    block_size: int = 256    # tokens per block
    kv_quant: str = "none"   # none | int8


class OutOfBlocks(RuntimeError):
    """Raised by :meth:`BlockAllocator.alloc` when the free list is short.

    The scheduler treats a raise from ``alloc`` as *backpressure* (requeue
    / wait a step) rather than a crash."""


class BlockAllocator:
    """Ref-counted free-list allocator over KV blocks (host-side).

    Contract: ``alloc(n)`` either returns exactly ``n`` block ids (each at
    refcount 1) or raises :class:`OutOfBlocks`. ``release`` *decrements*:
    a block leaves ownership only when its count drops to zero. Every id
    released must be a real block currently referenced by the caller; a
    double release raises ``ValueError`` at the offending call.

    With a prefix cache attached (:meth:`attach_cache`), ``release`` parks
    a refcount-zero cached block in the cache's second-chance pool,
    ``alloc`` reclaims from that pool when the free list alone is short,
    and :meth:`share` takes an extra reference on a resident block.
    :meth:`fail_next` arms deterministic injected failures.
    """

    def __init__(self, n_blocks: int):
        self.free: List[int] = list(range(n_blocks - 1, -1, -1))
        self._free_set = set(self.free)
        self.n_blocks = n_blocks
        self.refcount: List[int] = [0] * n_blocks
        self.cache = None           # optional prefix cache
        self._fail_next = 0
        self.tel = None             # optional telemetry counters

    def attach_cache(self, cache) -> None:
        self.cache = cache

    def fail_next(self, n: int = 1) -> None:
        """Arm ``n`` injected failures: each of the next ``n`` ``alloc``
        calls raises :class:`OutOfBlocks` and leaves the free list intact."""
        if n < 0:
            raise ValueError("fail_next needs n >= 0")
        self._fail_next += n

    def alloc(self, n: int) -> List[int]:
        if self._fail_next > 0:
            self._fail_next -= 1
            raise OutOfBlocks(
                f"injected allocator failure (requested {n} blocks, "
                f"{len(self.free)} nominally free)")
        if len(self.free) < n and self.cache is not None:
            reclaimed = self.cache.reclaim(n - len(self.free))
            self.free.extend(reclaimed)
            self._free_set.update(reclaimed)
            if reclaimed and self.tel is not None and self.tel.enabled:
                self.tel.registry.count("blocks_reclaimed", len(reclaimed))
        if len(self.free) < n:
            raise OutOfBlocks(
                f"requested {n} blocks, only {len(self.free)} free")
        out = [self.free.pop() for _ in range(n)]
        self._free_set.difference_update(out)
        for b in out:
            self.refcount[b] = 1
        if n and self.tel is not None and self.tel.enabled:
            self.tel.registry.count("blocks_allocated", n)
        return out

    def share(self, blocks: List[int]) -> None:
        """Take one extra reference on each resident block (prefix reuse).
        Sharing a free block would alias live pages, so that raises."""
        for b in blocks:
            if b < 0 or b >= self.n_blocks:
                raise ValueError(f"share of block {b} outside the pool "
                                 f"[0, {self.n_blocks})")
            if b in self._free_set:
                raise ValueError(
                    f"share of block {b}: it is on the free list — its "
                    f"bytes are not a valid cached prefix")
        for b in blocks:
            if self.refcount[b] > 0:
                self.refcount[b] += 1
            else:
                if self.cache is None or not self.cache.revive(b):
                    raise ValueError(
                        f"share of block {b}: refcount is zero and it is "
                        f"not parked in the prefix cache")
                self.refcount[b] = 1
        if blocks and self.tel is not None and self.tel.enabled:
            self.tel.registry.count("blocks_shared", len(blocks))

    def release(self, blocks: List[int]) -> None:
        seen = set()
        for b in blocks:
            if b < 0 or b >= self.n_blocks:
                raise ValueError(f"release of block {b} outside the pool "
                                 f"[0, {self.n_blocks})")
            if b in self._free_set or b in seen or self.refcount[b] == 0:
                raise ValueError(
                    f"double release of block {b}: it is already on the "
                    f"free list (freed blocks may have been reallocated — "
                    f"this would hand one page to two owners)")
            seen.add(b)
        freed = []
        for b in blocks:
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                if self.cache is not None and self.cache.is_cached(b):
                    self.cache.on_unreferenced(b)
                else:
                    freed.append(b)
        self.free.extend(freed)
        self._free_set.update(freed)
        if freed and self.tel is not None and self.tel.enabled:
            self.tel.registry.count("blocks_freed", len(freed))

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def n_reclaimable(self) -> int:
        """Cached blocks at refcount zero — evictable on demand."""
        return self.cache.n_unreferenced if self.cache is not None else 0

    @property
    def n_available(self) -> int:
        """Blocks obtainable by one ``alloc``: free + cached-reclaimable."""
        return len(self.free) + self.n_reclaimable

    def occupancy(self) -> Dict[str, int]:
        """Pool split: {owned (referenced), cached_reclaimable, free}."""
        free = len(self.free)
        cached = self.n_reclaimable
        return {"owned": self.n_blocks - free - cached,
                "cached_reclaimable": cached, "free": free}

    def utilization(self) -> float:
        return 1.0 - self.n_available / max(self.n_blocks, 1)


# ==========================================================================
# Storage ops on the state dict (in place)
# ==========================================================================

#: f32 reciprocal of 127 as the reference states it (np.float32(1/127));
#: a multiply, never a division by the constant
_INV_127 = float(np.float32(1.0 / 127.0))


def quant_encode(x: torch.Tensor, kv_quant: str
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Identity, or int8 codes + per-vector f32 scale (over the last
    axis): scale = max(amax, 1e-6) * f32(1/127), codes = round-half-even
    of x / scale clipped to +-127 — the reference's bits."""
    if kv_quant != "int8":
        return x, None
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-6) * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quant_decode(q: torch.Tensor, scale: Optional[torch.Tensor],
                 dtype=torch.bfloat16) -> torch.Tensor:
    if scale is None:
        return q.to(dtype)
    return (q.float() * scale).to(dtype)


def init_state(cfg: PagedKVConfig, device=None) -> Dict[str, torch.Tensor]:
    """Fresh storage: k/v (L, n_blocks + 1, block, K, hd) zeros (bf16, or
    int8 codes), int8 scales ones; index ``n_blocks`` is the null block."""
    store_dtype = torch.int8 if cfg.kv_quant == "int8" else torch.bfloat16
    shape = (cfg.n_layers, cfg.n_blocks + 1, cfg.block_size,
             cfg.n_kv_heads, cfg.head_dim)
    state = {"k": torch.zeros(shape, dtype=store_dtype, device=device),
             "v": torch.zeros(shape, dtype=store_dtype, device=device)}
    if cfg.kv_quant == "int8":
        sshape = shape[:-1] + (1,)
        state["k_scale"] = torch.ones(sshape, dtype=torch.float32,
                                      device=device)
        state["v_scale"] = torch.ones(sshape, dtype=torch.float32,
                                      device=device)
    return state


def _ids(block_ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(block_ids, np.int64), device=device)


def write_prefill(state: Dict[str, torch.Tensor], kv_quant: str,
                  layer_kv: Tuple[torch.Tensor, torch.Tensor],
                  block_ids) -> None:
    """Page out a whole prompt: k, v (L, T, K, hd) for ONE sequence,
    scattered into the sequence's blocks (T padded up to a block
    multiple, the pad zeros encoded like any other token)."""
    k, v = layer_kv
    bs = state["k"].shape[2]
    t = k.shape[1]
    pad = (-t) % bs
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nb = k.shape[1] // bs
    kq, ks = quant_encode(k.reshape(k.shape[0], nb, bs, *k.shape[2:]),
                          kv_quant)
    vq, vs = quant_encode(v.reshape(v.shape[0], nb, bs, *v.shape[2:]),
                          kv_quant)
    ids = _ids(np.asarray(block_ids)[:nb], state["k"].device)
    state["k"][:, ids] = kq.to(state["k"].dtype)
    state["v"][:, ids] = vq.to(state["v"].dtype)
    if ks is not None:
        state["k_scale"][:, ids] = ks
        state["v_scale"][:, ids] = vs


def write_token(state: Dict[str, torch.Tensor], kv_quant: str,
                layer_kv: Tuple[torch.Tensor, torch.Tensor],
                block_ids: torch.Tensor, offsets: torch.Tensor) -> None:
    """Decode append for every layer of ``state`` in one scatter a leaf:
    k, v (L, B, K, hd) encoded, then :func:`write_token_encoded`. Rows
    routed to block ``n_blocks`` land in the null block."""
    k, v = layer_kv
    kq, ks = quant_encode(k, kv_quant)
    vq, vs = quant_encode(v, kv_quant)
    enc = {"k": kq, "v": vq}
    if ks is not None:
        enc["k_scale"], enc["v_scale"] = ks, vs
    write_token_encoded(state, enc, block_ids, offsets)


def write_token_encoded(state: Dict[str, torch.Tensor],
                        enc: Dict[str, torch.Tensor],
                        block_ids: torch.Tensor,
                        offsets: torch.Tensor) -> None:
    """All-layer append of storage-ready values in ONE scatter per leaf.

    ``enc`` holds encoded k/v (L, N, K, hd) (+ scales); ``block_ids`` and
    ``offsets`` (N,) map each row to (block, in-block offset). Rows routed
    to block ``n_blocks`` land in the null block."""
    n_l, n = enc["k"].shape[0], enc["k"].shape[1]
    dev = state["k"].device
    li = torch.arange(n_l, device=dev).repeat_interleave(n)
    bi = block_ids.long().repeat(n_l)
    oi = offsets.long().repeat(n_l)
    for key, val in enc.items():
        state[key].index_put_(
            (li, bi, oi),
            val.reshape(n_l * n, *val.shape[2:]).to(state[key].dtype))


def append_slots(table: torch.Tensor, positions: torch.Tensor,
                 block_size: int, n_blocks: int, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map per-row token positions to (block id, in-block offset) through
    a block table: ``table`` (N, max_blocks), ``positions`` (N,), ``valid``
    (N,) bool. Invalid rows route to the null block ``n_blocks``."""
    mb = table.shape[1]
    idx = torch.clamp(positions.long() // block_size, 0, mb - 1)
    blk = torch.gather(table.long(), 1, idx[:, None])[:, 0]
    blk = torch.where(valid, blk, torch.full_like(blk, n_blocks))
    return blk, positions.long() % block_size


def _fill(key: str) -> float:
    return 1.0 if key.endswith("_scale") else 0.0


def truncate_slots(state: Dict[str, torch.Tensor], block_ids,
                   keep_tokens: int, block_size: int) -> None:
    """Rewind ONE sequence's pages to a shorter valid prefix: every token
    slot at position >= ``keep_tokens`` within its blocks returns to the
    never-written state (k/v zero, int8 scales 1.0) across all layers.
    The partially kept boundary block is scrubbed per position, every
    wholly dropped block with one block-granular write."""
    ids = np.asarray(block_ids, np.int64)
    if keep_tokens >= len(ids) * block_size:
        return
    dev = state["k"].device
    first_whole = -(-keep_tokens // block_size)
    if keep_tokens % block_size:
        bnd = int(ids[keep_tokens // block_size])
        for key in state:
            state[key][:, bnd, keep_tokens % block_size:] = _fill(key)
    if first_whole < len(ids):
        whole = _ids(ids[first_whole:], dev)
        for key in state:
            state[key][:, whole] = _fill(key)


def scrub_blocks(state: Dict[str, torch.Tensor], block_ids) -> None:
    """Reset whole blocks (any sequence) to the never-written state."""
    ids = _ids(block_ids, state["k"].device)
    for key in state:
        state[key][:, ids] = _fill(key)


def copy_block(state: Dict[str, torch.Tensor], src: int, dst: int) -> None:
    """Copy one block's bytes (every layer, every leaf) ``src`` -> ``dst``
    in place: the copy-on-write primitive (a request about to append into
    a shared or cache-registered block first duplicates it)."""
    for key in state:
        state[key][:, dst].copy_(state[key][:, src])


def gather(state: Dict[str, torch.Tensor], layer: int,
           block_table: torch.Tensor, dtype=torch.bfloat16
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-row view of one layer (the legacy path's read):
    ``block_table`` (B, max_blocks) -> k, v (B, max_blocks * block, K,
    hd) in ``dtype``. Ids outside the pool proper, the null block
    ``n_blocks`` included, read as zeros, as in the reference."""
    nb = state["k"].shape[1] - 1                 # the null block aside
    table = block_table.long()
    in_range = (table >= 0) & (table < nb)
    safe = torch.where(in_range, table, torch.zeros_like(table))
    ks = state["k_scale"][layer][safe] if "k_scale" in state else None
    vs = state["v_scale"][layer][safe] if "v_scale" in state else None
    k = quant_decode(state["k"][layer][safe], ks, dtype)
    v = quant_decode(state["v"][layer][safe], vs, dtype)
    mask = in_range[:, :, None, None, None]
    k = torch.where(mask, k, torch.zeros((), dtype=dtype, device=k.device))
    v = torch.where(mask, v, torch.zeros((), dtype=dtype, device=v.device))
    b, mb, bs = k.shape[:3]
    return (k.reshape(b, mb * bs, *k.shape[3:]),
            v.reshape(b, mb * bs, *v.shape[3:]))


class PagedKVCache:
    """Owns the storage dict and updates it in place; :meth:`pool` views
    the reference-shaped storage without the null block."""

    def __init__(self, cfg: PagedKVConfig, device=None):
        self.cfg = cfg
        self.state = init_state(cfg, device)

    def pool(self) -> Dict[str, torch.Tensor]:
        """(L, n_blocks, block, K, hd) views: the storage the reference
        holds, without the null block."""
        return {k: v[:, : self.cfg.n_blocks] for k, v in self.state.items()}

    def write_prefill(self, layer_kv, block_ids: List[int]) -> None:
        write_prefill(self.state, self.cfg.kv_quant, layer_kv, block_ids)

    def write_token(self, layer_kv, block_ids: torch.Tensor,
                    offsets: torch.Tensor) -> None:
        write_token(self.state, self.cfg.kv_quant, layer_kv, block_ids,
                    offsets)

    def truncate_slots(self, block_ids, keep_tokens: int) -> None:
        truncate_slots(self.state, block_ids, keep_tokens,
                       self.cfg.block_size)

    def gather(self, layer: int, block_table: torch.Tensor,
               dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
        return gather(self.state, layer, block_table, dtype)

    def hbm_bytes(self) -> int:
        """Bytes of the pool proper (k, v and int8 scales; the null
        block aside), as the reference counts its storage."""
        return sum(v.numel() * v.element_size()
                   for v in self.pool().values())
