"""Cross-request prefix cache: a radix (block-granular trie) index over
full KV blocks, with an LRU second-chance pool for evicted-but-cached
blocks (the port's copy of ``repro.serving.prefix_cache``, unchanged:
the index is host-only Python, so both packages' engines cache an
identical trace identically).

The paper's serving analysis (§II-D) shows prefill is compute-bound and
decode bandwidth-bound — re-prefilling a shared system prompt for every
request burns exactly the resource the engine has least of. This module
is the vLLM block-hash / SGLang RadixAttention design on top of the
paged :class:`~repro_torch.serving.cache.BlockAllocator`:

  * Every **full** block a request pages out during prefill is registered
    under its content key — the tuple of ``block_size`` token ids —
    chained from its parent block's trie node, so a node's path from the
    root IS the (token-ids, prefix) content hash. Partial blocks are
    never indexed: the boundary block of every request is always private,
    which is what makes decode appends safe without copying (see
    ``Engine._cow_tail`` for the defensive copy-on-write guard).
  * :meth:`match` walks the trie with a new prompt and returns the
    longest cached prefix as a list of resident block ids. The match is
    capped at ``len(tokens) - 1`` so at least one token is left to
    prefill — a forward pass must run to produce the first output token.
  * Blocks are *not* scrubbed when their refcount hits zero. They move
    into the ``unref`` LRU pool (second chance): a later request with the
    same prefix revives them for free, and only when the allocator's free
    list runs dry does :meth:`reclaim` evict LRU-first, scrub the bytes
    (through the engine-installed ``scrub`` hook) and hand the ids back.

Reclaim safety rests on a structural invariant maintained by the
scheduler/engine: tables only ever reference trie *prefixes* (a request
that shares a node shares all its ancestors), so a block whose refcount
is zero can only have referenced blocks *above* it, never below — the
unreferenced region of the trie is always a union of leaf-ward subtrees
and can be fully drained leaf-first.

SSM / hybrid architectures: KV blocks only hold attention KV; Mamba-style
layers carry a dense recurrent state. A node can therefore hold an
optional **SSM snapshot** (the slot's state tensors, cloned out of
the pool, after exactly
``depth * block_size`` tokens). When ``track_ssm`` is set, :meth:`match`
only returns nodes that carry a snapshot — matching deeper than the last
snapshot would leave the recurrent state unreconstructable. The engine
captures snapshots only at chunk-schedule-aligned boundaries so that a
resumed suffix prefill regroups the SSD scan exactly as a from-scratch
prefill would (bitwise parity).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple


class _Node:
    """One cached block: an edge of ``block_size`` token ids from its
    parent. The path root->node spells the full token prefix."""

    __slots__ = ("parent", "edge", "block", "depth", "children", "ssm")

    def __init__(self, parent: Optional["_Node"], edge: Tuple[int, ...],
                 block: int, depth: int):
        self.parent = parent
        self.edge = edge
        self.block = block
        self.depth = depth                  # blocks from root (root = 0)
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.ssm: Any = None                # optional state snapshot


class PrefixCache:
    """Radix index + LRU second-chance pool over cached KV blocks.

    The allocator calls :meth:`is_cached` / :meth:`on_unreferenced` /
    :meth:`revive` / :meth:`reclaim`; the scheduler calls :meth:`match`;
    the engine calls :meth:`register` as prefill pages blocks out and
    installs ``scrub`` (a callable taking a list of block ids) so reclaim
    can zero the bytes before the ids re-enter circulation.
    """

    def __init__(self, block_size: int, *, track_ssm: bool = False):
        self.block_size = block_size
        self.track_ssm = track_ssm
        self.root = _Node(None, (), -1, 0)
        self.by_block: Dict[int, _Node] = {}    # resident cached blocks
        self.unref: Dict[int, int] = {}         # block -> LRU tick (rc==0)
        self.scrub = None                       # engine hook: scrub(ids)
        # bitwise-parity cap (set by the engine): a match may only end at
        # a depth that is a multiple of this, i.e. on a prefill-chunk
        # boundary of the cache-off schedule — the resumed suffix then
        # partitions into exactly the chunks a cold prefill would run, so
        # every attention reduction and SSD regrouping keeps its order.
        self.align_blocks = 1
        self._tick = 0
        # counters (engine stats surface these)
        self.n_registered = 0
        self.n_evicted = 0
        # optional Telemetry (serving/telemetry.py), wired by the engine:
        # register/evict counters for the metrics registry, nothing else
        self.tel = None

    # ------------------------------------------------------------------
    # allocator-facing hooks
    # ------------------------------------------------------------------

    def is_cached(self, block: int) -> bool:
        return block in self.by_block

    def on_unreferenced(self, block: int) -> None:
        """Refcount hit zero: park the block in the LRU pool instead of
        freeing — its bytes stay valid for a future :meth:`match`."""
        self._tick += 1
        self.unref[block] = self._tick

    def revive(self, block: int) -> bool:
        """A cached-but-unreferenced block is being shared again: pull it
        out of the reclaimable pool. Returns False if it wasn't parked."""
        return self.unref.pop(block, None) is not None

    @property
    def n_unreferenced(self) -> int:
        return len(self.unref)

    @property
    def n_cached_blocks(self) -> int:
        return len(self.by_block)

    def reclaim(self, n: int) -> List[int]:
        """Evict up to ``n`` unreferenced cached blocks, LRU-first, and
        return their ids for the free list. Only childless nodes are
        evictable (an interior node's bytes anchor its descendants'
        prefix), but draining leaf-first always makes progress: a
        refcount-zero node's children are refcount-zero too (tables are
        prefix-closed), so the whole unreferenced pool is reachable.
        Scrubs the evicted blocks through the ``scrub`` hook — bytes are
        cleaned on *reclaim*, not on release, so parking stays O(1)."""
        got: List[int] = []
        while len(got) < n:
            best = None
            for b, tick in self.unref.items():
                if self.by_block[b].children:
                    continue
                if best is None or tick < best[1]:
                    best = (b, tick)
            if best is None:
                break
            b = best[0]
            node = self.by_block.pop(b)
            del self.unref[b]
            node.parent.children.pop(node.edge, None)
            got.append(b)
        self.n_evicted += len(got)
        if got and self.tel is not None and self.tel.enabled:
            self.tel.registry.count("prefix_blocks_evicted", len(got))
        if got and self.scrub is not None:
            self.scrub(got)
        return got

    # ------------------------------------------------------------------
    # scheduler / engine-facing API
    # ------------------------------------------------------------------

    def match(self, tokens: List[int]) -> Tuple[Optional[_Node], List[int]]:
        """Longest cached full-block prefix of ``tokens``.

        Returns ``(node, block_ids)`` where ``block_ids`` is the root→node
        path; ``(None, [])`` when nothing matches. Capped so that at least
        one token remains to prefill. The walk backtracks to the deepest
        node satisfying every resume constraint: depth a multiple of
        ``align_blocks`` (chunk-boundary parity), and with ``track_ssm``
        an SSM snapshot present — KV bytes alone cannot resume a
        recurrent layer."""
        bs = self.block_size
        limit = (len(tokens) - 1) // bs
        node = self.root
        path: List[_Node] = []
        for d in range(limit):
            child = node.children.get(tuple(tokens[d * bs:(d + 1) * bs]))
            if child is None:
                break
            node = child
            path.append(child)
        while path and ((self.track_ssm and path[-1].ssm is None)
                        or len(path) % self.align_blocks):
            path.pop()
        if not path:
            return None, []
        return path[-1], [p.block for p in path]

    def register(self, parent: Optional[_Node], edge: Tuple[int, ...],
                 block: int, ssm: Any = None) -> _Node:
        """Index ``block`` as the child of ``parent`` along ``edge`` (one
        full block of token ids). If an equivalent node already exists the
        existing one wins — the caller's block stays private (first-writer
        dedup) — but a snapshot still attaches if the node lacks one, so a
        chain registered by an attention-only path can later become
        matchable for SSM archs. Returns the (existing or new) node."""
        parent = parent if parent is not None else self.root
        child = parent.children.get(edge)
        if child is None:
            child = _Node(parent, edge, block, parent.depth + 1)
            parent.children[edge] = child
            self.by_block[block] = child
            self.n_registered += 1
            if self.tel is not None and self.tel.enabled:
                self.tel.registry.count("prefix_blocks_registered")
        if ssm is not None and child.ssm is None:
            child.ssm = ssm
        return child
