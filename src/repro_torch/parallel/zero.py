"""ZeRO state over the data axis: this rank's pieces of the logical
state, the exact gather of a leaf's pieces, and ZeRO-3's gather of
parameters where they are used.

A placement (``sharding.state_shardings``) names at most one dim of a
leaf that the data axes split (:func:`dp_cut`); a rank holds the
contiguous ``1/parts`` of that dim at its index (:func:`take`), the
whole leaf where no dim is split. Under a model axis the "leaf" is the
rank's TP piece (:func:`model_cut`, cut along another dim): the data
axis's gathers, reductions and ``+O`` act on that piece only. A fused
SSM leaf's TP piece (``in_proj``, ``conv_w``, ``conv_b``:
``sharding.fused_segments``) is cut segment by segment, its B and C
segments whole on every rank (``Cut.segs``). Every piece is a plain
tensor of the leaf's rank (cut along a dim, never flattened, so weight
decay's ``ndim >= 2`` test reads the leaf's rank).

**Exact gathers.** gloo offers only ``all_reduce`` and ``broadcast`` on
CUDA tensors, so a gather is an all-reduce: every rank writes the bytes
it holds into a zero buffer of the whole leaves and the buffer is summed
as int32 (``ShardCtx.dp_gather_bytes``): disjoint bit patterns add
without carries, so every value arrives bit for bit. Each leaf's bytes
start at a multiple of ``ALIGN`` bytes of the buffer, so a gathered
leaf is as aligned as an allocation and the card's GEMMs pick what they
pick for the one-device run.

**ZeRO-3 at use.** The train step hands the model a tree of
:class:`Shard` views (a piece, the leaf's whole shape and its cut, and
the f32 accumulator piece its reduced gradient goes to). The model calls
:func:`gather_used` on a layer's tree inside the body its remat policy
wraps (so the recomputation gathers again and nothing gathered is
saved), and :func:`gather_top` on the embedding, the final norm, the
head and the frontend/encoder leaves once a micro-batch (a tied table is
one gathered tensor, its two uses' gradients summed by autograd in bf16
as the one-device leaf's are). A gather is one :class:`_Gather` call per
tree: one int32 all-reduce forward; backward, the whole gradients
summed over the data axes in f32 in one buffer, each rank adding its
slice into its accumulator. The f32 sum never passes back through
autograd (which would round it to the leaf's bf16): the function's only
differentiable input is a scalar ``anchor`` that the step
differentiates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.models.params import (tree_map, tree_map_with_path,
                                       tree_paths, tree_unstack)

ALIGN = 512        # bytes: where each leaf starts in a gather buffer


@dataclasses.dataclass(frozen=True)
class Cut:
    """This rank's part of a leaf: ``parts`` contiguous pieces along
    ``dim``, piece ``idx`` here; ``dim`` None: the whole leaf. ``writes``:
    whether this rank is the first of the ranks that hold this piece,
    the one that writes it into an exact gather's buffer and counts it in
    a sum over the ranks (where the data axes hold a model axis folded
    in, a dim the model axis does not divide is cut over the data axis
    alone, and each data column's model ranks hold the same piece).
    ``segs``: a model cut of a fused axis, its components ``(length,
    cut)`` in order; each cut one is split ``parts`` ways, each other
    one whole in every piece (empty: the dim is one cut component)."""
    dim: Optional[int]
    parts: int = 1
    idx: int = 0
    writes: bool = True
    segs: Tuple[Tuple[int, bool], ...] = ()

    def bounds(self, n: int) -> Tuple[int, int]:
        w = n // self.parts
        return self.idx * w, (self.idx + 1) * w

    def ranges(self, n: int) -> List[Tuple[int, int, int, bool]]:
        """This piece's runs along ``dim`` of a whole of ``n``: ``(lo,
        hi)`` in the whole, where the run starts in the piece, and
        whether the run is cut (held by this rank alone) or whole."""
        if not self.segs:
            lo, hi = self.bounds(n)
            return [(lo, hi, 0, True)]
        out, start, at = [], 0, 0
        for length, is_cut in self.segs:
            lo, hi = start, start + length
            if is_cut:
                w = length // self.parts
                lo, hi = start + self.idx * w, start + (self.idx + 1) * w
            out.append((lo, hi, at, is_cut))
            start, at = start + length, at + hi - lo
        return out

    def whole_runs(self) -> List[Tuple[int, int]]:
        """``(start, length)`` in the piece of the runs every rank holds
        whole (a fused leaf's B and C segments)."""
        return [(at, hi - lo) for lo, hi, at, is_cut in
                self.ranges(sum(n for n, _ in self.segs)) if not is_cut]


WHOLE = Cut(None)


def dp_cut(ctx, spec) -> Cut:
    """The :class:`Cut` a spec gives this rank: the dim whose entry holds
    a data axis, split into the product of its axes' sizes; this rank
    writes its piece where its index is 0 on every data axis the entry
    leaves out (on all of them for a leaf no data axis splits)."""
    used: Tuple[str, ...] = ()
    cut = WHOLE
    for i, entry in enumerate(spec):
        axes = (() if entry is None else
                (entry,) if isinstance(entry, str) else tuple(entry))
        if any(a in ctx.dp_axes for a in axes):
            parts, idx = ctx.entry_parts(entry)
            used, cut = axes, Cut(i, parts, idx) if parts > 1 else WHOLE
            break
    writes = all(ctx._axis_index(a) == 0 for a in ctx.dp_axes
                 if a not in used and ctx.axis_size(a) > 1)
    return cut if writes else dataclasses.replace(cut, writes=False)


def model_cut(ctx, spec, segs=()) -> Cut:
    """The :class:`Cut` the model axis makes of a leaf whose spec is
    ``spec`` (its TP piece: the ZeRO cuts act on that piece), with the
    fused components ``segs`` of the cut dim where it has more than one;
    whole without a model axis of more than one rank."""
    if ctx.model_axis is None or ctx.size == 1 or ctx.model_axis not in spec:
        return WHOLE
    return Cut(spec.index(ctx.model_axis), ctx.size, ctx.rank,
               segs=tuple(segs) if len(segs) > 1 else ())


def take(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    """This rank's piece of the whole leaf ``t``, in a tensor of its own
    (so the whole can be freed)."""
    if cut.dim is None:
        return t
    if cut.segs:
        return piece_view(t, cut)
    lo, hi = cut.bounds(t.shape[cut.dim])
    return t.narrow(cut.dim, lo, hi - lo).clone()


def piece_view(t: torch.Tensor, cut: Cut) -> torch.Tensor:
    """The view of this rank's piece of the whole leaf ``t`` (a copy,
    the runs concatenated, where the cut has fused segments)."""
    if cut.dim is None:
        return t
    if cut.segs:
        return torch.cat([t.narrow(cut.dim, lo, hi - lo) for lo, hi, _, _
                          in cut.ranges(t.shape[cut.dim])], cut.dim)
    lo, hi = cut.bounds(t.shape[cut.dim])
    return t.narrow(cut.dim, lo, hi - lo)


def piece_shape(shape, cut: Cut) -> Tuple[int, ...]:
    if cut.dim is None:
        return tuple(shape)
    out = list(shape)
    if cut.segs:
        out[cut.dim] = sum(hi - lo for lo, hi, _, _ in
                           cut.ranges(shape[cut.dim]))
    else:
        out[cut.dim] //= cut.parts
    return tuple(out)


def whole_shape(shape, cut: Cut) -> Tuple[int, ...]:
    """The whole leaf's shape from a piece's ``shape`` under ``cut``."""
    if cut.dim is None:
        return tuple(shape)
    out = list(shape)
    out[cut.dim] = (sum(n for n, _ in cut.segs) if cut.segs
                    else out[cut.dim] * cut.parts)
    return tuple(out)


def _padded(nbytes: int) -> int:
    return -(-nbytes // ALIGN) * ALIGN


def gather_pieces(ctx, items, device, sum_bytes=None) -> List[torch.Tensor]:
    """The whole leaves of ``items`` — ``(piece or None, whole shape,
    dtype, Cut, writes)`` each, this rank writing its piece where
    ``writes`` and the cut's own ``writes`` say so — from every rank's
    pieces, through one exact all-reduce of an int32 buffer
    (``sum_bytes``: the data axes' ``ctx.dp_gather_bytes`` unless
    given).
    Returns views of that buffer, each starting ``ALIGN``-byte
    aligned."""
    offs, total = [], 0
    for _, shape, dtype, _, _ in items:
        offs.append(total)
        total += _padded(math.prod(shape) * _itemsize(dtype))
    buf = torch.zeros(total // 4, dtype=torch.int32, device=device)
    raw = buf.view(torch.uint8)
    out = []
    for (piece, shape, dtype, cut, writes), off in zip(items, offs):
        n = math.prod(shape) * _itemsize(dtype)
        whole = raw[off:off + n].view(dtype).view(shape)
        if writes and cut.writes:
            _write_piece(whole, piece, cut)
        out.append(whole)
    (sum_bytes or ctx.dp_gather_bytes)(buf)
    return out


def _write_piece(whole: torch.Tensor, piece: torch.Tensor, cut: Cut) -> None:
    """Write this rank's ``piece`` into its place in the zero buffer
    ``whole``: of a fused cut its own runs, and the whole runs on the
    axis's first rank alone (every rank holds them alike, and the gather
    sums the buffer)."""
    if cut.dim is None or not cut.segs:
        piece_view(whole, cut).copy_(piece)
        return
    for lo, hi, at, is_cut in cut.ranges(whole.shape[cut.dim]):
        if is_cut or cut.idx == 0:
            whole.narrow(cut.dim, lo, hi - lo).copy_(
                piece.narrow(cut.dim, at, hi - lo))


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def gather_leaf(ctx, piece: torch.Tensor, shape, cut: Cut,
                device=None, sum_bytes=None) -> torch.Tensor:
    """The whole leaf of ``shape`` from every rank's ``piece`` (exact;
    over the data axes unless ``sum_bytes`` names another sum, as
    :func:`gather_pieces`); a leaf no dim splits is every rank's
    already."""
    if cut.dim is None:
        return piece
    return gather_pieces(ctx, [(piece, tuple(shape), piece.dtype, cut,
                                True)], device or piece.device,
                         sum_bytes)[0]


# --------------------------------------------------------------------------
# ZeRO-3: gather at use
# --------------------------------------------------------------------------


class Shard:
    """One parameter leaf as ZeRO-3 hands it to the model: ``piece``,
    the whole leaf's ``shape`` and ``dtype``, ``cut``, ``kind`` and
    ``acc`` (the f32 accumulator piece this leaf's reduced gradient goes
    to; None where this rank keeps none of it), and ``comm`` (the
    micro-batch's :class:`ZeroComm`). ``kind``: ``"cut"`` (``piece`` is
    this rank's slice along ``cut.dim``), ``"replicated"`` (every rank
    holds the whole: nothing to gather), ``"owner"`` (this rank alone
    holds the whole: a layer of a leaf cut on its layers dim) or
    ``"absent"`` (another rank holds it; ``piece`` None)."""
    __slots__ = ("piece", "shape", "dtype", "cut", "kind", "acc", "comm")

    def __init__(self, piece, shape, dtype, cut: Cut, kind: str, acc, comm):
        self.piece, self.shape, self.dtype = piece, tuple(shape), dtype
        self.cut, self.kind, self.acc, self.comm = cut, kind, acc, comm

    @classmethod
    def of(cls, piece, shape, cut: Cut, acc, comm) -> "Shard":
        return cls(piece, shape, piece.dtype, cut,
                   "replicated" if cut.dim is None else "cut", acc, comm)

    def layer(self, i: int) -> "Shard":
        """Layer ``i`` of a leaf stacked on its first dim."""
        c, acc = self.cut, self.acc
        if self.kind == "replicated" or c.dim > 0:
            sub = c if c.dim is None else dataclasses.replace(c,
                                                              dim=c.dim - 1)
            return Shard(self.piece[i], self.shape[1:], self.dtype, sub,
                         self.kind, None if acc is None else acc[i],
                         self.comm)
        lo, hi = c.bounds(self.shape[0])       # the layers dim is cut
        if lo <= i < hi:
            return Shard(self.piece[i - lo], self.shape[1:], self.dtype,
                         Cut(None, writes=c.writes), "owner",
                         None if acc is None else acc[i - lo], self.comm)
        return Shard(None, self.shape[1:], self.dtype, WHOLE, "absent",
                     None, self.comm)


@dataclasses.dataclass
class ZeroComm:
    """What one micro-batch's gathers share: the context (its data
    axes), the device, and the ``anchor``, a zero f32 scalar with
    ``requires_grad`` whose gradient the step asks for."""
    ctx: object
    device: torch.device
    anchor: torch.Tensor


class _Gather(torch.autograd.Function):
    """Whole leaves from :class:`Shard` views; backward reduces their
    gradients into the shards' accumulators and returns none."""

    @staticmethod
    def forward(fctx, anchor, comm, shards):
        fctx.comm, fctx.shards = comm, shards
        need = [s for s in shards if s.kind != "replicated"]
        whole = iter(gather_pieces(comm.ctx, [
            (s.piece, s.shape, s.dtype, s.cut, s.kind != "absent")
            for s in need], comm.device) if need else ())
        return tuple(s.piece.detach() if s.kind == "replicated"
                     else next(whole) for s in shards)

    @staticmethod
    def backward(fctx, *grads):
        comm, shards = fctx.comm, fctx.shards
        offs, total = [], 0
        for s in shards:
            offs.append(total)
            total += math.prod(s.shape)
        buf = torch.zeros(total, dtype=torch.float32, device=comm.device)
        for s, g, off in zip(shards, grads, offs):
            if g is not None:
                buf[off:off + math.prod(s.shape)].view(s.shape).copy_(g)
        comm.ctx.dp_all_reduce(buf)
        for s, off in zip(shards, offs):
            if s.acc is not None:
                whole = buf[off:off + math.prod(s.shape)].view(s.shape)
                s.acc.add_(piece_view(whole, s.cut))
        return torch.zeros_like(comm.anchor), None, None


def _is_shard(x) -> bool:
    return isinstance(x, Shard)


def gather_used(tree):
    """``tree`` with every :class:`Shard` leaf replaced by its whole
    tensor (one :class:`_Gather` for the tree); a tree without Shards is
    returned as it is."""
    paths = [(p, s) for p, s in tree_paths(tree, is_leaf=_is_shard)
             if _is_shard(s)]
    if not paths:
        return tree
    comm = paths[0][1].comm
    outs = _Gather.apply(comm.anchor, comm, [s for _, s in paths])
    whole = {p: o for (p, _), o in zip(paths, outs)}
    return tree_map_with_path(lambda p, x: whole.get(p, x), tree,
                              is_leaf=_is_shard)


NESTED = ("blocks", "enc_blocks")


def gather_top(params):
    """``params`` with its top-level leaves (embedding, final norms,
    head, frontend projection) gathered in one call; the layer stacks
    stay Shards, gathered layer by layer where used."""
    top = {k: v for k, v in params.items() if k not in NESTED}
    got = gather_used(top)
    if got is top:
        return params
    return {**params, **got}


def unstack(tree, n: int) -> List:
    """Per-layer trees of a stacked tree: ``tree_unstack`` of tensors,
    :meth:`Shard.layer` of Shards."""
    leaves = tree_paths(tree, is_leaf=_is_shard)
    if not any(_is_shard(s) for _, s in leaves):
        return tree_unstack(tree, n)
    return [tree_map(lambda s: s.layer(i), tree, is_leaf=_is_shard)
            for i in range(n)]
