"""Sharding over the mesh's axes (the port of
``repro.parallel.sharding``): the model axis of the serving engine and
the data axis of training (ZeRO stages and offload).

The reference states placement as PartitionSpecs over a jax ``Mesh`` and
lets GSPMD partition each jitted step. The port runs one process per
rank of a ``torch.distributed`` group (``launch.mesh``) and each rank
computes with what it holds, so placement and computation are stated
here explicitly:

* :class:`ShardCtx` — the mesh's axes over process groups: the model
  axis (its size and this rank's index, the part of an axis this rank
  holds, ``part``; the KV heads its attention reads, ``kv_part``; the
  collectives of the row-parallel seams, ``all_reduce`` of f32 partials
  and ``gather_last`` of the vocab-sharded logits, in place for serving;
  for training Megatron's seam operators: ``exit_block`` (g, or under
  ``sp`` the sequence reduce-scatter) as autograd functions, and the f32
  sum of a column-parallel input's cotangent, ``sum_column_grad`` (f's
  backward, or under ``sp`` the all-gather's, for
  ``layers.dense_column``), with the rows a rank holds under ``sp``,
  ``own_rows``) and the data axes
  (the reference's ``dp_axes``, ``dp_size``, ``dp_spec_entry``, ``_dp``
  and ``batch_sharding``, and the data-axis collectives, built from
  ``all_reduce`` only, as gloo offers nothing else on CUDA tensors:
  ``dp_all_reduce`` of f32 gradients, ``dp_gather_bytes`` for an exact
  gather of the bytes each rank holds, ``dp_reduce_scatter``, an f32
  all-reduce of which each rank keeps its slice), and the model axis's
  exchange of expert parallelism (``gather_bytes``, the model-axis
  counterpart of ``dp_gather_bytes``; ``all_to_all``, and ``slice_t`` /
  ``gather_t``, the token slices along ``t``, built on it: under
  autograd each one's backward is its transpose, bit for bit; the
  load-balancing loss's ``mesh_mean``), and the attention mode
  (``attn_mode``): ``"head"`` splits the heads over the model axis,
  ``"seq"`` (context parallelism) the sequence, each rank attending
  with its rows of T against the k/v gathered from every rank
  (``seq_attention``, ``seq_kv_gather`` and ``seq_kv_scatter``, the f32
  sum of the ranks' dK/dV partials).
* :func:`make_shard_ctx` — the training context: the data axis, and a
  model axis that a technique without TP (or mamba2's ``dp_over_model``)
  folds into it; the data-axis collectives then run over the group of
  every axis folded in; the attention mode as the reference picks it.
* :func:`resolve_spec` — the reference's resolver: which dim of a leaf
  the model axis splits (``_tp_entry``, ``_TP_PRIORITY``; one entry per
  dim, ``None``, an axis name or a tuple of them, as a PartitionSpec's)
  and, for ZeRO, which dim the data axes split (``_zero_overlay``). An
  axis the degree does not divide stays whole (replication, never an
  error).
* :func:`state_shardings` / :func:`train_state_shardings` — a
  :class:`Placement` (spec, and whether ``+O`` puts the leaf in pinned
  host memory) for every leaf of params, gradients or optimizer state,
  named by the reference's key strings (``_normalize_path`` gives the
  moments, master weights, LoRA, nf4, int8 and ``Opt8`` leaves the
  reference's placement, quirks included).
* :func:`shard_params` — a model-axis rank's slice of a full parameter
  tree (serving).

**Fused axes.** mamba2's ``in_proj`` columns are z | x | B | C | dt and
its conv channels x | B | C, each one logical ``ssm_inner`` axis. GSPMD
cuts such an axis into contiguous blocks and reshards behind the
``ssm_x`` / ``ssm_bc`` / ``ssm_dt`` constraints; a rank that computes
only with what it holds cannot. So the *axis* is the resolver's and the
*cut* is the port's (:func:`fused_segments`): z and x channels by whole
heads, dt by heads, B and C (``ssm_ngroups`` groups, one on mamba2)
whole on every rank. A rank's ``in_proj`` is then ``2·di/tp + 2·G·N +
H/tp`` columns wide, not ``proj_out/tp``, and its conv channels
``di/tp + 2·G·N``; the dense SSM slot pool's conv leaf follows the same
cut. Where the resolver splits one SSM leaf but the SSD heads do not
divide (or the other way round), :func:`shard_params` raises. The data
axis needs no such cut: ZeRO shards state, and every rank computes with
whole gathered leaves.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.config import ArchConfig, Technique
from repro_torch.models.params import (ParamSpec, keystr_map,
                                       tree_map_with_path, tree_paths)
from repro_torch.parallel import zero as Z

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


MODEL = "model"     # the mesh axis the serving engine shards over
DATA = "data"


@dataclasses.dataclass
class ShardCtx:
    """The axes of ``mesh`` (a ``launch.mesh.Mesh``: ``shape``,
    ``axis_names``, this rank's ``rank`` on the model axis and its
    process ``group``, its ``data_rank`` and ``data_group`` on the data
    axis, and the ``comm_device`` host values travel on). ``dp_axes`` are
    the axes the batch and ZeRO state split over, ``model_axis`` the one
    TP uses (``None`` where the technique folds it into ``dp_axes``).
    ``attn_mode`` is the reference's: ``"head"`` (serving's, and
    training's where the model axis divides the heads) or ``"seq"``
    (training's sequence mode: the attention leaves stay whole on every
    model rank and T splits, :meth:`seq_splits`). ``comm_timer``, where
    set (a
    ``core.perfscope.Timer``), times each data-axis collective between two
    synchronizes as ``"collective"``, each model-axis exchange as
    ``"exchange"``, each training seam's collective as ``"seam"`` and
    each gather of k/v and sum of their cotangents in sequence mode as
    ``"kv"``; ``exchange_bytes`` counts the bytes the exchanges' buffers
    carried and ``seam_bytes`` those of the seams' and the k/v buffers
    (read from shapes: no sync)."""
    mesh: object
    cfg: Optional[ArchConfig] = None
    dp_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = MODEL
    technique: Technique = Technique()
    attn_mode: str = "head"
    comm_timer: object = None
    exchange_bytes: int = 0
    seam_bytes: int = 0

    def axis_size(self, name: Optional[str]) -> int:
        if name is None or self.mesh is None:
            return 1
        return int(self.mesh.shape[name])

    @property
    def size(self) -> int:
        """The model axis's size (1 without one)."""
        return self.axis_size(self.model_axis)

    @property
    def rank(self) -> int:
        return int(self.mesh.rank) if self.mesh is not None else 0

    # -- the data axes --
    @property
    def dp_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.dp_axes)

    @property
    def dp_spec_entry(self) -> Entry:
        return self.dp_axes if len(self.dp_axes) > 1 else (
            self.dp_axes[0] if self.dp_axes else None)

    def _axis_index(self, name: str) -> int:
        if name == MODEL:
            return self.rank
        return int(getattr(self.mesh, "data_rank", 0))

    @property
    def dp_rank(self) -> int:
        """This rank's index over the data axes, the first the major
        (row-major, as a PartitionSpec's tuple entry splits a dim)."""
        idx = 0
        for a in self.dp_axes:
            idx = idx * self.axis_size(a) + self._axis_index(a)
        return idx

    def _dp(self, dim: int) -> Entry:
        """Largest dp prefix that divides ``dim``."""
        axes = list(self.dp_axes)
        while axes and dim % math.prod(self.axis_size(a) for a in axes):
            axes.pop()
        if not axes:
            return None
        return tuple(axes) if len(axes) > 1 else axes[0]

    def batch_sharding(self, rows: int) -> Tuple[int, int]:
        """This rank's rows ``[r·B/dp, (r+1)·B/dp)`` of a batch of
        ``rows``, as ``P(dp, None)`` places them."""
        dp = self.dp_size
        if rows % dp:
            raise ValueError(f"a batch of {rows} rows does not split over "
                             f"{dp} data-parallel ranks")
        w = rows // dp
        return self.dp_rank * w, (self.dp_rank + 1) * w

    def entry_parts(self, entry: Entry) -> Tuple[int, int]:
        """``(parts, this rank's part)`` of a dim whose spec entry is
        ``entry``: the product of its axes' sizes, and this rank's index
        over them (the first axis the major)."""
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        n, idx = 1, 0
        for a in axes:
            n *= self.axis_size(a)
            idx = idx * self.axis_size(a) + self._axis_index(a)
        return n, idx

    # -- the model axis --
    def _mdl(self, dim: int) -> Optional[str]:
        """The model axis where TP uses it and it divides ``dim``, else
        ``None``."""
        m = self.model_axis
        if m is None or not self.technique.tp or dim % self.axis_size(m):
            return None
        return m

    def splits(self, n: int) -> bool:
        """Whether the model axis cuts an axis of ``n`` entries."""
        return self.size > 1 and self._mdl(n) is not None

    def part(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of an axis of ``n`` entries: its
        contiguous ``n/tp`` where the axis divides, else all of it."""
        if self._mdl(n) is None:
            return 0, n
        w = n // self.size
        return self.rank * w, (self.rank + 1) * w

    def kv_part(self, cfg: ArchConfig) -> Tuple[int, int]:
        """The KV heads this rank's attention reads: its own K/tp where
        the axis divides K; else every rank holds all K heads and reads
        the ones its q heads map to (head h reads h // G). Raises where
        those do not form an even grouping of its q heads."""
        h, k = cfg.n_heads, cfg.n_kv_heads
        if self._mdl(k) is not None:
            return self.part(k)
        q0, q1 = self.part(h)
        g = h // k
        lo, hi = q0 // g, (q1 - 1) // g + 1
        nq = q1 - q0
        g_l = nq // (hi - lo)
        if nq % (hi - lo) or any((q0 + j) // g - lo != j // g_l
                                 for j in range(nq)):
            raise NotImplementedError(
                f"{cfg.name}: q heads [{q0}, {q1}) of rank {self.rank} "
                f"read KV heads [{lo}, {hi}) unevenly at tp={self.size}")
        return lo, hi

    def all_reduce(self, t: torch.Tensor,
                   region: Optional[str] = None) -> torch.Tensor:
        """Sum ``t`` over the model axis, in place (a row-parallel
        seam's f32 partials, an f32 gradient); returns it. A no-op on one
        rank. Where ``region`` is given, ``comm_timer`` times the sum
        under it (a training seam's, ``"seam"``, and sequence mode's
        k/v, ``"kv"``, also count their bytes in ``seam_bytes``; the
        step's sums of gradients are ``"collective"``); serving's seams
        are not timed."""
        if self.size > 1:
            if region in ("seam", "kv"):
                self.seam_bytes += t.numel() * t.element_size()
            with (self._timed(t, region) if region else
                  contextlib.nullcontext()):
                dist.all_reduce(t, group=self.mesh.group)
        return t

    def gather_last(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """The whole last axis (``n`` entries) from each rank's part
        ``t``: this rank's part written into a zero f32 buffer of the
        whole width, summed over the model axis and cast back. Exact (x +
        0 is x, up to the sign of a zero), and an ``all_reduce``: gloo
        takes CUDA tensors in ``all_reduce`` and ``broadcast`` only."""
        if not self.splits(n):
            return t
        lo, hi = self.part(n)
        buf = t.new_zeros(t.shape[:-1] + (n,), dtype=torch.float32)
        buf[..., lo:hi] = t
        return self.all_reduce(buf).to(t.dtype)

    def broadcast_float(self, v: float) -> float:
        """Rank 0's reading of a host value (the engine's clock at
        ``submit``, so every rank orders requests alike)."""
        if self.size == 1:
            return v
        t = torch.tensor([v], dtype=torch.float64,
                         device=self.mesh.comm_device)
        dist.broadcast(t, src=self.mesh.ranks[0], group=self.mesh.group)
        return float(t.cpu()[0])

    # -- the model axis's exchange (expert parallelism; all_reduce only) --
    def gather_bytes(self, buf: torch.Tensor) -> torch.Tensor:
        """The model-axis counterpart of :meth:`dp_gather_bytes`: the
        exact gather of an int32 buffer in which each rank has written
        its words and left zeros elsewhere, as one ``all_reduce`` over
        the model axis (in place; returned). A no-op on one rank."""
        if buf.dtype != torch.int32:
            raise TypeError(f"gather_bytes takes int32, not {buf.dtype}")
        if self.size > 1:
            self.exchange_bytes += buf.numel() * 4
        return self.all_reduce(buf, "exchange")

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``jax.lax.all_to_all(send, model, 0, 0, tiled=False)``: block
        ``j`` of ``send`` (``size`` blocks on its first axis) goes to rank
        ``j``; block ``i`` of the result came from rank ``i``. Every value
        arrives bit for bit: each rank writes its blocks' bytes (an int32
        view: gloo takes no int16) into its row of a zero (size, size,
        words) buffer, :meth:`gather_bytes` sums the rows, and each rank
        reads its column. The buffer is ``size`` times ``send``: an
        all-to-all built from the one collective gloo offers on CUDA
        tensors. Under autograd its backward sends each block of the
        cotangent back by the same exchange (:class:`_AllToAll`: the
        exchange is its own transpose), bit for bit."""
        if self.size == 1:
            return send
        return _AllToAll.apply(send, self)

    def _exchange(self, send: torch.Tensor) -> torch.Tensor:
        m = self.size
        words = _words(send).view(m, -1)
        buf = words.new_zeros((m, m, words.shape[1]))
        buf[self.rank] = words
        self.gather_bytes(buf)
        return _from_words(buf[:, self.rank], send.dtype, send.shape)

    def gather_t(self, y: torch.Tensor, t: int) -> torch.Tensor:
        """The whole (B, t, ...) from each rank's slice ``y`` (B, t/size,
        ...) of its second axis (rank ``r`` holds ``[r·t/size,
        (r+1)·t/size)``), bit for bit, through :meth:`gather_bytes`: the
        reference's ``_constrain(ctx, y, "hidden")`` after an
        expert-parallel FFN whose tokens were split along ``t``. Under
        autograd the backward takes this rank's rows of the cotangent,
        which every rank holds alike (no sum)."""
        if self.size == 1:
            return y
        return _GatherSeq.apply(y, self, True)

    def slice_t(self, h: torch.Tensor) -> torch.Tensor:
        """This rank's slice ``[r·t/size, (r+1)·t/size)`` of the second
        axis of ``h`` (B, t, ...), which every rank holds alike: the
        token slice an expert-parallel FFN routes. Under autograd the
        backward gathers every rank's slice of the cotangent, bit for bit
        (through :meth:`gather_bytes`), so the cotangent of ``h`` is whole
        and alike on every rank; the transpose of :meth:`gather_t`."""
        if self.size == 1:
            return h
        return _SplitSeq.apply(h, self, True)

    def mesh_mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of the scalar ``t`` over the model axis and the data
        axes (the reference's ``pmean`` over both, of each shard's
        load-balancing loss): its value on every rank, and as its
        gradient the ``1/n`` share of this rank's own ``t`` (n ranks in
        all), so the ranks' gradients sum to the mean's."""
        n = self.size * self.dp_size
        tot = t.detach().reshape(1).to(torch.float32, copy=True)
        self.all_reduce(tot)
        self.dp_all_reduce(tot)
        part = t / n
        return tot[0] / n + (part - part.detach())

    def _gather_rows(self, y: torch.Tensor, total) -> torch.Tensor:
        """The whole (B, T, ...) from each rank's rows ``y`` (B, T/size,
        ...), bit for bit: this rank's bytes in its row of a zero int32
        buffer, summed over the model axis by ``total``."""
        words = _words(y)
        buf = words.new_zeros((self.size, words.numel()))
        buf[self.rank] = words
        total(buf)
        parts = _from_words(buf, y.dtype, (self.size,) + tuple(y.shape))
        return parts.movedim(0, 1).reshape(
            (y.shape[0], y.shape[1] * self.size) + tuple(y.shape[2:]))

    # -- data-axis collectives (all_reduce only) --
    def _timed(self, t: torch.Tensor, name: str = "collective"):
        if self.comm_timer is None:
            return contextlib.nullcontext()
        fence = ((lambda: torch.cuda.synchronize(t.device)) if t.is_cuda
                 else None)
        if fence is not None:
            fence()
        return self.comm_timer.region(name, fence=fence)

    @property
    def dp_group(self):
        """The process group of the data axes: the mesh's data column,
        or where the model axis is folded in, the group of every rank of
        both axes (the model row where the data axis has one rank)."""
        if MODEL not in self.dp_axes or self.axis_size(MODEL) == 1:
            return self.mesh.data_group
        if self.axis_size(DATA) == 1:
            return self.mesh.group
        return dist.group.WORLD

    def dp_all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the data axes, in place; returns it. A no-op on
        one rank. Gradients travel in f32 (the callers cast first), so
        the sum is the f32 sum the one-device accumulation makes."""
        if self.dp_size > 1:
            with self._timed(t):
                dist.all_reduce(t, group=self.dp_group)
        return t

    def dp_gather_bytes(self, buf: torch.Tensor) -> torch.Tensor:
        """The exact gather of an int32 buffer in which each rank has
        written the bytes it holds and left zeros elsewhere: an integer
        sum of disjoint bit patterns is their union (no carries), so
        every value arrives bit for bit, -0.0 and NaN payloads included
        (an f32 sum would turn -0.0 into +0.0). gloo takes int32, not
        int16, so a bf16 leaf travels as the int32 view of its padded
        bytes."""
        if buf.dtype != torch.int32:
            raise TypeError(f"dp_gather_bytes takes int32, not {buf.dtype}")
        return self.dp_all_reduce(buf)

    def dp_reduce_scatter(self, g: torch.Tensor, dim: Optional[int],
                          parts: int, idx: int) -> torch.Tensor:
        """This rank's slice ``idx`` of ``parts`` along ``dim`` of the f32
        sum of ``g`` over the data axes (``g`` is summed in place); the
        whole sum where ``dim`` is ``None``. The reduce-scatter as an f32
        all-reduce and a slice: under gloo it moves what an all-reduce
        moves."""
        self.dp_all_reduce(g)
        if dim is None:
            return g
        w = g.shape[dim] // parts
        return g.narrow(dim, idx * w, w)

    def dp_barrier(self) -> None:
        if self.dp_size > 1:
            dist.barrier(group=self.dp_group)

    # -- the model axis in training: Megatron's seams (all_reduce only) --
    @property
    def sp(self) -> bool:
        """Whether the residual stream is split on T over the model axis
        (Megatron sequence parallelism, ``Technique.sp``): the
        reference's ``"hidden"`` constraint, which splits T where the
        degree divides it (the model checks that it does)."""
        return self.size > 1 and self.technique.tp and self.technique.sp

    def own_rows(self, t: int) -> Tuple[int, int]:
        """This rank's rows ``[r·t/tp, (r+1)·t/tp)`` of a sequence of
        ``t`` positions (the rows it holds under ``sp``)."""
        if t % self.size:
            raise ValueError(f"sequence parallelism splits T={t} over a "
                             f"model axis of {self.size}: T must divide")
        w = t // self.size
        return self.rank * w, (self.rank + 1) * w

    def exit_block(self, y: torch.Tensor, rows: bool = True
                   ) -> torch.Tensor:
        """A row-parallel seam's f32 partials (B, T, ...) summed over the
        model axis: under ``sp`` (and ``rows``: ``y``'s second axis is
        the sequence) reduce-scattered to this rank's rows (backward: the
        cotangents' all-gather); else Megatron's g under autograd
        (all-reduce, backward: identity), and the serving path's in-place
        all-reduce without it."""
        if self.size == 1:
            return y
        if self.sp and rows:
            return _ScatterSeq.apply(y, self)
        # repro: allow[JIT-04] autograd's mode and requires_grad are host metadata of the tensor, not device values
        if torch.is_grad_enabled() and y.requires_grad:
            return _ReduceFromModel.apply(y, self)
        return self.all_reduce(y)

    def copy_to_model(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f alone, for inputs that are not a sequence (the
        experts' dispatch buffer where the model axis cuts their MLP
        width): forward the identity; under autograd the backward sums
        the cotangent's f32 partials over the model axis and rounds once
        to ``x``'s type."""
        if self.size == 1:
            return x
        return _CopyToModel.apply(x, self)

    def sum_column_grad(self, g: torch.Tensor, seq: bool) -> torch.Tensor:
        """The f32 partials ``g`` (B, T, ...) of a column-parallel
        input's cotangent summed over the model axis (Megatron's f
        backward), in f32: with ``seq`` reduce-scattered to this rank's
        rows (the backward of the sequence all-gather); the caller rounds
        once."""
        if seq:
            return self.seq_reduce_scatter(g)
        return self.all_reduce(g, "seam")

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Under ``sp``, the whole sequence from each rank's rows of the
        final hidden states, whose cotangent is whole on every rank (the
        loss's f sums it): backward takes this rank's rows, no sum."""
        if not self.sp:
            return x
        return _GatherSeq.apply(x, self)

    def reduce_from_model(self, t: torch.Tensor) -> torch.Tensor:
        """Megatron's g alone (the vocab-parallel loss's f32 partial
        sums): all-reduce; backward identity."""
        return t if self.size == 1 else _ReduceFromModel.apply(t, self)

    def model_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` (f32) over the model axis: each
        rank's values written into its row of a zero buffer, summed
        (exact: x + 0 is x) and reduced locally; no gradient."""
        if self.size == 1:
            return t
        buf = t.new_zeros((self.size,) + tuple(t.shape), dtype=torch.float32)
        buf[self.rank] = t
        return self.all_reduce(buf, "seam").amax(0)

    def seq_gather(self, y: torch.Tensor) -> torch.Tensor:
        """The whole (B, T, ...) from each rank's rows ``y`` (B, T/tp,
        ...), bit for bit, timed as a seam."""
        return self._gather_rows(y, lambda b: self.all_reduce(b, "seam"))

    def seq_reduce_scatter(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the f32 sum over the model axis of ``y``
        (B, T, ...), in ``y``'s type: an f32 all-reduce and a slice."""
        total = self.all_reduce(y.to(torch.float32, copy=True), "seam")
        lo, hi = self.own_rows(y.shape[1])
        return total[:, lo:hi].to(y.dtype)

    # -- sequence (context-parallel) attention, attn_mode "seq" --
    def seq_splits(self, t: int) -> bool:
        """Whether attention splits a sequence of ``t`` positions over
        the model axis: sequence mode, and the axis divides ``t`` (the
        reference's ``act_q``/``act_kv`` ``_mdl(T)``; else every rank
        attends the whole sequence, replicated)."""
        return self.attn_mode == "seq" and self.splits(t)

    def seq_kv_gather(self, k: torch.Tensor, v: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The whole (B, T, K, D) k and v from each rank's rows (B, T/tp,
        K, D), bit for bit, in one exact gather of the two side by side
        (timed as ``"kv"``); no gradient."""
        d = k.shape[-1]
        kv = self._gather_rows(torch.cat([k, v], -1),
                               lambda b: self.all_reduce(b, "kv"))
        return kv[..., :d], kv[..., d:]

    def seq_kv_scatter(self, dk: torch.Tensor, dv: torch.Tensor, t: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's rows of a sequence of ``t`` positions of the sums
        over the model axis of every rank's k/v cotangents ``dk``, ``dv``
        (B, S, K, D) over the keys ``[0, S)`` it read, in f32 (unrounded):
        the two side by side in a zero f32 buffer over the whole T (the
        keys past S no query of this rank reads), one f32 all-reduce, and
        a slice."""
        b, s, n_kv, d = dk.shape
        buf = dk.new_zeros((b, t, n_kv, 2 * d), dtype=torch.float32)
        buf[:, :s, :, :d] = dk
        buf[:, :s, :, d:] = dv
        self.all_reduce(buf, "kv")
        lo, hi = self.own_rows(t)
        return buf[:, lo:hi, :, :d], buf[:, lo:hi, :, d:]

    def enter_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of the whole sequence ``x`` (B, T, ...), which
        every rank holds alike, entering a block that runs on them alone
        (sequence-mode attention without ``sp``): backward, the
        cotangent's rows gathered from every rank, bit for bit, so the
        whole sequence's cotangent stays whole on every rank."""
        return _SplitSeq.apply(x, self)

    def leave_rows(self, y: torch.Tensor) -> torch.Tensor:
        """The whole sequence from each rank's rows ``y`` of a block's
        output, bit for bit (the reference's ``"hidden"`` constraint);
        backward takes this rank's rows of the cotangent, whole on every
        rank."""
        return _GatherSeq.apply(y, self)

    def seq_attention(self, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, mode: str) -> torch.Tensor:
        """Causal attention of this rank's rows under a sequence split:
        q (B, T/tp, H, D) and k, v (B, T/tp, K, D) its rows ``[lo, hi)``;
        the keys ``[0, hi)`` come from every rank and the mask takes
        ``q_offset = lo``. ``"flash"`` runs the flash kernels with their
        f32 dK/dV (``kernels.ops.seq_flash_attention``); ``"naive"`` the
        materialized scores on the gathered k/v (:class:`_SeqKV`), whose
        cotangents arrive in k/v's type. Either way each rank's dK/dV
        partials are summed over the ranks in f32 and rounded once."""
        if mode == "flash":
            from repro_torch.kernels import ops as kops
            return kops.seq_flash_attention(q, k, v, self)
        from repro_torch.models import layers as L
        lo, _ = self.own_rows(q.shape[1] * self.size)
        kg, vg = _SeqKV.apply(k, v, self)
        return L.attention(q, kg, vg, mode=mode, causal=True, q_offset=lo)


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: forward, the partials summed over the model axis in
    f32 (a fresh tensor), rounded once to their type; backward identity
    (the sum's cotangent is each part's)."""

    @staticmethod
    def forward(fctx, y, ctx):
        return ctx.all_reduce(y.to(torch.float32, copy=True),
                              "seam").to(y.dtype)

    @staticmethod
    def backward(fctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    """``ShardCtx.all_to_all`` under autograd: backward, the cotangent's
    blocks sent back by the same exact exchange (block ``i`` of the
    cotangent goes to rank ``i``, whose block it was)."""

    @staticmethod
    def forward(fctx, send, ctx):
        fctx.ctx = ctx
        return ctx._exchange(send)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx._exchange(g.contiguous()), None


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: forward identity; backward the cotangent's f32
    partials summed over the model axis (``"seam"``), rounded once."""

    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.all_reduce(g.to(torch.float32, copy=True),
                                   "seam").to(g.dtype), None


def _rows_gather(ctx, y: torch.Tensor, exchange: bool) -> torch.Tensor:
    """The whole T from each rank's rows ``y``, bit for bit: the
    expert-parallel exchange's gather (``"exchange"``) or a seam's."""
    if exchange:
        return ctx._gather_rows(y, ctx.gather_bytes)
    return ctx.seq_gather(y)


class _GatherSeq(torch.autograd.Function):
    """The whole T from each rank's rows (the final hidden states under
    sp, a sequence-mode attention block's output, an expert-parallel
    FFN's t-slices with ``exchange``), bit for bit; backward takes this
    rank's rows of the cotangent, whole on every rank (the loss's
    column-parallel head has already summed it over the axis)."""

    @staticmethod
    def forward(fctx, x, ctx, exchange=False):
        fctx.ctx = ctx
        return _rows_gather(ctx, x, exchange)

    @staticmethod
    def backward(fctx, g):
        lo, hi = fctx.ctx.own_rows(g.shape[1])
        return g[:, lo:hi].contiguous(), None, None


class _SplitSeq(torch.autograd.Function):
    """This rank's rows of a sequence every rank holds alike; backward,
    the cotangent's rows gathered from every rank, bit for bit (through
    the exchange with ``exchange``: an expert-parallel FFN's t-slice)."""

    @staticmethod
    def forward(fctx, x, ctx, exchange=False):
        fctx.ctx, fctx.exchange = ctx, exchange
        lo, hi = ctx.own_rows(x.shape[1])
        return x[:, lo:hi].contiguous()

    @staticmethod
    def backward(fctx, g):
        return _rows_gather(fctx.ctx, g.contiguous(), fctx.exchange), None, \
            None


class _SeqKV(torch.autograd.Function):
    """k and v over the keys ``[0, hi)`` from each rank's rows (this
    rank's ``[lo, hi)``), bit for bit; backward, every rank's cotangents
    summed over the ranks in f32 and cut to this rank's rows
    (``ShardCtx.seq_kv_scatter``), rounded once to k/v's type."""

    @staticmethod
    def forward(fctx, k, v, ctx):
        t = k.shape[1] * ctx.size
        _, hi = ctx.own_rows(t)
        kg, vg = ctx.seq_kv_gather(k, v)
        fctx.ctx, fctx.t, fctx.dtypes = ctx, t, (k.dtype, v.dtype)
        return kg[:, :hi].contiguous(), vg[:, :hi].contiguous()

    @staticmethod
    def backward(fctx, gk, gv):
        dk, dv = fctx.ctx.seq_kv_scatter(gk, gv, fctx.t)
        return dk.to(fctx.dtypes[0]), dv.to(fctx.dtypes[1]), None


class _ScatterSeq(torch.autograd.Function):
    """Megatron's sequence reduce-scatter: this rank's rows of the f32
    partials' sum over the model axis; backward, the cotangent's rows
    gathered from every rank, bit for bit."""

    @staticmethod
    def forward(fctx, y, ctx):
        fctx.ctx = ctx
        return ctx.seq_reduce_scatter(y)

    @staticmethod
    def backward(fctx, g):
        return fctx.ctx.seq_gather(g.contiguous()), None


def _words(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bytes as a flat int32 tensor (a copy only where ``t`` is
    not contiguous)."""
    flat = t.contiguous().view(-1)
    if flat.numel() * flat.element_size() % 4:
        raise ValueError(f"{tuple(t.shape)} {t.dtype}: not a whole number "
                         f"of 4-byte words")
    return flat.view(torch.uint8).view(torch.int32)


def _from_words(words: torch.Tensor, dtype: torch.dtype,
                shape) -> torch.Tensor:
    """The inverse of :func:`_words`: ``words``' bytes as ``dtype`` in
    ``shape``."""
    return words.contiguous().view(-1).view(torch.uint8).view(
        dtype).reshape(shape)


def make_shard_ctx(cfg: ArchConfig, technique: Technique, mesh
                   ) -> ShardCtx:
    """The training context of ``technique`` on ``mesh`` (the
    reference's): the data axes are ``pod`` and ``data`` where the mesh
    has them; a config with ``dp_over_model`` (mamba2), or a technique
    without TP, folds the model axis into them. The attention mode is
    ``technique.attn_mode`` where it is ``"head"`` or ``"seq"``; under
    ``"auto"`` it is sequence mode where a model axis of more than one
    rank does not divide the heads, else head mode."""
    if mesh is None:
        return ShardCtx(None, cfg, (), None, technique)
    names = list(mesh.axis_names)
    model_axis = MODEL if MODEL in names else None
    dp = tuple(a for a in ("pod", DATA) if a in names)
    if model_axis and (cfg.dp_over_model or not technique.tp):
        dp = dp + (model_axis,)             # fold the unused model axis
        model_axis = None
    msize = int(mesh.shape[model_axis]) if model_axis else 1
    if technique.attn_mode != "auto":
        mode = technique.attn_mode
    else:
        mode = "head" if (cfg.n_heads == 0 or msize <= 1
                          or cfg.n_heads % msize == 0) else "seq"
    return ShardCtx(mesh, cfg, dp, model_axis, technique, attn_mode=mode)


def make_serving_ctx(cfg: ArchConfig, mesh) -> Optional[ShardCtx]:
    """Model-axis context of the serving engine: no data axis (the batch,
    scheduler, block tables and allocator are host-global, every rank
    makes the same decisions), attention in head mode (the paged pool
    split on its KV-head axis, each rank's (o, m, l) partials merged
    locally), collectives at the row-parallel seams (``wo``, the MLP
    down projection, mamba2's ``out_proj``), the logits and, on MoE
    archs, the expert-parallel exchange (``blocks._moe_ep``: the experts
    split over the ranks where the degree divides them, else
    ``_moe_local`` with the experts cut on their MLP width). Axes the
    degree does not divide stay whole on every rank."""
    if mesh is None:
        return None
    if "model" not in mesh.axis_names:
        raise ValueError(f"serving mesh needs a 'model' axis, got "
                         f"{mesh.axis_names}")
    if int(mesh.shape["model"]) > 1 and cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not sharded "
            f"(its cross-attention takes no model axis)")
    return ShardCtx(mesh, cfg=cfg)


# ==========================================================================
# Parameter / gradient / optimizer-state placement (the reference's
# resolver)
# ==========================================================================

# logical axis -> model-axis eligibility under TP
_TP_AXES = {"q_heads", "mlp", "experts", "ssm_inner", "ssm_heads"}
_TP_AXES_COND = {"kv_heads"}     # only if the head *count* divides the axis
_TP_PRIORITY = {"experts": 0, "q_heads": 1, "kv_heads": 1, "mlp": 2,
                "ssm_inner": 2, "vocab": 3}


def _tp_entry(ctx: ShardCtx, name: Optional[str], dim: int, path: str):
    if name is None or ctx.model_axis is None or not ctx.technique.tp:
        return None
    m, msz = ctx.model_axis, ctx.axis_size(ctx.model_axis)
    if dim % msz:
        return None
    if name in _TP_AXES:
        if name == "q_heads" and ctx.attn_mode == "seq":
            return None  # sequence mode: every rank holds every head
        if name == "ssm_heads":
            return None  # small vectors (A, D, dt_bias): replicate
        return m
    if name in _TP_AXES_COND:
        if ctx.attn_mode == "seq":
            return None
        return m if (ctx.cfg and ctx.cfg.n_kv_heads % msz == 0) else None
    if name == "vocab" and "head" in path:
        return m
    return None


def _zero_overlay(entries: List[Entry], shape: Tuple[int, ...],
                  logical, ctx: ShardCtx) -> List[Entry]:
    """Add the DP axes to the best unsharded dim (FSDP/ZeRO sharding):
    the largest dim the data axes (or a prefix of them) divide, a
    non-``layers`` dim before a ``layers`` one."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    order = [i for i in order if logical[i] != "layers"] + \
            [i for i in order if logical[i] == "layers"]
    for i in order:
        if entries[i] is not None:
            continue
        dp = ctx._dp(shape[i])
        if dp is not None:
            entries[i] = dp
            return entries
    return entries


def resolve_spec(ctx: ShardCtx, path: str, shape: Tuple[int, ...],
                 logical: Tuple[Optional[str], ...], *,
                 zero: bool = False) -> Spec:
    """The spec of the leaf at ``path``: the model axis on the dim whose
    logical axis is eligible and divisible with the lowest
    ``_TP_PRIORITY`` (the first on a tie), at most one; with ``zero``
    the data axes on another dim (:func:`_zero_overlay`)."""
    entries: List[Entry] = [None] * len(shape)
    candidates = []
    for i, (name, dim) in enumerate(zip(logical, shape)):
        if _tp_entry(ctx, name, dim, path) is not None:
            candidates.append((_TP_PRIORITY.get(name, 9), i))
    if candidates:  # the model axis may shard at most one dim
        _, best = min(candidates)
        entries[best] = ctx.model_axis
    if zero:
        entries = _zero_overlay(entries, shape, logical, ctx)
    return tuple(entries)


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a state leaf lives: its ``spec`` (one entry a dim) and
    whether ``+O`` puts it in pinned host memory."""
    spec: Spec
    host: bool


_STATE_PREFIXES = ("['m']", "['v']", "['master']", "['params']")
_SUFFIXES = (".a", ".b", ".base", ".data", ".scale2", ".scale", ".q")


def _normalize_path(path: str) -> Tuple[str, str]:
    """Split a state key string into (base param key string, special
    suffix), stripping one optimizer-tree prefix so m/v/master leaves
    inherit the weight's spec. The reference's tests, in its order: the
    first token found anywhere in the path wins (``.b`` before ``.base``,
    so a LoRA base reads as suffix ``b``); ``Opt8`` fields are flat
    indices, which match no token."""
    for prefix in _STATE_PREFIXES:
        if path.startswith(prefix):
            path = path[len(prefix):]
            break
    for tok in _SUFFIXES:
        if tok in path:
            base, _, _ = path.partition(tok)
            return base, tok[1:]
    return path, ""


def state_shardings(ctx: ShardCtx, state_tree,
                    logical_by_path: Dict[str, tuple], *, component: str):
    """A :class:`Placement` for every leaf of ``state_tree`` (params /
    grads / the optimizer state), in its structure (``None`` stays
    ``None``); ``logical_by_path`` maps the reference's key strings of
    the param leaves to their logical axes (:func:`logical_by_keystr_of`).

    component: ``"params"`` | ``"grads"`` | ``"opt"``. The ZeRO overlay
    applies to params at stage >= 3, grads at >= 2, opt at >= 1. Offload
    (``+O``) puts opt state (and ZeRO-3 params) in pinned host memory."""
    t = ctx.technique
    stage = t.zero_stage
    zero = {"params": stage >= 3, "grads": stage >= 2,
            "opt": stage >= 1}[component]
    host = bool(t.offload) and (
        component == "opt" or (component == "params" and stage >= 3))

    def resolve(pstr, leaf):
        base, suffix = _normalize_path(pstr)
        logical = logical_by_path.get(base)
        shape = tuple(leaf.shape)
        if suffix in ("a", "b") or logical is None:
            entries: List[Entry] = [None] * len(shape)
            if zero:
                entries = _zero_overlay(entries, shape, ("?",) * len(shape),
                                        ctx)
            spec = tuple(entries)
        elif suffix in ("scale", "scale2"):
            spec = (None,) * len(shape)
        elif suffix == "data" and len(shape) != len(logical):
            # nf4-packed flat storage: dp overlay only
            entries = [None] * len(shape)
            if zero:
                entries = _zero_overlay(entries, shape, ("?",) * len(shape),
                                        ctx)
            spec = tuple(entries)
        else:
            spec = resolve_spec(ctx, base, shape, logical, zero=zero)
        return Placement(spec, host)

    return keystr_map(resolve, state_tree)


def logical_by_keystr_of(spec_tree) -> Dict[str, tuple]:
    """``{key string: logical axes}`` of a ``ParamSpec`` tree, keyed as
    the reference's ``logical_by_path_of`` keys it (``['blocks']['pos0']
    ['mix']['wq']``)."""
    return {"".join(f"[{k!r}]" for k in path.split("/")): logical
            for path, logical in logical_by_path_of(spec_tree).items()}


def train_state_shardings(state, model, ctx: ShardCtx) -> Dict:
    """The placement tree of ``init_train_state``'s output: params, the
    optimizer state and the replicated step counter."""
    logical = logical_by_keystr_of(model.param_specs())
    return {
        "params": state_shardings(ctx, state["params"], logical,
                                  component="params"),
        "opt": state_shardings(ctx, state["opt"], logical, component="opt"),
        "step": Placement((), False),
    }


def logical_by_path_of(spec_tree) -> Dict[str, tuple]:
    """``{path: logical axes}`` of a ``ParamSpec`` tree (paths as
    ``models.params.tree_paths`` spells them: ``blocks/pos0/mix/wq``)."""
    return {path: ps.logical for path, ps in tree_paths(
        spec_tree, is_leaf=lambda x: isinstance(x, ParamSpec))}


def fused_segments(name: str, cfg: ArchConfig, n: int
                   ) -> List[Tuple[int, bool]]:
    """The components of a split axis of ``n`` entries of the leaf
    ``name``, each ``(length, cut)``: cut components are split over the
    ranks, the others kept whole on every rank. mamba2's ``in_proj``
    (z | x | B | C | dt) and conv (x | B | C); every other axis is one
    cut component."""
    di, gn, h = cfg.d_inner, cfg.ssm_ngroups * cfg.ssm_state, cfg.n_ssm_heads
    if name == "in_proj":
        return [(di, True), (di, True), (gn, False), (gn, False), (h, True)]
    if name in ("conv_w", "conv_b"):
        return [(di, True), (gn, False), (gn, False)]
    return [(n, True)]


def ssm_plan_errors(ctx: ShardCtx) -> List[str]:
    """SSM leaves of ``ctx.cfg`` whose resolved split disagrees with the
    head cut: a rank computes z, x, dt, the conv and the norm on whole
    heads, so each of them is split exactly when the SSD heads
    divide."""
    from repro_torch.models.lm import LM
    cfg = ctx.cfg
    heads = ctx._mdl(cfg.n_ssm_heads) is not None if cfg.n_ssm_heads else None
    bad = []
    for path, ps in tree_paths(LM(cfg, device="cpu").param_specs(),
                               is_leaf=lambda x: isinstance(x, ParamSpec)):
        if "ssm_inner" not in ps.logical:
            continue
        split = MODEL in resolve_spec(ctx, path, tuple(ps.shape), ps.logical)
        if split != heads:
            bad.append(path)
    return bad


def piece_cut(ctx: ShardCtx, path: str, shape, logical: tuple):
    """The ``parallel.zero.Cut`` the model axis makes of the leaf at
    ``path`` of ``shape`` (its logical axes ``logical``): along the dim
    :func:`resolve_spec` names, component by component
    (:func:`fused_segments`: a fused SSM leaf's B and C runs whole on
    every rank); ``zero.WHOLE`` where the model axis does not split it."""
    spec = resolve_spec(ctx, path, tuple(shape), logical)
    if ctx.size == 1 or MODEL not in spec:
        return Z.WHOLE
    return Z.model_cut(ctx, spec, fused_segments(
        path.rsplit("/", 1)[-1], ctx.cfg, shape[spec.index(MODEL)]))


def param_piece(ctx: ShardCtx, path: str, leaf: torch.Tensor,
                logical: tuple) -> torch.Tensor:
    """This rank's piece of the whole leaf ``leaf`` at ``path`` (its
    logical axes ``logical``), cut by :func:`piece_cut` and copied out;
    the leaf itself where the model axis does not split it. ``leaf`` may
    be one layer slice of a stacked leaf with its ``layers`` dim kept
    (size 1): no dim of that axis is ever split."""
    return Z.take(leaf, piece_cut(ctx, path, leaf.shape, logical))


def shard_params(params, ctx: ShardCtx):
    """This rank's slice of the full tree ``params`` (plain tensors, the
    tree of ``LM(ctx.cfg).param_specs()``): each leaf cut by
    :func:`param_piece`, copied out so the full tree can be freed. A
    leaf already at this rank's piece shape (a tree of pieces drawn by
    ``LM.init(seed, pieces=True)``) is kept as it is."""
    from repro_torch.models.lm import LM
    specs = dict(tree_paths(LM(ctx.cfg, device="cpu").param_specs(),
                            is_leaf=lambda x: isinstance(x, ParamSpec)))
    table = {p: ps.logical for p, ps in specs.items()}
    bad = ssm_plan_errors(ctx) if ctx.size > 1 else []
    if bad:
        raise NotImplementedError(
            f"{ctx.cfg.name} at tp={ctx.size}: the resolver's split of "
            f"{bad} disagrees with the cut of {ctx.cfg.n_ssm_heads} SSD "
            f"heads")

    def cut(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            raise NotImplementedError(
                f"{path}: model-parallel serving takes plain tensors, not "
                f"{type(leaf).__name__} (quantized or LoRA weights)")
        whole = tuple(specs[path].shape)
        if tuple(leaf.shape) == whole:
            return param_piece(ctx, path, leaf, table[path])
        piece = tuple(param_piece(ctx, path, torch.empty(
            whole, device="meta"), table[path]).shape)
        if tuple(leaf.shape) != piece:
            raise ValueError(f"{path}: {tuple(leaf.shape)} is neither the "
                             f"whole leaf {whole} nor rank {ctx.rank}'s "
                             f"piece {piece}")
        return leaf

    return tree_map_with_path(cut, params,
                              is_leaf=lambda t: not isinstance(t, dict))
