"""Model-axis sharding of the serving engine: the serving half of
``repro.parallel.sharding``.

The reference states placement as PartitionSpecs over a jax ``Mesh`` and
lets GSPMD partition each jitted step. The port runs one process per
rank of a ``torch.distributed`` group (``launch.mesh``) and each rank
computes with what it holds, so placement and computation are stated
here explicitly:

* :class:`ShardCtx` — the model axis over a process group: its size and
  this rank's index, the part of an axis this rank holds (``part``; the
  KV heads its attention reads, ``kv_part``: the one statement of where
  a rank's pools and activations are cut) and the collectives of the
  row-parallel seams (``all_reduce`` of f32 partials, ``gather_last`` of
  the vocab-sharded logits).
* :func:`resolve_spec` — the training-side resolver the serving engine
  places parameters with (``_tp_entry``, ``_TP_PRIORITY``): which dim of
  a leaf the model axis splits (one entry per dim, ``None`` or
  ``"model"``, as a PartitionSpec's), at most one; an axis the degree
  does not divide stays whole (replication, never an error). Attention
  is in head mode, as the reference's ``make_serving_ctx`` pins it.
* :func:`shard_params` — this rank's slice of a full parameter tree.

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
divide (or the other way round), :func:`shard_params` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.config import ArchConfig
from repro_torch.models.params import ParamSpec, tree_map_with_path, \
    tree_paths

Spec = Tuple[Optional[str], ...]


MODEL = "model"     # the mesh axis the serving engine shards over


@dataclasses.dataclass
class ShardCtx:
    """The model axis of ``mesh`` (a ``launch.mesh.Mesh``: ``shape``,
    ``axis_names``, this rank's ``rank`` on the model axis, its process
    ``group`` and the ``comm_device`` host values travel on). Attention
    is in head mode (the reference's sequence-parallel ``attn_mode`` is
    not ported: ROADMAP queue 1 item 7)."""
    mesh: object
    cfg: Optional[ArchConfig] = None

    @property
    def size(self) -> int:
        return int(self.mesh.shape[MODEL]) if self.mesh is not None else 1

    @property
    def rank(self) -> int:
        return int(self.mesh.rank) if self.mesh is not None else 0

    def _mdl(self, dim: int) -> Optional[str]:
        """The model axis where it divides ``dim``, else ``None``."""
        return None if dim % self.size else MODEL

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

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the model axis, in place (a row-parallel
        seam's f32 partials); returns it. A no-op on one rank."""
        if self.size > 1:
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


def make_serving_ctx(cfg: ArchConfig, mesh) -> Optional[ShardCtx]:
    """Model-axis context of the serving engine: no data axis (the batch,
    scheduler, block tables and allocator are host-global, every rank
    makes the same decisions), attention in head mode (the paged pool
    split on its KV-head axis, each rank's (o, m, l) partials merged
    locally), collectives only at the row-parallel seams (``wo``, the MLP
    down projection, mamba2's ``out_proj``) and the logits. Axes the
    degree does not divide stay whole on every rank."""
    if mesh is None:
        return None
    if "model" not in mesh.axis_names:
        raise ValueError(f"serving mesh needs a 'model' axis, got "
                         f"{mesh.axis_names}")
    if int(mesh.shape["model"]) > 1 and cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers under tensor parallelism need expert "
            f"parallelism, the reference's _moe_ep, whose all-to-all "
            f"dispatch is not ported (ROADMAP queue 1 item 7; gloo has no "
            f"all-to-all)")
    if int(mesh.shape["model"]) > 1 and cfg.n_enc_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not sharded "
            f"(its cross-attention takes no model axis)")
    return ShardCtx(mesh, cfg=cfg)


# ==========================================================================
# Parameter sharding resolution (the reference's, without the ZeRO
# overlay: the serving engine has no data axis)
# ==========================================================================

# logical axis -> model-axis eligibility under TP
_TP_AXES = {"q_heads", "mlp", "experts", "ssm_inner", "ssm_heads"}
_TP_AXES_COND = {"kv_heads"}     # only if the head *count* divides the axis
_TP_PRIORITY = {"experts": 0, "q_heads": 1, "kv_heads": 1, "mlp": 2,
                "ssm_inner": 2, "vocab": 3}


def _tp_entry(ctx: ShardCtx, name: Optional[str], dim: int, path: str):
    if name is None or dim % ctx.size:
        return None
    if name in _TP_AXES:
        if name == "ssm_heads":
            return None  # small vectors (A, D, dt_bias): replicate
        return MODEL
    if name in _TP_AXES_COND:
        return MODEL if (ctx.cfg and ctx.cfg.n_kv_heads % ctx.size == 0) \
            else None
    if name == "vocab" and "head" in path:
        return MODEL
    return None


def resolve_spec(ctx: ShardCtx, path: str, shape: Tuple[int, ...],
                 logical: Tuple[Optional[str], ...]) -> Spec:
    """Which dim of the leaf at ``path`` the model axis splits: of the
    dims whose logical axis is eligible and divisible, the one of lowest
    ``_TP_PRIORITY`` (the first on a tie)."""
    entries: List[Optional[str]] = [None] * len(shape)
    candidates = []
    for i, (name, dim) in enumerate(zip(logical, shape)):
        if _tp_entry(ctx, name, dim, path) is not None:
            candidates.append((_TP_PRIORITY.get(name, 9), i))
    if candidates:  # the model axis may shard at most one dim
        _, best = min(candidates)
        entries[best] = MODEL
    return tuple(entries)


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


def _ssm_plan_errors(ctx: ShardCtx, table: Dict[str, tuple],
                     params) -> List[str]:
    """SSM leaves whose resolved split disagrees with the head cut: a
    rank computes z, x, dt, the conv and the norm on whole heads, so
    each of them is split exactly when the SSD heads divide."""
    cfg = ctx.cfg
    heads = ctx._mdl(cfg.n_ssm_heads) is not None if cfg.n_ssm_heads else None
    bad = []
    for path, leaf in tree_paths(params):
        logical = table.get(path, ())
        if "ssm_inner" not in logical:
            continue
        split = MODEL in resolve_spec(ctx, path, tuple(leaf.shape),
                                               logical)
        if split != heads:
            bad.append(path)
    return bad


def shard_params(params, ctx: ShardCtx):
    """This rank's slice of the full tree ``params`` (plain tensors, the
    tree of ``LM(ctx.cfg).param_specs()``): each leaf cut along the dim
    :func:`resolve_spec` names, component by component
    (:func:`fused_segments`), copied out so the full tree can be freed;
    a leaf the model axis does not split is this rank's as it is."""
    from repro_torch.models.lm import LM
    cfg = ctx.cfg
    table = logical_by_path_of(LM(cfg, device="cpu").param_specs())
    bad = _ssm_plan_errors(ctx, table, params)
    if bad and ctx.size > 1:
        raise NotImplementedError(
            f"{cfg.name} at tp={ctx.size}: the resolver's split of {bad} "
            f"disagrees with the cut of {cfg.n_ssm_heads} SSD heads")

    def cut(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            raise NotImplementedError(
                f"{path}: model-parallel serving takes plain tensors, not "
                f"{type(leaf).__name__} (quantized or LoRA weights)")
        spec = resolve_spec(ctx, path, tuple(leaf.shape), table[path])
        if ctx.size == 1 or MODEL not in spec:
            return leaf
        dim = spec.index(MODEL)
        pieces, start = [], 0
        for n, is_cut in fused_segments(path.rsplit("/", 1)[-1], cfg,
                                        leaf.shape[dim]):
            seg = leaf.narrow(dim, start, n)
            start += n
            if is_cut:
                lo, hi = ctx.part(n)
                seg = seg.narrow(dim, lo, hi - lo)
            pieces.append(seg)
        return torch.cat(pieces, dim)

    return tree_map_with_path(cut, params,
                              is_leaf=lambda t: not isinstance(t, dict))
