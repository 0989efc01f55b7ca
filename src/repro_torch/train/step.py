"""The training step (the port of ``repro.train.step``): model loss ->
backward -> AdamW, over one device.

The state is ``{"params", "opt", "step"}`` as in the reference. Its
params are the model's stacked leaves with ``requires_grad`` set; the
step computes their gradients with ``torch.autograd.grad`` (nothing
accumulates in ``.grad``) and updates params, optimizer state and the
step counter IN PLACE, the torch form of the reference's donated state.

On one device the reference's ZeRO stages, offload, tensor parallelism
and ``zero3_gather_once`` are no-ops (its placement helpers return the
tree unchanged without a mesh), and so they are here: ``F+R+Z3`` runs.

**Over a data axis** (a ``parallel.sharding.ShardCtx`` with ``dp_size >
1``: ``init_train_state(..., ctx=)``, ``build_train_step(..., ctx=)``)
each rank steps on its rows of the batch and the state lies where the
reference's resolver places it (``sharding.train_state_shardings``;
:class:`DPLayout`). Every rank draws the whole tree from the seed and
keeps its pieces (``parallel.zero.take``), so each piece is bit for bit
the one-device state's slice. The stages (``build_train_step``):

* Z0 — params and moments replicated; each rank's gradients are added
  in f32 into an f32 buffer, summed over the ranks (one all-reduce a
  leaf) and divided by ``dp x grad_accum``: the one-device
  accumulation's sum.
* Z1 — the moments (and f32 master weights) sharded; each rank updates
  the slice whose moments it holds, and the slices are gathered, bit for
  bit, into the replicated params.
* Z2 — as Z1, but each leaf's local gradient is reduce-scattered as soon
  as autograd returns (an f32 all-reduce of which the rank keeps its
  slice) and freed; the buffer holds only the rank's slices.
* Z3 — the params sharded too, gathered where the model uses them
  (``parallel.zero``); their gradients arrive reduced and sliced in the
  buffer, outside autograd. ``zero3_gather_once`` gathers the whole tree
  once a step instead of once a micro-batch.
* ``+O`` — the sharded moments (and under Z3 the params) live in pinned
  host memory, copied to the card for the step or the update and back.

**Over a model axis** (Megatron-style tensor parallelism, with
``Technique.sp`` sequence parallelism; alone or beside a data axis, a
2-D ``data x model`` mesh; every family but the encoder-decoder one)
each rank holds its TP piece of every leaf the resolver cuts on the
model axis (a fused SSM leaf's piece segment by segment, its B and C
runs whole: ``zero.Cut.segs``), and ZeRO cuts that piece over the data
axis (:class:`DPLayout`: the TP cut first, then the ZeRO overlay's). The
model runs the rank's heads, MLP columns, experts (expert parallelism)
and SSD heads (see ``models.lm``); the leaves each rank holds whole but
uses in part (``LM.model_summed``; of a fused leaf its whole runs) have
their gradients summed over the model axis once a step, after the data
axis's reduction; ``grad_norm`` sums the squares of cut leaves over
both axes and counts each replicated leaf (and whole run) once. In the
reference's sequence (context-parallel) attention mode
(``Technique.attn_mode="seq"``, or ``"auto"`` where the model axis does
not divide the heads) the attention leaves are whole on every model
rank, each rank attends with its rows of T, and where the axis splits
T those leaves are summed over it too (``LM.model_summed`` takes the
batch's T). Quantized full training, LoRA and the encoder-decoder
family raise under a model axis (ROADMAP queue 1 items 7.11, 7.10).
Under expert parallelism each (data, model) shard routes its own rows
at its own capacity and the load-balancing loss is the mean of the
shards' (the reference's ``pmean``), whose gradient
``LM.loss(aux_grad_scale=dp)`` brings to the global loss's.

One step serves the float techniques on one device and over the mesh's
axes (:func:`_float_step`; on one device it is the case ``dp = 1`` with
no stage). Over a data axis the gradient buffer persists from step to
step (its bytes are state at rest: full under Z0/Z1, this rank's slices
under Z2/Z3). Each micro-batch's CE is normalized by its global label
count (the count summed over the ranks; each rank divides its CE sum by
``1/dp`` of it, and the reduced gradient by ``dp x grad_accum``): the
reference's mean over the global micro-batch, the loss the mean of the
micro-batches' means as in the reference's accumulation. Where every
rank holds as many labels, each rank's loss is its micro-batch mean and
the step equals the one-device step with ``grad_accum = dp`` bit for
bit. ``grad_norm`` sums each rank's squares of the slices it holds, then
adds the partial sums over the ranks: only its order of sums differs.
Metrics are global and equal on every rank; ``ce`` and ``aux`` are the
last global micro-batch's, as in the reference. An MoE layer routes
with the global batch's statistics, order and capacity
(``models.blocks._moe_local`` over a data axis), so ``aux`` is global on
every rank; its gradient is this rank's part of the global loss's, and
``LM.loss(aux_grad_scale=dp)`` undoes the step's division by ``dp``
for it. MoE archs take one micro-batch a rank (:func:`check_dp`). ``Technique.grad_compress``
is inert, as in the reference's step (``parallel.compression`` is the
compressor).

LoRA fine-tuning (``peft`` "lora" or "qlora") follows the reference's
``init_train_state``: the base is quantized (``quant="int8"``), wrapped by
``apply_lora`` and split by ``split_trainable``; gradients, the optimizer
state and ``grad_norm`` cover the adapters only, and the frozen base,
norms and biases are never written. ``QL+Q8`` and ``L+Q8`` are the same
technique, as in the reference.

Quantized full training (``quant`` "int8" or "nf4" without peft, the
paper's "Q" rows) is the reference's dequant-train-requant cycle: the
params hold ``QTensor``s; each step trains a bf16 dequantized view of
them (:func:`dequant_tree`, the leaves autograd differentiates), updates
the view with AdamW and requantizes it into the params' fields
(:func:`requant_like`). The moments cover the view and default to 8-bit
(``AdamWConfig.state_bits=8``, :func:`default_opt_cfg`). Techniques whose
math the port does not have yet raise ``NotImplementedError`` naming
their ROADMAP item.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.config import ArchConfig, Technique
from repro_torch.core.perfscope import Timer
from repro_torch.models.lm import LM
from repro_torch.models.params import (ParamSpec, keystr_map, keystr_paths,
                                       set_path, tree_map, tree_paths)
from repro_torch.parallel import zero as Z
from repro_torch.parallel.sharding import (logical_by_keystr_of,
                                           make_shard_ctx, piece_cut,
                                           ssm_plan_errors, state_shardings)
from repro_torch.peft.lora import apply_lora, split_trainable
from repro_torch.quant.qtensor import (QTensor, quantize_int8,
                                       quantize_nf4, quantize_tree)
from repro_torch.train.optimizer import (AdamWConfig, adamw_apply,
                                         init_opt_state)

# the adapters' generator: seeded apart from the model's own draws, as the
# reference folds 7 into its key (``fold_in(rng, 7)``)
LORA_SEED_OFFSET = 7 << 32


def check_technique(technique: Technique) -> None:
    """Raise on a technique the port cannot run yet. ``sp`` and
    ``attn_mode`` act over a model axis and are no-ops without one, as
    in the reference."""
    waiting = []
    base = technique.quant
    if technique.peft == "qlora" and base == "none":
        base = "nf4"
    if technique.peft != "none" and base == "nf4":
        waiting.append(f"peft={technique.peft!r} on an nf4 base (the "
                       f"reference's apply_lora misreads a stacked nf4 "
                       f"QTensor, repro/peft/lora.py:74-75; ROADMAP queue 1 "
                       f"item 5, queue 3)")
    if technique.attn_mode not in ("auto", "head", "seq"):
        raise ValueError(f"attn_mode {technique.attn_mode!r}: one of auto, "
                         f"head, seq")
    if waiting:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(waiting))


def data_parallel(ctx) -> bool:
    """Whether ``ctx`` (a ``ShardCtx`` or None) trains over a data axis
    of more than one rank."""
    return ctx is not None and ctx.mesh is not None and ctx.dp_size > 1


def distributed(ctx) -> bool:
    """Whether ``ctx`` trains across ranks: over a data axis or a model
    axis of more than one rank."""
    return ctx is not None and ctx.mesh is not None and (
        ctx.dp_size > 1 or ctx.size > 1)


def check_dp(cfg: ArchConfig, technique: Technique, ctx) -> None:
    """Raise where ``ctx``'s mesh asks for what training across ranks
    cannot do yet, naming the ROADMAP item: under a model axis (the
    context's, after the folding of ``make_shard_ctx``) the
    encoder-decoder family, a dense FFN whose width the degree does not
    divide, SSM leaves the degree splits otherwise than the SSD heads,
    quantized full training and LoRA; under a data axis quantized full
    training, LoRA, and MoE archs with more than one micro-batch."""
    if ctx is None or ctx.mesh is None:
        return
    if ctx.size > 1:
        if cfg.n_enc_layers:
            raise NotImplementedError(
                f"{cfg.name} ({cfg.family}) over a model axis of "
                f"{ctx.size}: the encoder-decoder family's cross-attention "
                f"takes no model axis: ROADMAP queue 1 item 7.10")
        if "dense" in cfg.ffn_kinds() and cfg.d_ff % ctx.size:
            raise NotImplementedError(
                f"{cfg.name}: a dense FFN of width {cfg.d_ff} over a model "
                f"axis of {ctx.size}, which does not divide it (the "
                f"reference's GSPMD replicates it): ROADMAP queue 1 item "
                f"7.10")
        if "ssm" in cfg.layer_kinds() and ssm_plan_errors(ctx):
            raise NotImplementedError(
                f"{cfg.name}: the model axis of {ctx.size} splits the SSM "
                f"leaves {ssm_plan_errors(ctx)} otherwise than its "
                f"{cfg.n_ssm_heads} SSD heads: ROADMAP queue 1 item 7.10")
        if ctx.attn_mode == "head" and cfg.n_heads % ctx.size:
            raise NotImplementedError(
                f"{cfg.name}: attn_mode='head' over a model axis of "
                f"{ctx.size}, which does not divide its {cfg.n_heads} "
                f"heads (the reference's GSPMD replicates them): take "
                f"attn_mode 'seq' or 'auto'; head mode there is ROADMAP "
                f"queue 1 item 7.13")
        if technique.quant != "none" or technique.peft != "none":
            raise NotImplementedError(
                f"{technique.label()} over a model axis: quantized full "
                f"training and LoRA under tensor parallelism are not "
                f"ported: ROADMAP queue 1 item 7.11")
    if not data_parallel(ctx):
        return
    if technique.quant != "none" or technique.peft != "none":
        raise NotImplementedError(
            f"{technique.label()} over a data axis: quantized full "
            f"training and LoRA are not ported there (8-bit moments' "
            f"blocks run over a moment's global flattening, which a "
            f"rank's slice does not hold): ROADMAP queue 1 item 7.8")
    if cfg.is_moe and technique.grad_accum > 1:
        raise NotImplementedError(
            f"{cfg.name} over a data axis with grad_accum="
            f"{technique.grad_accum}: the reference's micro-batch i is the "
            f"global rows [i·B/accum, (i+1)·B/accum), which decide the "
            f"tokens that compete for an expert's capacity, and a rank's "
            f"micro-batches are cut from its own rows: ROADMAP queue 1 "
            f"item 7.9")


class DPLayout:
    """Where each param leaf's state lies on this rank across ranks: its
    TP piece (``tp``: the :class:`parallel.zero.Cut` the model axis makes,
    ``shapes``: the piece's shape, the whole leaf's without a model axis)
    and, of that piece, the ZeRO cut of the param, of its gradient and of
    its optimizer state (moments and master weights), keyed by the leaf's
    key string, from the reference's resolver; whether ``+O`` puts the
    params and the optimizer state in host memory; and :meth:`summed`,
    the leaves whose gradients the step sums over the model axis
    (``LM.model_summed``)."""

    def __init__(self, model: LM, technique: Technique, ctx):
        logical = logical_by_keystr_of(model.param_specs())
        tree: Dict = {}
        for path, ps in tree_paths(model.param_specs(),
                                   is_leaf=lambda x: isinstance(x, ParamSpec)):
            set_path(tree, path, torch.empty(ps.shape, dtype=ps.dtype,
                                             device="meta"))
        place = {c: dict(keystr_paths(state_shardings(
            ctx, tree, logical, component=c)))
            for c in ("params", "grads", "opt")}
        self.tp = {_keystr(path): piece_cut(ctx, path, ps.shape, ps.logical)
                   for path, ps in tree_paths(
                       model.param_specs(),
                       is_leaf=lambda x: isinstance(x, ParamSpec))}
        self.shapes = {p: Z.piece_shape(t.shape, self.tp[p])
                       for p, t in keystr_paths(tree)}
        self.model = model
        self.param = {p: Z.dp_cut(ctx, pl.spec)
                      for p, pl in place["params"].items()}
        self.grad = {p: Z.dp_cut(ctx, pl.spec)
                     for p, pl in place["grads"].items()}
        self.opt = {p: Z.dp_cut(ctx, pl.spec)
                    for p, pl in place["opt"].items()}
        self.params_host = any(pl.host for pl in place["params"].values())
        self.opt_host = any(pl.host for pl in place["opt"].values())
        if technique.zero_stage >= 2:
            assert self.grad == self.opt, "grads and moments cut alike"

    def summed(self, t: int):
        """Key strings of the leaves whose gradients the step sums over
        the model axis on sequences of ``t`` positions (of a fused SSM
        leaf, the runs its TP cut keeps whole: ``Cut.whole_runs``)."""
        return [_keystr(path) for path in self.model.model_summed(t)]

    def state_cut(self, path: str, tp: bool = False) -> Z.Cut:
        """The ZeRO cut of a leaf of the whole train state by its key
        string (``['params']...``, ``['opt']['m']...``, ``['step']``), or
        with ``tp`` its TP cut."""
        for prefix, table in (("['params']", self.param),
                              ("['opt']['m']", self.opt),
                              ("['opt']['v']", self.opt),
                              ("['opt']['master']", self.opt)):
            if path.startswith(prefix):
                return (self.tp if tp else table)[path[len(prefix):]]
        return Z.WHOLE

    def piece(self, path: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece (a tensor of its own) of the whole state
        leaf ``whole`` at ``path``: its TP piece's ZeRO piece."""
        t = Z.piece_view(whole, self.state_cut(path, tp=True))
        cut = self.state_cut(path)
        return t.clone() if cut.dim is None else Z.take(t, cut)


def _keystr(path: str) -> str:
    """The key string of the leaf at ``path`` (``blocks/pos0/mix/wq`` ->
    ``['blocks']['pos0']['mix']['wq']``)."""
    return "".join(f"[{k!r}]" for k in path.split("/"))


def logical_train_state(state, lay: DPLayout, ctx, device):
    """The whole (logical) train state from every rank's part, as host
    tensors: each sharded leaf gathered exactly (collectives every rank
    makes: the data axis's, then the model axis's), every other leaf
    copied; what a one-device run holding those values would hold. A
    checkpoint stores this (the reference's elastic layout)."""
    def whole(path, t):
        t = t.detach()
        cut = lay.state_cut(path)
        if cut.dim is not None:
            t = Z.gather_leaf(ctx, t.to(device), Z.whole_shape(t.shape, cut),
                              cut)
        tc = lay.state_cut(path, tp=True)
        if tc.dim is not None:
            t = Z.gather_leaf(ctx, t.to(device), Z.whole_shape(t.shape, tc),
                              tc, sum_bytes=ctx.gather_bytes)
        return t.cpu().clone()

    return keystr_map(whole, state)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """``t`` in host memory: pinned on a card, as it is on the CPU."""
    if t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _to_device(tree, device):
    """Device copies of a host tree's leaves (``+O``: the step's working
    copies; on the CPU a copy all the same)."""
    return tree_map(lambda t: t.to(device, copy=True, non_blocking=True),
                    tree)


@torch.no_grad()
def _copy_back(host_tree, dev_tree) -> None:
    """Write the device copies back into their host leaves."""
    for (_, h), (_, d) in zip(tree_paths(host_tree), tree_paths(dev_tree)):
        h.copy_(d)


def quant_full(technique: Technique) -> bool:
    """Whether ``technique`` trains every weight of a quantized base."""
    return technique.quant != "none" and technique.peft == "none"


def default_opt_cfg(technique: Technique) -> AdamWConfig:
    """The reference's default: 8-bit moments under quantized full
    training, 32-bit otherwise."""
    return AdamWConfig(state_bits=8 if quant_full(technique) else 32)


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def dequant_tree(tree):
    """``tree`` with every ``QTensor`` leaf dequantized to bf16 (a fresh
    tensor) and every other leaf kept."""
    return tree_map(lambda l: l.dequantize(torch.bfloat16) if _is_q(l)
                    else l, tree, is_leaf=_is_q)


@torch.no_grad()
def requant_like(view, like) -> None:
    """Quantize each leaf of ``view`` at a ``QTensor`` of ``like`` as that
    leaf was quantized (``quantize_int8``, or ``quantize_nf4`` stacked
    when its codes are), written IN PLACE into the QTensor's fields."""
    new = dict(tree_paths(view))
    for path, old in tree_paths(like, is_leaf=_is_q):
        if not _is_q(old):
            continue
        q = (quantize_int8(new[path]) if old.kind == "int8" else
             quantize_nf4(new[path], stacked=old.data.ndim == 2))
        old.data.copy_(q.data)
        old.scale.copy_(q.scale)
        if old.scale2 is not None:
            for dst, src in zip(old.scale2, q.scale2):
                dst.copy_(src)


def init_train_state(model: LM, technique: Technique, seed: int = 0,
                     opt_cfg: Optional[AdamWConfig] = None, *, ctx=None
                     ) -> Tuple[Dict[str, Any], AdamWConfig]:
    """Seeded params on the model's device, quantized and LoRA-wrapped as
    the technique says, with ``requires_grad`` set on the trainable leaves
    (all of them without LoRA, the adapters with it; under quantized full
    training the float leaves, the ``QTensor``s being retrained through
    their dequantized view) and optimizer state for those (for the view
    under quantized full training). Returns ``(state, opt_cfg)`` as the
    reference does. Across ranks (``ctx``, default the model's) the
    state is this rank's part of that state (:func:`_init_dp_state`)."""
    check_technique(technique)
    ctx = model.ctx if ctx is None else ctx
    check_dp(model.cfg, technique, ctx)
    opt_cfg = opt_cfg or default_opt_cfg(technique)
    if distributed(ctx):
        return _init_dp_state(model, technique, seed, opt_cfg, ctx), opt_cfg
    params = model.init(seed)
    if technique.quant != "none":
        params = quantize_tree(params, technique.quant)
    if technique.peft != "none":
        gen = torch.Generator(device=model.device).manual_seed(
            seed + LORA_SEED_OFFSET)
        params = apply_lora(params, gen, rank=technique.lora_rank)
    trainable, _ = split_trainable(params)
    tree_map(lambda t: None if _is_q(t) else t.requires_grad_(True),
             trainable, is_leaf=_is_q)
    basis = dequant_tree(trainable) if quant_full(technique) else trainable
    return {"params": params, "opt": init_opt_state(opt_cfg, basis),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.device)}, opt_cfg


def _init_dp_state(model: LM, technique: Technique, seed: int,
                   opt_cfg: AdamWConfig, ctx) -> Dict[str, Any]:
    """This rank's part of the one-device state: the params drawn from
    ``seed`` on the rank's device (over a model axis its TP pieces,
    ``LM.init(pieces=True)``), cut to the rank's ZeRO pieces (Z3; whole
    under Z0-Z2, with ``requires_grad``), zero moments at the optimizer
    state's pieces, f32 master weights from the params' pieces where
    ``opt_cfg`` keeps them; ``+O`` moves what it places on the host
    there."""
    lay = DPLayout(model, technique, ctx)
    full = model.init(seed, pieces=True)
    stage3 = technique.zero_stage >= 3
    dev = model.device

    def zeros(p, t):
        return torch.zeros(Z.piece_shape(t.shape, lay.opt[p]),
                           dtype=torch.float32, device=dev)

    opt = {"m": keystr_map(zeros, full), "v": keystr_map(zeros, full),
           "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if opt_cfg.master_fp32:
        opt["master"] = keystr_map(
            lambda p, t: Z.piece_view(t, lay.opt[p]).detach().to(
                torch.float32).clone(), full)
    params = full
    if stage3:
        params = keystr_map(lambda p, t: Z.take(t, lay.param[p]), full)
    del full
    return _placed({"params": params, "opt": opt,
                    "step": torch.zeros((), dtype=torch.int32, device=dev)},
                   lay, stage3)


def _placed(state, lay: DPLayout, stage3: bool):
    """``state`` with ``requires_grad`` on whole params (Z0-Z2) and what
    ``+O`` places on the host moved there."""
    if not stage3:
        tree_map(lambda t: t.requires_grad_(True), state["params"])
    if lay.params_host:
        state["params"] = tree_map(_to_host, state["params"])
    if lay.opt_host:
        state["opt"] = tree_map(_to_host, state["opt"])
    return state


def shard_train_state(whole, model: LM, technique: Technique, ctx):
    """This rank's part of a whole (logical) train state ``whole`` (a
    one-device state: bridged from the reference, or restored), placed as
    :func:`init_train_state` places its own. Every leaf is a copy: the
    step updates its state in place."""
    lay = DPLayout(model, technique, ctx)
    part = keystr_map(lambda p, t: lay.piece(p, t.detach().to(
        model.device)), whole)
    return _placed(part, lay, technique.zero_stage >= 3)


def build_train_step(model: LM, technique: Technique,
                     opt_cfg: AdamWConfig, *,
                     timer: Optional[Timer] = None, ctx=None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: ``batch`` holds
    ``tokens`` and ``labels`` (B, T) on the model's device; ``state`` is
    updated in place and returned. Metrics (0-dim f32 tensors, nothing
    is read to the host): ``loss``, ``ce``, ``aux`` and ``grad_norm``,
    the f32 norm over all gradient leaves (the trainable ones:
    ``split_trainable``; under quantized full training the dequantized
    view's, which is requantized after the update). With ``grad_accum >
    1`` the batch is split into that many micro-batches along its first
    axis; their gradients are summed in f32 and averaged, the loss is
    their mean and ``ce``/``aux`` are the last micro-batch's.

    With a ``timer``, the step's layers are timed into its regions
    ``forward`` (the loss), ``backward`` (the gradients, recomputation
    included) and ``optimizer`` (the AdamW update), one record per
    micro-batch for the first two; each region ends with a device sync
    on a CUDA device, so it is charged with its device work. Without
    one nothing is synced.

    Float techniques take :func:`_float_step`, on one device as over a
    data axis, a model axis or both (``ctx``, default the model's; see
    the module's notes: ``batch`` is then this rank's rows of the data
    axis, whole on every rank of a model row, ``state`` this rank's part,
    from :func:`init_train_state` with the same ``ctx``, and each rank
    runs ``grad_accum`` micro-batches of its rows). Quantized full
    training and LoRA, which both axes refuse, take
    :func:`_adapted_step`."""
    check_technique(technique)
    ctx = model.ctx if ctx is None else ctx
    check_dp(model.cfg, technique, ctx)

    def fence():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    def region(name):
        if timer is None:
            return contextlib.nullcontext()
        return timer.region(name, fence=fence)

    if technique.quant == "none" and technique.peft == "none":
        return _float_step(model, technique, opt_cfg, ctx, region)
    return _adapted_step(model, technique, opt_cfg, region)


def _adapted_step(model: LM, technique: Technique, opt_cfg: AdamWConfig,
                  region) -> Callable:
    """The one-device step of quantized full training and LoRA: the
    gradients of the trainable leaves (the adapters, or the bf16
    dequantized view, requantized after the update)."""
    accum = max(technique.grad_accum, 1)
    qfull = quant_full(technique)

    def _grads(leaves, params, batch):
        with region("forward"):
            loss, metrics = model.loss(params, batch)
        with region("backward"):
            grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)

    def train_step(state, batch):
        params = state["params"]
        trainable, _ = split_trainable(params)
        if qfull:
            # grads w.r.t. the bf16 dequantized view; requantized after
            qt = trainable
            with torch.no_grad():
                trainable = dequant_tree(qt)
            tree_map(lambda t: t.requires_grad_(True), trainable)
            params = trainable
        paths = tree_paths(trainable)
        leaves = [t for _, t in paths]
        if accum > 1:
            mb = _micro_rows(batch, accum)
            gsum = [torch.zeros(t.shape, dtype=torch.float32,
                                device=t.device) for t in leaves]
            lsum = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for i in range(accum):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss_i, metrics, g = _grads(leaves, params, part)
                for acc, gi in zip(gsum, g):
                    acc.add_(gi.to(torch.float32))
                lsum = lsum + loss_i
            grads = [acc / accum for acc in gsum]
            loss = lsum / accum
        else:
            loss, metrics, grads = _grads(leaves, params, batch)
        grad_tree: Dict = {}
        for (path, _), g in zip(paths, grads):
            set_path(grad_tree, path, g)
        with region("optimizer"):
            adamw_apply(opt_cfg, grad_tree, state["opt"], trainable)
            if qfull:
                requant_like(trainable, qt)
        state["step"].add_(1)
        metrics = dict(metrics)
        metrics["loss"] = loss
        norm_sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g in grads:
            norm_sq = norm_sq + torch.sum(torch.square(g.to(torch.float32)))
        metrics["grad_norm"] = torch.sqrt(norm_sq)
        return state, metrics

    return train_step


def _micro_rows(batch, accum: int) -> int:
    """The rows of each of ``accum`` micro-batches of ``batch``."""
    rows = batch["tokens"].shape[0]
    if rows % accum:
        raise ValueError(f"{rows} rows do not split into {accum} "
                         f"micro-batches")
    return rows // accum


def _float_step(model: LM, technique: Technique, opt_cfg: AdamWConfig, ctx,
                region) -> Callable:
    """The step of a float technique, on one device or as one rank of a
    mesh (the module's notes). On one device the stages and offload
    are no-ops, and the f32 gradient buffer is made from the first
    micro-batch's gradients and dropped after the update; across ranks
    it persists (its bytes are state at rest)."""
    persist = distributed(ctx)
    if not persist:
        technique = dataclasses.replace(technique, zero_stage=0,
                                        offload=False)
        ctx = make_shard_ctx(model.cfg, technique, None)
    lay = DPLayout(model, technique, ctx)
    stage = technique.zero_stage
    accum = max(technique.grad_accum, 1)
    dp = ctx.dp_size
    k = dp * accum                             # micro-batches in all
    dev = model.device
    once = stage >= 3 and technique.zero3_gather_once
    acc: Dict[str, torch.Tensor] = {}
    f32 = torch.float32

    def shards(params, comm):
        return keystr_map(lambda p, t: Z.Shard.of(
            t, lay.shapes[p], lay.param[p], acc[p], comm), params)

    def train_step(state, batch):
        params = state["params"]
        if persist and not acc:
            for p, t in keystr_paths(params):
                acc[p] = torch.zeros(Z.piece_shape(lay.shapes[p],
                                                   lay.grad[p]),
                                     dtype=f32, device=dev)
        for a in acc.values():
            a.zero_()
        work = (_to_device(params, dev) if stage >= 3 and lay.params_host
                else params)
        mb = _micro_rows(batch, accum)
        # each micro-batch's label count over the ranks: its CE is the
        # global micro-batch's mean, each rank dividing its sum by 1/dp
        # of that count
        n_mb = ctx.dp_all_reduce(torch.stack([
            (batch["labels"][i * mb:(i + 1) * mb] >= 0).sum()
            for i in range(accum)]).to(f32))
        denom = torch.clamp_min(n_mb, 1.0) / dp
        sums = torch.zeros(2, dtype=f32, device=dev)   # loss, ce
        if once:                       # the whole tree, once for the step
            anchor = torch.zeros((), dtype=f32, device=dev,
                                 requires_grad=True)
            gathered = Z.gather_used(shards(work, Z.ZeroComm(ctx, dev,
                                                             anchor)))
        for i in range(accum):
            part = {kk: v[i * mb:(i + 1) * mb] for kk, v in batch.items()}
            if stage >= 3:
                if once:
                    view = gathered
                else:
                    anchor = torch.zeros((), dtype=f32, device=dev,
                                         requires_grad=True)
                    view = shards(work, Z.ZeroComm(ctx, dev, anchor))
                with region("forward"):
                    loss, metrics = model.loss(view, part, n_tok=denom[i],
                                               aux_grad_scale=dp)
                with region("backward"):
                    torch.autograd.grad(loss, [anchor])
            else:
                paths = keystr_paths(params)
                with region("forward"):
                    loss, metrics = model.loss(params, part, n_tok=denom[i],
                                               aux_grad_scale=dp)
                with region("backward"):
                    grads = list(torch.autograd.grad(
                        loss, [t for _, t in paths]))
                    for j, (p, _) in enumerate(paths):
                        g, grads[j] = grads[j].to(f32), None
                        if stage >= 2:
                            c = lay.grad[p]
                            g = ctx.dp_reduce_scatter(g, c.dim, c.parts,
                                                      c.idx)
                        if p in acc:
                            acc[p].add_(g)
                        else:
                            acc[p] = g
                        del g
            # the graph goes with its last reference, before the next
            # micro-batch's forward
            loss, metrics = loss.detach(), {kk: v.detach()
                                            for kk, v in metrics.items()}
            sums[0] += loss
        sums[1] = metrics["ce"]                   # the last micro-batch's
        view = gathered = None          # the gathered tree goes before
        if stage <= 1:                  # the update
            for a in acc.values():
                ctx.dp_all_reduce(a)
        # used in part on each model rank
        for p in lay.summed(batch["tokens"].shape[1]):
            _model_sum(ctx, acc[p], lay.tp[p])
        for a in acc.values():
            a.div_(k)
        norm_sq = torch.zeros((), dtype=f32, device=dev)
        for p, a in acc.items():        # each piece counted once
            if (stage <= 1 or lay.grad[p].writes) and (
                    ctx.size == 1 or lay.tp[p].dim is not None or
                    ctx.rank == 0):
                norm_sq = norm_sq + _sum_sq(a, lay.tp[p], ctx.rank)
        if stage >= 2:
            ctx.dp_all_reduce(norm_sq.reshape(1))
        if ctx.size > 1:
            ctx.all_reduce(norm_sq.reshape(1), "collective")
        with region("optimizer"):
            opt = state["opt"]
            dev_opt = _to_device(opt, dev) if lay.opt_host else opt
            if stage >= 2:
                grads = keystr_map(lambda p, _: acc[p], work)
            else:
                grads = keystr_map(
                    lambda p, _: Z.piece_view(acc[p], lay.opt[p]), work)
            pieces = work if stage >= 3 else keystr_map(
                lambda p, t: Z.piece_view(t, lay.opt[p]), params)
            adamw_apply(opt_cfg, grads, dev_opt, pieces)
            with torch.no_grad():
                if stage in (1, 2):
                    for p, t in keystr_paths(params):
                        c = lay.opt[p]
                        if c.dim is not None:
                            t.copy_(Z.gather_leaf(
                                ctx, Z.piece_view(t, c), t.shape, c))
            if lay.opt_host:
                _copy_back(opt, dev_opt)
            if work is not params:
                _copy_back(params, work)
        if not persist:
            acc.clear()
        state["step"].add_(1)
        sums = ctx.dp_all_reduce(sums) / torch.tensor(
            [k, dp], dtype=f32, device=dev)
        # aux is the global micro-batch's on every rank already
        return state, {"loss": sums[0], "ce": sums[1], "aux": metrics["aux"],
                       "grad_norm": torch.sqrt(norm_sq)}

    train_step.grad_buffer = acc       # over a data axis, state at rest
    return train_step


def _model_sum(ctx, g: torch.Tensor, cut: Z.Cut) -> None:
    """Sum the gradient piece ``g`` over the model axis in place: all of
    it, or of a fused SSM leaf the runs its TP ``cut`` keeps whole on
    every rank."""
    if not cut.segs:
        ctx.all_reduce(g, "collective")
        return
    for at, n in cut.whole_runs():
        run = g.narrow(cut.dim, at, n)
        run.copy_(ctx.all_reduce(run.contiguous(), "collective"))


def _sum_sq(g: torch.Tensor, cut: Z.Cut, rank: int) -> torch.Tensor:
    """The squares of ``g`` this model rank counts in ``grad_norm``: of
    a fused SSM leaf's piece the runs every rank holds whole on the first
    rank alone."""
    if not cut.segs or rank == 0:
        return torch.sum(torch.square(g))
    return sum(torch.sum(torch.square(g.narrow(cut.dim, at, hi - lo)))
               for lo, hi, at, is_cut in cut.ranges(
                   sum(n for n, _ in cut.segs)) if is_cut)
