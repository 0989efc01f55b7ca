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

LoRA fine-tuning (``peft`` "lora" or "qlora") follows the reference's
``init_train_state``: the base is quantized (``quant="int8"``), wrapped by
``apply_lora`` and split by ``split_trainable``; gradients, the optimizer
state and ``grad_norm`` cover the adapters only, and the frozen base,
norms and biases are never written. ``QL+Q8`` and ``L+Q8`` are the same
technique, as in the reference. Techniques whose math the port does not
have yet raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.config import Technique
from repro_torch.core.perfscope import Timer
from repro_torch.models.lm import LM
from repro_torch.models.params import set_path, tree_map, tree_paths
from repro_torch.peft.lora import apply_lora, split_trainable
from repro_torch.quant.qtensor import quantize_tree
from repro_torch.train.optimizer import (AdamWConfig, adamw_apply,
                                         init_opt_state)

# the adapters' generator: seeded apart from the model's own draws, as the
# reference folds 7 into its key (``fold_in(rng, 7)``)
LORA_SEED_OFFSET = 7 << 32


def check_technique(technique: Technique) -> None:
    """Raise on a technique the port cannot run yet."""
    waiting = []
    base = technique.quant
    if technique.peft == "qlora" and base == "none":
        base = "nf4"
    if technique.peft != "none" and base == "nf4":
        waiting.append(f"peft={technique.peft!r} on an nf4 base (the "
                       f"reference's apply_lora misreads a stacked nf4 "
                       f"QTensor, repro/peft/lora.py:74-75; ROADMAP queue 1 "
                       f"item 5, queue 3)")
    if technique.peft == "none" and technique.quant != "none":
        waiting.append(f"quant={technique.quant!r} without peft (the "
                       f"dequant-train-requant cycle with 8-bit Opt8 "
                       f"moments, ROADMAP queue 1 item 5)")
    if technique.grad_compress:
        waiting.append("grad_compress (parallel/compression.py, ROADMAP "
                       "queue 1 item 7)")
    if technique.sp:
        waiting.append("sp (sequence parallelism needs a mesh, ROADMAP "
                       "queue 1 item 7)")
    if technique.attn_mode != "auto":
        waiting.append(f"attn_mode={technique.attn_mode!r} (needs a mesh, "
                       f"ROADMAP queue 1 item 7)")
    if waiting:
        raise NotImplementedError(
            "not ported yet: " + "; ".join(waiting))


def init_train_state(model: LM, technique: Technique, seed: int = 0,
                     opt_cfg: Optional[AdamWConfig] = None
                     ) -> Tuple[Dict[str, Any], AdamWConfig]:
    """Seeded params on the model's device, quantized and LoRA-wrapped as
    the technique says, with ``requires_grad`` set on the trainable leaves
    (all of them without LoRA, the adapters with it) and optimizer state
    for those. Returns ``(state, opt_cfg)`` as the reference does."""
    check_technique(technique)
    opt_cfg = opt_cfg or AdamWConfig()
    params = model.init(seed)
    if technique.quant != "none":
        params = quantize_tree(params, technique.quant)
    if technique.peft != "none":
        gen = torch.Generator(device=model.device).manual_seed(
            seed + LORA_SEED_OFFSET)
        params = apply_lora(params, gen, rank=technique.lora_rank)
    trainable, _ = split_trainable(params)
    tree_map(lambda t: t.requires_grad_(True), trainable)
    return {"params": params, "opt": init_opt_state(opt_cfg, trainable),
            "step": torch.zeros((), dtype=torch.int32,
                                device=model.device)}, opt_cfg


def build_train_step(model: LM, technique: Technique,
                     opt_cfg: AdamWConfig, *,
                     timer: Optional[Timer] = None) -> Callable:
    """``train_step(state, batch) -> (state, metrics)``: ``batch`` holds
    ``tokens`` and ``labels`` (B, T) on the model's device; ``state`` is
    updated in place and returned. Metrics (0-dim f32 tensors, nothing
    is read to the host): ``loss``, ``ce``, ``aux`` and ``grad_norm``,
    the f32 norm over all gradient leaves (the trainable ones:
    ``split_trainable``). With ``grad_accum > 1`` the
    batch is split into that many micro-batches along its first axis;
    their gradients are summed in f32 and averaged, the loss is their
    mean and ``ce``/``aux`` are the last micro-batch's.

    With a ``timer``, the step's layers are timed into its regions
    ``forward`` (the loss), ``backward`` (the gradients, recomputation
    included) and ``optimizer`` (the AdamW update), one record per
    micro-batch for the first two; each region ends with a device sync
    on a CUDA device, so it is charged with its device work. Without
    one nothing is synced."""
    check_technique(technique)
    accum = max(technique.grad_accum, 1)

    def fence():
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)

    def region(name):
        if timer is None:
            return contextlib.nullcontext()
        return timer.region(name, fence=fence)

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
        paths = tree_paths(trainable)
        leaves = [t for _, t in paths]
        if accum > 1:
            n = batch["tokens"].shape[0]
            if n % accum:
                raise ValueError(f"batch {n} does not split into {accum} "
                                 f"micro-batches")
            mb = n // accum
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
        state["step"].add_(1)
        metrics = dict(metrics)
        metrics["loss"] = loss
        norm_sq = torch.zeros((), dtype=torch.float32, device=loss.device)
        for g in grads:
            norm_sq = norm_sq + torch.sum(torch.square(g.to(torch.float32)))
        metrics["grad_norm"] = torch.sqrt(norm_sq)
        return state, metrics

    return train_step
