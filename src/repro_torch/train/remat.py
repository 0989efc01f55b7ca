"""Activation recomputation policies (the port of ``repro.train.remat``).

Applied around one decoder layer, the reference's rematerialization unit
(its per-layer scan body):

  none       — autograd keeps every saved tensor (paper's 'Naive')
  full       — save only the layer boundary, recompute the layer in the
               backward ('R')
  selective  — save the outputs of 2-D matrix products (``dense``'s
               ``mm``), recompute everything else; the counterpart of
               ``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``
               (batched products such as attention's scores are
               recomputed)
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

REMAT_MODES = ("none", "full", "selective")

_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def wrap_remat(body, mode: str):
    """``body`` wrapped so that its backward recomputes per ``mode``. A
    layer draws no random numbers, so no RNG state is stashed."""
    if mode == "none":
        return body
    if mode == "full":
        return functools.partial(checkpoint, body, use_reentrant=False,
                                 preserve_rng_state=False)
    if mode == "selective":
        return functools.partial(
            checkpoint, body, use_reentrant=False, preserve_rng_state=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_saveable))
    raise ValueError(f"unknown remat mode {mode!r}")


def remat_extra_flops_factor(mode: str) -> float:
    """Analytic forward-recompute multiplier for the roofline notes."""
    return {"none": 1.0, "selective": 1.15, "full": 4.0 / 3.0}[mode]
