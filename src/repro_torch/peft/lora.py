"""LoRA (the port of ``repro.peft.lora``).

``LoRATensor`` wraps a frozen base weight (a tensor or an int8
``QTensor``) with trainable low-rank factors A (fan_in..., r) and B
(r, fan_out...). ``models.layers.dense`` applies it as
``x @ W + scaling · (x @ A) @ B`` without materializing W + AB.

``split_trainable`` partitions a LoRA-fied tree into (trainable, frozen)
so that gradients and optimizer state cover the adapters only.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.models.params import (register_node, set_path, tree_map,
                                       tree_paths)
from repro_torch.quant.qtensor import QTensor


@dataclasses.dataclass
class LoRATensor:
    base: Any                   # torch.Tensor | QTensor - frozen
    a: Any                      # (fan_in_dims..., r) - trainable
    b: Any                      # (r, fan_out_dims...) - trainable
    scaling: float              # alpha / r


register_node(LoRATensor, ("base", "a", "b"))

# Default adapter targets, as PEFT does for Llama-family models: attention
# projections (+ the SSM projections). Matched by the last key of a path.
DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "in_proj", "out_proj")


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, QTensor, LoRATensor))


def apply_lora(params, generator: torch.Generator, rank: int = 64,
               alpha: float = 16.0,
               targets: Tuple[str, ...] = DEFAULT_TARGETS):
    """Wrap the matching weights with ``LoRATensor``. Dim 0 of a block
    weight is the layer stack and is kept in A and B (the reference's
    ``stacked=True``, its only use). A is an f32 normal draw from
    ``generator`` over √fan_in, cast to bf16; B is zero, so the wrapped
    model starts as the base model. ``wo`` (H, hd, d) contracts two axes.

    An nf4 base raises: the reference's ``apply_lora`` reads a stacked nf4
    ``QTensor``'s per-layer shape as if it were stacked
    (``repro/peft/lora.py:74-75``) and its step then fails."""
    out: dict = {}
    for path, leaf in tree_paths(params, is_leaf=_is_leaf):
        name = path.rsplit("/", 1)[-1]
        if name not in targets or len(leaf.shape) < 2:
            set_path(out, path, leaf)
            continue
        if isinstance(leaf, QTensor) and leaf.kind != "int8":
            raise NotImplementedError(
                f"LoRA on an {leaf.kind} base ({path}) is not ported: the "
                f"reference's apply_lora misreads a stacked nf4 QTensor's "
                f"shape (repro/peft/lora.py:74-75; ROADMAP queue 1 item 5, "
                f"queue 3)")
        shape = tuple(leaf.shape)
        lead, body = shape[:1], shape[1:]
        nin = 2 if name == "wo" and len(body) == 3 else 1
        dev = (leaf.data if isinstance(leaf, QTensor) else leaf).device
        fan_in = math.prod(body[:nin])
        a = (torch.randn(lead + body[:nin] + (rank,), generator=generator,
                         dtype=torch.float32, device=dev)
             / math.sqrt(fan_in)).to(torch.bfloat16)
        b = torch.zeros(lead + (rank,) + body[nin:], dtype=torch.bfloat16,
                        device=dev)
        set_path(out, path, LoRATensor(leaf, a, b, scaling=alpha / rank))
    return out


def _is_lora(x) -> bool:
    return isinstance(x, LoRATensor)


def split_trainable(params):
    """(trainable, frozen): under LoRA only the adapters train, as
    ``{"a", "b"}`` dicts, with ``None`` (and ``QTensor``s of ``None``
    fields) at every other leaf, the reference's tree; without LoRA
    everything trains and the frozen side is ``None``."""
    if not any(_is_lora(leaf)
               for _, leaf in tree_paths(params, is_leaf=_is_lora)):
        return params, None
    trainable = tree_map(
        lambda l: {"a": l.a, "b": l.b} if _is_lora(l) else None, params,
        is_leaf=_is_lora)
    frozen = tree_map(
        lambda l: ({"base": l.base, "scaling": l.scaling} if _is_lora(l)
                   else l), params, is_leaf=_is_lora)
    return trainable, frozen


def merge_trainable(trainable, frozen):
    """Inverse of :func:`split_trainable`."""
    if frozen is None:
        return trainable
    if isinstance(trainable, dict) and set(trainable) == {"a", "b"}:
        return LoRATensor(frozen["base"], trainable["a"], trainable["b"],
                          scaling=frozen["scaling"])
    if isinstance(trainable, dict):
        return {k: merge_trainable(trainable[k], frozen[k])
                for k in trainable}
    return frozen if trainable is None or isinstance(trainable, QTensor) \
        else trainable
