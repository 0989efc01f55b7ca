"""Bridge between the JAX package's parameter and train-state trees and
the port's.

The reference's params (``repro.models.lm.LM.init``) arrive as a nested
dict of numpy arrays (``jax.device_get`` of the pytree). The tree keeps
its keys and shapes on both sides: stacked ``blocks/pos{i}`` leaves keep
their leading ``n_periods`` axis, ``embed`` keeps the padded vocabulary,
and tied embeddings have no ``head`` leaf. bf16 crosses bit-exactly
through a 16-bit integer view, 0-dim leaves (step counters) stay 0-dim.

Quantized and LoRA leaves cross as ``jax.device_get`` leaves them: the
reference's ``QTensor`` and ``LoRATensor`` (recognized by class name and
fields, without importing the JAX package) become the port's classes of
the same fields and back, with the static fields kept (``kind``, the
logical ``shape``, ``dtype_orig`` as a numpy dtype on the JAX side and a
torch dtype on the port's, ``scaling``) and nf4's ``scale2`` pair as a
tuple. The reference's 8-bit moments (``Opt8``, a named tuple of codes,
scales and the static logical shape) become the port's ``Opt8`` and
back. ``None`` stays ``None``: a LoRA train state's ``m``/``v`` trees
hold ``None`` at frozen leaves and ``QTensor``s of ``None`` fields at
frozen quantized ones.

A train state (``repro.train.step.init_train_state``) is
``{"params", "opt": {"m", "v", "step"[, "master"]}, "step"}`` on both
sides; :func:`train_state_from_jax` also moves it to a device and marks
the trainable params (all, or the LoRA adapters; under quantized full
training the float leaves) as the leaves autograd differentiates.

Under tensor parallelism a rank holds its slice of the tree:
:func:`shard_from_jax` carries the reference's numpy params to it
(``from_jax_numpy``, then ``parallel.sharding.shard_params``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.models.params import tree_map
from repro_torch.peft.lora import LoRATensor, split_trainable
from repro_torch.quant.qtensor import QTensor
from repro_torch.train.optimizer import Opt8

_NODE_TYPES = {"QTensor": QTensor, "LoRATensor": LoRATensor}


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _node_fields(cls):
    return [f.name for f in dataclasses.fields(cls)]


def _torch_dtype(dt) -> torch.dtype:
    name = np.dtype(dt).name
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


def _numpy_dtype(dt: torch.dtype) -> np.dtype:
    if dt == torch.bfloat16:
        import ml_dtypes     # numpy's bf16 dtype; needed only here
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(str(dt).removeprefix("torch."))


def _cross(node, cls, conv, conv_dtype):
    """A QTensor/LoRATensor of either side as ``cls``, fields converted."""
    kw = {}
    for f in _node_fields(cls):
        v = getattr(node, f)
        if f == "dtype_orig":
            v = conv_dtype(v)
        elif f == "shape":
            v = tuple(int(d) for d in v)
        elif f in ("kind", "scaling"):
            pass
        elif isinstance(v, tuple):
            v = tuple(conv(e) for e in v)
        else:
            v = conv(v)
        kw[f] = v
    return cls(**kw)


def from_jax_numpy(tree) -> Dict:
    """numpy tree (bf16 as the ``bfloat16`` numpy extension dtype) ->
    tree of CPU torch tensors (``Engine`` moves them to its device)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    cls = _NODE_TYPES.get(type(tree).__name__)
    if cls is not None and dataclasses.is_dataclass(tree):
        return _cross(tree, cls, from_jax_numpy, _torch_dtype)
    if type(tree).__name__ == "Opt8" and hasattr(tree, "_fields"):
        return Opt8(from_jax_numpy(tree.q), from_jax_numpy(tree.scale),
                    tuple(int(d) for d in tree.shape))
    a = np.array(tree, copy=True, order="C")
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def shard_from_jax(tree, ctx) -> Dict:
    """The reference's numpy params -> this rank's shard of them (``ctx``
    a ``parallel.sharding.ShardCtx``), as CPU tensors."""
    from repro_torch.parallel.sharding import shard_params
    return shard_params(from_jax_numpy(tree), ctx)


def to_numpy(tree):
    """Inverse of :func:`from_jax_numpy`: tensors -> numpy arrays on the
    host, bf16 as the ``bfloat16`` numpy extension dtype."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    if isinstance(tree, (QTensor, LoRATensor)):
        return _cross(tree, type(tree), to_numpy, _numpy_dtype)
    if isinstance(tree, Opt8):
        return Opt8(to_numpy(tree.q), to_numpy(tree.scale), tree.shape)
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes     # numpy's bf16 dtype; needed only here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def train_state_from_jax(state, device) -> Dict:
    """The reference's train state (numpy tree) -> the port's, on
    ``device``, with ``requires_grad`` set on every trainable param leaf
    (``split_trainable``)."""
    out = tree_map(lambda t: t.to(device), from_jax_numpy(state))
    tree_map(lambda t: None if isinstance(t, QTensor)
             else t.requires_grad_(True),
             split_trainable(out["params"])[0],
             is_leaf=lambda t: isinstance(t, QTensor))
    return out
