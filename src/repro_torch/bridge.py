"""Bridge between the JAX package's parameter and train-state trees and
the port's.

The reference's params (``repro.models.lm.LM.init``) arrive as a nested
dict of numpy arrays (``jax.device_get`` of the pytree). The tree keeps
its keys and shapes on both sides: stacked ``blocks/pos{i}`` leaves keep
their leading ``n_periods`` axis, ``embed`` keeps the padded vocabulary,
and tied embeddings have no ``head`` leaf. bf16 crosses bit-exactly
through a 16-bit integer view, 0-dim leaves (step counters) stay 0-dim.

A train state (``repro.train.step.init_train_state``) is
``{"params", "opt": {"m", "v", "step"[, "master"]}, "step"}`` on both
sides; :func:`train_state_from_jax` also moves it to a device and marks
the params as the leaves autograd differentiates.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.params import tree_map


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def from_jax_numpy(tree) -> Dict:
    """numpy tree (bf16 as the ``bfloat16`` numpy extension dtype) ->
    tree of CPU torch tensors (``Engine`` moves them to its device)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v) for k, v in tree.items()}
    a = np.array(tree, copy=True, order="C")
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def to_numpy(tree):
    """Inverse of :func:`from_jax_numpy`: tensors -> numpy arrays on the
    host, bf16 as the ``bfloat16`` numpy extension dtype."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes     # numpy's bf16 dtype; needed only here
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def train_state_from_jax(state, device) -> Dict:
    """The reference's train state (numpy tree) -> the port's, on
    ``device``, with ``requires_grad`` set on every param leaf."""
    out = tree_map(lambda t: t.to(device), from_jax_numpy(state))
    tree_map(lambda t: t.requires_grad_(True), out["params"])
    return out
