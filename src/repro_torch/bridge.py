"""Weight bridge between the JAX package's parameter tree and the port's.

The reference's params (``repro.models.lm.LM.init``) arrive as a nested
dict of numpy arrays (``jax.device_get`` of the pytree). The tree keeps
its keys and shapes on both sides: stacked ``blocks/pos{i}`` leaves keep
their leading ``n_periods`` axis, ``embed`` keeps the padded vocabulary,
and tied embeddings have no ``head`` leaf. bf16 crosses bit-exactly
through a 16-bit integer view.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def from_jax_numpy(tree) -> Dict:
    """numpy tree (bf16 as the ``bfloat16`` numpy extension dtype) ->
    tree of CPU torch tensors (``Engine`` moves them to its device)."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v) for k, v in tree.items()}
    a = np.ascontiguousarray(tree)
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


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
