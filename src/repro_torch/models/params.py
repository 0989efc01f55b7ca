"""Parameter specs and seeded initialization.

A model is described once as a nested dict of :class:`ParamSpec` (shape,
dtype, logical axis names, initializer), the same tree the JAX package
builds, so a checkpoint bridged from the reference (``repro_torch.bridge``)
lands on exactly these keys and shapes. ``materialize`` draws every
``normal`` leaf from one explicit ``torch.Generator`` in the tree's sorted
key order, scaled by the fan-in of its non-stacked contraction axes;
the SSM leaves ``ssm_a`` and ``dt_bias`` are uniform draws from the same
generator, with the reference's ranges.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Tuple[Optional[str], ...]
    init: str = "normal"   # normal | zeros | ones | ssm_a | dt_bias
    fan_in_axes: Tuple[int, ...] = (0,)


def spec(shape, logical, init="normal", dtype=torch.bfloat16,
         fan_in_axes=(0,)) -> ParamSpec:
    if len(shape) != len(logical):
        raise ValueError(f"shape {shape} and logical axes {logical} differ "
                         f"in rank")
    return ParamSpec(tuple(int(s) for s in shape), dtype, tuple(logical),
                     init, tuple(fan_in_axes))


# Node types whose fields hold subtrees (``QTensor``, ``LoRATensor``):
# the trees' counterpart of the reference's pytree registration. Each
# registers the names of its tensor fields; a field may hold ``None`` or
# a tuple of tensors (nf4's ``scale2``).
_NODES: Dict[type, Tuple[str, ...]] = {}


def register_node(cls, fields: Tuple[str, ...]) -> None:
    _NODES[cls] = tuple(fields)


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def tree_paths(tree, prefix: str = "", is_leaf=None
               ) -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order, the order jax flattens
    dicts in; paths read like ``blocks/pos0/mix/wq``, a node's fields
    like ``blocks/pos0/mix/wq/base/data``. ``None`` is an empty subtree,
    as in jax."""
    if is_leaf is not None and is_leaf(tree):
        return [(prefix, tree)]
    if tree is None:
        return []
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += tree_paths(tree[k], _join(prefix, k), is_leaf)
        return out
    fields = _NODES.get(type(tree))
    if fields is None:
        return [(prefix, tree)]
    out = []
    for f in fields:
        v = getattr(tree, f)
        if isinstance(v, tuple):
            for j, e in enumerate(v):
                out += tree_paths(e, _join(prefix, f"{f}/{j}"), is_leaf)
        else:
            out += tree_paths(v, _join(prefix, f), is_leaf)
    return out


def tree_map_with_path(fn, tree, is_leaf=None, prefix: str = ""):
    """``fn(path, leaf)`` over the leaves of :func:`tree_paths`; dicts and
    nodes are rebuilt around the results, ``None`` stays ``None``."""
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix, tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, is_leaf, _join(prefix, k))
                for k, v in tree.items()}
    fields = _NODES.get(type(tree))
    if fields is None:
        return fn(prefix, tree)
    new = {}
    for f in fields:
        v = getattr(tree, f)
        new[f] = (tuple(tree_map_with_path(fn, e, is_leaf,
                                           _join(prefix, f"{f}/{j}"))
                        for j, e in enumerate(v))
                  if isinstance(v, tuple)
                  else tree_map_with_path(fn, v, is_leaf, _join(prefix, f)))
    return dataclasses.replace(tree, **new)


def tree_map(fn, tree, is_leaf=None):
    return tree_map_with_path(lambda _, leaf: fn(leaf), tree, is_leaf)


def tree_unstack(tree, n: int) -> List:
    """``n`` trees, the i-th holding slice i of every (stacked) leaf, as
    ``lax.scan`` slices a pytree: nodes keep their static fields. Each
    leaf is ``unbind`` once, so a backward stacks all slices' gradients
    once instead of adding one zero-padded slice per tree."""
    slices = {p: leaf.unbind(0) for p, leaf in tree_paths(tree)}
    return [tree_map_with_path(lambda p, _: slices[p][i], tree)
            for i in range(n)]


def set_path(tree: Dict, path: str, value) -> None:
    keys = path.split("/")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def _uniform(shape, lo: float, hi: float, generator, device):
    u = torch.rand(shape, generator=generator, dtype=torch.float32,
                   device=device)
    return u * (hi - lo) + lo


def materialize(specs, generator: torch.Generator,
                device: torch.device) -> Dict:
    """Initialize real parameters on ``device`` from ``generator`` (which
    must live on the same device type)."""
    out: Dict = {}
    for path, ps in tree_paths(specs):
        if ps.init == "ssm_a":      # A_log in [log 1, log 16], mamba2 default
            t = torch.log(_uniform(ps.shape, 1.0, 16.0, generator,
                                   device)).to(ps.dtype)
        elif ps.init == "dt_bias":  # softplus^-1 of dt ~ U[1e-3, 1e-1]
            u = _uniform(ps.shape, 1e-3, 1e-1, generator, device)
            t = (u + torch.log(-torch.expm1(-u))).to(ps.dtype)
        elif ps.init == "zeros":
            t = torch.zeros(ps.shape, dtype=ps.dtype, device=device)
        elif ps.init == "ones":
            t = torch.ones(ps.shape, dtype=ps.dtype, device=device)
        elif ps.init == "normal":
            fan_in = 1
            for ax in ps.fan_in_axes:
                a = ax + (1 if (ps.logical and ps.logical[0] == "layers")
                          else 0)
                if a < len(ps.shape):
                    fan_in *= ps.shape[a]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
            t = (torch.randn(ps.shape, generator=generator,
                             dtype=torch.float32, device=device)
                 * scale).to(ps.dtype)
        else:
            raise ValueError(f"unknown initializer {ps.init!r} at {path}")
        set_path(out, path, t)
    return out

