"""Parameter specs and seeded initialization.

A model is described once as a nested dict of :class:`ParamSpec` (shape,
dtype, logical axis names, initializer), the same tree the JAX package
builds, so a checkpoint bridged from the reference (``repro_torch.bridge``)
lands on exactly these keys and shapes. ``materialize`` draws every
``normal`` leaf from one explicit ``torch.Generator`` in the tree's sorted
key order (a leaf stacked over layers one layer slice at a time), scaled
by the fan-in of its non-stacked contraction axes; the SSM leaves
``ssm_a`` and ``dt_bias`` are uniform draws from the same generator, with
the reference's ranges.
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
# node types the reference registers without keys (``Opt8``): their
# fields' key strings are flat indices, not attribute names
_UNKEYED: set = set()


def register_node(cls, fields: Tuple[str, ...], keyed: bool = True) -> None:
    _NODES[cls] = tuple(fields)
    if not keyed:
        _UNKEYED.add(cls)


def node_fields(cls) -> Optional[Tuple[str, ...]]:
    """The tensor fields of a registered node type, or None."""
    return _NODES.get(cls)


def _field_key(node, field: str, i: int) -> str:
    """The reference's key string of a node's field: by attribute, or by
    flat index for a node it registers without keys."""
    if type(node) in _UNKEYED:
        return f"[<flat index {i}>]"
    return f".{field}"


def keystr_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key string, leaf) pairs in the reference's flatten order, named
    as ``jax.tree_util.keystr`` names them: ``['blocks']['pos0']['mix']
    ['wq']``, a ``QTensor``'s fields ``.data``/``.scale``/``.scale2[0]``,
    a ``LoRATensor``'s ``.base``/``.a``/``.b``, an ``Opt8``'s ``[<flat
    index 0>]`` (codes) and ``[<flat index 1>]`` (scales)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += keystr_paths(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, tuple):
        out = []
        for i, e in enumerate(tree):
            out += keystr_paths(e, f"{prefix}[{i}]")
        return out
    fields = _NODES.get(type(tree))
    if fields is None:
        return [(prefix, tree)]
    out = []
    for i, f in enumerate(fields):
        out += keystr_paths(getattr(tree, f),
                            prefix + _field_key(tree, f, i))
    return out


def keystr_map(fn, tree, prefix: str = ""):
    """``tree`` rebuilt with ``fn(key string, leaf)`` at each leaf of
    :func:`keystr_paths`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: keystr_map(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(keystr_map(fn, e, f"{prefix}[{i}]")
                     for i, e in enumerate(tree))
    fields = _NODES.get(type(tree))
    if fields is None:
        return fn(prefix, tree)
    return dataclasses.replace(tree, **{
        f: keystr_map(fn, getattr(tree, f), prefix + _field_key(tree, f, i))
        for i, f in enumerate(fields)})


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


def _draw(ps: ParamSpec, shape, generator, device) -> torch.Tensor:
    """One f32 draw of ``ps``'s random initializer at ``shape``."""
    if ps.init == "ssm_a":      # A_log in [log 1, log 16], mamba2 default
        return torch.log(_uniform(shape, 1.0, 16.0, generator, device))
    if ps.init == "dt_bias":    # softplus^-1 of dt ~ U[1e-3, 1e-1]
        u = _uniform(shape, 1e-3, 1e-1, generator, device)
        return u + torch.log(-torch.expm1(-u))
    if ps.init == "normal":
        stacked = bool(ps.logical) and ps.logical[0] == "layers"
        fan_in = 1
        for ax in ps.fan_in_axes:
            a = ax + (1 if stacked else 0)
            if a < len(ps.shape):
                fan_in *= ps.shape[a]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * scale
    raise ValueError(f"unknown initializer {ps.init!r}")


def materialize(specs, generator: torch.Generator,
                device: torch.device, piece=None) -> Dict:
    """Initialize real parameters on ``device`` from ``generator`` (which
    must live on the same device type). A leaf stacked on a leading
    ``layers`` axis is drawn one layer slice at a time, each slice cast
    into the leaf before the next is drawn, so the f32 scratch is one
    slice (qwen3-moe's stacked experts: 0.8 GB, not 38.6 GB).
    ``piece(path, t)``, where given, keeps a part of each drawn leaf (of
    each layer slice, with its ``layers`` dim kept at size 1): every
    value is drawn in the same order, so the parts are the whole tree's
    parts bit for bit, and no whole stacked leaf is ever held."""
    keep = piece or (lambda _, t: t)
    out: Dict = {}
    for path, ps in tree_paths(specs):
        if ps.init in ("zeros", "ones"):
            fill = torch.zeros if ps.init == "zeros" else torch.ones
            t = keep(path, fill(ps.shape, dtype=ps.dtype, device=device))
        elif ps.logical and ps.logical[0] == "layers":
            t = None
            for i in range(ps.shape[0]):
                part = keep(path, _draw(ps, ps.shape[1:], generator,
                                        device).to(ps.dtype)[None])
                if t is None:
                    t = torch.empty((ps.shape[0],) + tuple(part.shape[1:]),
                                    dtype=ps.dtype, device=device)
                t[i] = part[0]
        else:
            t = keep(path, _draw(ps, ps.shape, generator, device).to(
                ps.dtype))
        set_path(out, path, t.contiguous() if piece else t)
    return out
