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


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order, the order jax flattens
    dicts in; paths read like ``blocks/pos0/mix/wq``."""
    if isinstance(tree, dict):
        out: List[Tuple[str, Any]] = []
        for k in sorted(tree):
            out += tree_paths(tree[k], f"{prefix}/{k}" if prefix else k)
        return out
    return [(prefix, tree)]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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

