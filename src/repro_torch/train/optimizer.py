"""AdamW with 32-bit or 8-bit block-wise state and optional f32 master
weights (the port of ``repro.train.optimizer``).

State mirrors the trainable-param tree: ``{"m", "v", "step"[, "master"]}``
with a 0-dim int32 step counter, all on the params' device. The moments
are f32 leaves (``state_bits=32``) or :class:`Opt8` nodes
(``state_bits=8``, the paper's "Q" rows): int8 codes in blocks of
``OPT8_BLOCK`` with one f32 absmax scale a block, decoded to f32 for the
update and encoded again after it. :func:`adamw_apply` updates params,
moments, master weights and the counter IN PLACE under
``torch.no_grad()`` (the torch form of the reference's donated state),
with the reference's arithmetic in f32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.models.params import register_node, tree_map, tree_paths

OPT8_BLOCK = 256
# the reference divides the absmax by 127.0; the port multiplies by the f32
# reciprocal (NUM-01), so a scale may sit one f32 ulp from the reference's
_INV127 = float(np.float32(1.0 / 127.0))


@dataclasses.dataclass
class Opt8:
    """Block-wise int8 moment storage: ``q`` int8 (n_blocks, OPT8_BLOCK),
    the flat moment zero-padded to whole blocks; ``scale`` f32
    (n_blocks,), each block's absmax / 127; ``shape`` the moment's
    logical shape (static)."""
    q: Any
    scale: Any
    shape: Tuple[int, ...]


register_node(Opt8, ("q", "scale"), keyed=False)


def _o8_encode(x: torch.Tensor) -> Opt8:
    """``x`` as :class:`Opt8`: codes ``round(x / scale)`` (half to even)
    clipped to +-127."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.shape[0]) % OPT8_BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    b = flat.reshape(-1, OPT8_BLOCK)
    s = torch.clamp_min(b.abs().amax(dim=-1), 1e-12) * _INV127
    q = torch.clamp(torch.round(b / s[:, None]), -127, 127).to(torch.int8)
    return Opt8(q, s, tuple(x.shape))


def _o8_decode(o: Opt8) -> torch.Tensor:
    """The f32 moment an :class:`Opt8` holds, at its logical shape."""
    flat = (o.q.to(torch.float32) * o.scale[:, None]).reshape(-1)
    return flat[: math.prod(o.shape)].reshape(o.shape)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup: int = 100
    decay_steps: int = 10000
    min_lr_ratio: float = 0.1
    state_bits: int = 32          # 32 | 8 (block-wise int8 m/v)
    master_fp32: bool = False     # keep fp32 master weights in opt state


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_ratio``; f32 on the
    step's device."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup) / max(cfg.decay_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * cos


def init_opt_state(cfg: AdamWConfig, trainable) -> Dict[str, Any]:
    if cfg.state_bits not in (8, 32):
        raise ValueError(f"state_bits {cfg.state_bits} not 8 or 32")

    def zeros32(x):
        z = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return _o8_encode(z) if cfg.state_bits == 8 else z

    dev = next(t for _, t in tree_paths(trainable)).device
    state = {
        "m": tree_map(zeros32, trainable),
        "v": tree_map(zeros32, trainable),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if cfg.master_fp32:
        state["master"] = tree_map(
            lambda x: x.detach().to(torch.float32).clone(), trainable)
    return state


@torch.no_grad()
def adamw_apply(cfg: AdamWConfig, grads, opt_state, trainable) -> None:
    """One AdamW update from ``grads`` (same tree as ``trainable``, any
    float type), in place: ``trainable`` leaves, ``opt_state``'s
    moments, master weights and step. 8-bit moments are decoded, updated
    in f32 and encoded again into their ``Opt8`` fields. Weight decay
    applies to leaves of rank >= 2, counted on the stored (stacked) leaf
    as the reference counts it."""
    opt_state["step"].add_(1)
    step = opt_state["step"]
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    master = opt_state.get("master")
    b1, b2 = cfg.b1, cfg.b2
    is8 = lambda x: isinstance(x, Opt8)                 # noqa: E731
    flat_g = tree_paths(grads)
    flat_m = dict(tree_paths(opt_state["m"], is_leaf=is8))
    flat_v = dict(tree_paths(opt_state["v"], is_leaf=is8))
    flat_p = dict(tree_paths(trainable))
    flat_mw = dict(tree_paths(master)) if master is not None else {}
    for path, g in flat_g:
        m, v, p = flat_m[path], flat_v[path], flat_p[path]
        mw = flat_mw.get(path)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        for part in _parts((g, m, v, p, mw), is8(m) or is8(v)):
            _update(*part, b1=b1, b2=b2, bc1=bc1, bc2=bc2, lr=lr,
                    eps=cfg.eps, decay=decay)


# elements a slice of a leaf's update holds at most: the update's f32
# temporaries then stay small beside the state (an expert stack's leaf
# of 940M elements would take several 3.8 GB temporaries at once)
_CHUNK = 1 << 26


def _parts(leaves, whole: bool):
    """``leaves`` (gradient, moments, param, master weights or None, one
    shape), or slices of them along the first dim longer than 1 with at
    most ``_CHUNK`` elements each: the update is elementwise, so a slice's
    is the whole's. 8-bit moments (blocks over the flattened leaf) are
    updated whole."""
    g = leaves[0]
    dims = [i for i, n in enumerate(g.shape) if n > 1]
    if whole or g.numel() <= _CHUNK or not dims:
        return [leaves]
    dim = dims[0]
    step = max(1, g.shape[dim] * _CHUNK // g.numel())
    return [tuple(None if t is None else t.narrow(dim, lo, min(
        step, g.shape[dim] - lo)) for t in leaves)
        for lo in range(0, g.shape[dim], step)]


def _update(g, m, v, p, mw, *, b1, b2, bc1, bc2, lr, eps, decay) -> None:
    """The AdamW update of one leaf (or slice), in place."""
    is8 = lambda x: isinstance(x, Opt8)                 # noqa: E731
    gf = g.to(torch.float32)
    mf = b1 * (_o8_decode(m) if is8(m) else m) + (1 - b1) * gf
    vf = b2 * (_o8_decode(v) if is8(v) else v) + (1 - b2) * gf * gf
    for state, new in ((m, mf), (v, vf)):
        if is8(state):
            enc = _o8_encode(new)
            state.q.copy_(enc.q)
            state.scale.copy_(enc.scale)
        else:
            state.copy_(new)
    mhat = mf / bc1
    vhat = vf / bc2
    base = (mw if mw is not None else p).to(torch.float32)
    new = base - lr * (mhat / (torch.sqrt(vhat) + eps) + decay * base)
    if mw is not None:
        mw.copy_(new)
    p.copy_(new.to(p.dtype))
