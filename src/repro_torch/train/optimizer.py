"""AdamW with 32-bit state and optional f32 master weights (the port of
``repro.train.optimizer``).

State mirrors the trainable-param tree: ``{"m", "v", "step"[, "master"]}``
with f32 moments and a 0-dim int32 step counter, all on the params'
device. :func:`adamw_apply` updates params, moments, master weights and
the counter IN PLACE under ``torch.no_grad()`` (the torch form of the
reference's donated state), with the reference's arithmetic in f32. The
8-bit block-wise moments (the reference's ``state_bits=8``, ``Opt8``)
are not ported: the config has no such field yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch

from repro_torch.models.params import tree_map, tree_paths


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
    def zeros32(x):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

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
    moments, master weights and step. Weight decay applies to leaves of
    rank >= 2, counted on the stored (stacked) leaf as the reference
    counts it."""
    opt_state["step"].add_(1)
    step = opt_state["step"]
    lr = schedule(cfg, step)
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=sf.device), sf)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=sf.device), sf)
    master = opt_state.get("master")
    b1, b2 = cfg.b1, cfg.b2
    flat_g = tree_paths(grads)
    flat_m = dict(tree_paths(opt_state["m"]))
    flat_v = dict(tree_paths(opt_state["v"]))
    flat_p = dict(tree_paths(trainable))
    flat_mw = dict(tree_paths(master)) if master is not None else {}
    for path, g in flat_g:
        m, v, p = flat_m[path], flat_v[path], flat_p[path]
        mw = flat_mw.get(path)
        gf = g.to(torch.float32)
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf * gf)
        mhat = m / bc1
        vhat = v / bc2
        base = (mw if mw is not None else p).to(torch.float32)
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        new = base - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                           + decay * base)
        if mw is not None:
            mw.copy_(new)
        p.copy_(new.to(p.dtype))
