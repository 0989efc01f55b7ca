"""Builders: (arch x shape x technique) -> model and train step (the
one-device part of ``repro.launch.build``).

``make_model`` maps technique ``F`` to the flash kernels
(``attn_impl="flash"``, the counterpart of the reference's ``"pallas"``
mode). The reference's builder maps ``F`` to its XLA ``"chunked"`` scan,
the stand-in it uses where Pallas cannot run; both compute the same
function, and on the card the port has the kernel. ``qmm_impl`` routes
the int8 projections of a quantized base (``models.layers.dense``): the
int8 kernel by default, ``"ref"`` for the reference's dequantize-first
product.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from repro_torch.core.config import ArchConfig, Technique
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import build_train_step


def make_model(cfg: ArchConfig, technique: Technique, *,
               device: Optional[Union[str, torch.device]] = None,
               qmm_impl: str = "kernel") -> LM:
    attn_impl = "flash" if technique.flash else "naive"
    return LM(cfg, attn_impl=attn_impl, qmm_impl=qmm_impl,
              remat=technique.remat, device=device)


def build_train(cfg: ArchConfig, technique: Technique,
                opt_cfg: Optional[AdamWConfig] = None, *,
                device: Optional[Union[str, torch.device]] = None
                ) -> Tuple:
    """``(train_step, technique, model, opt_cfg)`` for one device.
    ``grad_accum == 0`` (auto) resolves to 1, as the reference's
    ``pick_grad_accum`` does without a mesh (where it needs no shape)."""
    if technique.grad_accum == 0:
        technique = dataclasses.replace(technique, grad_accum=1)
    model = make_model(cfg, technique, device=device)
    opt_cfg = opt_cfg or AdamWConfig()
    return build_train_step(model, technique, opt_cfg), technique, model, \
        opt_cfg
