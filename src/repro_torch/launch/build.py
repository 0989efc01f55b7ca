"""Builders: (arch x shape x technique) -> model and train step (the
one-device part of ``repro.launch.build``).

``make_model`` maps technique ``F`` to the flash kernels
(``attn_impl="flash"``, the counterpart of the reference's ``"pallas"``
mode). The reference's builder maps ``F`` to its XLA ``"chunked"`` scan,
the stand-in it uses where Pallas cannot run; both compute the same
function, and on the card the port has the kernel. ``qmm_impl`` routes
the int8 projections of a quantized base (``models.layers.dense``): the
int8 kernel by default, ``"ref"`` for the reference's dequantize-first
product. No ``ssd_impl`` is passed, as the reference's ``make_model``
passes none: an SSM layer trains through the ``LM`` default ``"ref"``
(``models.ssd.ssd_chunked_ref`` under autograd), the reference's jnp
training route; the SSD kernel, like the TPU kernel, has no backward.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ArchConfig, Technique
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import build_train_step, default_opt_cfg


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
    ``pick_grad_accum`` does without a mesh (where it needs no shape).
    ``opt_cfg`` defaults to the reference's: 8-bit moments under quantized
    full training (``Q``, ``Q8``), 32-bit otherwise."""
    if technique.grad_accum == 0:
        technique = dataclasses.replace(technique, grad_accum=1)
    model = make_model(cfg, technique, device=device)
    opt_cfg = opt_cfg or default_opt_cfg(technique)
    return build_train_step(model, technique, opt_cfg), technique, model, \
        opt_cfg


def batch_specs(cfg: ArchConfig, batch: int, seq_len: int,
                with_labels: bool = True
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """A training / prefill batch's entries as ``name -> (shape, dtype)``
    (the reference's ``batch_specs`` without a mesh). A vlm batch holds
    ``frontend_len`` patch embeddings and ``seq_len - frontend_len``
    tokens (``seq_len`` positions in all); an encdec batch holds
    ``frontend_len`` frame embeddings for the encoder and ``seq_len``
    tokens; the other families ``seq_len`` tokens."""
    n_tok = seq_len
    out: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    if cfg.family in ("vlm", "encdec"):
        if cfg.family == "vlm":
            n_tok = seq_len - cfg.frontend_len
        out["frontend_embeds"] = ((batch, cfg.frontend_len, cfg.d_model),
                                  torch.bfloat16)
    out["tokens"] = ((batch, n_tok), torch.int32)
    if with_labels:
        out["labels"] = ((batch, n_tok), torch.int32)
    return out


def random_batch(cfg: ArchConfig, batch: int, seq_len: int, *,
                 seed: int = 0, with_labels: bool = True,
                 device: Optional[Union[str, torch.device]] = None
                 ) -> Dict[str, torch.Tensor]:
    """A seeded batch in :func:`batch_specs`' layout, drawn on ``device``
    (the card unless the caller passes ``"cpu"``): tokens and labels
    uniform over the vocabulary, frontend embeddings standard normal."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, (shape, dtype) in batch_specs(cfg, batch, seq_len,
                                            with_labels).items():
        if dtype.is_floating_point:
            out[name] = torch.randn(shape, generator=g, device=dev).to(dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shape, generator=g,
                                      device=dev, dtype=dtype)
    return out
