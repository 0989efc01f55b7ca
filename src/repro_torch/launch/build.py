"""Builders: (arch x shape x technique x mesh) -> model and train step
(the training part of ``repro.launch.build``).

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

With a mesh (``launch.mesh.Mesh``) :func:`build_train` trains over its
data axis: the context is the reference's ``make_shard_ctx``, and
``grad_accum == 0`` (auto) takes the reference's ``pick_grad_accum``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ArchConfig, ShapeSpec, Technique
from repro_torch.core.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.parallel.sharding import ShardCtx, make_shard_ctx
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import build_train_step, default_opt_cfg


def make_model(cfg: ArchConfig, technique: Technique, *,
               device: Optional[Union[str, torch.device]] = None,
               qmm_impl: str = "kernel", ctx=None) -> LM:
    attn_impl = "flash" if technique.flash else "naive"
    return LM(cfg, attn_impl=attn_impl, qmm_impl=qmm_impl,
              remat=technique.remat, device=device, ctx=ctx)


def pick_grad_accum(cfg: ArchConfig, shape: ShapeSpec, ctx: ShardCtx,
                    target_tokens_per_chip: int = 16384) -> int:
    """Microbatch count so live activations per chip stay bounded (the
    reference's production default, the paper's Table IV 'maximize batch
    via accumulation/recomputation' regime); 1 without a mesh. Each rank
    then runs that many micro-batches of its rows, so the count is also
    halved until it divides a rank's ``B/dp`` rows (the port's rule: the
    reference's micro-batch is global, GSPMD's to place)."""
    if ctx is None or ctx.mesh is None:
        return 1
    dp = max(ctx.dp_size, 1)
    b = shape.global_batch
    tokens_per_chip = b * shape.seq_len // min(dp, b)
    accum = 1
    for cand in (8, 4, 2):
        if b % cand:
            continue
        mb = b // cand
        if mb % dp and mb < dp:
            continue
        if tokens_per_chip // cand <= target_tokens_per_chip:
            accum = cand
            break
    # ensure the microbatch still shards over dp
    while accum > 1 and ((b // accum) % dp and (b // accum) < dp
                         or (b // dp) % accum):
        accum //= 2
    return accum


def build_train(cfg: ArchConfig, technique: Technique,
                opt_cfg: Optional[AdamWConfig] = None, *,
                device: Optional[Union[str, torch.device]] = None,
                mesh=None, shape: Optional[ShapeSpec] = None) -> Tuple:
    """``(train_step, technique, model, opt_cfg)``: on one device, or as
    one rank of ``mesh`` (on the mesh's device; ``model.ctx`` is the
    training context). ``grad_accum == 0`` (auto) resolves through
    :func:`pick_grad_accum` (which needs ``shape`` with a mesh): 1 on one
    device, as the reference's. ``opt_cfg`` defaults to the reference's:
    8-bit moments under quantized full training (``Q``, ``Q8``), 32-bit
    otherwise."""
    ctx = make_shard_ctx(cfg, technique, mesh) if mesh is not None else None
    if technique.grad_accum == 0:
        technique = dataclasses.replace(
            technique, grad_accum=pick_grad_accum(cfg, shape, ctx))
        if ctx is not None:
            ctx.technique = technique
    if mesh is not None and device is None:
        device = mesh.device
    model = make_model(cfg, technique, device=device, ctx=ctx)
    opt_cfg = opt_cfg or default_opt_cfg(technique)
    return build_train_step(model, technique, opt_cfg, ctx=ctx), \
        technique, model, opt_cfg


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
