"""Device selection for the port's entry points.

``Engine``, ``LM`` and ``launch.serve`` run on the card by default. A
caller that wants the CPU (the parity tests) says so with
``device="cpu"``; with no card and no explicit CPU request they raise
instead of quietly running somewhere else. A model-parallel rank takes
its device from :func:`rank_device`, by the same rule.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the card. Any CUDA device also sets the numerics
    switches the f32-accumulate-once discipline relies on: no TF32 in f32
    products and no reduced-precision reductions in bf16 ones."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    return dev


DIST_BACKENDS = ("nccl", "gloo")


def rank_device(rank: int, world: int, backend: str,
                device: Optional[Union[str, torch.device]] = None
                ) -> torch.device:
    """The device of rank ``rank`` of ``world`` model-parallel ranks:
    ``cuda:(rank % device_count)``, or the CPU when the caller passes
    ``device="cpu"``. Like :func:`resolve_device` it raises without a
    card unless asked for the CPU. ``nccl`` needs one card per rank: it
    raises where ranks would share one. ``gloo`` runs on the CPU and on
    CUDA tensors, several ranks to a card."""
    if backend not in DIST_BACKENDS:
        raise ValueError(f"backend {backend!r} not one of {DIST_BACKENDS}")
    if device is not None and torch.device(device).type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA devices; the CPU ranks "
                             "take gloo")
        return torch.device("cpu")
    resolve_device(device)
    n = torch.cuda.device_count()
    if backend == "nccl" and world > n:
        raise RuntimeError(
            f"nccl needs one card per rank: {world} ranks would share "
            f"{n} card(s); ranks that share a card take gloo")
    return torch.device("cuda", rank % n)
