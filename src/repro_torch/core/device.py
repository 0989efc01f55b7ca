"""Device selection for the port's entry points.

``Engine``, ``LM`` and ``launch.serve`` run on the card by default. A
caller that wants the CPU (the parity tests) says so with
``device="cpu"``; with no card and no explicit CPU request they raise
instead of quietly running somewhere else.
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
