"""PyTorch/CUDA port of the serving stack.

The JAX package ``repro`` is the reference; this package mirrors its
module names (``core.config``, ``models.lm``, ``serving.engine``, ...)
so each port module sits next to a counterpart of the same name. It
imports ``torch`` and numpy only. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (see :func:`repro_torch.core.device.
resolve_device`); they never fall back to the CPU on their own.
"""
