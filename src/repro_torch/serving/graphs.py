"""CUDA-graph capture of the engine's steps: the torch form of the
reference's ``jax.jit`` executables (``repro.serving.engine``,
``_fused_step`` / ``_chunk_step`` / ``_verify_step``).

A :class:`StepGraph` is one step function captured once at one static
shape over the engine's preallocated pools: static device input buffers,
the graph and its static outputs. A replay copies the step's host inputs
into the static buffers from pinned staging, launches the graph, and
copies the outputs back into pinned buffers behind one stream sync.

**Launch counters.** The kernels' ``LAUNCHES`` / ``BODIES`` counters are
host counters, bumped where a Python wrapper launches its kernel. Under
capture the wrappers run but nothing launches, and a replay runs no
wrapper. So a capture records the counts its wrappers added, takes them
back out, and every replay adds them again: the counters keep counting
kernel launches on the device, one for each kernel each replay runs.

Nothing in a captured body may sync, read a device value on the host or
copy host memory to the device; kernel state that is built lazily (split
counters, the RoPE table, loaded libraries, cuBLAS) must exist before the
capture, so each shape runs once eagerly first (:meth:`Engine.warmup`
runs it on throwaway copies of the pools, a first use while serving is
the step itself).
"""
from __future__ import annotations

import gc
from collections import Counter
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssd as ssdk

#: every launch counter of the port's kernels
KERNEL_COUNTERS: Tuple[Counter, ...] = (
    fa.LAUNCHES, fd.LAUNCHES, rn.LAUNCHES, ssdk.LAUNCHES, ssdk.BODIES,
    qmm.LAUNCHES, qmm.BODIES)


def _add_counts(delta: List[Counter], sign: int) -> None:
    for counter, d in zip(KERNEL_COUNTERS, delta):
        for key, n in d.items():
            counter[key] += sign * n
            if counter[key] == 0:
                del counter[key]


class StepGraph:
    """``fn(**inputs) -> tuple of tensors`` captured once in ``pool``.

    ``inputs`` are device tensors at the step's static shapes (their
    values do not matter: capture runs nothing); the graph owns them from
    then on and reads them, and :meth:`replay` refills them."""

    def __init__(self, fn: Callable, inputs: Dict[str, torch.Tensor],
                 pool):
        self.inputs = inputs
        self.staging = {k: torch.empty(v.shape, dtype=v.dtype,
                                       pin_memory=True)
                        for k, v in inputs.items()}
        self.graph = torch.cuda.CUDAGraph()
        before = [Counter(c) for c in KERNEL_COUNTERS]
        # no garbage collection inside the capture: collecting a dropped
        # engine there frees its graphs and their memory, which is not
        # allowed while a stream captures
        collect = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.outputs = tuple(fn(**self.inputs))
        finally:
            if collect:
                gc.enable()
        #: kernel launches of one replay, by counter
        self.launches = [c - b for c, b in zip(KERNEL_COUNTERS, before)]
        _add_counts(self.launches, -1)        # the capture launched nothing
        self.host_out = tuple(torch.empty(o.shape, dtype=o.dtype,
                                          pin_memory=True)
                              for o in self.outputs)

    def replay(self, host_inputs: Dict[str, np.ndarray]
               ) -> Tuple[np.ndarray, ...]:
        """Run the step on ``host_inputs`` (numpy, the capture's shapes
        and dtypes); returns its outputs as numpy after one sync."""
        for k, a in host_inputs.items():
            self.staging[k].numpy()[...] = a
            self.inputs[k].copy_(self.staging[k], non_blocking=True)
        self.graph.replay()
        _add_counts(self.launches, +1)
        for h, o in zip(self.host_out, self.outputs):
            h.copy_(o, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return tuple(h.numpy().copy() for h in self.host_out)
