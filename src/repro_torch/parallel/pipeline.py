"""Pipeline parallelism: a GPipe schedule of microbatches over the stages
of a layer stack (the port of ``repro.parallel.pipeline``).

The layer stack is split into S stages of L/S layers (:func:`split_stages`),
stage s on rank s of the pipe axis. The schedule is the reference's: M + S
- 1 ticks; at tick t rank 0 takes microbatch t (zeros once they run out),
every other rank the activations its predecessor made at tick t - 1, each
runs its stage, and the last stage emits microbatch t - (S - 1); the
activations then shift one rank along the ring. ``bubble_fraction`` is
(S - 1)/(M + S - 1), the share of ticks a stage idles.

**The pipe axis is the mesh's model axis.** The reference maps the
schedule onto a ``pipe`` axis of a jax mesh with ``shard_map``;
``launch.mesh`` names no axis of that name, so :func:`pipeline_forward`
takes the model-axis group of a ``launch.mesh.Mesh`` (its ``group``,
``rank`` and ``shape["model"]``) as its pipe group: stage s runs on model
rank s.

**Collectives.** gloo offers only ``broadcast`` and ``all_reduce`` on CUDA
tensors, so the ring shift (the reference's ``ppermute``) is one
``all_reduce`` of a zero int32 buffer of S slots: each rank writes its
activations' bytes into its own slot and reads its predecessor's. The
outputs, which only the last stage writes, are summed over the axis the
same way. An integer sum of one value and zeros is that value, so every
value arrives bit for bit. The module is forward only, as the
reference's is.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map
from repro_torch.parallel.sharding import MODEL, _from_words, _words


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """The share of a GPipe schedule's M + S - 1 ticks a stage idles."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def split_stages(stacked, n_stages: int):
    """Reshape scan-stacked (L, ...) leaves into (S, L/S, ...)."""
    def f(a):
        n = a.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape(n_stages, n // n_stages, *a.shape[1:])
    return tree_map(f, stacked)


def pipeline_forward(mesh, axis: str, stage_fn: Callable, n_micro: int,
                     timer=None) -> Callable:
    """``fwd(stage_params, x_micro)`` running the GPipe schedule over the
    ranks of ``mesh``'s ``axis`` (its model axis: module notes).

    ``stage_params``: a tree whose leaves lead with the stage dim
    (:func:`split_stages`); this rank runs ``stage_fn(its stage's params,
    activations)``. ``x_micro``: (n_micro, mb, ...) on every rank (only
    rank 0 reads it). Returns the (n_micro, mb, ...) outputs of the last
    stage on every rank. With a ``timer`` (a ``core.perfscope.Timer``)
    each stage's run is timed as ``"tick"`` and each ring shift as
    ``"shift"``, each between two synchronizes on a CUDA device."""
    if axis != MODEL:
        raise ValueError(f"the pipe axis is the mesh's {MODEL!r} axis, not "
                         f"{axis!r}")
    n_stages = int(mesh.shape[axis])
    rank = mesh.rank if n_stages > 1 else 0

    def region(name, like):
        if timer is None:
            return contextlib.nullcontext()
        fence = ((lambda: torch.cuda.synchronize(like.device))
                 if like.is_cuda else None)
        if fence is not None:
            fence()
        return timer.region(name, fence=fence)

    def total(buf: torch.Tensor) -> torch.Tensor:
        if n_stages > 1:
            dist.all_reduce(buf, group=mesh.group)
        return buf

    def shift(y: torch.Tensor) -> torch.Tensor:
        """The predecessor's activations (rank 0 reads the last
        stage's, which it never uses)."""
        if n_stages == 1:
            return y
        words = _words(y)
        buf = words.new_zeros((n_stages, words.numel()))
        buf[rank] = words
        total(buf)
        return _from_words(buf[(rank - 1) % n_stages], y.dtype, y.shape)

    def fwd(stage_params, x_micro: torch.Tensor) -> torch.Tensor:
        p = tree_map(lambda a: a[rank], stage_params)
        mb_shape = tuple(x_micro.shape[1:])
        buf = x_micro.new_zeros(mb_shape)
        outputs = x_micro.new_zeros((n_micro,) + mb_shape)
        n_ticks = n_micro + n_stages - 1
        for t in range(n_ticks):
            if rank == 0:
                cur = (x_micro[t] if t < n_micro
                       else x_micro.new_zeros(mb_shape))
            else:
                cur = buf
            with region("tick", x_micro):
                y = stage_fn(p, cur)
            out_idx = t - (n_stages - 1)
            if rank == n_stages - 1 and 0 <= out_idx < n_micro:
                outputs[out_idx] = y
            if t + 1 < n_ticks:         # the last tick's shift feeds nothing
                with region("shift", y):
                    buf = shift(y)
        if n_stages == 1:
            return outputs
        return _from_words(total(_words(outputs).clone()), outputs.dtype,
                           outputs.shape)

    return fwd
