"""Meshes of ``torch.distributed`` ranks and their launcher (the port of
``repro.launch.mesh``).

The reference builds a jax ``Mesh`` over the devices of one process. The
port runs one process per rank: :func:`spawn_ranks` starts ``data x
model`` of them with the ``spawn`` start method (CUDA cannot fork), each
joins one process group through a ``file://`` rendezvous in a fresh
temporary directory (parallel test workers never race for a TCP port)
and calls :func:`make_local_mesh`, which returns the :class:`Mesh` the
serving engine (a model axis) or the trainer (a data axis, a model axis
or both) takes. Ranks lie as ``jax.make_mesh((data, model), ("data",
"model"))`` lays devices out: global rank ``d * model + m``
(:func:`mesh_groups`); on a 2-D mesh each model row and each data column
is a process group of its own. The backend is
always the caller's: ``nccl`` needs one card per rank and raises where
ranks would share one; ``gloo`` runs the CPU tests and ranks that share
card 0 (on CUDA tensors gloo stages each collective through the host).
Rank ``r`` computes on ``cuda:(r % device_count)`` or, when the caller
says so, on the CPU (``core.device.rank_device``); the launcher prints
the mapping before it starts the ranks.
"""
from __future__ import annotations

import dataclasses
import queue
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.core.device import rank_device

# a collective that waits longer than this fails the rank (a peer died)
COLLECTIVE_TIMEOUT_S = 300
# the launcher gives up on ranks that report nothing for this long
RANK_TIMEOUT_S = 1800


@dataclasses.dataclass
class Mesh:
    """A ``data`` x ``model`` mesh of ranks, seen from one of them:
    ``rank`` is its index on the model axis, ``ranks`` the global ranks of
    its model group ``group`` (its row of the mesh); ``data_rank``,
    ``data_ranks`` and ``data_group`` are the same on the data axis (its
    column); ``device`` is where it computes and ``comm_device`` where
    host values travel for a collective (the CPU under gloo, its card
    under nccl). An axis of one rank has no group (``None``); an axis
    that spans the world uses the world's group."""
    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    rank: int
    ranks: Tuple[int, ...]
    group: object
    backend: str
    device: torch.device
    comm_device: torch.device
    data_rank: int = 0
    data_ranks: Tuple[int, ...] = (0,)
    data_group: object = None


def mesh_groups(model: int, data: int
                ) -> Tuple[List[List[int]], List[List[int]]]:
    """``(model rows, data columns)``: the global ranks of each model
    group (row ``d``: ``d * model + m`` over ``m``) and of each data group
    (column ``m``: ``d * model + m`` over ``d``)."""
    rows = [[d * model + m for m in range(model)] for d in range(data)]
    cols = [[d * model + m for d in range(data)] for m in range(model)]
    return rows, cols


def make_local_mesh(model: int = 1, data: int = 1, *, backend: str,
                    rank: int, init_method: str,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Mesh:
    """Join the process group of ``model * data`` ranks as global rank
    ``rank`` (at ``init_method``, unless this process has joined already)
    and return its mesh. The serving engine takes ``data=1``: a pure
    model-parallel mesh whose model group is the whole world; the trainer
    takes either axis or both. With both above 1 every rank makes one
    group per model row and one per data column (:func:`mesh_groups`),
    all in the same order, as ``new_group`` requires, and keeps its own
    row and column."""
    world = model * data
    dev = rank_device(rank, world, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if dist.get_world_size() != world:
        raise ValueError(f"the process group has {dist.get_world_size()} "
                         f"ranks, the mesh {world}")
    g = dist.get_rank()
    rows, cols = mesh_groups(model, data)
    d, m = divmod(g, model)
    row_group = col_group = dist.group.WORLD
    if model > 1 and data > 1:
        row_groups = [dist.new_group(r) for r in rows]
        col_groups = [dist.new_group(c) for c in cols]
        row_group, col_group = row_groups[d], col_groups[m]
    return Mesh(shape={"data": data, "model": model},
                axis_names=("data", "model"), rank=m,
                ranks=tuple(rows[d]),
                group=row_group if model > 1 else None,
                backend=backend, device=dev,
                comm_device=dev if backend == "nccl" else torch.device("cpu"),
                data_rank=d, data_ranks=tuple(cols[m]),
                data_group=col_group if data > 1 else None)


def mesh_layout(mesh: Mesh) -> dict:
    """The mesh's shape and axes, its device count, and this rank's place
    on both axes: its model row and data column, by global rank."""
    return {"shape": dict(mesh.shape), "axes": list(mesh.axis_names),
            "devices": int(mesh.shape["data"] * mesh.shape["model"]),
            "model_rank": mesh.rank, "data_rank": mesh.data_rank,
            "row": list(mesh.ranks), "column": list(mesh.data_ranks)}


def _rank_main(rank: int, model: int, data: int, backend: str,
               init_method: str, device, threads: Optional[int],
               fn: Callable, args: Sequence, results) -> None:
    """One rank: join the mesh, run ``fn(mesh, *args)``, report its
    result (or its traceback) to the launcher."""
    try:
        if threads is not None:
            torch.set_num_threads(threads)
        mesh = make_local_mesh(model=model, data=data, backend=backend,
                               rank=rank, init_method=init_method,
                               device=device)
        out = fn(mesh, *args)
        dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    results.put((rank, True, out))


def spawn_ranks(fn: Callable, model: int = 1, *, data: int = 1,
                backend: str,
                device: Optional[Union[str, torch.device]] = None,
                args: Sequence = (), threads: Optional[int] = None) -> List:
    """Run ``fn(mesh, *args)`` on the ``data x model`` ranks of a mesh of
    that shape, one process each, and return their results in global
    rank order. ``fn`` and ``args`` cross to the ranks by pickling
    (``fn`` by import path). On the card the CUDA kernels are built here
    first, once, so no two ranks build into the build directory at once.
    A rank that raises or dies fails the run: the others are terminated
    and the error names the rank, with its traceback. ``threads`` sets
    each rank's intra-op thread count. The device and backend checks of
    ``rank_device`` run here first."""
    n = model * data
    devs = [rank_device(r, n, backend, device) for r in range(n)]
    print(f"[mesh] {n} ranks ({data} data x {model} model), backend "
          f"{backend}: " + ", ".join(
              f"rank {r} -> {d}" for r, d in enumerate(devs)), flush=True)
    if devs[0].type == "cuda":
        from repro_torch.kernels import _build
        _build.build_all()
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_mesh_") as tmp:
        init = f"file://{tmp}/rendezvous"
        procs = [ctx.Process(target=_rank_main, args=(
                     r, model, data, backend, init, device, threads, fn,
                     tuple(args), results)) for r in range(n)]
        for p in procs:
            p.start()
        got: Dict[int, object] = {}
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while len(got) < n:
                try:
                    rank, ok, val = results.get(timeout=1.0)
                except queue.Empty:
                    gone = {r: p.exitcode for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got}
                    if not gone:
                        if time.monotonic() > deadline:
                            raise TimeoutError(
                                f"ranks {sorted(set(range(n)) - set(got))} "
                                f"gave no result within {RANK_TIMEOUT_S}s"
                            ) from None
                        continue
                    try:            # what it sent before it exited
                        rank, ok, val = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank(s) {sorted(gone)} exited (codes "
                            f"{gone}) without a result") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{val}")
                got[rank] = val
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    return [got[r] for r in range(n)]
