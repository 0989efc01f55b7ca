"""Checkpointing with atomic commit, async save and retention (the port
of ``repro.checkpoint.manager``), in the reference's on-disk layout.

A checkpoint of step N is the directory ``step_{N:09d}``: one
``leaf_{i:05d}.npy`` per tensor leaf, a ``manifest.json`` of ``{step,
leaves: [{path, file, shape, dtype, stored_dtype}]}`` and a ``COMMITTED``
marker. Everything is written to ``step_{N:09d}.tmp``, the marker last,
then renamed, so discovery ignores a save cut short. bf16 leaves are
stored as their uint16 bit patterns, with ``dtype`` naming the logical
type.

Leaves are numbered in the reference's flatten order (dict keys sorted,
a node's fields in their registered order) and named by the reference's
key strings: ``['params']['blocks']['pos0']['mix']['wq']``, a
``QTensor``'s fields as ``.data``/``.scale``/``.scale2[0]``, a
``LoRATensor``'s as ``.base.data``/``.a``/``.b`` and an ``Opt8``'s as
``[<flat index 0>]`` (codes) and ``[<flat index 1>]`` (scales). So each
package reads the other's checkpoints.

``save`` snapshots the state to host memory first (on a card: pinned
buffers filled on the current stream, then ONE sync), so training may
update the state in place while a background thread writes the
snapshot; one save is in flight at a time. A data-parallel run saves
its logical (whole) state, and ``restore(piece=)`` cuts each stored leaf
to the part a rank holds.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import keystr_map, keystr_paths

COMMIT_MARKER = "COMMITTED"


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor's bits as numpy: bf16 as its uint16 view."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype != str(arr.dtype):
        raise ValueError(f"stored {arr.dtype} for a {dtype} leaf")
    return torch.from_numpy(arr)


def snapshot(tree) -> List[Tuple[str, torch.Tensor]]:
    """Host copies of every leaf, in flatten order. Device leaves go to
    pinned buffers, all copies queued on the current stream, then one
    sync; host leaves are cloned (the step updates them in place)."""
    out, cuda = [], False
    for path, t in keystr_paths(tree):
        t = t.detach()
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            cuda = True
        else:
            host = t.clone()
        out.append((path, host))
    if cuda:
        torch.cuda.current_stream().synchronize()
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._save_thread: Optional[threading.Thread] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    # ------------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = True) -> None:
        """Snapshot ``state`` to host memory, then write and commit it,
        in a background thread unless ``blocking`` (which waits for a
        save in flight first)."""
        host = snapshot(state)

        def _write():
            tmp = self._step_dir(step) + ".tmp"
            final = self._step_dir(step)
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "leaves": []}
            for i, (path, t) in enumerate(host):
                fname = f"leaf_{i:05d}"
                arr = _to_numpy(t)
                np.save(os.path.join(tmp, fname + ".npy"), arr)
                manifest["leaves"].append(
                    {"path": path, "file": fname, "shape": list(arr.shape),
                     "dtype": _dtype_name(t.dtype),
                     "stored_dtype": str(arr.dtype)})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            with open(os.path.join(tmp, COMMIT_MARKER), "w") as f:
                f.write(str(time.time()))
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        self.wait()                      # backpressure: one save in flight
        if blocking:
            _write()
        else:
            self._save_thread = threading.Thread(target=_write, daemon=True)
            self._save_thread.start()

    def wait(self) -> None:
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in sorted(os.listdir(self.dir)):
            if not name.startswith("step_") or name.endswith(".tmp"):
                continue
            if os.path.exists(os.path.join(self.dir, name, COMMIT_MARKER)):
                out.append(int(name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None, *,
                piece=None):
        """``(state, step)``: a new tree of ``state_like``'s structure with
        each leaf read from the checkpoint of ``step`` (default: the
        latest committed) onto that leaf's device (pinned where the leaf
        is), ``requires_grad`` as the leaf has it. ``piece(path, whole)``,
        where given, cuts each stored (logical, whole) leaf to the part
        ``state_like`` holds, before the shapes are checked: a rank of a
        data-parallel run restores its shards from any run's save."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_path = {leaf["path"]: leaf for leaf in manifest["leaves"]}

        def load(path, like):
            meta = by_path[path]
            arr = np.load(os.path.join(d, meta["file"] + ".npy"))
            t = _from_numpy(arr, meta["dtype"])
            if piece is not None:
                t = piece(path, t)
            if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
                raise ValueError(
                    f"{path}: checkpoint holds {meta['dtype']} "
                    f"{tuple(t.shape)}, the state {like.dtype} "
                    f"{tuple(like.shape)}")
            t = t.to(like.device)
            if like.device.type == "cpu" and like.is_pinned():
                t = t.pin_memory()
            return t.requires_grad_(like.requires_grad)

        return keystr_map(load, state_like), step
