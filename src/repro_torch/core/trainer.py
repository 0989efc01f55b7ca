"""End-to-end Trainer (the port of ``repro.core.trainer``): synthetic
data -> train step -> metrics -> checkpoint/restart, on one device or as
one rank of a mesh (``mesh=``, a ``launch.mesh.Mesh``: a data axis, a
model axis, or both).

Each step is timed on the host clock and fenced by a device sync, so its
time includes its device work. With a ``checkpoint_dir`` the state is
saved every ``checkpoint_every`` steps (in a background thread when
``async_checkpoint``), ``resume="auto"`` restores the latest committed
step and continues the data stream from it (``SyntheticLM.batch_at`` is
a function of the step), and SIGTERM ends the loop at the next step
boundary with a blocking emergency save. ``run()`` returns after the
writer has finished.

Over a data axis each rank steps on its rows of ``SyntheticLM.batch_at``
(``ShardCtx.batch_sharding``), the metrics are global (equal on every
rank) and ``tokens_per_s`` counts the global batch. A checkpoint holds
the logical (whole) state, gathered from every rank's part and written
by rank 0 (``train.step.logical_train_state``); a restore cuts it to the
placement of the run that reads it, on any number of ranks or on one
device. The ranks agree on a SIGTERM at each step boundary. The SIGTERM
handler is ``run()``'s only. Over a model axis each rank of a model row
steps on the same rows; checkpoints there raise (ROADMAP queue 1 item
7.12).
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.config import ArchConfig, ShapeSpec, Technique
from repro_torch.core.perfscope import Timer
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.build import build_train
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import (DPLayout, distributed,
                                    init_train_state, logical_train_state)


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    resume: str = "none"           # none | auto
    seed: int = 0
    async_checkpoint: bool = True


class Trainer:
    """``device`` is the card unless the caller passes ``"cpu"``; with a
    ``mesh`` it is the mesh's."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec,
                 technique: Technique, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None,
                 mesh=None):
        if tcfg.resume not in ("none", "auto"):
            raise ValueError(f"resume {tcfg.resume!r} not 'none' or 'auto'")
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        step_fn, self.technique, self.model, self.opt_cfg = build_train(
            cfg, technique, opt_cfg, device=device, mesh=mesh, shape=shape)
        self.device = self.model.device
        self.ctx = self.model.ctx
        self.dp = distributed(self.ctx)
        if tcfg.checkpoint_dir and self.ctx is not None and \
                self.ctx.size > 1:
            raise NotImplementedError(
                "checkpoints under a model axis (the TP pieces gathered "
                "into the logical state and cut again on restore) are not "
                "ported: ROADMAP queue 1 item 7.12")
        self.layout = (DPLayout(self.model, self.technique, self.ctx)
                       if self.dp else None)
        self.step_fn = step_fn
        self.state = init_train_state(self.model, self.technique, tcfg.seed,
                                      self.opt_cfg, ctx=self.ctx)[0]
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=tcfg.seed))
        self.ckpt = (CheckpointManager(tcfg.checkpoint_dir)
                     if tcfg.checkpoint_dir else None)
        self.timer = Timer()
        self.start_step = 0
        self._interrupted = False
        if tcfg.resume == "auto" and self.ckpt and \
                self.ckpt.latest_step() is not None:
            self.state, self.start_step = self.ckpt.restore(
                self.state, piece=self._piece if self.dp else None)

    def _on_sigterm(self, *_):
        self._interrupted = True

    def _piece(self, path: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a stored whole leaf."""
        return self.layout.piece(path, whole)

    def _batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        batch = self.data.batch_at(step)
        if self.dp:
            lo, hi = self.ctx.batch_sharding(self.shape.global_batch)
            batch = {k: v[lo:hi] for k, v in batch.items()}
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch.items()}

    def _stop(self) -> bool:
        """Whether to stop at this step boundary: a SIGTERM seen here or,
        over a data axis with checkpoints, on any rank."""
        if not (self.dp and self.ckpt):
            return self._interrupted
        flag = torch.tensor([float(self._interrupted)], device=self.device)
        return bool(self.ctx.dp_all_reduce(flag)[0] > 0)

    def save(self, step: int, blocking: bool) -> None:
        """Checkpoint the state of ``step``: over a data axis the logical
        state, gathered by every rank, written by rank 0."""
        if not self.dp:
            self.ckpt.save(step, self.state, blocking=blocking)
            return
        whole = logical_train_state(self.state, self.layout, self.ctx,
                                    self.device)
        if self.ctx.dp_rank == 0:
            self.ckpt.save(step, whole, blocking=blocking)

    def run(self) -> Dict[str, Any]:
        """The steps from ``start_step``. SIGTERM (preemption) during the
        run ends it at the next step boundary with an emergency
        checkpoint: the handler is installed here and the previous one
        restored on return, so no handler keeps a dropped ``Trainer``
        (and its state on the card) alive."""
        try:
            previous = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            return self._run()      # not the main thread: no handler
        try:
            return self._run()
        finally:
            # None: a handler not set from Python, which cannot be put back
            signal.signal(signal.SIGTERM, signal.SIG_DFL
                          if previous is None else previous)

    def _run(self) -> Dict[str, Any]:
        history = []
        step = self.start_step
        fence = (None if self.device.type != "cuda" else
                 lambda: torch.cuda.synchronize(self.device))
        while step < self.tcfg.steps and not self._stop():
            batch = self._batch_for(step)
            with self.timer.region("step", fence=fence):
                self.state, metrics = self.step_fn(self.state, batch)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                history.append(m)
            if self.ckpt and step % self.tcfg.checkpoint_every == 0:
                self.save(step, blocking=not self.tcfg.async_checkpoint)
        if self.ckpt and self._stop():
            self.save(step, blocking=True)
        if self.ckpt:
            self.ckpt.wait()
            if self.dp:
                self.ctx.dp_barrier()       # rank 0's save is committed
        tokens_per_step = self.shape.global_batch * self.shape.seq_len
        times = self.timer.summary()
        step_ms = times.get("step", {}).get("mean_ms", 0.0)
        return {
            "history": history,
            "final_step": step,
            "tokens_per_s": (tokens_per_step / (step_ms / 1e3)
                             if step_ms else 0.0),
            "step_ms": step_ms,
        }
