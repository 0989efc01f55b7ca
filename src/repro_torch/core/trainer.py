"""End-to-end Trainer (the port of ``repro.core.trainer``): synthetic
data -> train step -> metrics, on one device.

Each step is timed on the host clock and fenced by a device sync, so its
time includes its device work. SIGTERM stops the loop at the next step
boundary. Checkpointing (``checkpoint_dir``/``resume``) waits for the
port of ``checkpoint/manager.py`` and raises until then.
"""
from __future__ import annotations

import dataclasses
import signal
from typing import Any, Dict, Optional, Union

import torch

from repro_torch.core.config import ArchConfig, ShapeSpec, Technique
from repro_torch.core.perfscope import Timer
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.launch.build import build_train
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import init_train_state


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_dir: Optional[str] = None   # not ported yet: raises
    resume: str = "none"           # none | auto (not ported yet: raises)
    seed: int = 0


class Trainer:
    """``device`` is the card unless the caller passes ``"cpu"``."""

    def __init__(self, cfg: ArchConfig, shape: ShapeSpec,
                 technique: Technique, tcfg: TrainerConfig,
                 opt_cfg: Optional[AdamWConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        if tcfg.checkpoint_dir is not None or tcfg.resume != "none":
            raise NotImplementedError(
                "checkpointing is not ported yet (checkpoint/manager.py, "
                "ROADMAP queue 1 item 5)")
        self.cfg, self.shape, self.tcfg = cfg, shape, tcfg
        step_fn, self.technique, self.model, self.opt_cfg = build_train(
            cfg, technique, opt_cfg, device=device)
        self.device = self.model.device
        self.step_fn = step_fn
        self.state = init_train_state(self.model, self.technique, tcfg.seed,
                                      self.opt_cfg)[0]
        self.data = SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
            global_batch=shape.global_batch, seed=tcfg.seed))
        self.timer = Timer()
        self._interrupted = False
        # SIGTERM (preemption) -> stop at the step boundary
        try:
            signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            pass  # not in main thread (tests)

    def _on_sigterm(self, *_):
        self._interrupted = True

    def _batch_for(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch_at(step).items()}

    def run(self) -> Dict[str, Any]:
        history = []
        step = 0
        fence = (None if self.device.type != "cuda" else
                 lambda: torch.cuda.synchronize(self.device))
        while step < self.tcfg.steps and not self._interrupted:
            batch = self._batch_for(step)
            with self.timer.region("step", fence=fence):
                self.state, metrics = self.step_fn(self.state, batch)
            step += 1
            if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                history.append(m)
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
