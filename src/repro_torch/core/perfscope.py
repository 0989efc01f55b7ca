"""Wall-clock regions (the port's copy of ``repro.core.perfscope.Timer``'s
``region`` and ``summary``)."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np


class Timer:
    def __init__(self):
        self.records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def region(self, name: str, fence: Optional[Callable[[], None]] = None):
        """Time a ``with`` region. ``fence`` (optional) is a zero-arg
        callable run before the clock stops — pass a device sync to
        charge the region with its queued device work."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                fence()
            self.records[name].append(time.perf_counter() - t0)

    def summary(self, drop_warmup: int = 1) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, ts in self.records.items():
            ts = ts[drop_warmup:] if len(ts) > drop_warmup else ts
            out[name] = {
                "mean_ms": float(np.mean(ts)) * 1e3,
                "std_ms": float(np.std(ts)) * 1e3,
                "calls": len(ts),
            }
        return out
