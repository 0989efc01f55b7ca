"""Host-side statistics helpers (the port's copy of ``repro.core.stats``)."""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

__all__ = ["percentile"]


def percentile(samples: Iterable[Optional[float]], p: float) -> float:
    """Percentile that is safe on empty and singleton samples.

    ``None`` entries are dropped; an empty window reports 0.0 instead of
    raising; a single sample reports itself for every percentile."""
    kept = [s for s in samples if s is not None]
    if not kept:
        return 0.0
    if len(kept) == 1:
        return float(kept[0])
    return float(np.percentile(kept, p))
