"""Wall-clock regions (the port's copy of ``repro.core.perfscope.Timer``'s
``region`` and ``summary``), and the profiles' kernel classes."""
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


# (class, name fragments) in match order: cuBLAS names its bf16-operand
# GEMMs nvjet_t* (f32 sums) or *gemm_bf16*, its f32 ones *sgemm*,
# *f32f32_f32f32*, nvjet_s* or, batched over few rows (the MoE experts'
# down projection), gemmSN_*_kernel<float
KERNEL_CLASSES = (
    ("the port's CUDA kernels", ("paged_mq_kernel", "ssd_chunk_scan",
                                 "rmsnorm_kernel", "dense_decode_kernel",
                                 "fwd_kernel", "fwd_mma_kernel", "bwd_dkv",
                                 "bwd_dq", "qmm_kernel", "qmm_mma_kernel")),
    ("split-K reductions", ("splitKreduce",)),
    ("tensor-core GEMMs", ("nvjet_t", "gemm_bf16", "bf16gemm")),
    ("f32 GEMMs", ("sgemm", "f32f32_f32f32", "nvjet_s",
                   "gemmSN_NN_kernel<float", "gemmSN_TN_kernel<float")),
    ("casts and copies", ("copy_kernel", "Memcpy")),
)


def kernel_classes(by_name: Dict[str, List[float]], steps: int
                   ) -> Dict[str, List[float]]:
    """Device time (ms per step) and launches per step of each kernel
    class, from ``{kernel name: [us, count]}`` over ``steps`` steps; what
    no class names is "other"."""
    out = {name: [0.0, 0.0] for name, _ in KERNEL_CLASSES}
    out["other"] = [0.0, 0.0]
    for kname, (us, n) in by_name.items():
        cls = next((name for name, frags in KERNEL_CLASSES
                    if any(f in kname for f in frags)), "other")
        out[cls][0] += us / 1e3 / steps
        out[cls][1] += n / steps
    return out


def format_classes(classes: Dict[str, List[float]]) -> str:
    return "; ".join(f"{name} {ms:.2f} ms ({n:.0f})"
                     for name, (ms, n) in classes.items())
