"""Where a training step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train [--steps 2] \
        [--technique QL+Q8+F+R]

Trains full-width qwen1.5-0.5b (seeded random weights) with
``--technique`` (default F+R: flash kernels, full recomputation;
QL+Q8+F+R fine-tunes LoRA adapters on an int8 base through the int8
kernel) at batch 4 x 2048 tokens, the shape of ``chip_smoke.py``'s
training phases. After one warm-up step it times
``--steps`` steps three ways: on the host clock without a profiler (wall
per step); split into its layers by the train step's own timed regions,
each fenced by a device sync (forward: the loss; backward: the gradient;
optimizer: the AdamW update); and under ``torch.profiler`` (device busy
time per step, the device's idle share, kernels per step, and device time
by kernel). Prints the card's name and power limit first; needs a CUDA
device.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--technique", default="F+R")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.config import technique_from_label
    from repro_torch.core.device import resolve_device
    from repro_torch.core.perfscope import Timer, format_classes, kernel_classes
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.build import make_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_config("qwen1.5-0.5b")
    tech = technique_from_label(args.technique)
    model = make_model(cfg, tech, device=dev)
    opt = AdamWConfig()
    state, _ = init_train_state(model, tech, 0, opt)
    step = build_train_step(model, tech, opt)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch))
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in data.batch_at(0).items()}

    state, _ = step(state, batch)               # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps

    # the same step with its layers timed, each fenced (host clock)
    timer = Timer()
    timed_step = build_train_step(model, tech, opt, timer=timer)
    for _ in range(args.steps):
        state, _ = timed_step(state, batch)
    split = {k: v["mean_ms"] for k, v in
             timer.summary(drop_warmup=0).items()}

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    wall_prof = (time.perf_counter() - t0) / args.steps

    by_name = defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
    print(f"[profile] {card} | qwen1.5-0.5b full width, {args.technique}, "
          f"batch {args.batch} x {args.seq}, {args.steps} steps, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"[profile] layers (fenced, host clock): forward "
          f"{split['forward']:.1f} ms, backward (recompute included) "
          f"{split['backward']:.1f} ms, optimizer "
          f"{split['optimizer']:.1f} ms per step")
    if not by_name:
        print("[profile] device time: not measured (the profiler recorded "
              f"no device events); wall per step {wall * 1e3:.2f} ms")
        return
    busy = sum(v[0] for v in by_name.values()) / 1e3 / args.steps
    n_kernels = sum(v[1] for v in by_name.values()) / args.steps
    flash = sum(v[0] for k, v in by_name.items()
                if "fwd_kernel" in k or "fwd_mma_kernel" in k
                or "bwd_dkv" in k or "bwd_dq" in k) / 1e3 / args.steps
    int8 = sum(v[0] for k, v in by_name.items()
               if "qmm_kernel" in k or "qmm_mma_kernel" in k
               ) / 1e3 / args.steps
    # the profiler slows the host, not the device: the idle share is the
    # busy time against the unprofiled wall time
    print(f"[profile] wall per train step {wall * 1e3:.2f} ms "
          f"({wall_prof * 1e3:.2f} ms under the profiler), "
          f"{args.batch * args.seq / wall:.0f} tokens/s; device busy "
          f"{busy:.2f} ms per step, idle share "
          f"{max(0.0, 1 - busy / (wall * 1e3)) * 100:.1f}%; "
          f"{n_kernels:.0f} kernels per step; flash kernels "
          f"{flash:.2f} ms per step ({flash / busy * 100:.1f}% of busy); "
          f"int8 kernel {int8:.2f} ms per step ({int8 / busy * 100:.1f}% "
          f"of busy)")
    print("[profile] by class (ms per step, launches per step): "
          + format_classes(kernel_classes(by_name, args.steps)))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    for name, (us, n) in top:
        print(f"[profile]   {us / 1e3 / args.steps:9.3f} ms/step "
              f"{n / args.steps:7.1f}/step  {name[:110]}")


if __name__ == "__main__":
    main()
