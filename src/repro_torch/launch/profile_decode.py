"""Where a fused decode step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \
        [--arch qwen1.5-0.5b|mamba2-130m|llama2-7b] [--steps 10] \
        [--speculate off|ngram] [--repetitive] [--eager]

Serves the arch at full width (seeded random weights) with eight running
requests (prompts of 64/256/1000 tokens, cycled; ``--repetitive`` tiles
one random 8-token pattern instead, the trace on which the n-gram
proposer fires), runs ``Engine.warmup`` for the trace's table buckets
(each step kind's CUDA graphs; ``--eager`` dispatches every op from the
host instead), warms up, then times ``--steps`` decode steps twice: on
the host clock without a profiler (wall per step: mean, min, median,
max; tokens per step), and under ``torch.profiler`` (device busy time per
step, the device's idle share, the device's kernels per step beside the
host's launch calls per step (graph launches, kernel launches, copies),
and device time by kernel). With ``--speculate ngram`` every decode step
is a verify step of up to depth + 1 tokens a row. Prints the card's name
and power limit first; needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from collections import defaultdict
from typing import List, Optional

# the CUDA API calls by which the host starts device work
_HOST_CALLS = {"cudaGraphLaunch": "graph launches",
               "cudaLaunchKernel": "kernel launches",
               "cuLaunchKernel": "kernel launches",
               "cudaLaunchKernelExC": "kernel launches",
               "cuLaunchKernelEx": "kernel launches",
               "cudaMemcpyAsync": "copies"}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--speculate", default="off", choices=("off", "ngram"))
    ap.add_argument("--repetitive", action="store_true")
    ap.add_argument("--eager", action="store_true",
                    help="dispatch each op from the host (no CUDA graphs)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.core.perfscope import format_classes, kernel_classes
    from repro_torch.data.pipeline import (repetitive_requests,
                                           serving_requests)
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, Request

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = get_config(args.arch)
    params = LM(cfg, device=dev).init(0)
    eng = Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                 speculate=args.speculate, device=dev,
                 cuda_graphs=not args.eager)
    warm = 3
    prompts = (repetitive_requests(8, cfg.vocab_size, prompt_len=256)
               if args.repetitive else
               serving_requests(8, cfg.vocab_size,
                                prompt_lens=[64, 256, 1000]))
    max_new = (4 + warm + 2 * args.steps) * (
        1 + eng.spec.depth if eng.spec else 1)
    lens = sorted({len(p) for p in prompts})
    eng.warmup(max(lens) + max_new, prompt_lens=lens)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
    for _ in range(1 + warm):          # whole-prompt prefill, then decode
        eng.step()
    if sum(r is not None for r in eng.sched.running) != 8:
        raise RuntimeError("expected eight running requests")
    torch.cuda.synchronize()
    tok0 = eng.decode_tokens
    walls = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        eng.step()                     # ends in the step's one sync
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    wall = sum(walls) / args.steps
    walls.sort()
    per_step = (eng.decode_tokens - tok0) / args.steps
    traces = sum(eng.trace_counts.values())

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            eng.step()
        torch.cuda.synchronize()
    wall_prof = (time.perf_counter() - t0) / args.steps

    by_name = defaultdict(lambda: [0.0, 0])
    host = defaultdict(int)            # launch calls of the host, by kind
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name][0] += e.time_range.elapsed_us()
            by_name[e.name][1] += 1
        elif e.name in _HOST_CALLS:
            host[_HOST_CALLS[e.name]] += 1
    busy = sum(v[0] for v in by_name.values()) / 1e3 / args.steps
    n_kernels = sum(v[1] for v in by_name.values()) / args.steps
    ours = {name: sum(v[0] for k, v in by_name.items()
                      if kernel in k) / 1e3 / args.steps
            for name, kernel in (("paged_attention", "paged_mq_kernel"),
                                 ("ssd", "ssd_chunk_scan"),
                                 ("rmsnorm", "rmsnorm_kernel"))}
    cache = "bf16 KV" if cfg.n_kv_heads else "f32 SSM states"
    spec = (f"speculate {args.speculate}, "
            f"accept_rate {eng.stats().get('accept_rate', 0.0):.3f}, "
            if args.speculate != "off" else "")
    dispatch = ("eager (host dispatch)" if args.eager else
                f"graph replay ({len(eng._graphs)} graphs, {traces} "
                f"captures, all in warmup)")
    print(f"[profile] {card} | {cfg.name} full width, 8 rows, {cache}, "
          f"{'repetitive' if args.repetitive else 'random'} prompts, "
          f"{spec}{dispatch}, {args.steps} steps, {per_step:.2f} tokens "
          f"per step")
    spread = (f"min/median/max {walls[0] * 1e3:.2f}/"
              f"{walls[len(walls) // 2] * 1e3:.2f}/{walls[-1] * 1e3:.2f} ms")
    if not by_name:
        print("[profile] device time: not measured (the profiler recorded "
              f"no device events); wall per step {wall * 1e3:.2f} ms "
              f"({spread})")
        return
    calls = ", ".join(f"{kind} {host[kind] / args.steps:.0f}"
                      for kind in ("graph launches", "kernel launches",
                                   "copies"))
    # the profiler slows the host, not the device: the idle share is the
    # busy time against the unprofiled wall time
    print(f"[profile] wall per decode step {wall * 1e3:.2f} ms ({spread}; "
          f"{wall_prof * 1e3:.2f} ms under the profiler); device busy "
          f"{busy:.2f} ms per step, idle share "
          f"{max(0.0, 1 - busy / (wall * 1e3)) * 100:.1f}%; "
          f"{n_kernels:.0f} device kernels per step against the host's "
          f"launch calls per step: {calls}; "
          + "; ".join(f"{name} {ms:.2f} ms per step ({ms / busy * 100:.1f}% "
                      f"of busy)" for name, ms in ours.items()))
    print("[profile] by class (ms per step, launches per step): "
          + format_classes(kernel_classes(by_name, args.steps)))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    for name, (us, n) in top:
        print(f"[profile]   {us / 1e3 / args.steps:8.3f} ms/step "
              f"{n / args.steps:6.1f}/step  {name[:110]}")


if __name__ == "__main__":
    main()
