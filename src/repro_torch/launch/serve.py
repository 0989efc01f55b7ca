"""Serving launcher CLI of the port: the continuous-batching engine over a
synthetic burst, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
        --requests 16 --int8-kv                # fused paged decode
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --prefill-chunk 16                     # paged chunked prefill
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
        --prefill-chunk 16 --device cpu        # attention-free SSM arch
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch qwen3-moe-30b-a3b|jamba-v0.1-52b   # MoE; hybrid SSM + MoE
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --speculate ngram --repetitive         # speculative decoding
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --prefix-cache --prefill-chunk 8 --chaos 0 \
        --trace-out build/trace.json           # prefix cache, faults, trace
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --model-parallel 2                     # TP over 2 gloo ranks
    PYTHONPATH=src python -m repro_torch.launch.serve --model-parallel 2 \
        --dist-backend gloo                    # 2 ranks sharing card 0
    PYTHONPATH=src python -m repro_torch.launch.serve --model-parallel 2 \
        --arch qwen3-moe-30b-a3b --reduced --device cpu \
        --dist-backend gloo                    # expert parallelism

Fused decode and chunked prefill read the KV cache through one paged
multi-query attention kernel (kernels/flash_decode), at T=1 and T=chunk.
On ``mamba2-130m`` both prefill kinds run the SSD scan through the SSD
kernel (kernels/ssd) and decode advances the per-slot SSM states; on
``jamba-v0.1-52b`` so do its SSD layers, beside one paged attention
layer a period of 8. ``qwen3-moe-30b-a3b``, ``dbrx-132b`` and jamba run
their MoE FFNs at the serving capacity multiplier (4.0).
``--speculate`` verifies proposed tokens through the same paged read
(T = 1 + depth), and on an SSM arch scans each window's tokens through
the decode recurrence, keeping the state after each;
``draft:<config>`` drafts with that config's model (an SSM one too),
whose decode reads its dense cache through the dense decode kernel, and
``--repetitive`` serves repeated-pattern prompts, on which the n-gram
proposer fires. ``--prefix-cache`` shares cached full blocks across
requests; ``--chaos SEED`` injects a seeded fault schedule
(serving/faults.py); ``--trace-out`` enables telemetry and writes a
Chrome trace; ``--legacy`` decodes through the per-layer oracle.
As the reference CLI does, it serves the arch's reduced (smoke) config
with random weights from seed 0; ``chip_smoke.py`` drives the full width.
Before the burst it calls ``Engine.warmup`` for every table bucket the
trace implies: on the card that captures each step's CUDA graph, which
the burst then replays; it prints their count as ``fused_step_traces``.
It prints each request's tokens. ``--model-parallel N`` shards the
engine over N ranks it spawns (``launch.mesh.spawn_ranks``), each
serving the same burst on its slice of the same seeded weights; rank 0's
lines are printed, with ``model_parallel: N``. The ranks talk over
``--dist-backend``: ``nccl`` (a card per rank) or ``gloo`` (the CPU, or
ranks sharing a card; the only backend of the CPU, so the default
there). Under TP the steps run eagerly (no CUDA graphs: they hold
collectives), and deadlines and ``--chaos`` (whose storms arm deadlines)
are refused: each rank would read its own clock. On MoE archs the
ranks split the experts where N divides them (expert parallelism, the
tokens exchanged with each expert's rank), else the experts' MLP width.
``--reduced`` names the default: the CLI serves smoke configs only.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional


def parse_mixed_lens(text: Optional[str]) -> Optional[List[int]]:
    """Parse ``--mixed-lens`` ("16,64,24") into positive prompt lengths,
    rejecting malformed input at the CLI boundary."""
    if text is None:
        return None
    lens: List[int] = []
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            raise ValueError(
                f"--mixed-lens {text!r}: empty entry (double or trailing "
                f"comma?) — expected comma-separated positive ints")
        try:
            val = int(tok)
        except ValueError:
            raise ValueError(
                f"--mixed-lens {text!r}: {tok!r} is not an integer") \
                from None
        if val < 1:
            raise ValueError(
                f"--mixed-lens {text!r}: prompt length {val} must be >= 1")
        lens.append(val)
    return lens


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b",
                    help="qwen1.5-0.5b, llama2-7b/13b/70b (dense) or "
                         "mamba2-130m (ssm)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--n-blocks", type=int, default=128)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--int8-kv", action="store_true")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="page prompts out N tokens per step, interleaved "
                         "with decode (0 = whole-prompt prefill)")
    ap.add_argument("--mixed-lens", default=None,
                    help="comma-separated prompt lengths cycled over the "
                         "burst, e.g. 16,64,24 (overrides --prompt-len)")
    ap.add_argument("--speculate", default="off",
                    help="off | ngram | draft:<config> (dense archs)")
    ap.add_argument("--spec-depth", type=int, default=4,
                    help="proposed tokens per verify round (at most)")
    ap.add_argument("--repetitive", action="store_true",
                    help="repeated-pattern prompts (the n-gram proposer's "
                         "trace) instead of random ones")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="per-request deadline in seconds; expired "
                         "requests are evicted as timed_out (0 = none)")
    ap.add_argument("--queue-cap", type=int, default=0,
                    help="bound the waiting queue: submissions beyond it "
                         "are rejected as queue_full (0 = unbounded)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="cross-request prefix caching (needs "
                         "--prefill-chunk): cached full blocks are shared "
                         "and prefill runs only the novel suffix; tokens "
                         "equal a cache-off run's")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="seeded fault injection: block squeezes, "
                         "allocator failures and delayed cancellations")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable telemetry and write a Chrome-trace JSON "
                         "of the run (request spans, step phases, chaos)")
    ap.add_argument("--trace-fenced", action="store_true",
                    help="with --trace-out: synchronize the device after "
                         "each step, so each step's phases carry its "
                         "device time")
    grp = ap.add_mutually_exclusive_group()
    grp.add_argument("--fused", dest="mode", action="store_const",
                     const="fused", help="the fused steps (default)")
    grp.add_argument("--legacy", dest="mode", action="store_const",
                     const="legacy", help="per-layer decode oracle")
    ap.set_defaults(mode="fused")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch path)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="shard the engine over N ranks (paged KV pool on "
                         "its KV heads, SSM pools on their heads, "
                         "row-parallel seams, MoE experts over the ranks); "
                         "greedy output equals N=1's")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's smoke config (the default, and the "
                         "only config this CLI serves)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"),
                    default=None,
                    help="the ranks' backend: nccl (one card per rank) or "
                         "gloo (the CPU, or ranks sharing a card); "
                         "required on the card with --model-parallel")
    args = ap.parse_args(argv)

    from repro_torch.configs import list_archs
    from repro_torch.launch.mesh import spawn_ranks

    if args.arch not in list_archs():
        ap.error(f"unknown --arch {args.arch!r} (choose from "
                 f"{', '.join(list_archs())})")
    try:
        parse_mixed_lens(args.mixed_lens)
    except ValueError as e:
        ap.error(str(e))
    if args.chaos is not None and args.mode != "fused":
        ap.error("--chaos requires the fused engine (drop --legacy)")
    if args.prefix_cache and not args.prefill_chunk:
        ap.error("--prefix-cache requires --prefill-chunk N: a cache hit "
                 "resumes the suffix through the chunk step, and only a "
                 "chunk-aligned resume keeps greedy output token-identical "
                 "to a cache-off run")
    if args.prefix_cache and args.mode != "fused":
        ap.error("--prefix-cache requires the fused engine (drop --legacy)")
    if args.trace_fenced and not args.trace_out:
        ap.error("--trace-fenced requires --trace-out PATH")
    if args.model_parallel < 1:
        ap.error("--model-parallel must be >= 1")
    if args.model_parallel == 1:
        for line in _serve(None, args):
            print(line)
        return
    if args.mode != "fused":
        ap.error("--model-parallel requires the fused engine (drop --legacy)")
    if args.deadline_s or args.chaos is not None:
        ap.error("--deadline-s and --chaos are refused with "
                 "--model-parallel: each rank would read its own clock")
    cpu = args.device is not None and args.device.startswith("cpu")
    backend = args.dist_backend or ("gloo" if cpu else None)
    if backend is None:
        ap.error("--model-parallel on the card needs --dist-backend: nccl "
                 "(one card per rank) or gloo (ranks sharing a card)")
    # CPU ranks share the host's cores evenly
    threads = max(1, (os.cpu_count() or 1) // args.model_parallel)
    lines = spawn_ranks(_serve, args.model_parallel, backend=backend,
                        device="cpu" if cpu else None, args=(args,),
                        threads=threads if cpu else None)[0]
    for line in lines:
        print(line)


def _serve(mesh, args) -> List[str]:
    """Serve the CLI's burst, alone (``mesh=None``) or as one rank of
    ``mesh``; returns the lines to print."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (repetitive_requests,
                                           serving_requests)
    from repro_torch.launch.mesh import mesh_layout
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, Rejected, Request
    from repro_torch.serving.faults import FaultInjector
    from repro_torch.serving.telemetry import Telemetry

    lens = parse_mixed_lens(args.mixed_lens)
    faults = (FaultInjector.from_seed(args.chaos,
                                      rids=range(args.requests))
              if args.chaos is not None else None)
    cfg = get_config(args.arch, reduced=True)
    device = mesh.device if mesh is not None else args.device
    model = LM(cfg, device=device)
    params = model.init(0)
    telemetry = Telemetry(enabled=bool(args.trace_out),
                          fenced=args.trace_fenced)
    eng = Engine(cfg, params, max_batch=args.max_batch,
                 n_blocks=args.n_blocks, block_size=args.block_size,
                 kv_quant="int8" if args.int8_kv else "none",
                 mode=args.mode, prefill_chunk=args.prefill_chunk or None,
                 speculate=args.speculate, spec_depth=args.spec_depth,
                 queue_cap=args.queue_cap or None,
                 default_deadline_s=args.deadline_s or None,
                 faults=faults, prefix_cache=args.prefix_cache,
                 telemetry=telemetry, device=model.device, mesh=mesh,
                 cuda_graphs=mesh is None)
    del params
    out: List[str] = []
    if args.repetitive:
        prompts = repetitive_requests(args.requests, cfg.vocab_size,
                                      prompt_len=args.prompt_len)
    else:
        prompts = serving_requests(args.requests, cfg.vocab_size,
                                   prompt_len=args.prompt_len,
                                   prompt_lens=lens)
    # every table bucket the trace implies, before it arrives
    eng.warmup(max(lens or [args.prompt_len]) + args.max_new,
               prompt_lens=lens or [args.prompt_len])
    for i, p in enumerate(prompts):
        try:
            eng.submit(Request(rid=i, tokens=p,
                               max_new_tokens=args.max_new))
        except Rejected as e:
            # load shedding is a reported outcome, not a launcher crash
            out.append(f"{'rejected':>20s}: rid={i} ({e.reason})")
    eng.run()
    if faults is not None:
        faults.release_all(eng)     # return any still-squeezed blocks
        for step, action, detail in eng.telemetry.chaos_actions:
            out.append(f"{'chaos':>20s}: step {step:>3d} {action} {detail}")
    out.append(f"{'device':>20s}: {model.device}")
    if mesh is not None:
        out.append(f"{'mesh':>20s}: {mesh_layout(mesh)}")
    out.append(f"{'mode':>20s}: {args.mode}")
    for k, v in eng.stats().items():
        out.append(f"{k:>20s}: {v:.4f}" if isinstance(v, float) else
                   f"{k:>20s}: {v}")
    out.append(f"{'fused_step_traces':>20s}: "
               f"{sum(eng.trace_counts.values())}")
    for r in sorted(eng.finished, key=lambda r: r.rid):
        out.append(f"{'tokens':>20s}: rid={r.rid} "
                   + " ".join(str(t) for t in r.output))
    if args.trace_out and (mesh is None or mesh.rank == 0):
        trace = eng.telemetry.export_chrome(
            args.trace_out,
            metadata={"arch": args.arch, "mode": args.mode,
                      "chaos_seed": args.chaos,
                      "model_parallel": eng.tp_degree})
        out.append(f"{'trace_out':>20s}: {args.trace_out} "
                   f"({len(trace['traceEvents'])} events)")
    return out


if __name__ == "__main__":
    main()
