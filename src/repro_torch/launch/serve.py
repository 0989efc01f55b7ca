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
        --speculate ngram --repetitive         # speculative decoding

Fused decode and chunked prefill read the KV cache through one paged
multi-query attention kernel (kernels/flash_decode), at T=1 and T=chunk.
On ``mamba2-130m`` both prefill kinds run the SSD scan through the SSD
kernel (kernels/ssd) and decode advances the per-slot SSM states.
``--speculate`` verifies proposed tokens through the same paged read
(T = 1 + depth); ``draft:<config>`` drafts with that config's model,
whose decode reads its dense cache through the dense decode kernel, and
``--repetitive`` serves repeated-pattern prompts, on which the n-gram
proposer fires.
As the reference CLI does, it serves the arch's reduced (smoke) config
with random weights from seed 0; ``chip_smoke.py`` drives the full width.
Before the burst it calls ``Engine.warmup`` for every table bucket the
trace implies: on the card that captures each step's CUDA graph, which
the burst then replays; it prints their count as ``fused_step_traces``.
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, list_archs
    from repro_torch.data.pipeline import (repetitive_requests,
                                           serving_requests)
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, Rejected, Request

    if args.arch not in list_archs():
        ap.error(f"unknown --arch {args.arch!r} (choose from "
                 f"{', '.join(list_archs())})")
    try:
        lens = parse_mixed_lens(args.mixed_lens)
    except ValueError as e:
        ap.error(str(e))
    cfg = get_config(args.arch, reduced=True)
    model = LM(cfg, device=args.device)
    params = model.init(0)
    eng = Engine(cfg, params, max_batch=args.max_batch,
                 n_blocks=args.n_blocks, block_size=args.block_size,
                 kv_quant="int8" if args.int8_kv else "none",
                 prefill_chunk=args.prefill_chunk or None,
                 speculate=args.speculate, spec_depth=args.spec_depth,
                 device=model.device)
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
            print(f"{'rejected':>20s}: rid={i} ({e.reason})")
    eng.run()
    print(f"{'device':>20s}: {model.device}")
    for k, v in eng.stats().items():
        print(f"{k:>20s}: {v:.4f}" if isinstance(v, float) else
              f"{k:>20s}: {v}")
    print(f"{'fused_step_traces':>20s}: {sum(eng.trace_counts.values())}")


if __name__ == "__main__":
    main()
