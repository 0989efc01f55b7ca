#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root (it puts ``src`` on ``sys.path`` itself and
imports nothing of the JAX package). Phases, one line each:

1. device   - the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    - nvcc builds every kernel of the serving path from
              ``src/repro_torch/kernels/csrc`` (all sources in parallel).
3. kernel   - the paged-attention kernel against its plain PyTorch version
              on the card over T x G x D x {bf16, int8} with a padded table
              bucket, a zero-length row and a short row; T=1 through the
              decode entry point equals T=1 through the prefix entry point
              bit for bit.
4. engine   - full-width qwen1.5-0.5b (seeded random weights) serves 16
              requests (prompts 64/256/1000, 64 new tokens each) twice:
              whole-prompt prefill with bf16 KV, and chunked prefill (64)
              with int8 KV. Every request must finish; the kernel's launch
              count must be 24 x (decode steps + chunk steps); every
              generated token must be the argmax of a dense, unpaged
              forward over the same tokens, or within a bf16 near-tie
              margin of it.
5. timing   - engine decode tok/s and p50 TTFT; the kernel held against
              its plain version at the engine's decode and chunk shapes
              (16 KV heads, D=64), and its time per launch there beside
              its byte bound,
              the plain version's time and one
              ``scaled_dot_product_attention`` call on the same K/V
              gathered dense (timed here only; the port never calls it).

Any failed check raises. The last three lines of standard output are the
kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py f32 tolerance
NEAR_TIE_ULPS = 8                  # bf16 ulps of the top logit


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# helpers on the card
# --------------------------------------------------------------------------


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_paged_case(*, b, t, h, kv, d, bs, lengths, mb, n_blocks, quant,
                    n_layers=1, seed=0):
    """Random q (bf16) and paged K/V over ``n_layers`` pools; each row's
    live blocks are distinct pool blocks, the rest of its table row is the
    zero padding the engine uses."""
    import torch
    from repro_torch.serving.cache import quant_encode
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, t, h, d), generator=g, device=dev).bfloat16()
    shape = (n_layers, n_blocks, bs, kv, d)
    k = torch.randn(shape, generator=g, device=dev).bfloat16()
    v = torch.randn(shape, generator=g, device=dev).bfloat16()
    ks = vs = None
    if quant:
        k, ks = quant_encode(k, "int8")
        v, vs = quant_encode(v, "int8")
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    table = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    used = 0
    for i, ln in enumerate(lengths):
        nb = -(-ln // bs)
        check(nb <= mb and used + nb < n_blocks, "bad synthetic case")
        table[i, :nb] = perm[used:used + nb].int()
        used += nb
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, ks, vs, table, lens


def layer(x, i):
    return None if x is None else x[i]


def normalized(o, l):
    import torch
    return o / torch.clamp_min(l, 1e-30)


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def allclose(a, b, **tol) -> bool:
    import torch
    return bool(torch.allclose(a, b, **tol))


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_kernel_vs_plain():
    import torch
    from repro_torch.kernels import flash_decode as fd
    n = 0
    worst = 0.0
    for t in (1, 4, 8, 64):
        for gq in (1, 2, 4):
            for d in (64, 128):
                for quant in (False, True):
                    bs, mb, kv = 16, 8, 2
                    lengths = [mb * bs - 5, bs + 3, 0]   # full, short, empty
                    q, k, v, ks, vs, table, lens = make_paged_case(
                        b=3, t=t, h=kv * gq, kv=kv, d=d, bs=bs,
                        lengths=lengths, mb=mb, n_blocks=40, quant=quant,
                        seed=n)
                    args = (q, k[0], v[0], table, lens, layer(ks, 0),
                            layer(vs, 0))
                    want = fd._paged_prefix_torch(*args)
                    got = fd._paged_mq_cuda(*args)
                    torch.cuda.synchronize()
                    ow, og = normalized(want[0], want[2]), normalized(
                        got[0], got[2])
                    tag = f"T={t} G={gq} D={d} {'int8' if quant else 'bf16'}"
                    check(allclose(og, ow, **KERNEL_TOL),
                          f"kernel output differs at {tag}: "
                          f"{max_err(og, ow)}")
                    check(allclose(got[1], want[1], **KERNEL_TOL),
                          f"kernel m differs at {tag}")
                    check(allclose(got[2], want[2], **KERNEL_TOL),
                          f"kernel l differs at {tag}")
                    check(bool(torch.all(got[0][2] == 0)) and
                          bool(torch.all(got[2][2] == 0)) and
                          bool(torch.all(got[1][2] == -1e30)),
                          f"zero-length row not empty at {tag}")
                    worst = max(worst, max_err(og, ow))
                    if t == 1:
                        one = fd.paged_flash_decode_partial(
                            q[:, 0], k[0], v[0], table, lens,
                            k_scale=layer(ks, 0), v_scale=layer(vs, 0))
                        mq = fd.paged_flash_prefix_partial(
                            q, k[0], v[0], table, lens,
                            k_scale=layer(ks, 0), v_scale=layer(vs, 0))
                        for a, b in zip(one, mq):
                            check(torch.equal(a, b[:, 0]),
                                  f"T=1 decode != prefix bitwise at {tag}")
                    n += 1
    print(f"[kernel] {n} cases kernel == plain within rtol=atol=2e-5 "
          f"(max |err| of normalized output {worst:.3g}); T=1 decode read "
          f"== prefix read bitwise")


def dense_reference_logits(model, params, tokens, kv_quant):
    """Unpaged forward over ``tokens`` (1, T) with the engine's storage
    semantics: under int8 KV every key and value is attended as stored
    (quantized and dequantized), as chunked prefill and decode do."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.serving.cache import quant_decode, quant_encode
    if kv_quant == "none":
        return model.forward(params, tokens)[0]
    cfg = model.cfg
    x = model._embed_in(params, tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None]
    for i in range(cfg.n_layers):
        lp = model.layer_params(params, i)
        h = L.rmsnorm(x, lp["mix"]["ln"], cfg.norm_eps)
        q, k, v = B._qkv(h, lp["mix"], cfg, pos)
        k = quant_decode(*quant_encode(k, "int8"), torch.float32)
        v = quant_decode(*quant_encode(v, "int8"), torch.float32)
        out = L.naive_attention(q, k, v, causal=True).to(q.dtype)
        x = x + L.dense(out, lp["mix"]["wo"], n_in=2)
        x = B.ffn_apply(x, lp["ffn"], cfg)
    return model._head(params, x)[0]


def teacher_forced(model, params, done, kv_quant):
    """Share of generated tokens equal to the dense argmax, and the worst
    near-tie gap (in bf16 ulps of the top logit) among the others."""
    import torch
    match = total = 0
    worst = 0.0
    for r in done:
        seq = list(r.tokens) + r.output
        toks = torch.tensor([seq[:-1]], dtype=torch.int64, device="cuda")
        with torch.no_grad():
            logits = dense_reference_logits(model, params, toks,
                                            kv_quant).float()
        p0 = len(r.tokens) - 1
        rows = logits[p0:p0 + len(r.output)]
        top, arg = rows.max(dim=-1)
        got = torch.tensor(r.output, device="cuda")
        mine = rows.gather(1, got[:, None])[:, 0]
        ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30)))
                         - 7)
        gap = ((top - mine) / ulp).cpu()
        same = (arg == got).cpu()
        match += int(same.sum())
        total += len(r.output)
        bad = (~same) & (gap > NEAR_TIE_ULPS)
        check(not bool(bad.any()),
              f"rid {r.rid}: token(s) at {bad.nonzero()[:, 0].tolist()} "
              f"are {gap[bad].tolist()} bf16 ulps below the dense max "
              f"(margin {NEAR_TIE_ULPS})")
        if (~same).any():
            worst = max(worst, float(gap[~same].max()))
    return match / total, worst


def phase_engine(cfg, params, *, prefill_chunk, kv_quant):
    import torch
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.serving.engine import Engine, Request
    eng = Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                 kv_quant=kv_quant, prefill_chunk=prefill_chunk,
                 device="cuda")
    prompts = serving_requests(16, cfg.vocab_size,
                               prompt_lens=[64, 256, 1000])
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=64))
    torch.cuda.synchronize()
    fd.LAUNCHES.clear()                  # count the main path's run only
    t0 = time.monotonic()
    done = eng.run(max_steps=5000)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = fd.LAUNCHES["paged_attention"]
    st = eng.stats()
    steps = st["decode_steps"] + st["chunk_steps"]
    check(len(done) == 16 and st["finished"] == 16,
          f"{st['finished']} of 16 requests finished")
    check(all(len(r.output) == 64 for r in done),
          "a request ended with fewer than 64 tokens")
    check(launches == cfg.n_layers * steps,
          f"kernel launches {launches} != {cfg.n_layers} x {steps} steps")
    share, worst = teacher_forced(eng.model, eng.params, done, kv_quant)
    mode = (f"chunk={prefill_chunk}" if prefill_chunk else "whole-prompt")
    print(f"[engine] qwen1.5-0.5b full width, {mode}, kv={kv_quant}: "
          f"16/16 finished x 64 tokens in {wall:.2f}s; "
          f"{st['decode_steps']} decode + {st['chunk_steps']} chunk steps, "
          f"kernel launches {launches} = {cfg.n_layers} x {steps}; "
          f"preemptions {st['preemptions']}; dense-argmax match "
          f"{share:.4f} (others within {worst:.1f} <= {NEAR_TIE_ULPS} "
          f"bf16 ulps); decode {st['decode_tok_s']:.1f} tok/s, "
          f"p50 TTFT {st['p50_ttft_s'] * 1e3:.1f} ms")
    return launches, st


def time_shape(cfg, *, b, t, lengths, quant, mb, n_blocks, n_layers):
    """The kernel against its plain version at one shape of the main path
    (normalized output, m and l within ``KERNEL_TOL``), then kernel, plain
    and library times there, cycling through ``n_layers`` pools as the
    engine does so the pages are not L2-hot."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    h, kv, d, bs = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 16
    q, k, v, ks, vs, table, lens = make_paged_case(
        b=b, t=t, h=h, kv=kv, d=d, bs=bs, lengths=lengths, mb=mb,
        n_blocks=n_blocks, quant=quant, n_layers=n_layers, seed=7)
    scale = 1.0 / math.sqrt(d)

    def args(i):
        li = i % n_layers
        return (q, k[li], v[li], table, lens, layer(ks, li), layer(vs, li))

    ref = fd._paged_prefix_torch(*args(0), sm_scale=scale)
    out = fd._paged_mq_cuda(*args(0), sm_scale=scale)
    on, rn = normalized(out[0], out[2]), normalized(ref[0], ref[2])
    err = max_err(on, rn)
    tag = f"B={b} T={t} H={h} K={kv} D={d} {'int8' if quant else 'bf16'}"
    check(allclose(on, rn, **KERNEL_TOL),
          f"kernel output differs from plain at {tag}: {err}")
    check(allclose(out[1], ref[1], **KERNEL_TOL),
          f"kernel m differs from plain at {tag}")
    check(allclose(out[2], ref[2], **KERNEL_TOL),
          f"kernel l differs from plain at {tag}")
    ms = cuda_ms(lambda i: fd._paged_mq_cuda(*args(i), sm_scale=scale),
                 iters=200)
    plain_ms = cuda_ms(
        lambda i: fd._paged_prefix_torch(*args(i), sm_scale=scale), iters=20)
    # the same attention as one library call on K/V gathered dense
    smax = max(lengths)
    cols = -(-smax // bs)
    dense = []
    for li in range(n_layers):
        kd = k[li][table[:, :cols].long()].reshape(b, cols * bs, kv, d)
        vd = v[li][table[:, :cols].long()].reshape(b, cols * bs, kv, d)
        if quant:
            kd = (kd.float() * ks[li][table[:, :cols].long()].reshape(
                b, cols * bs, kv, 1)).bfloat16()
            vd = (vd.float() * vs[li][table[:, :cols].long()].reshape(
                b, cols * bs, kv, 1)).bfloat16()
        dense.append((kd.transpose(1, 2).contiguous(),
                      vd.transpose(1, 2).contiguous()))
    mask = (torch.arange(cols * bs, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    qd = q.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda i: F.scaled_dot_product_attention(
        qd, *dense[i % n_layers], attn_mask=mask, scale=scale), iters=200)
    # least traffic: live K/V (+ int8 scales) once, the live table columns,
    # lengths and q once, o/m/l once
    live = sum(lengths)
    kv_bytes = live * kv * d * (1 if quant else 2) * 2
    if quant:
        kv_bytes += live * kv * 4 * 2
    io_bytes = (b * t * h * d * 2 + b * t * h * d * 4 + b * t * h * 4 * 2
                + 4 * sum(-(-ln // bs) for ln in lengths) + b * 4)
    ops = 4.0 * t * (h // kv) * live * kv * d
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["int8" if quant else "bf16"] * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "max_abs_err": err}


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, str(SRC))
    card = card_line()
    print(f"[device] {card} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    from repro_torch.configs import get_config
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.models.lm import LM
    resolve_device("cuda")           # numerics switches for the whole run
    t0 = time.monotonic()
    logs = _build.build_all(verbose=True)
    ptxas = " ".join(line.strip() for log in logs.values()
                     for line in log.splitlines() if "registers" in line)
    print(f"[build] {', '.join(_build.KERNELS)} built by nvcc in "
          f"{time.monotonic() - t0:.1f}s ({ptxas[:300]})")

    phase_kernel_vs_plain()

    cfg = get_config("qwen1.5-0.5b")
    model = LM(cfg, device="cuda")
    params = model.init(0)
    la, st_a = phase_engine(cfg, params, prefill_chunk=None, kv_quant="none")
    lb, st_b = phase_engine(cfg, params, prefill_chunk=64, kv_quant="int8")

    mb = 128                            # table bucket of a 1064-token row
    dec = time_shape(cfg, b=8, t=1, lengths=[96, 288, 1032, 96, 288, 1032,
                                             96, 288],
                     quant=False, mb=mb, n_blocks=1025, n_layers=24)
    chk = time_shape(cfg, b=1, t=64, lengths=[936], quant=True, mb=64,
                     n_blocks=1025, n_layers=24)
    for name, r in (("decode B=8 T=1 bf16", dec),
                    ("chunk B=1 T=64 ctx=936 int8", chk)):
        print(f"[timing] paged_attention {name}: {r['ms'] * 1e3:.1f} us "
              f"(bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms'] * 100:.1f}% of it), == plain within "
              f"rtol=atol=2e-5, plain "
              f"{r['plain_ms'] * 1e3:.1f} us, sdpa {r['library_ms'] * 1e3:.1f}"
              f" us, max |err| {r['max_abs_err']:.3g}")
    print(f"[timing] engine: whole-prompt bf16 decode "
          f"{st_a['decode_tok_s']:.1f} tok/s, p50 TTFT "
          f"{st_a['p50_ttft_s'] * 1e3:.1f} ms; chunk=64 int8 decode "
          f"{st_b['decode_tok_s']:.1f} tok/s, p50 TTFT "
          f"{st_b['p50_ttft_s'] * 1e3:.1f} ms")
    record = {"kernels": [{
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_decode.py:206",
        "launches": la + lb,
        "max_abs_err": dec["max_abs_err"],
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
    }]}
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
