#!/usr/bin/env python3
"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root (it puts ``src`` on ``sys.path`` itself and
imports nothing of the JAX package). Phases, one line each:

1. device   - the card's name and power limit (nvidia-smi), torch and CUDA.
2. build    - nvcc builds every kernel from ``src/repro_torch/kernels/
              csrc`` (one nvcc per source, all in parallel), the flash
              library twice more, with ``-DFLASH_PLANT_P_HI_ONLY`` and
              with ``-DFLASH_PLANT_FWD_P_HI_ONLY`` (phase 6's planted
              faults), the int8 library with
              ``-DQMM_PLANT_SPLIT_HI_ONLY`` (phase 12's) and the SSD
              library with ``-DSSD_PLANT_HI_ONLY`` and with
              ``-DSSD_PLANT_PASS_SKIPS_U0`` (phase 9's). Phase 19 runs
              next.
3. kernel   - the paged-attention kernel against its plain PyTorch version
              on the card over T x G x D x {bf16, int8} with a padded table
              bucket, a zero-length row and a short row, and at contexts it
              splits many ways (up to 4,096 positions on a 256-column
              table; the split count per case is printed); T=1 through the
              decode entry point equals T=1 through the prefix entry point
              bit for bit, and row t of every T-wide read equals the T=1
              read of q[:, t] bit for bit; four planted faults (one split
              dropped, the merge without the rescale, each split's span one
              page short, the int8 scales skipped) must each break 2e-5.
4. engine   - full-width qwen1.5-0.5b (seeded random weights) serves 16
              requests (prompts 64/256/1000, 64 new tokens each) twice:
              whole-prompt prefill with bf16 KV, and chunked prefill (64)
              with int8 KV, each after ``Engine.warmup`` for every table
              bucket of the trace, its steps replayed as CUDA graphs.
              Every request must finish; the kernel's launch count must be
              24 x (decode steps + chunk steps), the RMSNorm kernel's 49 x
              (prefill groups + decode + chunk steps); every generated
              token must be the argmax of a dense, unpaged forward over
              the same tokens, or within a bf16 near-tie margin of it.
              Each run's eager twin follows it (phase 20).
5. timing   - engine decode tok/s and p50 TTFT; the kernel held against
              its plain version at the engine's decode and chunk shapes
              (16 KV heads, D=64), and at llama2-7b's decode shape (B=8,
              32 KV heads, D=128) after phase 21, and its time per launch
              there by CUDA-graph replay (and once by events) beside its
              byte bound, the plain version's time and one
              ``scaled_dot_product_attention`` call on the same K/V
              gathered dense (timed here only; the port never calls it).
6. flash    - the three flash-attention kernels (forward, dK/dV, dQ)
              against their plain versions on the card: the reference's
              kernel-test shapes, G in {1,2,4,8} x D in {64,128}, ragged
              lengths, causal and full, bf16 and f32, and the training
              shape at B=1 in f32 and bf16 (f32 within 2e-5, bf16 within
              a few bf16 ulps); the autograd wrapper's gradient against
              autograd through the materialized-score attention. It says
              which forward and backward body each case ran (bf16 at D
              64/128 must be bf16 mma.sync tiles with P and dS split hi +
              lo; f32: the FMA body), and counts the tensor-core cases at
              which each planted build (P rounded to bf16, no low half, in
              the backward's dV and in the forward's O) breaks a limit:
              readings, not checks.
7. train    - full-width qwen1.5-0.5b (seeded random weights) trains
              through ``Trainer`` with technique F+R+Z3 at batch 4 x
              2048 tokens. First one loss + backward through the flash
              kernels against the same through naive attention on the
              same params and batch, and again with each of two faults
              planted in the flash wrappers, which the same limits must
              catch; then 4 steps, whose losses and gradient norms must
              be finite and which must launch the forward kernel 48
              times and each backward kernel 24 times per step, and the
              RMSNorm kernel 104 times per step (2 x 24 layers, twice
              with remat, plus the final norm in 4 checkpointed loss
              blocks, forward and recompute).
8. timing   - the flash kernels at the training shape (B=4, H=16,
              T=2048, D=64, causal, bf16): time per launch beside the
              bound, the plain versions' times (each kernel's function
              and the whole backward), and
              ``scaled_dot_product_attention`` forward, backward and
              forward + backward on the same tensors (timed here only);
              each kernel's body and bound as built (the forward 3
              products, the backward 10: P and dS each take two) beside
              the useful work's.
9. ssd      - the SSD kernel against its plain version on the card, f32,
              at mamba2-130m's whole-prompt shape (B=4, T=1000 padded to
              1024, H=24, P=64, N=128, chunk 256), its chunk step's (B=1,
              T=64 taken at its live length, a carried state), four
              chunks with a carried state, an odd one (G=2, T not a
              multiple of the chunk) and one the FMA body takes (N=4,
              P=8); y and the final state within ``SSD_TOL``. It prints
              each case's body and CUDA kernels a call; both mamba2 shapes
              must run the tensor-core body, each within 2x the FMA body's
              max |err| on the same inputs (y and state each). Two faults
              planted in the wrapper (``init_state`` dropped, the state not
              carried from chunk to chunk) and one in the kernel (the
              state pass leaves out the first chunk's contribution, a
              build with ``SSD_PLANT_PASS_SKIPS_U0``) must each break that
              limit; the build with only the hi parts
              (``SSD_PLANT_HI_ONLY``) is a reading: the tensor-core cases
              at which it breaks a limit are counted.
10. mamba2  - full-width mamba2-130m (seeded random weights) serves the
              same 16 requests twice, through the replayed steps after
              warmup, each run followed by its eager twin (phase 20):
              whole-prompt prefill, and chunked
              prefill (64) on a pool small enough to preempt. Every
              request must finish; the SSD kernel must launch exactly
              24 x (prefill groups + chunk steps) times, and never in a
              decode step, the RMSNorm kernel 73 x (prefill groups +
              chunk + decode steps); every token must be the argmax of a
              teacher-forced ``LM(ssd_impl="ref").forward`` or within
              8 bf16 ulps of it.
11. timing  - the SSD kernel at B=4, T=1024, at the chunk step's shape
              as the engine now passes it (B=1, T=64, one chunk of 64, a
              carried state) and padded to one 256 chunk as the engine
              passed it before: device time per call by CUDA-graph replay
              (and by events), and that of the build without its products
              (``SSD_TIME_NO_PRODUCTS``: its staging alone), each beside
              its bound, its bound as built (the six part products of the
              tensor-core body), the plain version's time and the CUDA
              kernels a call launches (no one library call computes SSD).
12. qmm     - the int8 weight-only matmul kernel against its plain version
              on the card: the reference's kernel-test shapes, M in {1, 7},
              K and N off the tile, G in {1, 16}, the four fine-tuning
              projections at M=2048; x bf16 and f32, out bf16 and f32 (f32
              within 2e-5, bf16 within 1 bf16 ulp beyond a 1e-5 floor);
              the body of every case is printed, and the four projections
              must run the tensor-core body; the autograd wrapper's dx
              against autograd through the plain version; two planted
              faults (scales ignored, the last K tile dropped) must each
              break a limit, and the library built with the split operand's
              hi part alone (``QMM_PLANT_SPLIT_HI_ONLY``) must break one at
              some case (the count is printed).
13. finetune - full-width qwen1.5-0.5b (seeded random weights) fine-tunes
              LoRA adapters (rank 64) on an int8 frozen base through
              ``Trainer`` with technique QL+Q8+F+R at batch 4 x 2048. B is
              set to seeded nonzero values; then one loss + backward with
              the int8 kernel against the same with the reference's
              dequantize-first route on the same params and batch (loss
              within ``FT_LOSS_ATOL``, every adapter gradient's cosine >=
              0.999), and again under each fault of phase 12, which must
              break one of those limits; then 4 steps, whose losses and
              gradient norms must be finite, which must leave the int8
              base, embed, norms and biases bit-unchanged, and which must
              launch the int8 kernel 24 x 7 x 2 = 336 times (every launch
              on the tensor-core body), the flash
              kernels 48/24/24 and the RMSNorm kernel 104 per step; then 2
              L+F+R steps (bf16 base), which must launch the int8 kernel
              0 times and RMSNorm 104 per step.
14. timing  - the int8 kernel at the step's four shapes (M=8192): its body,
              time per launch beside its bound and its bound as built (the
              useful operations times the part products it runs), the
              plain version's time and the reference's route on the card,
              dequantize to x's type + ``torch.matmul`` (two calls: no one
              PyTorch call computes this function); the kernel's time per
              step.
15. rmsnorm - the RMSNorm kernel against its plain version on the card:
              rows {1, 8, 333, 8192} x D {768, 1024, 1536, 4096, and the
              ragged 1000, 999} x x and w each
              in {bf16, f32} (f32 within 2e-5, bf16 within 1 bf16 ulp
              beyond a 1e-5 floor), rows at magnitudes 1e-3..10; two
              planted faults (eps dropped, the last block's rows skipped)
              must each break that limit; the autograd wrapper's dx and
              dw against autograd through the plain version at a training
              shape (1 ulp).
16. decode  - the dense-cache decode kernel against its plain version:
              tests/test_kernels.py:72-75's shapes, the draft model's
              shape (B=1, H=K=16, D=64, S in {65, 1068}), G=2, a
              zero-length row and a length past S, and long caches the
              kernel splits many ways (S 4,096 and 8,192, B 1/4/8, G
              1/2/8, D 64/128, whole splits empty, a length reaching S),
              bf16 and f32 (normalized output, m and l within 2e-5); four
              planted faults (length mask off by one, m not carried
              across tiles, one split's partial dropped, the partials
              summed without the rescale to their common max) must each
              break it.
17. spec    - full-width qwen1.5-0.5b (seeded random weights) with
              speculative decoding, max_batch 8, block_size 16, 1024
              blocks: (a) n-gram, depth 4, on 16 repeated-pattern prompts
              of 256 tokens, 64 new tokens each; (b) a self-draft (a
              DraftModelProposer with the target's own weights), depth 4,
              on 4 requests (prompts 64 and 256), 32 new tokens. Each
              runs spec-off, then spec-on, both through the replayed
              steps after warmup (the draft model decodes eagerly); the
              n-gram spec-on run then has its eager twin (phase 20).
              Every request finishes with
              its budget, and every stream equals spec-off's up to a
              split at a bf16 near tie (4 ulps) of spec-off's logits.
              Launches: paged read 24 x verify steps, dense decode 24 x
              draft decode steps, RMSNorm 49 x (prefill groups + verify
              steps + draft prefills + draft decode steps); the
              self-draft's accept_rate must exceed 0.6 and each of its
              rejected proposals must be a bf16 near tie (8 ulps) of a
              dense forward's logits.
18. timing  - the RMSNorm kernel at the training step's shape (8,192 x
              1,024 bf16), at decode (8 x 1,024) and at the draft's decode
              (1 x 1,024), the dense decode
              kernel at the draft's shape and at B=8, S=4,096, each
              beside its bound, its plain version and one library call
              (``F.rms_norm``; ``scaled_dot_product_attention`` with the
              length mask), timed as CUDA-graph replays: the host's cost
              per call exceeds these kernels' device time.
19. dense   - ``layers.dense`` on the card (bf16 operands on the tensor
              cores, f32 sums, one rounding; an f32 output through
              ``aten::mm.dtype``, its gradient from a three-part bf16
              split of the f32 cotangent) against the f32 route on the
              same tensors at every product of qwen1.5-0.5b (q/k/v, o,
              gate/up, down, the tied head) at 8 and 8,192 rows, forward
              and gradients: bf16 within 1 ulp beyond a 1e-5 floor, f32
              within 2e-5; the down projection (an f32 input) keeps the
              f32 route; an f32 output rounded through bf16 (planted)
              must break 2e-5. It runs right after the build.
20. graphs  - each engine trace of phases 4, 10 and 17 (qwen whole-prompt
              bf16 and chunked int8, mamba2 whole-prompt and chunked with
              preemption, the n-gram spec-on run) is served once through
              the replayed steps and once eagerly (``Engine(...,
              cuda_graphs=False)``) in this process: tokens, ``stats()``
              counters (all but times) and the final KV pool (without its
              null block, which inactive rows' appends race into) and SSM
              pool must be bitwise equal; the replaying engine must
              capture nothing after ``warmup``, and ``warmup`` must leave
              both pools (null block included) bitwise as it found them.
              It prints, replayed and eager, decode tok/s, p50 TTFT and
              the wall per decode step (min/median/max), and the graphs.
21. llama2  - full-width llama2-7b (seeded random weights, 6.7 B
              parameters in bf16) serves phase 4's 16 requests through
              the replayed steps, whole-prompt bf16 KV and chunked (64)
              int8 KV, with phase 4's checks (paged launches 32 x steps,
              RMSNorm 65 x forwards, tokens against a dense forward); it
              prints decode tok/s, the wall per decode step and the device
              time of a decode step with all 8 rows live (its graph
              replayed between two events) beside that step's byte bound
              (every weight and the live KV read once).

Any failed check raises. The last three lines of standard output are the
kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``; the line before them gives the whole
run's time. Each main path (the six engine runs, the training run, the
two fine-tuning runs, the four speculative engine runs) is driven with
every launch count set to 0 just before it (after the engine's warmup)
and read just after; so is each eager twin. Without
a CUDA device, or without the repository beside it, the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
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
F32_FMA_OPS = 67e12                # f32 on the FMA pipes, not a bound
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)   # tests/test_kernels.py f32 tolerance
GRAD_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_kernels.py:65
# bf16 flash outputs against the plain version, in bf16 ulps of the larger
# magnitude: both sum in f32 and round once, so only f32 summation order
# differs and splits a rounding (measured at the training shape: o at most
# 1 ulp off, dq/dk/dv bit-equal); the absolute floor covers sums that
# cancel to near zero, where f32 roundoff (< 1e-6 here) exceeds an ulp
BF16_ULPS = 2
BF16_ULPS_G1_GRADS = 1             # dq/dk/dv at the training shape (G=1)
BF16_ATOL = 1e-5
TRAIN_SHAPE = dict(b=4, h=16, t=2048, d=64)   # qwen1.5-0.5b at 4 x 2048
LOSS_ATOL = 1e-4                   # flash vs naive loss, full width
GRAD_NORM_RTOL = 0.01
GRAD_COS = 0.999
NEAR_TIE_ULPS = 8                  # bf16 ulps of the top logit
# SSD kernel against its plain version, f32: each scans the decay itself,
# and a chunk's cumulative decay reaches about -200, where an f32 ulp is
# 1.5e-5, so every decay factor may differ by ~1e-5 relative (measured at
# mamba2's whole-prompt shape: y within 4.6e-4, the state within 8.4e-5;
# rtol=atol=2e-5 fails): the reference's own SSD kernel test's limit
# (tests/test_kernels.py:328)
SSD_TOL = dict(rtol=2e-3, atol=2e-4)
# (B, T, H, P, G, N, chunk, carried state)
SSD_CASES = (("whole-prompt", 4, 1000, 24, 64, 1, 128, 256, False),
             ("chunk step", 1, 64, 24, 64, 1, 128, 256, True),
             ("4 chunks", 2, 1024, 24, 64, 1, 128, 256, True),
             ("odd", 2, 100, 6, 32, 2, 48, 32, True),
             ("fma", 3, 70, 2, 8, 1, 4, 32, True))
# the two mamba2 shapes: the tensor-core body, within this factor of the
# FMA body's max |err| against the plain version on the same inputs
SSD_MAMBA2 = ("whole-prompt", "chunk step")
SSD_FMA_FACTOR = 2.0
# mamba2's chunked run: 16 requests on 8 slots with prompts of up to 1,000
# tokens need more 16-token blocks than this at once, so it preempts
MAMBA2_PRESSURE_BLOCKS = 192
# int8 kernel cases (name, M, K, N, G): tests/test_kernels.py:362's shapes,
# decode-size M, K and N off the 128 x 128 x 64 (32) tiles, G = 16 head groups,
# and qwen1.5-0.5b's four fine-tuning projections at M = 2048
QMM_CASES = (("test_kernels", 128, 256, 128, 1),
             ("test_kernels", 64, 512, 384, 1),
             ("decode", 1, 1024, 1024, 16), ("ragged", 7, 1000, 1040, 16),
             ("ragged", 7, 1000, 300, 1), ("ragged", 200, 130, 70, 1),
             ("q/k/v", 2048, 1024, 1024, 16), ("o", 2048, 1024, 1024, 1),
             ("gate/up", 2048, 1024, 2816, 1), ("down", 2048, 2816, 1024, 1))
STEP_NAMES = ("q/k/v", "o", "gate/up", "down")
# the fine-tuning step's projections at M = 4 x 2048 tokens: (name, K, N,
# G, x type, out type, launches per layer per forward pass)
QMM_STEP = (("q/k/v", 1024, 1024, 16, "bf16", "f32", 3),
            ("o", 1024, 1024, 1, "bf16", "bf16", 1),
            ("gate/up", 1024, 2816, 1, "bf16", "f32", 2),
            ("down", 2816, 1024, 1, "f32", "f32", 1))
# the int8 kernel keeps each dequantized weight in f32 where the reference
# route rounds it to bf16: the two routes' losses differ by that rounding
# (measured on the CPU at reduced width, QL+Q8+F+R with B nonzero: 9.9e-5
# at 2 x 64 tokens, 6.4e-5 at 4 x 128; tests/test_torch_finetune.py holds
# the kernel route to the reference at 2e-3); worst adapter gradient
# cosine 0.99982 there
FT_LOSS_ATOL = 2e-3


# RMSNorm kernel launches of each main-path run, by run
RMSNORM_RUNS = {}
# a self-draft proposes the target's own greedy tokens, computed through
# other reads (its prefill's naive attention and its dense decode read
# against the verify's paged read), so it is rejected only at bf16 near
# ties: every rejected proposal must be within NEAR_TIE_ULPS of the top
# of a dense forward's logits there (read on an H100 at full width: 0.768
# accepted, 4 of 4 streams split at such ties). A dense read that
# disagrees with the paged one would leave only each round's first
# proposal (from the draft's prefill) right, so back-off would settle at
# depth 2 with accept_rate <= 0.5: the run must exceed this
SELF_DRAFT_ACCEPT = 0.6
SPEC_NEAR_TIE_ULPS = 4             # the port's rule for spec-on vs spec-off
# RMSNorm kernel cases: the layers' widths (qwen1.5-0.5b 1024, mamba2
# 768 and its gated norm's 1536, llama2-7b 4096) and two ragged ones (1000:
# the last vectors of a row fall to some threads only; 999: not a whole
# number of 16-byte vectors, read element by element) at decode, odd and
# training row counts
RMS_ROWS = (1, 8, 333, 8192)
RMS_DIMS = (768, 1024, 1536, 4096, 1000, 999)
# dense decode kernel cases (B, S, H, K, D, lengths): tests/test_kernels.py
# :72-75, the draft model's shape, G = 2, a zero-length row, a length past S
DENSE_CASES = ((2, 256, 4, 4, 128, [128, 256]),
               (3, 512, 8, 2, 128, [256, 512, 128]),
               (2, 256, 4, 1, 64, [128, 256]),
               (1, 65, 16, 16, 64, [61]), (1, 1068, 16, 16, 64, [1064]),
               (2, 300, 8, 4, 64, [300, 37]),
               (3, 300, 16, 16, 64, [300, 0, 1000]))
DENSE_TILE = 32                    # positions the m-carry fault cuts at
# long caches the split kernel cuts many ways (B, S, H, K, D, lengths):
# S 4,096 and 8,192, B in {1, 4, 8}, G in {1, 2, 8}, D in {64, 128},
# lengths that leave whole splits empty and one that reaches S
DENSE_SPLIT_CASES = ((1, 4096, 16, 16, 64, [4096]),
                     (4, 4096, 8, 4, 128, [4096, 3000, 17, 0]),
                     (8, 4096, 16, 16, 64, [4096, 1, 2048, 4095, 333, 64,
                                            0, 4000]),
                     (1, 8192, 8, 1, 128, [8192]),
                     (4, 8192, 16, 2, 64, [8192, 100, 7000, 5]),
                     (8, 8192, 8, 4, 64, [8192, 0, 1, 8191, 4096, 4097, 63,
                                          64]))
# paged cases the kernel splits many ways (T, B, G, D, lengths, int8): up to
# 4,096 positions on a 256-column table, a verify window, a chunk, whole
# splits empty, a zero-length row
PAGED_SPLIT_CASES = ((1, 8, 1, 64, [4096, 1, 2048, 4095, 333, 64, 0, 4000],
                      False),
                     (5, 4, 2, 128, [4096, 17, 0, 2000], True),
                     (64, 1, 1, 64, [4096], True),
                     (8, 2, 4, 64, [3000, 40], False))
# rows of the dense phase: a decode step's 8 and a training step's 4 x 2048
DENSE_ROWS = (8, 8192)
# the tensor cores and an f32 SGEMM sum a product's K terms in other orders
# and roundings, so the two routes' f32 sums differ by roundoff that grows
# with K and with the sums' scale (projections sum to 10-100 over up to
# 152,064 terms, against flash's ~1 over <= 8,192); where a sum cancels to
# near zero that difference is many bf16 ulps of the result. The floor is
# that roundoff, sqrt(K) * 2^-24 * the output's rms, this many times over;
# phase 19 also prints which products break 1 ulp at flash's 1e-5 floor
DENSE_ROUNDOFFS = 16


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def norms_per_forward(cfg) -> int:
    """RMSNorm calls of one forward: each layer's mixer and FFN norms, an
    SSM layer's gated norm, and the final norm."""
    return sum(3 if kind == "ssm" else 2
               for kind in cfg.layer_kinds()) + 1


def norms_per_train_step(cfg, seq: int, remat: bool) -> int:
    """RMSNorm launches of one dense training step: 2 norms a layer (again
    when full remat recomputes the layer), and the final norm in each
    512-token loss block, which is checkpointed (forward and
    recompute)."""
    return 2 * cfg.n_layers * (2 if remat else 1) + 2 * -(-seq // 512)


def count_rmsnorm(run: str, launches: int, want: int, what: str) -> str:
    check(launches == want, f"{run}: RMSNorm launches {launches} != {want} "
          f"({what})")
    RMSNORM_RUNS[run] = launches
    return f"RMSNorm launches {launches} = {what}"


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


def graph_ms(fn, iters: int = 48, reps: int = 10) -> float:
    """Device time (ms) per call of ``fn(i)``, i < ``iters``, captured
    once in a CUDA graph and replayed ``reps`` times between two events:
    for calls whose device time is near or below the host's per-call cost
    (a small kernel behind its Python wrapper), where ``cuda_ms`` would
    time the host."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm up off the capture
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


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


def paged_vs_plain(args, run=None):
    """The paged kernel (or ``run``) against the plain version on the same
    inputs: (worst |err| of the normalized output, whether it, m and l are
    within ``KERNEL_TOL``)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    got = (run or fd._paged_mq_cuda)(*args)
    want = fd._paged_prefix_torch(*args)
    torch.cuda.synchronize()
    og, ow = normalized(got[0], got[2]), normalized(want[0], want[2])
    ok = (allclose(og, ow, **KERNEL_TOL) and
          allclose(got[1], want[1], **KERNEL_TOL) and
          allclose(got[2], want[2], **KERNEL_TOL))
    return max_err(og, ow), ok


def paged_split_parts(run, args, short=False):
    """Each of the kernel's column splits at this shape as its own
    partial, from ``run`` on that split's table columns alone (one launch
    per row and split, one split each); ``short`` drops the last page of
    every split's span."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    q, k, v, table, lens, ks, vs = args
    bs, mb = k.shape[1], table.shape[1]
    n_split = fd.paged_splits(q.shape[0], k.shape[2], mb,
                              torch.cuda.get_device_properties(
                                  0).multi_processor_count)
    parts = []
    for lo, hi in fd.page_spans(lens, bs, mb, n_split):
        rows = []
        for r in range(q.shape[0]):
            a, b = int(lo[r]), int(hi[r]) - int(short and hi[r] > lo[r])
            live = max(0, min(int(lens[r]) - a * bs, (b - a) * bs))
            cols = (slice(a, b) if live else slice(0, 1))  # >= 1 column
            rows.append(run(q[r:r + 1], k, v,
                            table[r:r + 1, cols].contiguous(),
                            torch.tensor([live], dtype=torch.int32,
                                         device=q.device), ks, vs,
                            n_split=1))
        parts.append(tuple(torch.cat(x) for x in zip(*rows)))
    return parts


def _paged_split_dropped(run):
    """The middle split's partial left out of the merge."""
    def fault(*args):
        from repro_torch.kernels import flash_decode as fd
        parts = paged_split_parts(run, args)
        if len(parts) > 1:
            del parts[len(parts) // 2]
        return fd.merge_split_partials(parts)
    return fault


def _paged_no_rescale(run):
    """The splits' partials summed as they are, without the rescale to
    their common max."""
    def fault(*args):
        import torch
        parts = paged_split_parts(run, args)
        return (sum(p[0] for p in parts),
                torch.stack([p[1] for p in parts]).amax(0),
                sum(p[2] for p in parts))
    return fault


def _paged_span_short(run):
    """Every split's span one page short (its last page not read)."""
    def fault(*args):
        from repro_torch.kernels import flash_decode as fd
        return fd.merge_split_partials(paged_split_parts(run, args,
                                                         short=True))
    return fault


def _paged_scale_skipped(run):
    """int8 pages read without their scales (all ones)."""
    def fault(q, k, v, table, lens, ks, vs):
        import torch
        if ks is not None:
            ks, vs = torch.ones_like(ks), torch.ones_like(vs)
        return run(q, k, v, table, lens, ks, vs)
    return fault


PAGED_PLANTED = (("one split's partial dropped", _paged_split_dropped),
                 ("partials merged without the rescale to the common max",
                  _paged_no_rescale),
                 ("each split's span one page short", _paged_span_short),
                 ("int8 scales skipped", _paged_scale_skipped))


def phase_kernel_vs_plain():
    import torch
    from repro_torch.kernels import flash_decode as fd
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n = 0
    worst = 0.0
    cases = []
    for t in (1, 4, 8, 64):
        for gq in (1, 2, 4):
            for d in (64, 128):
                for quant in (False, True):
                    bs, mb, kv = 16, 8, 2
                    cases.append(dict(b=3, t=t, h=kv * gq, kv=kv, d=d, bs=bs,
                                      lengths=[mb * bs - 5, bs + 3, 0],
                                      mb=mb, n_blocks=40, quant=quant))
    # contexts the kernel splits many ways: up to 4,096 positions on a
    # 256-column table, B up to 8, G 1/2/4, whole splits empty
    for t, b, gq, d, lengths, quant in PAGED_SPLIT_CASES:
        kv = 16 if gq == 1 else 4
        cases.append(dict(b=b, t=t, h=kv * gq, kv=kv, d=d, bs=16,
                          lengths=lengths, mb=256,
                          n_blocks=sum(-(-x // 16) for x in lengths) + 2,
                          quant=quant))
    splits = []
    for i, c in enumerate(cases):
        q, k, v, ks, vs, table, lens = make_paged_case(**c, seed=i)
        args = (q, k[0], v[0], table, lens, layer(ks, 0), layer(vs, 0))
        tag = (f"B={c['b']} T={c['t']} G={c['h'] // c['kv']} D={c['d']} "
               f"mb={c['mb']} {'int8' if c['quant'] else 'bf16'}")
        err, ok = paged_vs_plain(args)
        check(ok, f"kernel differs from plain at {tag}: {err}")
        got = fd._paged_mq_cuda(*args)
        empty = lens == 0
        check(bool((got[0][empty] == 0).all() and (got[2][empty] == 0).all()
                   and (got[1][empty] == -1e30).all()),
              f"zero-length row not empty at {tag}")
        worst = max(worst, err)
        splits.append(fd.paged_splits(c["b"], c["kv"], c["mb"], n_sm))
        # row t of a T-wide read is the T=1 read of q[:, t], bit for bit
        for t in range(c["t"]):
            one = fd._paged_mq_cuda(q[:, t:t + 1].contiguous(), *args[1:])
            check(all(torch.equal(a[:, t:t + 1], b) for a, b in
                      zip(got, one)),
                  f"row {t} of the T={c['t']} read != the T=1 read at {tag}")
        if c["t"] == 1:
            kw = dict(k_scale=layer(ks, 0), v_scale=layer(vs, 0))
            one = fd.paged_flash_decode_partial(q[:, 0], *args[1:5], **kw)
            mq = fd.paged_flash_prefix_partial(q, *args[1:5], **kw)
            for a, b in zip(one, mq):
                check(torch.equal(a, b[:, 0]),
                      f"T=1 decode != prefix bitwise at {tag}")
        n += 1
    long = splits[-len(PAGED_SPLIT_CASES):]
    check(all(x > 1 for x in long), f"a long case ran unsplit: {long}")
    print(f"[kernel] {n} cases kernel == plain within rtol=atol=2e-5 "
          f"(max |err| of normalized output {worst:.3g}); T=1 decode read "
          f"== prefix read bitwise; row t of every T-wide read == the T=1 "
          f"read bitwise; zero-length rows empty; column splits per case "
          f"{splits[0]} (the {n - len(long)} short cases), then {long} (up "
          f"to 4,096 positions on a 256-column table)")
    for name, fault in PAGED_PLANTED:
        caught, total = [], 0
        for i, c in enumerate(cases):
            if name.startswith("int8") and not c["quant"]:
                continue
            if "split" in name or "merged" in name:
                if splits[i] == 1:
                    continue
            total += 1
            q, k, v, ks, vs, table, lens = make_paged_case(**c, seed=i)
            err, ok = paged_vs_plain(
                (q, k[0], v[0], table, lens, layer(ks, 0), layer(vs, 0)),
                fault(fd._paged_mq_cuda))
            if not ok:
                caught.append(err)
        check(bool(caught), f"planted paged fault '{name}' passes every "
              f"case")
        print(f"[kernel] planted fault '{name}': caught at {len(caught)} of "
              f"{total} cases it applies to (max |err| "
              f"{min(caught):.3g}-{max(caught):.3g})")


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


SERVE_LENS = [64, 256, 1000]       # the engine phases' prompts, cycled
SERVE_NEW = 64                     # new tokens a request


def free_card() -> None:
    """Release what dropped engines held: an engine is a reference cycle
    (its scheduler's preemption hook), and its graphs hold their pool."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def pool_bytes(eng, null_block: bool):
    """Clones of the paged KV storage (with or without the null block,
    which the appends of inactive rows race into) and the SSM pool."""
    kv = eng.kv.state if null_block else eng.kv.pool()
    return ({k: v.clone() for k, v in kv.items()},
            {(pos, leaf): a.clone() for pos, st in eng._ssm_states.items()
             for leaf, a in st.items()})


def mib(tensors: dict) -> int:
    return sum(v.numel() * v.element_size() for v in tensors.values()) >> 20


def pools_equal(a, b) -> bool:
    import torch
    return all(a[i].keys() == b[i].keys() and
               all(torch.equal(a[i][k], b[i][k]) for k in a[i])
               for i in range(2))


def counters(st) -> dict:
    """``stats()`` without its times (every key ending in ``_s``)."""
    return {k: v for k, v in st.items() if not k.endswith("_s")}


def drive_engine(eng, prompts, max_new: int, max_steps: int):
    """The engine phases' main path: ``warmup`` for every table bucket of
    the trace (it must leave both pools bitwise as they were), every
    launch count set to 0, the burst served, each decode step's wall and
    SSD launches recorded (and the host inputs of the last decode step
    with every row live, by key). Returns the run's record."""
    import torch
    from repro_torch.kernels import ssd as ssdk
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import Request
    before = pool_bytes(eng, null_block=True)
    lens = sorted({len(p) for p in prompts})
    t0 = time.monotonic()
    eng.warmup(max(lens) + max_new, prompt_lens=lens)
    torch.cuda.synchronize()
    warm_s = time.monotonic() - t0
    check(pools_equal(before, pool_bytes(eng, null_block=True)),
          "warmup changed the pools")
    del before
    warm_traces = dict(eng.trace_counts)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
    walls, ssd_in_decode, full = [], [], {}
    name = "_decode_spec" if eng.spec is not None else "_decode_fused"
    decode, run_step = getattr(eng, name), eng._run_step

    def timed(live):
        if live:
            n, t = ssdk.LAUNCHES["ssd"], time.perf_counter()
        decode(live)
        if live:
            walls.append(time.perf_counter() - t)
            ssd_in_decode.append(ssdk.LAUNCHES["ssd"] - n)

    def recorded(key, impl, inputs):
        if key[0] == "decode" and inputs["active"].all():
            full.clear()
            full[key] = {k: a.copy() for k, a in inputs.items()}
        return run_step(key, impl, inputs)

    setattr(eng, name, timed)
    eng._run_step = recorded
    torch.cuda.synchronize()
    for c in graphs.KERNEL_COUNTERS:   # count the main path's run only
        c.clear()
    t0 = time.monotonic()
    done = eng.run(max_steps=max_steps)
    torch.cuda.synchronize()
    return {"done": done, "st": eng.stats(), "wall": time.monotonic() - t0,
            "walls": walls, "ssd_in_decode": ssd_in_decode, "full": full,
            "warm_traces": warm_traces, "traces": dict(eng.trace_counts),
            "graphs": len(eng._graphs), "warm_s": warm_s}


def wall_line(rec) -> str:
    w = sorted(rec["walls"])
    return (f"{rec['st']['decode_tok_s']:.1f} tok/s, p50 TTFT "
            f"{rec['st']['p50_ttft_s'] * 1e3:.1f} ms, wall per decode step "
            f"{w[0] * 1e3:.2f}/{w[len(w) // 2] * 1e3:.2f}/{w[-1] * 1e3:.2f} "
            f"ms (min/median/max of {len(w)})")


def compare_replay(name, rep, eager_rec, eager_eng, pools: str) -> None:
    """The graph phase's checks of one trace: the replaying engine's
    tokens, ``stats()`` counters and final pools (``rep["pools"]``)
    bitwise the eager engine's, and no capture after its warmup."""
    got = {r.rid: r.output for r in rep["done"]}
    want = {r.rid: r.output for r in eager_rec["done"]}
    check(got == want, f"{name}: replayed tokens differ from the eager "
          f"engine's at rids {[k for k in want if got.get(k) != want[k]]}")
    a, b = counters(rep["st"]), counters(eager_rec["st"])
    check(a == b, f"{name}: stats() counters differ: "
          f"{ {k: (a[k], b.get(k)) for k in a if a[k] != b.get(k)} }")
    check(pools_equal(rep["pools"], pool_bytes(eager_eng, null_block=False)),
          f"{name}: final KV or SSM pool bytes differ from the eager "
          f"engine's")
    check(rep["traces"] == rep["warm_traces"],
          f"{name}: captured while serving: "
          f"{set(rep['traces']) - set(rep['warm_traces'])}")
    check(rep["graphs"] == len(rep["warm_traces"]) and
          eager_rec["graphs"] == 0,
          f"{name}: {rep['graphs']} graphs for {len(rep['warm_traces'])} "
          f"keys, the eager engine {eager_rec['graphs']}")
    print(f"[graphs] {name}: replay == eager bitwise: the tokens of "
          f"{len(got)} requests, {len(a)} stats() counters, the final "
          f"pools ({pools}); {rep['graphs']} "
          f"graphs captured by warmup in {rep['warm_s']:.2f}s (both pools "
          f"bitwise unchanged), 0 while serving. Replay: {wall_line(rep)}; "
          f"eager: {wall_line(eager_rec)}; {card_line()}")


def phase_engine(cfg, params, *, prefill_chunk, kv_quant, cuda_graphs=True):
    """Serve the 16-request burst through the engine's entry points and
    hold the run's launch counts and tokens. ``cuda_graphs=False`` is the
    graph phase's eager twin of the same run (its tokens are held to the
    replayed run's, bitwise, instead of to a dense forward)."""
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                 kv_quant=kv_quant, prefill_chunk=prefill_chunk,
                 device="cuda", cuda_graphs=cuda_graphs)
    prompts = serving_requests(16, cfg.vocab_size, prompt_lens=SERVE_LENS)
    rec = drive_engine(eng, prompts, SERVE_NEW, 5000)
    done, st = rec["done"], rec["st"]
    launches = fd.LAUNCHES["paged_attention"]
    check(sum(fa.LAUNCHES.values()) == 0,
          f"the engine launched flash kernels: {dict(fa.LAUNCHES)}")
    steps = st["decode_steps"] + st["chunk_steps"]
    check(len(done) == 16 and st["finished"] == 16,
          f"{st['finished']} of 16 requests finished")
    check(all(len(r.output) == SERVE_NEW for r in done),
          f"a request ended with fewer than {SERVE_NEW} tokens")
    check(launches == cfg.n_layers * steps,
          f"kernel launches {launches} != {cfg.n_layers} x {steps} steps")
    mode = (f"chunk={prefill_chunk}" if prefill_chunk else "whole-prompt")
    run = (f"{cfg.name} {mode} kv={kv_quant}"
           + ("" if cuda_graphs else " eager"))
    forwards = st["prefill_groups"] + steps
    want = norms_per_forward(cfg) * forwards
    what = f"{norms_per_forward(cfg)} x {forwards} forwards"
    if cuda_graphs:
        rms = count_rmsnorm(run, rn.LAUNCHES["rmsnorm"], want, what)
        share, worst = teacher_forced(eng.model, eng.params, done, kv_quant)
        tokens = (f"dense-argmax match {share:.4f} (others within "
                  f"{worst:.1f} <= {NEAR_TIE_ULPS} bf16 ulps)")
    else:
        check(rn.LAUNCHES["rmsnorm"] == want, f"{run}: RMSNorm launches "
              f"{rn.LAUNCHES['rmsnorm']} != {want} ({what})")
        rms = f"RMSNorm launches {want} = {what}"
        tokens = "tokens held to the replayed run's"
    print(f"[engine] {cfg.name} full width, {mode}, kv={kv_quant}, "
          f"{'graph replay' if cuda_graphs else 'eager'}: 16/16 finished x "
          f"{SERVE_NEW} tokens in {rec['wall']:.2f}s; {st['decode_steps']} "
          f"decode + {st['chunk_steps']} chunk steps, kernel launches "
          f"{launches} = {cfg.n_layers} x {steps}; {rms}; preemptions "
          f"{st['preemptions']}; {tokens}; decode "
          f"{st['decode_tok_s']:.1f} tok/s, p50 TTFT "
          f"{st['p50_ttft_s'] * 1e3:.1f} ms")
    rec["launches"] = launches
    return rec, eng


def phase_graphs_dense(cfg, params):
    """Phases 4 and 20 on a dense arch: each engine trace through the
    replayed steps (phase 4's checks), then eagerly, held bitwise."""
    out = []
    for chunk, quant in ((None, "none"), (64, "int8")):
        rep, eng = phase_engine(cfg, params, prefill_chunk=chunk,
                                kv_quant=quant)
        rep["pools"] = pool_bytes(eng, null_block=False)
        pools = f"KV {mib(rep['pools'][0])} MiB"
        del eng
        free_card()
        eager, eng = phase_engine(cfg, params, prefill_chunk=chunk,
                                  kv_quant=quant, cuda_graphs=False)
        mode = f"chunk={chunk} int8" if chunk else "whole-prompt bf16"
        compare_replay(f"{cfg.name} {mode}", rep, eager, eng, pools)
        del eng, eager, rep["pools"]
        free_card()
        out.append(rep)
    return out


def replay_busy_ms(eng, full, reps: int = 20) -> float:
    """Device time (ms) of one decode step with every row live: the graph
    of the run's last such step replayed ``reps`` times on its inputs
    between two events (each replay writes the same KV again)."""
    import torch
    (key, inputs), = full.items()
    graph = eng._graphs[key]
    graph.replay(inputs)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def decode_bound_ms(eng, inputs) -> float:
    """Least time (ms) of one decode step on these inputs: every weight
    read once (an untied embedding table only at the batch's rows), the
    live KV (with int8 scales) read once, each row's new KV written once,
    at the card's memory rate; its operations (2 per weight a row) take
    far less at the bf16 peak."""
    from repro_torch.models.params import tree_paths
    cfg, kv = eng.cfg, eng.kv_cfg
    rows = int(inputs["active"].sum())
    leaves = [t for path, t in tree_paths(eng.params)
              if path != "embed" or cfg.tie_embeddings]
    n_weights = sum(t.numel() for t in leaves)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    if not cfg.tie_embeddings:
        weights += rows * cfg.d_model * eng.params["embed"].element_size()
    per_token = kv.n_layers * 2 * kv.n_kv_heads * (
        kv.head_dim * (1 if kv.kv_quant == "int8" else 2)
        + (4 if kv.kv_quant == "int8" else 0))
    live = int(inputs["lengths"][inputs["active"]].sum())
    t_bytes = (weights + (live + rows) * per_token) / HBM_BYTES_PER_S
    t_ops = 2.0 * rows * n_weights / PEAK_OPS["bf16"]
    return max(t_bytes, t_ops) * 1e3


def phase_llama2(cfg):
    """llama2-7b at full width (seeded weights) through the captured
    steps: phase 4's burst and checks, whole-prompt bf16 KV then chunked
    (64) int8 KV; decode tok/s, the wall per decode step and the device
    time of a full decode step beside that step's byte bound."""
    from repro_torch.models.lm import LM
    params = LM(cfg, device="cuda").init(0)
    out = []
    for chunk, quant in ((None, "none"), (64, "int8")):
        rec, eng = phase_engine(cfg, params, prefill_chunk=chunk,
                                kv_quant=quant)
        (_, inputs), = rec["full"].items()
        busy = replay_busy_ms(eng, rec["full"])
        bound = decode_bound_ms(eng, inputs)
        rows = int(inputs["active"].sum())
        w = sorted(rec["walls"])
        check(rec["traces"] == rec["warm_traces"],
              f"llama2 captured while serving: "
              f"{set(rec['traces']) - set(rec['warm_traces'])}")
        mode = f"chunk={chunk} int8" if chunk else "whole-prompt bf16"
        print(f"[llama2] {cfg.name} {mode}: {rec['graphs']} graphs, 0 "
              f"captured while serving; decode {rec['st']['decode_tok_s']:.1f}"
              f" tok/s; wall per decode step {w[0] * 1e3:.2f}/"
              f"{w[len(w) // 2] * 1e3:.2f}/{w[-1] * 1e3:.2f} ms (min/median/"
              f"max); a full step ({rows} rows, "
              f"{int(inputs['lengths'].sum())} live positions) by graph "
              f"replay {busy:.3f} ms against its byte bound {bound:.3f} ms "
              f"({bound / busy * 100:.1f}% of it; at most "
              f"{rows / bound * 1e3:.0f} tok/s); {card_line()}")
        out.append(rec)
        del eng
        free_card()
    del params
    free_card()
    return out


def time_shape(cfg, *, b, t, lengths, quant, mb, n_blocks, n_layers,
               splits=()):
    """The kernel against its plain version at one shape of the main path
    (normalized output, m and l within ``KERNEL_TOL``), then kernel, plain
    and library times there, cycling through ``n_layers`` pools as the
    engine does so the pages are not L2-hot. The kernel and SDPA are timed
    by CUDA-graph replay (their device time is below the wrapper's host
    cost), and once more by events around a run of calls, as earlier
    readings were; the plain version reads ``lengths`` on the host, so
    events time it. The kernel is also timed at each split count of
    ``splits``, the neighbours of ``paged_splits``' choice."""
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
    ms = graph_ms(lambda i: fd._paged_mq_cuda(*args(i), sm_scale=scale))
    by_split = {n: graph_ms(lambda i: fd._paged_mq_cuda(
        *args(i), sm_scale=scale, n_split=n)) for n in splits}
    event_ms = cuda_ms(lambda i: fd._paged_mq_cuda(*args(i),
                                                   sm_scale=scale),
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

    def sdpa(i):
        return F.scaled_dot_product_attention(
            qd, *dense[i % n_layers], attn_mask=mask, scale=scale)

    lib_ms = graph_ms(sdpa)
    lib_event_ms = cuda_ms(sdpa, iters=200)
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
            "max_abs_err": err, "event_ms": event_ms, "by_split": by_split,
            "library_event_ms": lib_event_ms,
            "n_split": fd.paged_splits(b, kv, mb, torch.cuda.
                                       get_device_properties(0).
                                       multi_processor_count)}



# --------------------------------------------------------------------------
# flash attention and training
# --------------------------------------------------------------------------


def flash_inputs(*, b, h, kv, t, s, d, dtype, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b, h, t, d), generator=g, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, kv, s, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v, do


def bf16_ulp_check(a, b, n: int, atol: float = BF16_ATOL):
    """(worst |a - b| in bf16 ulps of the larger magnitude among the
    elements that differ by more than ``atol``, 0 if none; whether every
    element is within ``atol`` + ``n`` such ulps)."""
    import torch
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (a - b).abs()
    over = diff > atol
    worst = float((diff / ulp)[over].max()) if bool(over.any()) else 0.0
    return worst, bool((diff <= atol + n * ulp).all())


def flash_vs_plain(q, k, v, do, causal, grad_ulps=BF16_ULPS, strict=True):
    """Forward and backward kernels against the plain versions on the
    same inputs: f32 outputs and lse within ``KERNEL_TOL``, bf16 outputs
    within ``BF16_ULPS`` (o) and ``grad_ulps`` (dq, dk, dv) bf16 ulps.
    Returns the worst |err| of (o, lse, dq, dk, dv), how many elements of
    each differ at all, and the worst bf16 ulps of the bf16 outputs; with
    ``strict=False`` the outputs whose limit broke instead of failing."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa._fwd_cuda(q, k, v, causal=causal, sm_scale=None)
    o_ref, lse_ref = fa._flash_fwd_torch(q, k, v, causal=causal)
    grads = fa._bwd_cuda(q, k, v, o, lse, do, causal=causal, sm_scale=None)
    want = fa._flash_bwd_torch(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    dims = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3])
    tag = (f"B,H,K,T,S,D={dims} {q.dtype} "
           f"{'causal' if causal else 'full'}")
    errs, n_diff, ulps, broken = {}, {}, {}, []
    for name, a, b, n_ulps in (("o", o, o_ref, BF16_ULPS),
                               ("lse", lse, lse_ref, None),
                               *[(n, x, y, grad_ulps) for n, x, y in
                                 zip(("dq", "dk", "dv"), grads, want)]):
        errs[name] = max_err(a.float(), b.float())
        n_diff[name] = int((a != b).sum())
        if a.dtype == torch.bfloat16:
            ulps[name], ok = bf16_ulp_check(a, b, n_ulps)
            msg = (f"flash {name} differs from plain at {tag} by "
                   f"{ulps[name]} bf16 ulps > {n_ulps} (max |err| "
                   f"{errs[name]})")
        else:
            ok = allclose(a, b, **KERNEL_TOL)
            msg = f"flash {name} differs from plain at {tag}: {errs[name]}"
        if not ok:
            broken.append(name)
        if strict:
            check(ok, msg)
    if not strict:
        return broken
    return errs, n_diff, ulps


def phase_flash_vs_plain():
    import torch
    from repro_torch.models import layers as L
    cases = ([(1, 4, 4, 128, 128, 128, c) for c in (True, False)]
             + [(2, 4, 2, 256, 256, 128, c) for c in (True, False)]
             + [(1, 8, 1, 256, 256, 64, c) for c in (True, False)]
             + [(2, 4, 4, 128, 384, 128, False)]
             + [(1, 8, 8 // g, 192, 192, d, True) for g in (1, 2, 4, 8)
                for d in (64, 128)]
             + [(2, 4, 2, 100, 100, 64, True), (1, 2, 1, 70, 130, 64,
                                                  False)])
    from repro_torch.kernels import flash_attention as fa
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_ulps = 0.0
    n = 0
    bodies = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, h, kv, t, s, d, causal) in enumerate(cases):
            errs, _, ulps = flash_vs_plain(*flash_inputs(
                b=b, h=h, kv=kv, t=t, s=s, d=d, dtype=dtype, seed=i), causal)
            worst[dtype] = max(worst[dtype], *errs.values())
            worst_ulps = max(worst_ulps, *ulps.values(), 0.0)
            fwd, bwd = fa.fwd_body(dtype, d), fa.bwd_body(dtype, d)
            check(fwd == bwd == ("mma" if dtype == torch.bfloat16 and
                                 d in (64, 128) else "simt"),
                  f"flash bodies fwd {fwd}, bwd {bwd} for {dtype} at D={d}")
            key = (str(dtype).replace("torch.", ""), fwd, bwd)
            bodies[key] = bodies.get(key, 0) + 1
            n += 1
    sh = TRAIN_SHAPE
    n_row = sh["h"] * sh["t"]
    train = dict(b=1, h=sh["h"], kv=sh["h"], t=sh["t"], s=sh["t"],
                 d=sh["d"])
    f32_errs, _, _ = flash_vs_plain(*flash_inputs(
        **train, dtype=torch.float32, seed=98), True)
    train_errs, train_diff, train_ulps = flash_vs_plain(*flash_inputs(
        **train, dtype=torch.bfloat16, seed=99), True,
        grad_ulps=BF16_ULPS_G1_GRADS)
    # the autograd wrapper end to end, f32, against naive attention
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn((2, 256, 8, 64), generator=g, device="cuda")
    k, v = (torch.randn((2, 256, 2, 64), generator=g, device="cuda")
            for _ in range(2))
    w = torch.randn((2, 256, 8, 64), generator=g, device="cuda")
    res = []
    for mode in ("naive", "flash"):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = L.attention(*xs, mode=mode, causal=True)
        res.append((out.detach(), *torch.autograd.grad((out * w).sum(), xs)))
    grad_err = max(max_err(a, b) for a, b in zip(*res))
    for name, a, b in zip(("out", "dq", "dk", "dv"), *res):
        check(allclose(a, b, **GRAD_TOL),
              f"flash autograd {name} differs from naive: {max_err(a, b)}")
    print(f"[flash] {n} cases fwd+bwd kernels == plain (f32 within "
          f"rtol=atol=2e-5, max |err| {worst[torch.float32]:.3g}; bf16 "
          f"within {BF16_ULPS} ulps + {BF16_ATOL}, max |err| "
          f"{worst[torch.bfloat16]:.3g}, max {worst_ulps:g} ulps beyond "
          f"the floor); training "
          f"shape B=1 f32 within rtol=atol=2e-5, max |err| "
          + ", ".join(f"{nm} {e:.3g}" for nm, e in f32_errs.items())
          + f"; training shape B=1 bf16 (o within {BF16_ULPS} ulps, "
          f"dq/dk/dv within {BF16_ULPS_G1_GRADS}) max |err| "
          + ", ".join(f"{nm} {e:.3g}" for nm, e in train_errs.items())
          + f", max ulps beyond the {BF16_ATOL} floor "
          + ", ".join(f"{nm} {u:g}" for nm, u in train_ulps.items())
          + " (elements that differ: "
          + ", ".join(f"{nm} {c} of {n_row if nm == 'lse' else n_row * sh['d']}"
                      for nm, c in train_diff.items()) + ")"
          + f"; autograd through the kernels == naive autograd within "
          f"2e-3 (max |err| {grad_err:.3g}); forward/backward body per "
          f"case: "
          + ", ".join(f"{dt} {fb}/{bb} x {c}" for (dt, fb, bb), c in
                      sorted(bodies.items()))
          + f", training shape bf16 {fa.fwd_body(torch.bfloat16, sh['d'])}/"
          f"{fa.bwd_body(torch.bfloat16, sh['d'])}")
    # planted in the kernel build: P's low half dropped from dV += P^T dO
    caught, total = [], 0
    with fault_build(fa, FLASH_FAULT):
        for i, (b, h, kv, t, s, d, causal) in enumerate(cases):
            if fa.bwd_body(torch.bfloat16, d) != "mma":
                continue
            total += 1
            broken = flash_vs_plain(*flash_inputs(
                b=b, h=h, kv=kv, t=t, s=s, d=d, dtype=torch.bfloat16,
                seed=i), causal, strict=False)
            if broken:
                caught.append(f"{(b, h, kv, t, s, d, causal)}: "
                              f"{'/'.join(broken)}")
        total += 1
        broken = flash_vs_plain(*flash_inputs(
            **train, dtype=torch.bfloat16, seed=99), True,
            grad_ulps=BF16_ULPS_G1_GRADS, strict=False)
        if broken:
            caught.append(f"training shape: {'/'.join(broken)}")
    print(f"[flash] planted fault 'P rounded to bf16 with no low half' "
          f"(a build with -D{FLASH_FAULT[0]}): caught at {len(caught)} of "
          f"{total} bf16 tensor-core cases"
          + (": " + "; ".join(caught) if caught else
             " (dV moves by under a bf16 ulp; a finding, not a check)"))
    # planted in the kernel build: P's low half dropped from the forward's
    # O += P V (a reading, as the backward's)
    caught, total = [], 0
    with fault_build(fa, FLASH_FWD_FAULT):
        for i, (b, h, kv, t, s, d, causal) in enumerate(cases):
            if fa.fwd_body(torch.bfloat16, d) != "mma":
                continue
            total += 1
            broken = flash_vs_plain(*flash_inputs(
                b=b, h=h, kv=kv, t=t, s=s, d=d, dtype=torch.bfloat16,
                seed=i), causal, strict=False)
            if broken:
                caught.append(f"{(b, h, kv, t, s, d, causal)}: "
                              f"{'/'.join(broken)}")
        total += 1
        broken = flash_vs_plain(*flash_inputs(
            **train, dtype=torch.bfloat16, seed=99), True,
            grad_ulps=BF16_ULPS_G1_GRADS, strict=False)
        if broken:
            caught.append(f"training shape: {'/'.join(broken)}")
    print(f"[flash] planted fault 'forward P rounded to bf16 with no low "
          f"half' (a build with -D{FLASH_FWD_FAULT[0]}): caught at "
          f"{len(caught)} of {total} bf16 tensor-core cases"
          + (": " + "; ".join(caught) if caught else
             " (o moves by under a bf16 ulp; a finding, not a check)"))


def _zero_output(fwd):
    def run(*args, **kw):
        o, lse = fwd(*args, **kw)
        return o.zero_(), lse
    return run


def _drop_dq(bwd):
    def run(*args, **kw):
        dq, dk, dv = bwd(*args, **kw)
        return dq.zero_(), dk, dv
    return run


# faults planted in the flash wrappers, in process, to show that the
# flash-vs-naive limits of phase 7 can fail: (name, wrapper, fault)
PLANTED = (("attention output zeroed", "_fwd_cuda", _zero_output),
           ("dq dropped", "_bwd_cuda", _drop_dq))


@contextlib.contextmanager
def planted(module, attr, fault):
    real = getattr(module, attr)
    setattr(module, attr, fault(real))
    try:
        yield
    finally:
        setattr(module, attr, real)


# a macro that builds the flash library with P's low half dropped from the
# dV product of the tensor-core backward (csrc/flash_attention.cu)
FLASH_FAULT = ("FLASH_PLANT_P_HI_ONLY",)
# and with P's low half dropped from the tensor-core forward's O += P V
FLASH_FWD_FAULT = ("FLASH_PLANT_FWD_P_HI_ONLY",)


# a macro that builds the int8 library with only the hi part of its split
# operands (csrc/quant_matmul.cu)
QMM_FAULT = ("QMM_PLANT_SPLIT_HI_ONLY",)
# macros that build the SSD library with only the hi parts of its split
# operands, and with the state pass leaving out the first chunk's
# contribution (csrc/ssd.cu)
SSD_HI_FAULT = ("SSD_PLANT_HI_ONLY",)
SSD_PASS_FAULT = ("SSD_PLANT_PASS_SKIPS_U0",)
# and with every part product left out: phase 11 times its staging alone
SSD_NO_PRODUCTS = ("SSD_TIME_NO_PRODUCTS",)


@contextlib.contextmanager
def fault_build(module, defines):
    """``module``'s kernels from the library built with ``defines``."""
    real = module._entries
    module._entries = lambda: real(defines)
    try:
        yield
    finally:
        module._entries = real


def train_loss_and_grads(model, params, batch):
    import torch
    from repro_torch.models.params import tree_paths
    leaves = [t for _, t in tree_paths(params)]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads))
    return float(loss.detach()), float(norm), grads


def phase_train(cfg):
    """Full width through the trainer's entry point: flash vs naive on
    step 0's batch, then 4 F+R+Z3 steps with the launch counts read."""
    import torch
    from repro_torch.core.config import ShapeSpec, technique_from_label
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.models.lm import LM
    sh = TRAIN_SHAPE
    steps = 4
    trainer = Trainer(cfg, ShapeSpec("cli", sh["t"], sh["b"], "train"),
                      technique_from_label("F+R+Z3"),
                      TrainerConfig(steps=steps, log_every=1),
                      device="cuda")
    model = trainer.model
    check(model.attn_impl == "flash" and model.remat == "full",
          f"F+R+Z3 built attn_impl={model.attn_impl} remat={model.remat}")
    params = trainer.state["params"]
    batch = trainer._batch_for(0)
    naive = LM(cfg, attn_impl="naive", remat="full", device="cuda")
    t0 = time.monotonic()
    ln, nn_, gn = train_loss_and_grads(naive, params, batch)

    def against_naive():
        """Flash's loss, grad_norm and worst leaf cosine against naive's,
        and the limits each breaks."""
        lf, nf, gf = train_loss_and_grads(model, params, batch)
        cos = min(float(torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().flatten(), dim=0))
            for a, b in zip(gf, gn))
        reading = {"loss": abs(lf - ln), "grad_norm": abs(nf - nn_) / nn_,
                   "cosine": cos}
        broken = [k for k, bad in (
            ("loss", reading["loss"] > LOSS_ATOL),
            ("grad_norm", reading["grad_norm"] > GRAD_NORM_RTOL),
            ("cosine", not cos >= GRAD_COS)) if bad]
        return lf, nf, reading, broken

    lf, nf, reading, broken = against_naive()
    check(not broken, f"flash vs naive breaks {broken}: loss {lf} vs {ln} "
          f"(limit {LOSS_ATOL}), grad_norm {nf} vs {nn_} (limit "
          f"{GRAD_NORM_RTOL} relative), min leaf cosine {reading['cosine']}"
          f" (limit {GRAD_COS})")
    print(f"[train] step-0 batch, flash vs naive (remat full): loss "
          f"{lf:.6f} vs {ln:.6f} (|diff| {reading['loss']:.3g} <= "
          f"{LOSS_ATOL}), grad_norm {nf:.6f} vs {nn_:.6f} (rel "
          f"{reading['grad_norm']:.3g} <= {GRAD_NORM_RTOL}), min leaf "
          f"cosine {reading['cosine']:.6f} >= {GRAD_COS} "
          f"({time.monotonic() - t0:.1f}s)")
    for name, attr, fault in PLANTED:
        with planted(fa, attr, fault):
            _, _, bad_reading, bad_broken = against_naive()
        check(bool(bad_broken), f"planted fault '{name}' passes every "
              f"flash-vs-naive limit: {bad_reading}")
        print(f"[train] planted fault '{name}': |dloss| "
              f"{bad_reading['loss']:.3g}, grad_norm rel "
              f"{bad_reading['grad_norm']:.3g}, min leaf cosine "
              f"{bad_reading['cosine']:.6f}; caught by "
              + ", ".join(bad_broken))
    del gn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES.clear()                  # count the main path's run only
    fd.LAUNCHES.clear()
    rn.LAUNCHES.clear()
    out = trainer.run()
    torch.cuda.synchronize()
    launches = {n: fa.LAUNCHES[n] for n in ("fwd", "bwd_dkv", "bwd_dq")}
    per_step = norms_per_train_step(cfg, sh["t"], remat=True)
    rms = count_rmsnorm("F+R+Z3 training", rn.LAUNCHES["rmsnorm"],
                        per_step * steps, f"{per_step} per step x {steps}")
    check(fd.LAUNCHES["paged_attention"] == 0,
          "training launched the paged kernel")
    peak = torch.cuda.max_memory_allocated() / 2**30
    hist = out["history"]
    check(out["final_step"] == steps and len(hist) == steps,
          f"trainer ran {out['final_step']} of {steps} steps")
    for h in hist:
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"step {h['step']}: loss {h['loss']}, grad_norm "
              f"{h['grad_norm']}")
    want = {"fwd": 2 * cfg.n_layers * steps,
            "bwd_dkv": cfg.n_layers * steps, "bwd_dq": cfg.n_layers * steps}
    check(launches == want, f"flash launches {launches} != {want} "
          f"(48/24/24 per step)")
    print(f"[train] qwen1.5-0.5b full width, F+R+Z3, batch {sh['b']} x "
          f"{sh['t']}: {steps} steps, losses "
          + ", ".join(f"{h['loss']:.4f}" for h in hist)
          + ", grad_norms " + ", ".join(f"{h['grad_norm']:.4f}" for h in hist)
          + f"; steps 2-{steps}: {out['step_ms']:.1f} ms/step, "
          f"{out['tokens_per_s']:.0f} tokens/s; {rms}; flash launches "
          f"fwd {launches['fwd']} bwd_dkv {launches['bwd_dkv']} bwd_dq "
          f"{launches['bwd_dq']} (= {launches['fwd'] // steps}/"
          f"{launches['bwd_dkv'] // steps}/{launches['bwd_dq'] // steps} per "
          f"step); peak memory {peak:.2f} GiB; {card_line()}")
    return launches, out


def flash_bounds(*, b, h, kv, t, s, d, elt):
    """Least time (ms) of each kernel's function on this card: bytes of
    its inputs read once and outputs written once over HBM rate, against
    its useful products (causal pairs only) over the bf16 tensor-core
    rate. Returns {name: (bound_ms, bound_by)}."""
    pairs = b * h * t * (t + 1) // 2 if t == s else b * h * t * s
    qo = b * h * t * d * elt
    kv_bytes = b * kv * s * d * elt
    row = b * h * t * 4
    work = {                             # (bytes, products of 2*D per pair)
        "fwd": (qo + 2 * kv_bytes + qo + row, 2),
        "bwd_dkv": (2 * qo + 2 * kv_bytes + 2 * row + 2 * kv_bytes, 4),
        "bwd_dq": (2 * qo + 2 * kv_bytes + 2 * row + qo, 3),
        "bwd": (3 * qo + 2 * kv_bytes + row + qo + 2 * kv_bytes, 5),
    }
    out = {}
    for name, (nbytes, products) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2.0 * d * pairs * products / PEAK_OPS["bf16"] * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def built_bounds(*, b, h, t, d):
    """Least time (ms) of the tensor-core kernels as built, at the bf16
    tensor-core rate: P and dS split hi + lo double the products that take
    them, so the forward runs 1 + 2 products of 2*D per causal pair (2 of
    them useful), dK/dV 2 + 4, dQ 2 + 2, the whole backward 10 (5
    useful)."""
    pairs = b * h * t * (t + 1) // 2
    return {name: 2.0 * d * pairs * n / PEAK_OPS["bf16"] * 1e3
            for name, n in (("fwd", 3), ("bwd_dkv", 6), ("bwd_dq", 4),
                            ("bwd", 10))}


def phase_flash_timing():
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    sh = TRAIN_SHAPE
    q, k, v, do = flash_inputs(b=sh["b"], h=sh["h"], kv=sh["h"], t=sh["t"],
                               s=sh["t"], d=sh["d"], dtype=torch.bfloat16,
                               seed=5)
    errs, _, ulps = flash_vs_plain(q, k, v, do, True,
                                   grad_ulps=BF16_ULPS_G1_GRADS)
    scale = 1.0 / math.sqrt(sh["d"])
    o, lse = fa._fwd_cuda(q, k, v, causal=True, sm_scale=None)
    delta = fa._delta(o, do)
    # as the backward runs it: the tensor-core dQ kernel computes delta
    # itself (into a buffer the dK/dV kernel then reads)
    mma = fa.bwd_body(q.dtype, sh["d"]) == "mma"
    dq_delta = torch.empty_like(delta) if mma else delta
    ms = {
        "fwd": cuda_ms(lambda i: fa._fwd_cuda(q, k, v, causal=True,
                                              sm_scale=None), iters=20),
        "bwd_dkv": cuda_ms(lambda i: fa._bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal=True, scale=scale), iters=10),
        "bwd_dq": cuda_ms(lambda i: fa._bwd_dq_cuda(
            q, k, v, do, lse, dq_delta, causal=True, scale=scale,
            out=o if mma else None), iters=10),
        "bwd": cuda_ms(lambda i: fa._bwd_cuda(q, k, v, o, lse, do,
                                              causal=True, sm_scale=None),
                       iters=10),
    }
    plain = {"fwd": cuda_ms(lambda i: fa._flash_fwd_torch(q, k, v,
                                                          causal=True),
                            iters=5, warmup=1)}
    for name, part in (("bwd_dkv", "dkv"), ("bwd_dq", "dq"), ("bwd", "all")):
        plain[name] = cuda_ms(lambda i: fa._flash_bwd_torch(
            q, k, v, o, lse, do, causal=True, part=part), iters=5, warmup=1)
    lib_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=20)
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = cuda_ms(lambda i: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters=20)
    del out

    def sdpa_fwd_bwd(i):
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), do)

    lib_fb = cuda_ms(sdpa_fwd_bwd, iters=20)
    bounds = flash_bounds(b=sh["b"], h=sh["h"], kv=sh["h"], t=sh["t"],
                          s=sh["t"], d=sh["d"], elt=2)
    built = built_bounds(b=sh["b"], h=sh["h"], t=sh["t"], d=sh["d"])
    for name in ("fwd", "bwd_dkv", "bwd_dq", "bwd"):
        bd, by = bounds[name]
        body = (fa.fwd_body if name == "fwd" else fa.bwd_body)(
            torch.bfloat16, sh["d"])
        note = f"; {body} body, bound as built {built[name] * 1e3:.2f} us"
        print(f"[timing] flash {name} B=4 H=16 T=2048 D=64 causal bf16: "
              f"{ms[name] * 1e3:.1f} us (bound {bd * 1e3:.2f} us by {by}, "
              f"{bd / ms[name] * 100:.2f}% of it{note}); {card_line()}")
    print(f"[timing] flash plain fwd {plain['fwd'] * 1e3:.1f} us, plain "
          f"dk/dv {plain['bwd_dkv'] * 1e3:.1f} us, plain dq "
          f"{plain['bwd_dq'] * 1e3:.1f} us, plain bwd (dq, dk, dv) "
          f"{plain['bwd'] * 1e3:.1f} us; sdpa fwd {lib_fwd * 1e3:.1f} us, "
          f"sdpa bwd {lib_bwd * 1e3:.1f} us, sdpa fwd+bwd "
          f"{lib_fb * 1e3:.1f} us; kernels == plain (o within {BF16_ULPS} "
          f"ulps, dq/dk/dv within {BF16_ULPS_G1_GRADS}), max |err| "
          + ", ".join(f"{nm} {e:.3g}" for nm, e in errs.items())
          + f", max ulps beyond the {BF16_ATOL} floor "
          + ", ".join(f"{nm} {u:g}" for nm, u in ulps.items()))
    return {"ms": ms, "plain": plain, "lib_fwd": lib_fwd, "lib_bwd": lib_bwd,
            "lib_fb": lib_fb, "bounds": bounds, "errs": errs}


# --------------------------------------------------------------------------
# SSD kernel and mamba2 serving
# --------------------------------------------------------------------------


def ssd_case(b, t, h, p, g, n, *, init, seed):
    """Model-layout SSD inputs at the reference kernel test's scales (x,
    B, C ~ 0.5 N(0,1), dt = softplus(N(0,1)), A = -exp(0.3 N(0,1))), and
    a carried state when ``init``."""
    import torch
    g_ = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g_, device="cuda")

    x, B, C = rn(b, t, h, p) * 0.5, rn(b, t, g, n) * 0.5, rn(b, t, g, n) * 0.5
    dt = torch.nn.functional.softplus(rn(b, t, h))
    A, D = -torch.exp(rn(h) * 0.3), rn(h)
    state = rn(b, h, p, n) * 0.5 if init else None
    return x, B, C, dt, A, D, state


def _drop_init(run):
    def fault(*args, init_state=None, **kw):
        return run(*args, init_state=None, **kw)
    return fault


def _no_carry(run):
    """Each chunk from its own init only: the state is not carried."""
    def fault(xdt, b, c, a, *, chunk, init_state=None):
        import torch
        q = min(chunk, xdt.shape[2])
        ys, st = [], None
        for t0 in range(0, xdt.shape[2], q):
            sl = slice(t0, t0 + q)
            y, st = run(xdt[:, :, sl].contiguous(), b[:, :, sl].contiguous(),
                        c[:, :, sl].contiguous(), a[:, :, sl].contiguous(),
                        chunk=chunk, init_state=init_state)
            ys.append(y)
        return torch.cat(ys, dim=2), st
    return fault


SSD_PLANTED = (("init_state dropped", _drop_init),
               ("state not carried across chunks", _no_carry))


def ssd_vs_plain(case, run=None, body=None):
    """The kernel (or ``run``, a planted fault around it; ``body`` forces
    one body) against the plain version on one case: worst |err| of y and
    of the final state, and whether both are within ``SSD_TOL``."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd as ssdk
    name, b, t, h, p, g, n, chunk, init = case
    x, B, C, dt, A, _, state = ssd_case(b, t, h, p, g, n, init=init,
                                        seed=len(name) + t)
    args = kops.ssd_inputs(x, B, C, dt, A, chunk, state)
    want = ssdk.ssd_chunked_plain(*args[:4], chunk=chunk, init_state=args[4])
    kw = {} if body is None else {"body": body}
    got = (run or ssdk._ssd_cuda)(*args[:4], chunk=chunk, init_state=args[4],
                                  **kw)
    torch.cuda.synchronize()
    errs = [max_err(a, w) for a, w in zip(got, want)]
    ok = all(allclose(a, w, **SSD_TOL) for a, w in zip(got, want))
    return errs, ok


def ssd_shape(case):
    """(T as the kernel takes it, its chunk Q, CUDA kernels a call)."""
    from repro_torch.kernels import ssd as ssdk
    _, _, t, _, p, _, n, chunk, _ = case
    tp = -(-t // min(chunk, t)) * min(chunk, t)
    q = min(chunk, tp)
    return tp, q, ssdk.kernels_per_call(tp, q, n, p)


def phase_ssd_vs_plain():
    from repro_torch.kernels import ssd as ssdk
    mma_cases = []
    for case in SSD_CASES:
        name, b, t, h, p, g, n, chunk, init = case
        body = ssdk.ssd_body(n, p)
        ssdk.BODIES.clear()
        (ey, es), ok = ssd_vs_plain(case)
        tp, q, kernels = ssd_shape(case)
        tag = (f"{name} B={b} T={t} H={h} P={p} G={g} N={n} chunk={chunk}"
               f"{' +init_state' if init else ''}")
        check(ok, f"SSD kernel differs from plain at {tag}: y {ey}, state "
              f"{es} (limit {SSD_TOL})")
        check(dict(ssdk.BODIES) == {body: 1},
              f"the {tag} call ran {dict(ssdk.BODIES)}, not one {body}")
        line = (f"[ssd] {tag}: {body} body, T'={tp} in chunks of {q}, "
                f"{kernels} CUDA kernel{'s' if kernels > 1 else ''} a call; "
                f"kernel == plain within rtol={SSD_TOL['rtol']:g} "
                f"atol={SSD_TOL['atol']:g}, max |err| y {ey:.3g}, state "
                f"{es:.3g}")
        if body == "mma":
            mma_cases.append(case)
        if name in SSD_MAMBA2:
            check(body == "mma", f"mamba2's {name} shape runs the {body} "
                  f"body, not the tensor cores")
            (fy, fs), _ = ssd_vs_plain(case, body="fma")
            check(ey <= SSD_FMA_FACTOR * fy and es <= SSD_FMA_FACTOR * fs,
                  f"the tensor-core body's max |err| at {tag} (y {ey:.3g}, "
                  f"state {es:.3g}) is over {SSD_FMA_FACTOR:g}x the FMA "
                  f"body's (y {fy:.3g}, state {fs:.3g})")
            line += (f" (the FMA body on the same inputs: y {fy:.3g}, state "
                     f"{fs:.3g}; ratio {ey / max(fy, 1e-30):.2f}, "
                     f"{es / max(fs, 1e-30):.2f})")
        print(line)
    for fault_name, fault in SSD_PLANTED:
        caught = []
        for case in SSD_CASES:
            (ey, es), ok = ssd_vs_plain(case, fault(ssdk._ssd_cuda))
            if not ok:
                caught.append(f"{case[0]} (y {ey:.3g}, state {es:.3g})")
        check(bool(caught), f"planted SSD fault '{fault_name}' passes "
              f"every case")
        print(f"[ssd] planted fault '{fault_name}': caught at "
              + ", ".join(caught))
    for defines, what, must in (
            (SSD_PASS_FAULT, "the state pass without the first chunk's "
             "contribution", True),
            (SSD_HI_FAULT, "hi parts only", False)):
        caught, passed = [], []
        with fault_build(ssdk, defines):
            for case in mma_cases:
                (ey, es), ok = ssd_vs_plain(case)
                (passed if ok else caught).append(
                    f"{case[0]} (y {ey:.3g}, state {es:.3g})")
        if must:
            check(bool(caught), f"planted build -D{defines[0]} passes every "
                  f"case")
        print(f"[ssd] planted build -D{defines[0]} ({what}): caught at "
              f"{len(caught)} of {len(mma_cases)} tensor-core cases: "
              + (", ".join(caught) or "none") + "; passed at: "
              + (", ".join(passed) or "none"))


def ssd_bounds(*, b, t, h, p, g, n, q, init):
    """Least time (ms) of the SSD kernel's function, as for the other
    kernels: its f32 inputs read once and outputs written once over HBM
    rate, against its useful FLOPs (the causal pairs of the two Q x Q
    products, the inter-chunk product and the state update) over the
    card's dense tensor-core rate. Returns (bound_ms, bound_by, flops)."""
    nbytes = 4 * (2 * b * h * t * p + 2 * b * g * t * n + b * h * t
                  + b * h * n * p * (2 if init else 1))
    pairs = q * (q + 1) // 2
    flops = b * h * (t // q) * (2 * pairs * (n + p) + 4 * q * n * p)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS["bf16"] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", flops)


# part products a useful product runs on the SSD kernel's tensor-core body
SSD_PARTS = 6


def time_ssd(name, b, t, *, init, seed, pad_to=None):
    """The SSD kernel at mamba2-130m's widths (H=24, P=64, N=128, chunk
    256) on B = ``b`` rows of T = ``t`` tokens as the engine passes them
    (padded to a multiple of min(256, T)), or padded to ``pad_to``, with a
    carried state when ``init``, beside its bound, its bound as built and
    its plain version."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd as ssdk
    h, p, g, n, chunk = 24, 64, 1, 128, 256
    x, B, C, dt, A, _, st = ssd_case(b, t, h, p, g, n, init=init, seed=seed)
    xdt, bm, cm, a, init_state = kops.ssd_inputs(x, B, C, dt, A, chunk, st)
    if pad_to is not None:                # zero positions after the live
        extra = pad_to - xdt.shape[2]
        xdt, bm, cm = (torch.nn.functional.pad(v, (0, 0, 0, extra))
                       for v in (xdt, bm, cm))
        a = torch.nn.functional.pad(a, (0, extra))
    tp = xdt.shape[2]
    q = min(chunk, tp)

    def run(i):
        return ssdk._ssd_cuda(xdt, bm, cm, a, chunk=chunk,
                              init_state=init_state)

    got = run(0)
    want = ssdk.ssd_chunked_plain(xdt, bm, cm, a, chunk=chunk,
                                  init_state=init_state)
    err = max(max_err(u, w) for u, w in zip(got, want))
    check(all(allclose(u, w, **SSD_TOL) for u, w in zip(got, want)),
          f"SSD kernel differs from plain at the {name} timing shape: {err}")
    # device time per call by CUDA-graph replay: at the chunk step it is
    # below the wrapper's host cost, which events around calls would time
    iters = 8 if tp * b > 1024 else 48
    ms = graph_ms(run, iters=iters)
    event_ms = cuda_ms(run, iters=20)
    with fault_build(ssdk, SSD_NO_PRODUCTS):
        staging_ms = graph_ms(run, iters=iters)
    plain_ms = cuda_ms(lambda i: ssdk.ssd_chunked_plain(
        xdt, bm, cm, a, chunk=chunk, init_state=init_state), iters=10)
    bound_ms, bound_by, flops = ssd_bounds(b=b, t=tp, h=h, p=p, g=g, n=n,
                                           q=q, init=init)
    body = ssdk.ssd_body(n, p)
    built_ms = SSD_PARTS * flops / PEAK_OPS["bf16"] * 1e3
    kernels = ssdk.kernels_per_call(tp, q, n, p)
    print(f"[timing] ssd {name} B={b} T={t} (as passed {tp}, chunks of {q}) "
          f"H={h} P={p} N={n} G={g}{' +init_state' if init else ''} f32, "
          f"{body} body, {kernels} CUDA kernel{'s' if kernels > 1 else ''} "
          f"a call: {ms * 1e3:.1f} us by graph replay (by events "
          f"{event_ms * 1e3:.1f} us; without its products, "
          f"-D{SSD_NO_PRODUCTS[0]}: {staging_ms * 1e3:.1f} us) (bound "
          f"{bound_ms * 1e3:.2f} us by {bound_by}, {bound_ms / ms * 100:.2f}% "
          f"of it; its {flops / 1e9:.3f} GFLOP take "
          f"{flops / PEAK_OPS['bf16'] * 1e6:.2f} us on the tensor cores, as "
          f"built ({SSD_PARTS} part products) {built_ms * 1e3:.2f} us, "
          f"{built_ms / ms * 100:.1f}% of it), plain {plain_ms * 1e3:.1f} "
          f"us, == plain within rtol={SSD_TOL['rtol']:g} "
          f"atol={SSD_TOL['atol']:g}, max |err| {err:.3g}; {card_line()}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err, "built_ms": built_ms}


def phase_ssd_timing():
    """The SSD kernel at mamba2's whole-prompt shape (B=4, T=1024) and at
    its chunk step's (B=1, T=64, a carried state): as the engine passes
    it (one chunk of 64) and padded to one 256 chunk, as it was passed
    before."""
    whole = time_ssd("whole-prompt", 4, 1024, init=False, seed=11)
    time_ssd("chunk step", 1, 64, init=True, seed=12)
    time_ssd("chunk step padded", 1, 64, init=True, seed=12, pad_to=256)
    return whole


def phase_ssm_engine(cfg, params, *, prefill_chunk, n_blocks,
                     cuda_graphs=True):
    """Serve ``cfg`` (an attention-free arch) through the engine, count
    the SSD kernel's launches in the run and in its decode steps, and hold
    every token against a teacher-forced forward with the plain SSD
    (``cuda_graphs=False``: the graph phase's eager twin, whose tokens are
    held to the replayed run's instead)."""
    n_req, max_new = 16, SERVE_NEW
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, max_batch=8, n_blocks=n_blocks, block_size=16,
                 prefill_chunk=prefill_chunk, device="cuda",
                 cuda_graphs=cuda_graphs)
    check(eng.model.ssd_impl == "kernel",
          f"the engine's SSD runs {eng.model.ssd_impl!r}, not the kernel")
    prompts = serving_requests(n_req, cfg.vocab_size, prompt_lens=SERVE_LENS)
    rec = drive_engine(eng, prompts, max_new, 20000)
    done, st, in_decode = rec["done"], rec["st"], rec["ssd_in_decode"]
    launches = ssdk.LAUNCHES["ssd"]
    check(sum(fd.LAUNCHES.values()) + sum(fa.LAUNCHES.values()) == 0,
          f"the engine launched attention kernels: {dict(fd.LAUNCHES)} "
          f"{dict(fa.LAUNCHES)}")
    check(len(done) == n_req and st["finished"] == n_req,
          f"{st['finished']} of {n_req} requests finished")
    check(all(len(r.output) == max_new for r in done),
          f"a request ended with fewer than {max_new} tokens")
    passes = st["prefill_groups"] + st["chunk_steps"]
    check(launches == cfg.n_layers * passes,
          f"SSD launches {launches} != {cfg.n_layers} x {passes} "
          f"(prefill groups + chunk steps)")
    check(len(in_decode) == st["decode_steps"] and sum(in_decode) == 0,
          f"decode steps launched the SSD kernel {sum(in_decode)} times")
    if prefill_chunk:
        check(st["preemptions"] >= 1, "the pressure pool never preempted")
    mode = (f"chunk={prefill_chunk}, {n_blocks} blocks"
            if prefill_chunk else "whole-prompt")
    forwards = passes + st["decode_steps"]
    want = norms_per_forward(cfg) * forwards
    what = f"{norms_per_forward(cfg)} x {forwards} forwards"
    if cuda_graphs:
        rms = count_rmsnorm(f"mamba2 {mode}", rn.LAUNCHES["rmsnorm"], want,
                            what)
        ref = LM(cfg, ssd_impl="ref", device="cuda")
        share, worst = teacher_forced(ref, eng.params, done, "none")
        tokens = (f"ref-forward argmax match {share:.4f} (others within "
                  f"{worst:.1f} <= {NEAR_TIE_ULPS} bf16 ulps)")
    else:
        check(rn.LAUNCHES["rmsnorm"] == want, f"mamba2 {mode} eager: "
              f"RMSNorm launches {rn.LAUNCHES['rmsnorm']} != {want}")
        rms = f"RMSNorm launches {want} = {what}"
        tokens = "tokens held to the replayed run's"
    print(f"[mamba2] {cfg.name} full width, {mode}, "
          f"{'graph replay' if cuda_graphs else 'eager'}: {n_req}/{n_req} "
          f"finished x {max_new} tokens in {rec['wall']:.2f}s; "
          f"{st['prefill_groups']} prefill groups + {st['chunk_steps']} "
          f"chunk steps + {st['decode_steps']} decode steps, SSD launches "
          f"{launches} = {cfg.n_layers} x {passes}, 0 in decode steps; "
          f"{rms}; preemptions {st['preemptions']}; {tokens}; decode "
          f"{st['decode_tok_s']:.1f} tok/s, p50 TTFT "
          f"{st['p50_ttft_s'] * 1e3:.1f} ms")
    rec["launches"] = launches
    return rec, eng


def phase_graphs_ssm(cfg, params):
    """Phases 10 and 20 on mamba2: each trace through the replayed steps
    (phase 10's checks), then eagerly, held bitwise."""
    total = 0
    for chunk, n_blocks in ((None, 1024), (64, MAMBA2_PRESSURE_BLOCKS)):
        rep, eng = phase_ssm_engine(cfg, params, prefill_chunk=chunk,
                                    n_blocks=n_blocks)
        rep["pools"] = pool_bytes(eng, null_block=False)
        del eng
        free_card()
        eager, eng = phase_ssm_engine(cfg, params, prefill_chunk=chunk,
                                      n_blocks=n_blocks, cuda_graphs=False)
        mode = (f"chunk={chunk} on {n_blocks} blocks" if chunk
                else "whole-prompt")
        compare_replay(f"{cfg.name} {mode}", rep, eager, eng,
                       f"SSM {mib(rep['pools'][1])} MiB")
        del eng, eager, rep["pools"]
        free_card()
        total += rep["launches"]
    return total


# --------------------------------------------------------------------------
# int8 weight-only matmul and LoRA fine-tuning
# --------------------------------------------------------------------------


def _dtype(name):
    import torch
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]


def qmm_case(m, k, n, g, x_dtype, *, seed=0):
    """x ~ N(0, 1) and a weight ~ N(0, 1/K), as the model's fan-in-scaled
    init, quantized by ``quantize_int8`` as (K, G, N/G): scales (K, G),
    the layout ``layers.dense`` hands the kernel."""
    import torch
    from repro_torch.quant.qtensor import quantize_int8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device="cuda").to(x_dtype)
    w = torch.randn((k, g, n // g), generator=gen, device="cuda") / k ** 0.5
    qt = quantize_int8(w.bfloat16())
    return x, qt.data.reshape(k, n), qt.scale.reshape(k, g)


def qmm_vs_plain(x, w_q, scale, out_dtype, run=None):
    """The kernel (or ``run``, a planted fault around it) against the plain
    version: (worst |err|, whether within the limit: f32 within
    ``KERNEL_TOL``, bf16 within 1 bf16 ulp beyond ``BF16_ATOL``)."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    got = (run or qmm._qmm_cuda)(x, w_q, scale, out_dtype=out_dtype)
    want = qmm.int8_matmul_plain(x, w_q, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    err = max_err(got.float(), want.float())
    if out_dtype == torch.bfloat16:
        return err, bf16_ulp_check(got, want, 1)[1]
    return err, allclose(got, want, **KERNEL_TOL)


def _ignore_scales(run):
    def fault(x, w_q, scale, **kw):
        import torch
        return run(x, w_q, torch.ones_like(scale), **kw)
    return fault


def _drop_last_k_tile(run):
    """A kernel whose K loop stops one of its K tiles early."""
    def fault(x, w_q, scale, **kw):
        from repro_torch.kernels import quant_matmul as qmm
        tile = qmm.k_tile(x.dtype, x.shape[0], w_q.shape[1], x.shape[1],
                          scale.shape[1])
        keep = (x.shape[1] - 1) // tile * tile
        return run(x[:, :keep].contiguous(), w_q[:keep].contiguous(),
                   scale[:keep].contiguous(), **kw)
    return fault


QMM_PLANTED = (("scales ignored", _ignore_scales),
               ("last K tile dropped", _drop_last_k_tile))


QMM_TYPES = (("bf16", "bf16"), ("bf16", "f32"), ("f32", "f32"),
             ("f32", "bf16"))


def phase_qmm_vs_plain():
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import quant_matmul as qmm
    worst = {"f32": 0.0, "bf16": 0.0}
    n = 0
    bodies = []
    for i, (name, m, k, n_, g) in enumerate(QMM_CASES):
        for xt, ot in QMM_TYPES:
            x, w_q, scale = qmm_case(m, k, n_, g, _dtype(xt), seed=i)
            body = qmm.qmm_body(x.dtype, m, n_, k, g)
            if name in STEP_NAMES:
                check(body.startswith("mma"), f"the step's {name} shape "
                      f"(x {xt}) runs the {body} body")
            err, ok = qmm_vs_plain(x, w_q, scale, _dtype(ot))
            check(ok, f"int8 kernel differs from plain at {name} M={m} "
                  f"K={k} N={n_} G={g} x {xt} out {ot} ({body} body): max "
                  f"|err| {err}")
            worst[ot] = max(worst[ot], err)
            bodies.append(f"{name} M={m} K={k} N={n_} G={g} x {xt}: {body}")
            n += 1
    print("[qmm] bodies: " + "; ".join(bodies[::2]))
    # the autograd wrapper: dx against autograd through the plain version
    x, w_q, scale = qmm_case(2048, 1024, 1024, 16, torch.bfloat16, seed=50)
    dy = torch.randn((2048, 1024), device="cuda")
    grads = []
    for fn in (lambda t: kops.int8_matmul(t, w_q, scale,
                                          out_dtype=torch.float32),
               lambda t: qmm.int8_matmul_plain(t, w_q, scale,
                                               out_dtype=torch.float32)):
        xg = x.clone().requires_grad_(True)
        grads.append(torch.autograd.grad((fn(xg) * dy).sum(), xg)[0])
    dx_ulps, dx_ok = bf16_ulp_check(grads[0], grads[1], 1)
    check(dx_ok, f"int8_matmul dx differs from autograd through the plain "
          f"version by {dx_ulps} bf16 ulps")
    print(f"[qmm] {n} cases (10 shapes x x/out in bf16/f32) kernel == "
          f"plain: f32 out within rtol=atol=2e-5 (max |err| "
          f"{worst['f32']:.3g}), bf16 out within 1 ulp + {BF16_ATOL} (max "
          f"|err| {worst['bf16']:.3g}); dx of the autograd wrapper == "
          f"autograd through the plain version within 1 bf16 ulp (max "
          f"{dx_ulps:g} ulps beyond the floor, max |err| "
          f"{max_err(grads[0].float(), grads[1].float()):.3g})")
    for fault_name, fault in QMM_PLANTED:
        caught = []
        for i, (name, m, k, n_, g) in enumerate(QMM_CASES):
            x, w_q, scale = qmm_case(m, k, n_, g, torch.bfloat16, seed=i)
            err, ok = qmm_vs_plain(x, w_q, scale, torch.float32,
                                   fault(qmm._qmm_cuda))
            if not ok:
                caught.append(err)
        check(bool(caught), f"planted int8 fault '{fault_name}' passes "
              f"every case")
        print(f"[qmm] planted fault '{fault_name}': caught at "
              f"{len(caught)} of {len(QMM_CASES)} shapes (bf16 x, f32 out; "
              f"max |err| {min(caught):.3g}-{max(caught):.3g})")
    # the split operand's hi part alone, in the tensor-core body: a reading
    # of how many cases it breaks (the SIMT cases cannot change)
    caught, missed = [], []
    with fault_build(qmm, QMM_FAULT):
        for i, (name, m, k, n_, g) in enumerate(QMM_CASES):
            for xt, ot in QMM_TYPES:
                x, w_q, scale = qmm_case(m, k, n_, g, _dtype(xt), seed=i)
                if qmm.qmm_body(x.dtype, m, n_, k, g) == "simt":
                    continue
                err, ok = qmm_vs_plain(x, w_q, scale, _dtype(ot))
                (missed if ok else caught).append(
                    (f"{name} M={m} x {xt} out {ot}", err))
    check(bool(caught), f"the -D{QMM_FAULT[0]} build passes every case")
    errs = [e for _, e in caught]
    print(f"[qmm] planted build -D{QMM_FAULT[0]} (hi parts only): caught at "
          f"{len(caught)} of {len(caught) + len(missed)} tensor-core cases "
          f"(max |err| {min(errs):.3g}-{max(errs):.3g}); passed at: "
          + (", ".join(f"{c} ({e:.3g})" for c, e in missed) or "none"))


def adapter_loss_and_grads(model, params, batch):
    """Loss (float) and the adapters' gradients, in ``split_trainable``
    order."""
    import torch
    from repro_torch.models.params import tree_paths
    from repro_torch.peft.lora import split_trainable
    leaves = [t for _, t in tree_paths(split_trainable(params)[0])]
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), grads


def phase_finetune(cfg):
    """Full width through the trainer's entry point: the int8 kernel's
    route against the reference's on one batch, 4 QL+Q8+F+R steps with the
    launch counts read and the frozen base held, then 2 L+F+R steps."""
    import torch
    from repro_torch.core.config import ShapeSpec, technique_from_label
    from repro_torch.core.trainer import Trainer, TrainerConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.build import make_model
    from repro_torch.models.params import tree_paths
    from repro_torch.peft.lora import split_trainable
    sh = TRAIN_SHAPE
    steps = 4
    shape = ShapeSpec("cli", sh["t"], sh["b"], "train")
    tech = technique_from_label("QL+Q8+F+R")
    trainer = Trainer(cfg, shape, tech, TrainerConfig(steps=steps,
                                                      log_every=1),
                      device="cuda")
    model = trainer.model
    check((model.qmm_impl, model.attn_impl, model.remat) ==
          ("kernel", "flash", "full"),
          f"QL+Q8+F+R built qmm_impl={model.qmm_impl} attn_impl="
          f"{model.attn_impl} remat={model.remat}")
    params = trainer.state["params"]
    trainable = tree_paths(split_trainable(params)[0])
    n_train = sum(t.numel() for _, t in trainable)
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():                # B = 0 at init: A's gradient is 0
        for path, t in trainable:
            if path.endswith("/b"):
                t.copy_(torch.randn(t.shape, generator=g, device="cuda")
                        * 0.02)
    frozen = {p: t.clone() for p, t in tree_paths(params)
              if not p.endswith(("/a", "/b"))}
    adapters = {p: t.detach().clone() for p, t in trainable}
    batch = trainer._batch_for(0)
    ref = make_model(cfg, tech, device="cuda", qmm_impl="ref")
    t0 = time.monotonic()
    lr, gr = adapter_loss_and_grads(ref, params, batch)

    def against_ref():
        lk, gk = adapter_loss_and_grads(model, params, batch)
        cos = min(float(torch.nn.functional.cosine_similarity(
            a.float().flatten(), b.float().flatten(), dim=0))
            for a, b in zip(gk, gr))
        reading = {"loss": abs(lk - lr), "cosine": cos}
        broken = [k for k, bad in (("loss", reading["loss"] > FT_LOSS_ATOL),
                                   ("cosine", not cos >= GRAD_COS)) if bad]
        return lk, reading, broken

    lk, reading, broken = against_ref()
    check(not broken, f"int8 kernel route vs reference route breaks "
          f"{broken}: loss {lk} vs {lr} (limit {FT_LOSS_ATOL}), min adapter "
          f"gradient cosine {reading['cosine']} (limit {GRAD_COS})")
    print(f"[finetune] step-0 batch, B seeded nonzero, int8 kernel vs the "
          f"reference's dequantize-first route: loss {lk:.6f} vs {lr:.6f} "
          f"(|diff| {reading['loss']:.3g} <= {FT_LOSS_ATOL}), min adapter "
          f"gradient cosine {reading['cosine']:.6f} >= {GRAD_COS} over "
          f"{len(gr)} leaves ({time.monotonic() - t0:.1f}s)")
    for name, fault in QMM_PLANTED:
        with planted(qmm, "_qmm_cuda", fault):
            _, bad_reading, bad_broken = against_ref()
        check(bool(bad_broken), f"planted fault '{name}' passes every "
              f"kernel-vs-reference limit: {bad_reading}")
        print(f"[finetune] planted fault '{name}': |dloss| "
              f"{bad_reading['loss']:.3g}, min adapter gradient cosine "
              f"{bad_reading['cosine']:.6f}; caught by "
              + ", ".join(bad_broken))
    del gr, ref
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    qmm.LAUNCHES.clear()                 # count the main path's run only
    qmm.BODIES.clear()
    fa.LAUNCHES.clear()
    rn.LAUNCHES.clear()
    out = trainer.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = qmm.LAUNCHES["int8_matmul"]
    bodies = dict(qmm.BODIES)
    check(sum(bodies.values()) == launches and "simt" not in bodies,
          f"fine-tuning int8 launches by body {bodies} (of {launches}): "
          f"every one must run the tensor cores")
    flash = {n: fa.LAUNCHES[n] for n in ("fwd", "bwd_dkv", "bwd_dq")}
    hist = out["history"]
    check(out["final_step"] == steps and len(hist) == steps,
          f"trainer ran {out['final_step']} of {steps} steps")
    for h in hist:
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"step {h['step']}: loss {h['loss']}, grad_norm "
              f"{h['grad_norm']}")
    per_step = cfg.n_layers * 7 * 2      # 7 base projections, run twice (R)
    check(launches == per_step * steps,
          f"int8 launches {launches} != {per_step} x {steps} steps")
    want = {"fwd": 2 * cfg.n_layers * steps,
            "bwd_dkv": cfg.n_layers * steps, "bwd_dq": cfg.n_layers * steps}
    check(flash == want, f"flash launches {flash} != {want}")
    norms = norms_per_train_step(cfg, sh["t"], remat=True)
    rms = count_rmsnorm("QL+Q8+F+R fine-tuning", rn.LAUNCHES["rmsnorm"],
                        norms * steps, f"{norms} per step x {steps}")
    now = dict(tree_paths(params))
    moved = [p for p, t in frozen.items() if not torch.equal(now[p], t)]
    check(not moved, f"frozen leaves changed: {moved[:5]}")
    adapters_moved = sum(not torch.equal(now[p], t)
                         for p, t in adapters.items())
    check(adapters_moved == len(adapters),
          f"{len(adapters) - adapters_moved} adapter leaves never moved")
    n_frozen = len(frozen)
    del frozen, adapters
    print(f"[finetune] qwen1.5-0.5b full width, QL+Q8+F+R (LoRA rank "
          f"{tech.lora_rank}, {n_train} trainable parameters), batch "
          f"{sh['b']} x {sh['t']}: {steps} steps, losses "
          + ", ".join(f"{h['loss']:.4f}" for h in hist)
          + ", grad_norms " + ", ".join(f"{h['grad_norm']:.4f}" for h in hist)
          + f"; steps 2-{steps}: {out['step_ms']:.1f} ms/step, "
          f"{out['tokens_per_s']:.0f} tokens/s; int8 launches {launches} "
          f"(= {launches // steps} per step = {cfg.n_layers} x 7 x 2; by "
          f"body {bodies}), "
          f"flash {flash['fwd']}/{flash['bwd_dkv']}/{flash['bwd_dq']}; "
          f"{rms}; {n_frozen} frozen leaves bit-unchanged, "
          f"{adapters_moved} of "
          f"{len(trainable)} adapter leaves updated; peak memory "
          f"{peak:.2f} GiB; {card_line()}")
    del trainer, params, now
    torch.cuda.empty_cache()
    bf16_steps = 2
    lora = Trainer(cfg, shape, technique_from_label("L+F+R"),
                   TrainerConfig(steps=bf16_steps, log_every=1),
                   device="cuda")
    torch.cuda.synchronize()
    qmm.LAUNCHES.clear()
    fa.LAUNCHES.clear()
    rn.LAUNCHES.clear()
    out_l = lora.run()
    torch.cuda.synchronize()
    rms_l = count_rmsnorm("L+F+R fine-tuning", rn.LAUNCHES["rmsnorm"],
                          norms * bf16_steps,
                          f"{norms} per step x {bf16_steps}")
    check(qmm.LAUNCHES["int8_matmul"] == 0,
          f"L+F+R launched the int8 kernel {qmm.LAUNCHES['int8_matmul']} "
          f"times")
    check(fa.LAUNCHES["fwd"] == 2 * cfg.n_layers * bf16_steps,
          f"L+F+R flash launches {dict(fa.LAUNCHES)}")
    for h in out_l["history"]:
        check(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
              f"L+F+R step {h['step']}: loss {h['loss']}")
    print(f"[finetune] L+F+R (bf16 base), {bf16_steps} steps: losses "
          + ", ".join(f"{h['loss']:.4f}" for h in out_l["history"])
          + f"; int8 launches 0; {rms_l}; {out_l['step_ms']:.1f} ms/step "
          f"(step 2)")
    del lora
    torch.cuda.empty_cache()
    return launches, out


def qmm_bound(m, k, n, g, x_bytes, out_bytes):
    """Least time (ms) of one int8 product on this card: x, codes, scales
    read once and the output written once over HBM rate, against its
    2·M·K·N FLOPs at the bf16 tensor-core rate. (ms, bound_by)."""
    nbytes = m * k * x_bytes + k * n + k * g * 4 + m * n * out_bytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * k * n / PEAK_OPS["bf16"] * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def qmm_products(body: str, x_dtype) -> int:
    """bf16 part products the tensor-core body runs for each useful one: 3
    (bf16 x and w split in three, or x·s split in three and the codes),
    6 for f32 x and w both split (the six of weight >= 2^-16)."""
    import torch
    return 6 if body == "mma_w" and x_dtype == torch.float32 else 3


def phase_qmm_timing(cfg):
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    m = TRAIN_SHAPE["b"] * TRAIN_SHAPE["t"]
    rows = {}
    for i, (name, k, n, g, xt, ot, per_layer) in enumerate(QMM_STEP):
        x_dtype, out_dtype = _dtype(xt), _dtype(ot)
        x, w_q, scale = qmm_case(m, k, n, g, x_dtype, seed=100 + i)
        body = qmm.qmm_body(x_dtype, m, n, k, g)
        check(body.startswith("mma"), f"the step's {name} shape runs the "
              f"{body} body")
        err, ok = qmm_vs_plain(x, w_q, scale, out_dtype)
        check(ok, f"int8 kernel differs from plain at the step's {name} "
              f"shape: {err}")
        ms = cuda_ms(lambda j: qmm._qmm_cuda(x, w_q, scale,
                                             out_dtype=out_dtype), iters=20)
        plain_ms = cuda_ms(lambda j: qmm.int8_matmul_plain(
            x, w_q, scale, out_dtype=out_dtype), iters=10)

        def ref_route(j):
            # the reference's dense: dequantize to x's type, then the product
            w = (w_q.reshape(k, g, n // g).float()
                 * scale[:, :, None]).reshape(k, n).to(x_dtype)
            return torch.matmul(x, w)

        lib_ms = cuda_ms(ref_route, iters=20)
        bound_ms, bound_by = qmm_bound(m, k, n, g, x.element_size(),
                                       torch.empty((), dtype=out_dtype
                                                   ).element_size())
        parts = qmm_products(body, x_dtype)
        built_ms = 2.0 * m * k * n * parts / PEAK_OPS["bf16"] * 1e3
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "built_ms": built_ms, "max_abs_err": err,
                      "per_layer": per_layer}
        tflops = 2.0 * m * k * n / (ms * 1e-3) / 1e12
        print(f"[timing] int8_matmul {name} M={m} K={k} N={n} G={g} x {xt} "
              f"out {ot}, {body} body: {ms * 1e3:.1f} us ({tflops:.1f} "
              f"TFLOP/s; bound {bound_ms * 1e3:.2f} us by {bound_by}, "
              f"{bound_ms / ms * 100:.2f}% of it; as built ({parts} part "
              f"products) {built_ms * 1e3:.2f} us, {built_ms / ms * 100:.2f}% "
              f"of it), plain (f32 dequantize + "
              f"f32 matmul) {plain_ms * 1e3:.1f} us, reference route "
              f"(dequantize to {xt} + torch.matmul, two calls) "
              f"{lib_ms * 1e3:.1f} us; == plain, max |err| {err:.3g}")
    per_step = {key: 2 * cfg.n_layers * sum(r[key] * r["per_layer"]
                                            for r in rows.values())
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "built_ms")}
    print(f"[timing] int8_matmul per QL+Q8+F+R step ({cfg.n_layers} layers "
          f"x 7 projections x 2 with remat, {2 * cfg.n_layers * 7} "
          f"launches): "
          f"kernel {per_step['ms']:.1f} ms, bound {per_step['bound_ms']:.2f} "
          f"ms, as built {per_step['built_ms']:.2f} ms, plain "
          f"{per_step['plain_ms']:.1f} ms, reference route "
          f"{per_step['library_ms']:.1f} ms; down "
          f"{rows['down']['ms'] * 1e3:.1f} us against its reference route's "
          f"{rows['down']['library_ms'] * 1e3:.1f} us; {card_line()}")
    return rows, per_step


# --------------------------------------------------------------------------
# RMSNorm and dense-cache decode kernels, speculative serving
# --------------------------------------------------------------------------


def rms_case(rows, d, xd, wd, *, seed=0):
    """x (rows, d) with each row at a magnitude in 1e-3..10, so eps
    matters in some rows; w near 1."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    scale = 10.0 ** (torch.rand((rows, 1), generator=g, device="cuda") * 4
                     - 3)
    x = torch.randn((rows, d), generator=g, device="cuda") * scale
    w = torch.randn(d, generator=g, device="cuda") + 1.0
    return x.to(_dtype(xd)), w.to(_dtype(wd))


def rms_vs_plain(x, w, run=None):
    """The kernel (or ``run``, a planted fault around it) against the plain
    version: (worst |err|, whether within the limit: f32 out within
    ``KERNEL_TOL``, bf16 out within 1 bf16 ulp beyond ``BF16_ATOL``)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    got = (run or rn._rmsnorm_cuda)(x, w, 1e-5)
    want = rn.rmsnorm_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    err = max_err(got.float(), want.float())
    if x.dtype == torch.bfloat16:
        return err, bf16_ulp_check(got, want, 1)[1]
    return err, allclose(got, want, **KERNEL_TOL)


def _drop_eps(run):
    def fault(x, w, eps):
        return run(x, w, 0.0)
    return fault


def _skip_last_row_tile(run):
    """A kernel whose grid stops one block early (its rows, as many as the
    kernel puts in a block at this shape, unwritten: here zeros)."""
    def fault(x, w, eps):
        import torch
        from repro_torch.kernels import rmsnorm as rn
        tile = rn.rows_per_block(x.shape[0], x.shape[1], x.dtype)
        keep = (x.shape[0] - 1) // tile * tile
        out = torch.zeros_like(x)
        if keep:
            out[:keep] = run(x[:keep].contiguous(), w, eps)
        return out
    return fault


RMS_PLANTED = (("eps dropped", _drop_eps),
               ("last block's rows skipped", _skip_last_row_tile))


def phase_rmsnorm_vs_plain():
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rmsnorm as rn
    types = (("bf16", "bf16"), ("bf16", "f32"), ("f32", "bf16"),
             ("f32", "f32"))
    cases = [(rows, d, xd, wd) for rows in RMS_ROWS for d in RMS_DIMS
             for xd, wd in types]
    worst = {"f32": 0.0, "bf16": 0.0}
    for i, (rows, d, xd, wd) in enumerate(cases):
        x, w = rms_case(rows, d, xd, wd, seed=i)
        err, ok = rms_vs_plain(x, w)
        check(ok, f"RMSNorm kernel differs from plain at rows={rows} D={d} "
              f"x {xd} w {wd}: max |err| {err}")
        worst[xd] = max(worst[xd], err)
    # the autograd wrapper at a training shape: dx and dw against autograd
    # through the plain version
    x, w = rms_case(8192, 1024, "bf16", "bf16", seed=99)
    dy = torch.randn(x.shape, device="cuda").bfloat16()
    grads = []
    for fn in (kops.rmsnorm, rn.rmsnorm_plain):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xg, wg), (xg, wg), dy))
    for name, a, b in zip(("dx", "dw"), *grads):
        ulps, ok = bf16_ulp_check(a, b, 1)
        check(ok, f"RMSNorm {name} differs from autograd through the plain "
              f"version by {ulps} bf16 ulps")
    print(f"[rmsnorm] {len(cases)} cases (rows {RMS_ROWS} x D {RMS_DIMS} x "
          f"x/w in bf16/f32) kernel == plain: f32 out within rtol=atol=2e-5 "
          f"(max |err| {worst['f32']:.3g}), bf16 out within 1 ulp + "
          f"{BF16_ATOL} (max |err| {worst['bf16']:.3g}); dx, dw of the "
          f"autograd wrapper at 8192 x 1024 bf16 == autograd through the "
          f"plain version within 1 bf16 ulp")
    for fault_name, fault in RMS_PLANTED:
        caught = []
        for i, (rows, d, xd, wd) in enumerate(cases):
            x, w = rms_case(rows, d, xd, wd, seed=i)
            err, ok = rms_vs_plain(x, w, fault(rn._rmsnorm_cuda))
            if not ok:
                caught.append(err)
        check(bool(caught), f"planted RMSNorm fault '{fault_name}' passes "
              f"every case")
        print(f"[rmsnorm] planted fault '{fault_name}': caught at "
              f"{len(caught)} of {len(cases)} cases (max |err| "
              f"{min(caught):.3g}-{max(caught):.3g})")


def dense_case(b, s, h, kv, d, lengths, dtype, *, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, kv, s, d), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, kv, s, d), generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, k, v, lens


def dense_vs_plain(q, k, v, lens, run=None):
    """The kernel (or ``run``) against the plain version: (worst |err| of
    the normalized output, whether o/l, m and l are within
    ``KERNEL_TOL``)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    got = (run or fd._dense_decode_cuda)(q, k, v, lens)
    want = fd._dense_decode_torch(q, k, v, lens)
    torch.cuda.synchronize()
    og, ow = normalized(got[0], got[2]), normalized(want[0], want[2])
    ok = (allclose(og, ow, **KERNEL_TOL) and
          allclose(got[1], want[1], **KERNEL_TOL) and
          allclose(got[2], want[2], **KERNEL_TOL))
    return max_err(og, ow), ok


def _mask_off_by_one(run):
    def fault(q, k, v, lens):
        import torch
        return run(q, k, v, torch.clamp(lens + 1, max=k.shape[2]))
    return fault


def _m_not_carried(run):
    """Each 32-position tile's partial summed into the result without the
    rescale to a common max: the running max restarts every tile."""
    def fault(q, k, v, lens):
        import torch
        s = k.shape[2]
        o = l = m = None
        for t0 in range(0, s, DENSE_TILE):
            part = run(q, k[:, :, t0:t0 + DENSE_TILE],
                       v[:, :, t0:t0 + DENSE_TILE],
                       torch.clamp(lens - t0, 0, DENSE_TILE))
            o = part[0] if o is None else o + part[0]
            l = part[2] if l is None else l + part[2]
            m = part[1] if m is None else torch.maximum(m, part[1])
        return o, m, l
    return fault


def split_parts(run, q, k, v, lens):
    """Each of the kernel's position splits at this shape as its own
    partial, from ``run`` on that split's positions alone (a launch per
    row and split)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    n_split = fd.dense_splits(q.shape[0], k.shape[1], k.shape[2],
                              torch.cuda.get_device_properties(
                                  0).multi_processor_count)
    parts = []
    for lo, hi in fd.split_spans(lens, k.shape[2], n_split):
        rows = []
        for r in range(q.shape[0]):
            a, b = int(lo[r]), int(hi[r])
            rows.append(run(q[r:r + 1], k[r:r + 1, :, a:b],
                            v[r:r + 1, :, a:b],
                            torch.tensor([b - a], dtype=torch.int32,
                                         device=q.device)))
        parts.append(tuple(torch.cat(x) for x in zip(*rows)))
    return parts


def _split_dropped(run):
    """The middle split's partial left out of the merge (a shape the
    kernel does not split keeps its one partial)."""
    def fault(q, k, v, lens):
        from repro_torch.kernels import flash_decode as fd
        parts = split_parts(run, q, k, v, lens)
        if len(parts) > 1:
            del parts[len(parts) // 2]
        return fd.merge_split_partials(parts)
    return fault


def _no_rescale(run):
    """The splits' partials summed as they are, without the rescale to
    their common max."""
    def fault(q, k, v, lens):
        import torch
        parts = split_parts(run, q, k, v, lens)
        return (sum(p[0] for p in parts),
                torch.stack([p[1] for p in parts]).amax(0),
                sum(p[2] for p in parts))
    return fault


DENSE_PLANTED = (("length mask off by one", _mask_off_by_one),
                 ("m not carried across tiles", _m_not_carried),
                 ("one split's partial dropped", _split_dropped),
                 ("partials summed without the rescale to the common max",
                  _no_rescale))


def phase_dense_decode_vs_plain():
    import torch
    from repro_torch.kernels import flash_decode as fd
    worst = 0.0
    n = 0
    cases = DENSE_CASES + DENSE_SPLIT_CASES
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = [fd.dense_splits(c[0], c[3], c[1], n_sm) for c in cases]
    for i, case in enumerate(cases):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, lens = dense_case(*case, dtype, seed=i)
            err, ok = dense_vs_plain(q, k, v, lens)
            check(ok, f"dense decode kernel differs from plain at {case} "
                  f"{dtype}: max |err| {err}")
            got = fd._dense_decode_cuda(q, k, v, lens)
            empty = lens == 0
            check(bool((got[0][empty] == 0).all() and
                       (got[2][empty] == 0).all() and
                       (got[1][empty] == -1e30).all()),
                  f"zero-length row not empty at {case}")
            worst = max(worst, err)
            n += 1
    print(f"[decode] {n} cases (tests/test_kernels.py:72-75, the draft's "
          f"B=1 H=K=16 D=64 at S=65 and 1068, G=2, a zero-length row, a "
          f"length past S; S 4096 and 8192 at B 1/4/8, G 1/2/8, D 64/128, "
          f"whole splits empty, a length reaching S; bf16 and f32) kernel "
          f"== plain: normalized output, m and l within rtol=atol=2e-5 "
          f"(max |err| {worst:.3g}); position splits per case "
          f"{splits}")
    for fault_name, fault in DENSE_PLANTED:
        caught = []
        for i, case in enumerate(cases):
            q, k, v, lens = dense_case(*case, torch.float32, seed=i)
            err, ok = dense_vs_plain(q, k, v, lens,
                                     fault(fd._dense_decode_cuda))
            if not ok:
                caught.append(err)
        check(bool(caught), f"planted dense decode fault '{fault_name}' "
              f"passes every case")
        print(f"[decode] planted fault '{fault_name}': caught at "
              f"{len(caught)} of {len(cases)} shapes (f32; max |err| "
              f"{min(caught):.3g}-{max(caught):.3g})")


def spec_splits(model, params, prompts, want, got):
    """Streams of a spec-on run against spec-off's: a stream may split only
    at a position where spec-off's own logits (a dense forward over the
    prompt and spec-off's tokens before the split) put the spec-on token
    within ``SPEC_NEAR_TIE_ULPS`` bf16 ulps of the top. Returns the split
    count."""
    import torch
    splits = 0
    for rid, ref in want.items():
        out = got[rid]
        j = next((i for i, (a, b) in enumerate(zip(ref, out)) if a != b),
                 None)
        if j is None:
            continue
        splits += 1
        toks = torch.tensor([prompts[rid] + ref[:j]], dtype=torch.int64,
                            device="cuda")
        row = model.forward(params, toks)[0, -1].float()
        top = float(row.max())
        ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
        check(float(row[out[j]]) >= top - SPEC_NEAR_TIE_ULPS * ulp,
              f"rid {rid}: spec-on splits from spec-off at token {j} "
              f"({out[j]} vs {ref[j]}), not a bf16 near tie")
    return splits


def rejected_draft_gaps(model, params, prompts, final, rounds):
    """For each round whose proposals were not all accepted, the first
    rejected proposal's gap below the top logit, in bf16 ulps of the top,
    in a dense forward over the prompt and the run's tokens before it."""
    import torch
    gaps = []
    for rid, n_out, props in rounds:
        out = final[rid]
        j = next((i for i, p in enumerate(props)
                  if n_out + i < len(out) and out[n_out + i] != p), None)
        if j is None:
            continue
        toks = torch.tensor([prompts[rid] + out[:n_out + j]],
                            dtype=torch.int64, device="cuda")
        row = model.forward(params, toks)[0, -1].float()
        top = float(row.max())
        ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
        gaps.append((top - float(row[props[j]])) / ulp)
    return gaps


def phase_spec_engine(cfg, params, *, name, prompts, max_new, draft,
                      eager_twin=False):
    """Serve ``prompts`` spec-off, then spec-on (n-gram when ``draft`` is
    False, else a self-draft), with the launch counts of the spec-on run
    held against its stats; with ``eager_twin`` the spec-on run again
    eagerly, held bitwise to the replayed one (phase 20)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.speculate import DraftModelProposer
    outs, stats, walls = {}, {}, {}
    proposer = None
    rounds = []                          # (rid, tokens emitted, proposals)
    for mode in ("off", "on"):
        if mode == "on":
            proposer = (DraftModelProposer(cfg, params, device="cuda")
                        if draft else "ngram")
        if mode == "on" and draft:
            propose = proposer.propose

            def recorded(req, k, propose=propose):
                out = propose(req, k)
                rounds.append((req.rid, len(req.output), list(out)))
                return out

            proposer.propose = recorded
        eng = Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                     speculate=proposer, spec_depth=4, device="cuda")
        rec = drive_engine(eng, prompts, max_new, 5000)
        done = rec["done"]
        walls[mode] = rec["wall"]
        st = stats[mode] = rec["st"]
        check(rec["traces"] == rec["warm_traces"],
              f"{name} spec-{mode}: captured while serving: "
              f"{set(rec['traces']) - set(rec['warm_traces'])}")
        check(len(done) == len(prompts) and st["finished"] == len(prompts),
              f"{name} spec-{mode}: {st['finished']} of {len(prompts)} "
              f"requests finished")
        check(all(len(r.output) == max_new for r in done),
              f"{name} spec-{mode}: a request ended off its budget of "
              f"{max_new} tokens")
        outs[mode] = {r.rid: r.output for r in done}
    # the spec-on run's counts, read before any check runs a forward
    paged = fd.LAUNCHES["paged_attention"]
    dense = fd.LAUNCHES["dense_decode"]
    norms = rn.LAUNCHES["rmsnorm"]
    steps = st["decode_steps"] + st["chunk_steps"] + st["verify_steps"]
    check(st["decode_steps"] == 0 and st["verify_steps"] > 0 and
          st["spec_rounds"] > 0,
          f"{name}: {st['verify_steps']} verify steps, {st['decode_steps']} "
          f"plain decode steps, {st['spec_rounds']} spec rounds")
    check(paged == cfg.n_layers * steps,
          f"{name}: paged launches {paged} != {cfg.n_layers} x {steps} steps")
    check(sum(fa.LAUNCHES.values()) == 0,
          f"{name}: the engine launched flash kernels: {dict(fa.LAUNCHES)}")
    n_pre, n_dec = ((proposer.n_prefills, proposer.n_decode_steps)
                    if draft else (0, 0))
    check(dense == cfg.n_layers * n_dec,
          f"{name}: dense decode launches {dense} != {cfg.n_layers} x "
          f"{n_dec} draft decode steps")
    tie_note = ""
    if draft:
        check(dense > 0, f"{name}: the draft never decoded")
        check(st["accept_rate"] > SELF_DRAFT_ACCEPT,
              f"{name}: self-draft accept_rate {st['accept_rate']:.4f} <= "
              f"{SELF_DRAFT_ACCEPT}")
        gaps = rejected_draft_gaps(eng.model, eng.params, prompts,
                                   outs["on"], rounds)
        check(all(g <= NEAR_TIE_ULPS for g in gaps),
              f"{name}: rejected self-draft proposals {max(gaps):.1f} bf16 "
              f"ulps below the top (margin {NEAR_TIE_ULPS})")
        tie_note = (f"; {len(gaps)} rejected proposals, each within "
                    f"{max(gaps, default=0.0):.1f} <= {NEAR_TIE_ULPS} bf16 "
                    f"ulps of the top of a dense forward")
    forwards = st["prefill_groups"] + steps + n_pre + n_dec
    rms = count_rmsnorm(f"spec {name}", norms,
                        norms_per_forward(cfg) * forwards,
                        f"{norms_per_forward(cfg)} x {forwards} forwards")
    splits = spec_splits(eng.model, eng.params, prompts, outs["off"],
                         outs["on"])
    off = stats["off"]
    print(f"[spec] qwen1.5-0.5b full width, {name}: {len(prompts)}/"
          f"{len(prompts)} finished x {max_new} tokens both ways; spec-on "
          f"== spec-off except {splits} split(s) at near ties; "
          f"accept_rate {st['accept_rate']:.4f} ({st['spec_accepted_tokens']}"
          f" of {st['spec_proposed_tokens']} in {st['spec_rounds']} rounds),"
          f" depth histogram {st['spec_depth_hist']}; {st['verify_steps']} "
          f"verify steps vs {off['decode_steps']} spec-off decode steps; "
          f"paged launches {paged} = {cfg.n_layers} x {steps}, dense decode "
          f"{dense} = {cfg.n_layers} x {n_dec} draft decode steps "
          f"({n_pre} draft prefills){tie_note}; {rms}; decode tok/s spec-on "
          f"{st['decode_tok_s']:.1f} vs spec-off {off['decode_tok_s']:.1f}; "
          f"wall {walls['on']:.2f}s vs {walls['off']:.2f}s")
    if eager_twin:
        rep = dict(rec, pools=pool_bytes(eng, null_block=False))
        del eng
        free_card()
        twin = Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                      speculate=proposer, spec_depth=4, device="cuda",
                      cuda_graphs=False)
        eager = drive_engine(twin, prompts, max_new, 5000)
        compare_replay(f"{cfg.name} {name} spec-on", rep, eager, twin,
                       f"KV {mib(rep['pools'][0])} MiB")
        del twin, rep
        free_card()
    return {"dense": dense, "st": st, "off": off}


def rms_bound(rows, d, x_bytes, w_bytes):
    """Least time (ms) of one RMSNorm: x read once, w read once, the output
    written once, against ~4 f32 operations an element on the FMA pipes.
    (ms, bound_by)."""
    t_bytes = (2 * rows * d * x_bytes + d * w_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * rows * d / F32_FMA_OPS * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def time_dense_decode(cfg, *, b, s, live):
    """The dense decode kernel at B = ``b`` rows of ``live`` positions in a
    cache of S = ``s`` (one cache per layer, cycled), beside its byte
    bound, its plain version, and SDPA with the length mask, all by
    CUDA-graph replay."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_l = cfg.n_layers
    g = torch.Generator(device="cuda").manual_seed(300 + b)
    q = torch.randn((b, h, d), generator=g, device="cuda").bfloat16()
    caches = [tuple(torch.randn((b, s, kv, d), generator=g,
                                device="cuda").bfloat16() for _ in range(2))
              for _ in range(n_l)]
    lens = torch.full((b,), live, dtype=torch.int32, device="cuda")
    scale = 1.0 / math.sqrt(d)

    def args(i):
        kc, vc = caches[i % n_l]
        return q, kc.transpose(1, 2), vc.transpose(1, 2), lens

    err, ok = dense_vs_plain(*args(0))
    check(ok, f"dense decode kernel differs from plain at B={b} S={s}: "
          f"{err}")
    ms = graph_ms(lambda i: fd._dense_decode_cuda(*args(i), sm_scale=scale))
    norm_ms = graph_ms(lambda i: fd.flash_decode(*args(i), sm_scale=scale))
    plain_ms = graph_ms(lambda i: fd._dense_decode_torch(*args(i),
                                                         sm_scale=scale))
    mask = (torch.arange(s, device="cuda") < lens[:, None])[:, None, None, :]
    qd = q[:, :, None]

    def sdpa(i):
        kc, vc = caches[i % n_l]
        return F.scaled_dot_product_attention(
            qd, kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
            scale=scale)

    lib_ms = graph_ms(sdpa)
    o_p, _, l_p = fd._dense_decode_torch(*args(0), sm_scale=scale)
    check(allclose(sdpa(0)[:, :, 0].float(), normalized(o_p, l_p),
                   rtol=2e-2, atol=2e-2),
          "SDPA's output is not the dense decode read's function")
    kv_bytes = 2 * b * live * kv * d * 2
    io_bytes = b * h * d * 2 + b * h * d * 4 + b * h * 4 * 2 + b * 4
    t_bytes = (kv_bytes + io_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * b * h * live * d / PEAK_OPS["bf16"] * 1e3
    dec = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    n_split = fd.dense_splits(b, kv, s, torch.cuda.get_device_properties(
        0).multi_processor_count)
    print(f"[timing] dense_decode B={b} H={h} K={kv} D={d} S={s} ({live} "
          f"live) bf16, {n_split} position splits, {n_l} caches cycled: "
          f"{ms * 1e3:.2f} us (bound {dec['bound_ms'] * 1e3:.3f} us by "
          f"{dec['bound_by']}, {dec['bound_ms'] / ms * 100:.2f}% of it); "
          f"with the normalisation {norm_ms * 1e3:.2f} us; plain "
          f"{plain_ms * 1e3:.2f} us; sdpa with the length mask "
          f"{lib_ms * 1e3:.2f} us; == plain, max |err| {err:.3g}; "
          f"{card_line()}")
    return dec


def phase_new_kernel_timing(cfg):
    """The RMSNorm kernel at the training step's and a decode step's shape,
    and the dense decode kernel at the draft model's shape, each beside
    its bound, the plain version and one library call, all as device time
    per call of a CUDA-graph replay (``graph_ms``); the dense decode
    kernel again at B = 8, S = 4,096."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    rows_out = {}
    for name, rows, xd in (("train", 8192, "bf16"), ("decode", 8, "bf16"),
                           ("draft", 1, "bf16")):
        d = cfg.d_model
        # four inputs cycled, so the 16 MB training operand is not L2-hot
        ins = [rms_case(rows, d, xd, "bf16", seed=200 + j) for j in range(4)]
        err, ok = rms_vs_plain(*ins[0])
        check(ok, f"RMSNorm kernel differs from plain at {rows} x {d}: {err}")
        ms = graph_ms(lambda i: rn._rmsnorm_cuda(*ins[i % 4]))
        plain_ms = graph_ms(lambda i: rn.rmsnorm_plain(*ins[i % 4]))
        lib_ms = graph_ms(lambda i: F.rms_norm(ins[i % 4][0], (d,),
                                               ins[i % 4][1], 1e-5))
        bound_ms, bound_by = rms_bound(rows, d, 2, 2)
        rows_out[name] = {"ms": ms, "plain_ms": plain_ms,
                          "library_ms": lib_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by, "max_abs_err": err}
        print(f"[timing] rmsnorm {rows} x {d} {xd} (w bf16, "
              f"{rn.rows_per_block(rows, d, _dtype(xd))} rows a block): "
              f"{ms * 1e3:.2f} us (bound {bound_ms * 1e3:.3f} us by "
              f"{bound_by}, {bound_ms / ms * 100:.2f}% of it), plain "
              f"{plain_ms * 1e3:.2f} us, F.rms_norm {lib_ms * 1e3:.2f} us; "
              f"== plain, max |err| {err:.3g}")
    # the draft's decode read: B=1, S = context + k, one cache per layer;
    # then a batch of 8 long rows, which the kernel splits 3 ways
    dec = time_dense_decode(cfg, b=1, s=1068, live=1064)
    time_dense_decode(cfg, b=8, s=4096, live=4096)
    return rows_out, dec


# --------------------------------------------------------------------------
# dense on the tensor cores
# --------------------------------------------------------------------------


def ulp_check_rows(a, b, n: int, atol: float, rows: int = 512):
    """``bf16_ulp_check`` over blocks of ``rows`` leading rows, so a
    152,064-wide output needs no f32 copies of the whole of it."""
    worst, ok = 0.0, True
    a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    for r0 in range(0, a2.shape[0], rows):
        w, o = bf16_ulp_check(a2[r0:r0 + rows], b2[r0:r0 + rows], n, atol)
        worst, ok = max(worst, w), ok and o
    return worst, ok


def dense_floor(k: int, ref) -> float:
    """The absolute floor of a bf16 product output's check: the f32
    roundoff of a K-term sum at the output's scale, sqrt(K) * 2^-24 *
    rms, ``DENSE_ROUNDOFFS`` times over (flash's 1e-5 floor is that for
    sums of magnitude ~1; a projection's sums reach 10-100 over up to
    152,064 terms), and never below ``BF16_ATOL``."""
    import torch
    rms = float(torch.linalg.vector_norm(ref, dtype=torch.float32)
                / math.sqrt(ref.numel()))
    return max(BF16_ATOL, DENSE_ROUNDOFFS * math.sqrt(k) * 2.0 ** -24 * rms)


def dense_projections(cfg):
    """qwen1.5-0.5b's products through ``layers.dense``: (name, x dims
    after the rows, x dtype, w shape or "tied", n_in, out_dtype)."""
    import torch
    d, h, hd, ff = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    f32 = torch.float32
    return (("q/k/v", (d,), "bf16", (d, h, hd), 1, f32),
            ("o", (h, hd), "bf16", (h, hd, d), 2, None),
            ("gate/up", (d,), "bf16", (d, ff), 1, f32),
            ("down", (ff,), "f32", (ff, d), 1, None),
            ("head", (d,), "bf16", "tied", 1, None))


def phase_dense(cfg):
    """``layers.dense`` on the card against its f32 route on the same
    tensors at every projection of qwen1.5-0.5b, at 8 and 8,192 rows,
    forward and gradients; an f32 output rounded through bf16 must break
    the f32 limit."""
    import torch
    from repro_torch.models import layers as L
    worst = {"bf16": 0.0, "f32": 0.0, "f32 grads": 0.0}
    caught, floors, past_flat, n = [], [], [], 0
    for rows in DENSE_ROWS:
        for name, xs, xd, ws, n_in, out in dense_projections(cfg):
            g = torch.Generator(device="cuda").manual_seed(rows + n)
            x = torch.randn((rows, *xs), generator=g, device="cuda")
            x = x.to(_dtype(xd))
            if ws == "tied":                 # the head: embed (V, d).T
                emb = (torch.randn((cfg.vocab_size, cfg.d_model),
                                   generator=g, device="cuda") * 0.02
                       ).bfloat16()
            else:
                k_in = math.prod(ws[:n_in])
                emb = (torch.randn(ws, generator=g, device="cuda")
                       / math.sqrt(k_in)).bfloat16()
            out_dt = out or torch.promote_types(x.dtype, emb.dtype)
            k = math.prod(xs)

            def weight(t):
                return t.T if ws == "tied" else t

            def f32_route(a, t):
                w2 = weight(t).reshape(k, -1)
                y = L._dense_f32(a.reshape(rows, k), w2, out_dt)
                return y.reshape(rows, *weight(t).shape[n_in:])

            res = []
            for fn in (lambda a, t: L.dense(a, weight(t), n_in,
                                            out_dtype=out), f32_route):
                xg = x.clone().requires_grad_(True)
                wg = emb.clone().requires_grad_(True)
                y = fn(xg, wg)
                dy = torch.randn(y.shape, generator=torch.Generator(
                    device="cuda").manual_seed(7), device="cuda").to(y.dtype)
                res.append((y.detach(), *torch.autograd.grad(y, (xg, wg),
                                                             dy)))
                del y, dy
            route = L.tensor_core_route(x.dtype, emb.dtype, out_dt)
            check(route == (xd == "bf16"), f"dense {name}: tensor-core "
                  f"route {route} for {xd} x")
            tag = f"dense {name} at {rows} rows"
            n_out = res[1][0][0].numel()
            for what, a, b, k_sum in zip(("y", "dx", "dw"), *res,
                                         (k, n_out, rows)):
                check(a.dtype == b.dtype and a.shape == b.shape,
                      f"{tag}: {what} {a.dtype} {tuple(a.shape)} vs "
                      f"{b.dtype} {tuple(b.shape)}")
                if a.dtype == torch.bfloat16:
                    floor = dense_floor(k_sum, b)
                    floors.append(floor)
                    ulps, ok = ulp_check_rows(a, b, 1, floor)
                    check(ok, f"{tag}: {what} {ulps} bf16 ulps from the f32 "
                          f"route beyond the {floor:.3g} floor (limit 1)")
                    # a reading: the flash checks' 1e-5 floor here
                    flat, flat_ok = ulp_check_rows(a, b, 1, BF16_ATOL)
                    if not flat_ok:
                        past_flat.append(f"{name} {what} at {rows} rows "
                                         f"({flat:g} ulps, K {k_sum})")
                    key = "f32 grads" if out_dt == torch.float32 else "bf16"
                    worst[key] = max(worst[key], ulps)
                else:
                    err = max_err(a, b)
                    check(allclose(a, b, **KERNEL_TOL),
                          f"{tag}: {what} differs from the f32 route by "
                          f"{err} (limit rtol=atol=2e-5)")
                    worst["f32"] = max(worst["f32"], err)
            if route and out_dt == torch.float32:
                w2 = emb.reshape(k, -1)
                bad = torch.matmul(x.reshape(rows, k), w2).float()
                check(not allclose(bad, res[1][0].reshape(rows, -1),
                                   **KERNEL_TOL),
                      f"{tag}: the planted bf16 rounding passes 2e-5")
                caught.append(max_err(bad, res[1][0].reshape(rows, -1)))
            del res
            n += 1
    torch.cuda.empty_cache()
    print(f"[dense] {n} products (q/k/v, o, gate/up, down, tied head at "
          f"{' and '.join(map(str, DENSE_ROWS))} rows) through layers.dense "
          f"== the f32 route: bf16 outputs and gradients within 1 ulp "
          f"beyond a floor of {DENSE_ROUNDOFFS} x sqrt(K) x 2^-24 x rms "
          f"({min(floors):.3g}-{max(floors):.3g}; max "
          f"{worst['bf16']:g} ulps among the elements past it), f32 "
          f"outputs within rtol=atol=2e-5 (max |err| {worst['f32']:.3g}), "
          f"the gradients of f32-output products (bf16 hi + lo cotangent) "
          f"max {worst['f32 grads']:g} ulps; the down projection (f32 x) "
          f"keeps the f32 route; planted fault 'f32 output rounded through "
          f"bf16' caught at {len(caught)} of {len(caught)} f32-output "
          f"products (|err| {min(caught):.3g}-{max(caught):.3g}); at the "
          f"flash checks' {BF16_ATOL} floor instead, {len(past_flat)} of "
          f"{len(floors)} bf16 tensors break 1 ulp"
          + (": " + ", ".join(past_flat) if past_flat else ""))


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
    t_start = time.monotonic()
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
    logs = _build.build_all(verbose=True, variants=[
        ("flash_attention", FLASH_FAULT), ("flash_attention", FLASH_FWD_FAULT),
        ("quant_matmul", QMM_FAULT), ("ssd", SSD_HI_FAULT),
        ("ssd", SSD_PASS_FAULT), ("ssd", SSD_NO_PRODUCTS)])
    print(f"[build] {', '.join(_build.KERNELS)}, the flash library with "
          f"-D{FLASH_FAULT[0]} and with -D{FLASH_FWD_FAULT[0]}, the int8 "
          f"library with -D{QMM_FAULT[0]} and the SSD library with "
          f"-D{SSD_HI_FAULT[0]} and with -D{SSD_PASS_FAULT[0]} (planted "
          f"faults) and with -D{SSD_NO_PRODUCTS[0]} (timed alone) built by "
          f"nvcc in {time.monotonic() - t0:.1f}s")
    for name, log in logs.items():
        print(f"[build] {name}: " + " ".join(
            line.strip() for line in log.splitlines() if "registers" in line))

    record = {"kernels": []}
    phase_dense(get_config("qwen1.5-0.5b"))
    phase_kernel_vs_plain()

    cfg = get_config("qwen1.5-0.5b")
    params = LM(cfg, device="cuda").init(0)
    run_a, run_b = phase_graphs_dense(cfg, params)
    st_a, st_b = run_a["st"], run_b["st"]
    del params
    free_card()
    mb = 128                        # table bucket of a 1064-token row
    dec = time_shape(cfg, b=8, t=1, lengths=[96, 288, 1032, 96, 288, 1032,
                                             96, 288],
                     quant=False, mb=mb, n_blocks=1025, n_layers=24,
                     splits=(3, 16))
    chk = time_shape(cfg, b=1, t=64, lengths=[936], quant=True, mb=64,
                     n_blocks=1025, n_layers=24, splits=(4, 8))
    for name, r in (("decode B=8 T=1 bf16", dec),
                    ("chunk B=1 T=64 ctx=936 int8", chk)):
        print(f"[timing] paged_attention {name}, {r['n_split']} column "
              f"splits: {r['ms'] * 1e3:.2f} us by graph replay "
              f"(bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms'] * 100:.1f}% of it; by events "
              f"around 200 calls {r['event_ms'] * 1e3:.2f} us), == plain "
              f"within rtol=atol=2e-5, plain "
              f"{r['plain_ms'] * 1e3:.1f} us, sdpa "
              f"{r['library_ms'] * 1e3:.2f} us by graph replay (by events "
              f"{r['library_event_ms'] * 1e3:.2f} us), max |err| "
              f"{r['max_abs_err']:.3g}; at other split counts "
              + ", ".join(f"{n}: {v * 1e3:.2f} us" for n, v in
                          r["by_split"].items()) + f"; {card_line()}")
    print(f"[timing] engine (graph replay): whole-prompt bf16 decode "
          f"{st_a['decode_tok_s']:.1f} tok/s, p50 TTFT "
          f"{st_a['p50_ttft_s'] * 1e3:.1f} ms; chunk=64 int8 decode "
          f"{st_b['decode_tok_s']:.1f} tok/s, p50 TTFT "
          f"{st_b['p50_ttft_s'] * 1e3:.1f} ms")
    llama = get_config("llama2-7b")
    llama_runs = phase_llama2(llama)
    wide = time_shape(llama, b=8, t=1, lengths=[96, 288, 1032, 96, 288,
                                                1032, 96, 288],
                      quant=False, mb=mb, n_blocks=1025, n_layers=32)
    free_card()
    print(f"[timing] paged_attention llama2-7b decode B=8 T=1 H=K=32 D=128 "
          f"bf16, {wide['n_split']} column splits: {wide['ms'] * 1e3:.2f} "
          f"us by graph replay (bound {wide['bound_ms'] * 1e3:.2f} us by "
          f"{wide['bound_by']}, {wide['bound_ms'] / wide['ms'] * 100:.1f}% "
          f"of it; by events {wide['event_ms'] * 1e3:.2f} us), == plain "
          f"within rtol=atol=2e-5 (max |err| {wide['max_abs_err']:.3g}), "
          f"plain {wide['plain_ms'] * 1e3:.1f} us, sdpa "
          f"{wide['library_ms'] * 1e3:.2f} us by graph replay; "
          f"{card_line()}")
    record["kernels"].append({
        "name": "paged_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/flash_decode.py:206",
        "launches": run_a["launches"] + run_b["launches"] + sum(
            r["launches"] for r in llama_runs),
        "max_abs_err": dec["max_abs_err"],
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
    })

    phase_flash_vs_plain()
    train_launches, _ = phase_train(get_config("qwen1.5-0.5b"))
    ft = phase_flash_timing()
    flash_src = "src/repro_torch/kernels/csrc/flash_attention.cu"
    # bwd is the whole flash_attention_bwd (both kernels, one launch
    # each per call, so its launches are either kernel's count); no
    # one library call computes dK/dV or dQ alone
    for name, line, errs, lib, launches in (
            ("fwd", 76, ("o", "lse"), ft["lib_fwd"],
             train_launches["fwd"]),
            ("bwd_dkv", 120, ("dk", "dv"), None,
             train_launches["bwd_dkv"]),
            ("bwd_dq", 165, ("dq",), None, train_launches["bwd_dq"]),
            ("bwd", 203, ("dq", "dk", "dv"), ft["lib_bwd"],
             train_launches["bwd_dkv"])):
        record["kernels"].append({
            "name": f"flash_attention_{name}",
            "route": "cuda",
            "source": flash_src,
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": launches,
            "max_abs_err": max(ft["errs"][e] for e in errs),
            "ms": ft["ms"][name],
            "plain_ms": ft["plain"][name],
            "bound_ms": ft["bounds"][name][0],
            "bound_by": ft["bounds"][name][1],
            "library_ms": lib,
        })

    phase_ssd_vs_plain()
    cfg = get_config("mamba2-130m")
    params = LM(cfg, device="cuda").init(0)
    ssd_launches = phase_graphs_ssm(cfg, params)
    del params
    free_card()
    sd = phase_ssd_timing()
    record["kernels"].append({
        "name": "ssd_chunked_kernel",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd.cu",
        "replaces": "src/repro/kernels/ssd.py:75",
        "launches": ssd_launches,
        "max_abs_err": sd["max_abs_err"],
        "ms": sd["ms"],
        "plain_ms": sd["plain_ms"],
        "bound_ms": sd["bound_ms"],
        "bound_by": sd["bound_by"],
        "library_ms": None,
    })

    phase_qmm_vs_plain()
    cfg = get_config("qwen1.5-0.5b")
    ft_launches, _ = phase_finetune(cfg)
    rows, _ = phase_qmm_timing(cfg)
    gate = rows["gate/up"]
    record["kernels"].append({
        "name": "int8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:40",
        "launches": ft_launches,
        "max_abs_err": gate["max_abs_err"],
        "ms": gate["ms"],
        "plain_ms": gate["plain_ms"],
        "bound_ms": gate["bound_ms"],
        "bound_by": gate["bound_by"],
        "library_ms": gate["library_ms"],
    })

    phase_rmsnorm_vs_plain()
    phase_dense_decode_vs_plain()
    from repro_torch.data.pipeline import repetitive_requests, serving_requests
    params = LM(cfg, device="cuda").init(0)
    ngram = phase_spec_engine(
        cfg, params, name="n-gram depth 4, 16 repetitive requests",
        prompts=repetitive_requests(16, cfg.vocab_size, prompt_len=256),
        max_new=64, draft=False, eager_twin=True)
    self_draft = phase_spec_engine(
        cfg, params, name="self-draft depth 4, 4 requests",
        prompts=serving_requests(4, cfg.vocab_size, prompt_lens=[64, 256],
                                 seed=1),
        max_new=32, draft=True)
    del params
    rms_t, dec_t = phase_new_kernel_timing(cfg)
    print(f"[spec] RMSNorm launches per run: " + ", ".join(
        f"{k} {v}" for k, v in RMSNORM_RUNS.items()))
    train = rms_t["train"]
    record["kernels"].append({
        "name": "rmsnorm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "launches": sum(RMSNORM_RUNS.values()),
        "max_abs_err": train["max_abs_err"],
        "ms": train["ms"],
        "plain_ms": train["plain_ms"],
        "bound_ms": train["bound_ms"],
        "bound_by": train["bound_by"],
        "library_ms": train["library_ms"],
    })
    record["kernels"].append({
        "name": "dense_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dense_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:93",
        "launches": self_draft["dense"] + ngram["dense"],
        "max_abs_err": dec_t["max_abs_err"],
        "ms": dec_t["ms"],
        "plain_ms": dec_t["plain_ms"],
        "bound_ms": dec_t["bound_ms"],
        "bound_by": dec_t["bound_by"],
        "library_ms": dec_t["library_ms"],
    })

    print(f"[done] every phase passed in {time.monotonic() - t_start:.1f}s, "
          f"the build included")
    print(json.dumps(record))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
