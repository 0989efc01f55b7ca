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
              The cases include phase 27's per-rank shapes (8 of qwen's
              16 KV heads at D=64, decode and an int8 chunk; 16 of
              llama2-7b's 32 at D=128), and a rank that holds every KV
              head but reads one (chatglm3-6b at TP = 4: 8 q heads on 1
              of the pool's 2 KV heads, D=128, decode bf16 and an int8
              chunk): the read of that window of the pool, in place,
              equals the read of a copy of it bit for bit.
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
              readings, not checks. Then the causal ``q_offset`` cases
              (``FLASH_OFFSET_CASES``: T = 1,024 rows at q_offset 1,024
              over 2,048 keys, at 0 over 2,048 keys, at 1,000 over 2,024,
              D = 64 with G = 1 and D = 128 with G = 8, bf16 and f32)
              against the plain versions at the same limits; the dK/dV
              kernel's f32 output rounded must be its bf16 output bit
              for bit and keys no row reaches zero; and a T = 2,048
              sequence split over 2 ranks must give the whole run's o,
              lse and dq rows bit for bit and, summed in f32, its dK/dV.
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
8. timing   - the flash kernels at the training shapes (B=4, T=2048,
              causal, bf16: qwen H=16, D=64; llama2-7b H=32, D=128;
              qwen3-moe H=32 over 4 KV heads, D=128): time per launch
              beside the
              bound, the plain versions' times (each kernel's function
              and the whole backward), and
              ``scaled_dot_product_attention`` forward, backward and
              forward + backward on the same tensors (timed here only);
              each kernel's body and bound as built (the forward 3
              products, the backward 12: P and dS take three parts in
              dK/dV, dS two in dQ) beside
              the useful work's. Then the q_offset forms at phase 30's
              sequence-mode ranks (B=4, H=K=16, D=64, 1,024 rows at
              q_offset 0 over 1,024 keys and at 1,024 over 2,048, dK/dV
              in f32) beside their bounds on the live (row, key) pairs,
              the plain versions and SDPA with the explicit mask.
9. ssd      - the SSD kernel against its plain version on the card, f32,
              at mamba2-130m's whole-prompt shape (B=4, T=1000 padded to
              1024, H=24, P=64, N=128, chunk 256), its chunk step's (B=1,
              T=64 taken at its live length, a carried state), four
              chunks with a carried state, an odd one (G=2, T not a
              multiple of the chunk) and one the FMA body takes (N=4,
              P=8), and both mamba2 shapes at H=12, a rank's heads under
              phase 27's TP = 2; y and the final state within
              ``SSD_TOL``. It prints
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
              projections of qwen and of llama2-7b (K, N in {4096, 11008},
              G = 32 head groups) at M=2048; x bf16 and f32, out bf16 and
              f32 (f32
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
14. timing  - the int8 kernel at the step's four shapes (M=8192), qwen's
              and llama2-7b's: its body,
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
              shape (1 ulp). The norm of a row split over ranks (phase
              27's mamba2 gated norm: the partial-sum pass, a sum over
              the parts, the scale pass) at the per-rank widths 768 (TP
              = 2) and 384 (TP = 4) of d_inner 1,536: one part against
              ``rmsnorm_plain`` of it, the parts together against
              ``rmsnorm_plain`` of the whole row, the partial sums
              against their plain version; a planted fault (each part
              scaled by its own sum) must break it; the partial-sum pass
              timed beside its bound, its plain version and
              ``torch.linalg.vecdot``.
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
              parameters in bf16), then llama2-13b (13.0 B, 40 layers),
              serve phase 4's 16 requests through
              the replayed steps, whole-prompt bf16 KV and chunked (64)
              int8 KV, with phase 4's checks (paged launches one a layer a
              step, RMSNorm 2 x layers + 1 a forward, tokens against a
              dense forward); it
              prints decode tok/s, the wall per decode step and the device
              time of a decode step with all 8 rows live (its graph
              replayed between two events) beside that step's byte bound
              (every weight and the live KV read once).
22. lifecycle - the serving engine's lifecycle slice at full width,
              through the replayed steps after ``warmup``, on phase 4's
              pool (8 slots, 1,024 blocks of 16, chunk 64): (a) qwen
              int8 KV and (b) mamba2 serve one warming request, then
              (``reset_stats``) 16 requests of a 960-token shared prefix
              and a 64-token suffix each, 64 new, prefix cache off and
              on: tokens bitwise, hit rate 1.0, 16 x 960 tokens reused,
              prefill tokens 16,384 against 1,024 and chunk steps 256
              against 16, the launch identities of phases 4 and 10, no
              capture after warmup, the allocator clean; on mamba2 the
              snapshot restored at depth 960 is bitwise the state a cold
              prefill reached there, and the snapshots' MiB are printed;
              (c) phase 4's chunked int8 burst with the cache on under
              ``FaultInjector.from_seed`` for two seeds (squeezes,
              allocator failures, cancels, two pollution twins, a NaN):
              survivors bitwise the fault-free run, the NaN-armed
              request failed, terminal causes summing to the requests
              that entered, the allocator clean; (d) that trace with
              telemetry off, on and fenced: tokens, ``trace_counts`` and
              pool bytes bitwise, the snapshot's documented keys, a
              Chrome trace written under ``build/``, the fenced per-step
              sweep / schedule / dispatch / sync split. p50 TTFT and
              decode tok/s are printed as readings.
23. moe     - (a) full-width qwen3-moe-30b-a3b (48 layers, 128 experts
              top-8, q/k norms; 30.5 B seeded parameters, 57 GiB of
              bf16, drawn a layer slice at a time) serves phase 4's 16
              requests through the replayed steps, whole-prompt bf16 KV
              and chunked (64) int8 KV, with phase 4's launch checks
              (paged launches per attention layer a step, RMSNorm 4 x
              layers + 1 a forward). Each run prints decode tok/s, p50
              TTFT, the wall per decode step, peak
              ``max_memory_allocated``, and a full decode step's device
              time by graph replay against its byte bound with every
              expert and with only the experts that step routed to. Each
              run is then served again with a ``MoeProbe`` installed
              before the warmup (a wrapper around ``blocks._moe_local``
              whose copies of each call's experts the graphs capture; the
              timed runs carry none): its tokens and ``stats()``
              counters bitwise the timed run's (the chunked run's probed
              twin is eager, with phase 20's checks), its tokens within 8
              bf16 ulps of a teacher-forced forward's argmax with the
              engine's routing forced (each token's experts in every MoE
              layer and the assignments the capacity step dropped, from
              the plain capacity step on the recorded experts), its
              dropped assignments printed. (b) jamba-v0.1-52b at full
              width cut to one period (8 of its 32 layers: attention at
              offset 4, an MoE FFN at the odd offsets, 7 SSD layers) the
              same runs, with SSD launches 7 x (prefill groups + chunk
              steps), 0 in decode. (c) the paged read at G = 8, D = 128
              (decode B = 8, chunk T = 64 int8) and the SSD scan at H =
              128, N = 16 (B = 4, T = 1,024; the chunk step) against their
              plain versions (2e-5; the SSD limit) and timed by graph
              replay.
24. slice   - the rest of one-device training, each part at 4 x 2048
              tokens, printing step ms, tokens/s and peak memory: (a)
              full-width llama2-7b QL+Q8+F+R (6.7 B weights, an int8
              base, LoRA rank 64): the flash route against naive
              attention at phase 7's limits and the int8 kernel route
              against the reference's at phase 13's on one batch, 4 steps
              through ``Trainer.run`` with the launches by kernel and the
              frozen base bit-unchanged, then the adapters learning on one
              fixed batch (the loss falls by 0.2 within 8 steps, warmup
              0, no weight decay, the lr of ``LEARN_LR``); (b) qwen1.5-0.5b
              Q8+F+R, then Q+F+R (nf4): the codes after each step those of
              quantizing the updated view, bitwise, the 8-bit moments' bytes
              against f32's, the loss falling; (c) mamba2-130m F+R (the
              SSD reference under autograd), the loss falling; (d)
              qwen3-moe-30b-a3b F+R at full width cut to 2 of its 48
              layers (G = 8 flash backward), aux finite and positive, the
              dropped assignments printed, the loss falling; (e) qwen
              F+R+Z3: 2 steps, a blocking save, a new Trainer resuming to
              step 4 with async saves, bitwise 4 straight steps.
25. family  - the encoder-decoder and vision-language families at full
              width (seeded weights), through ``LM``'s entry points with
              ``attn_impl="flash"`` (the engine serves neither frontend):
              seamless-m4t-large-v2 (2.03 B parameters) prefills 8
              requests of 1,024 seeded frames and a 64-token prompt
              (the encoder's non-causal flash forward) and decodes 64
              greedy steps; internvl2-26b (19.86 B, 39.7 GB) 8 requests
              of 256 patches and a 256-token prompt in a 576-position
              cache, 64 steps (the dense decode read at G = 6, D = 128).
              Launches held (flash forward one a layer of the prefill,
              the encoder's included; dense decode one a decoder layer a
              step; RMSNorm one a norm a forward), every token the
              argmax of a teacher-forced forward or a 4-ulp near tie;
              prefill ms, decode tok/s and peak memory printed. Each
              then trains F+R through ``build_train``'s step on one
              fixed batch of 4 x 1,024 positions (seamless 1,024 frames
              and 1,024 tokens; internvl2 cut to 2 of 48 layers, 256
              patches and 768 tokens): flash against naive |dloss|
              (within 2e-3), 3 steps whose loss falls, launches per step.
              The encoder's flash kernels (B=8, H=16, T=S=1,024, D=64,
              non-causal), the dense decode read at both families'
              shapes and RMSNorm at 6,144 against their plain versions,
              timed beside bound, plain and library.
26. ssm     - decoding the SSM families through the replayed steps:
              mamba2-130m n-gram (depth 4, 16 repetitive 256-token
              prompts, 64 new; its proposals are a reading: random
              weights may never repeat a context token) and a self-draft
              (4 requests, 32 new),
              each spec-off then spec-on, streams equal up to 4-ulp near
              ties, the self-draft's accept_rate > 0.6 and each
              rejection an 8-ulp near tie, launches per verify step (0
              SSD: the per-token scan; the draft's prefills launch it);
              ``LM.prefill`` plus 64 ``decode_step``s on the n-gram
              prompts against the engine's spec-off stream; a scripted
              proposer (one good token, a garbage tail) whose slot
              states after partial acceptance equal spec-off's at the
              same length within 3e-2 of their scale; jamba-v0.1-52b over
              one period, n-gram and the scripted run on 4 of its
              prompts, with every MoE assignment kept (no drops: a
              dropped token's output depends on its step's rows); the
              paged read at jamba's widest verify window (T = 5, G = 4,
              D = 128) against its plain version and timed.
27. tp      - the serving engine sharded over two ranks that share card
              0 (``launch.mesh.spawn_ranks``, gloo, the steps eager: a
              CUDA graph cannot capture their collectives), at full
              width: qwen1.5-0.5b chunked (64) with int8 KV, llama2-7b and
              mamba2-130m whole-prompt, 8 requests (prompts 64/256, 32
              new) each, first on one device in this process, then on
              the two ranks. Both ranks' tokens must be equal, and equal
              to the single-device run's up to splits at 4-ulp bf16 near
              ties of its logits (counted and printed); every rank
              launches the paged read once an attention layer a step on
              its K/2 KV heads, the SSD scan once an SSM layer a prefill
              group on its 12 heads, RMSNorm once a norm (the gated norm's
              scale pass included) and its partial-sum pass once a gated
              norm. Teacher forced: TP = 1's streams go through both
              ranks' model, through TP = 1's and through TP = 1 with
              TP = 2's order of sums (each row-parallel product as two
              f32 halves added, the gated norm's squares summed by
              halves, the column-parallel products on each rank's
              columns, the paged read split as a rank's heads split it);
              at every position the largest logit gap to TP = 1 must
              stay within ``TP_FORCED_ULPS`` bf16 ulps of the row's top,
              and TP = 2's logits must equal the emulated order's bit for
              bit. The emulated order also serves the burst on one
              device: its streams' splits from TP = 2's are printed
              beside TP = 1's. It prints each rank's peak memory, decode
              tok/s and the share of a decode step spent in collectives
              (each timed between two synchronizes), beside the card's name
              and power limit; with two or more cards it also runs nccl,
              one card per rank, and otherwise says that it did not.
28. dp      - training over a data axis of two ranks that share card 0
              (gloo): qwen1.5-0.5b at full width, F+R, global batch 4 x
              2048 (phase 24's), 3 steps. The one-device oracle
              (grad_accum 2, the ranks' rows as its two micro-batches)
              runs in this process; then one spawn runs Z0, Z1, Z2, Z3
              and Z3+O in turn, each from fresh seeded state (qwen cut
              to 4 of 24 layers, widths untouched), and
              mamba2-130m F+R+Z3 for 2 steps against its own oracle.
              Every stage's per-step loss must equal the oracle's bit for
              bit, its grad_norm within rtol 1e-6, and its final params
              and moments must too (two linear per-leaf hashes of the
              gathered bytes, taken on the card, and the sha256 of each
              rank's piece of every leaf against that of the same piece of
              the oracle's), on both ranks; each rank launches the
              flash forward twice an attention layer a step (R), each
              backward kernel once, and RMSNorm as phase 7 counts for its
              micro-batch. The state at rest on the card (params,
              moments, the persistent gradient buffer) must fall from Z0
              to Z1 to Z2 to Z3 to Z3+O. Prints each stage's per-rank
              peak memory, state at rest on the card and in pinned host
              memory, step ms and the share of a step spent in
              collectives (each timed between two synchronizes), beside
              the card's name and power limit; with two or more cards it
              also runs Z3 over nccl, one card per rank, and otherwise
              says that it did not.

30. tp-train - tensor-parallel training on card 0, ranks over gloo: (A)
              qwen1.5-0.5b at full width, F+R, 2 steps of 4 x 2048 at TP =
              2 with sequence parallelism off, then on, then with the
              attention in sequence (context-parallel) mode, sp off, in
              one spawn, against the one-device F+R run on the same
              batches: step
              1's loss and ce within 1e-5 relative, grad_norm within
              1e-3 (step 2: 1e-2 and 3%), after step 1 each param
              within half of its update at cosine >= 0.9 and each first
              moment within 2^-5 of its norm from one device's (linear
              sketches of every leaf, each rank's pieces at their
              indices in the whole; beside them how far each run lies
              from the f32 step's, and a control: how far apart two
              one-device bf16 steps, grad_accum 1 and 2, lie);
              teacher forced, each head-mode run's step 1 loss equals
              the one-device forward in TP = 2's order of sums bit for
              bit. In sequence mode every rank launches the flash
              kernels on all 16 heads at its own q_offset (0, 1,024),
              gathers k/v once a forward and sums their f32 cotangents
              once a backward an attention layer, and times its own
              flash kernels while the others wait. (B) the (2 data x 2
              model) mesh, 4 ranks, F+R+Z3 with sequence parallelism,
              in head mode and then in sequence mode, qwen cut to 2 of
              24 layers, against one device at grad_accum 2. In head mode each rank launches the flash
              kernels on its H/2 heads; RMSNorm as one device does;
              it prints per rank peak memory and state at rest against
              one device, the seams', k/v and step collectives a step,
              ms each and their share of the step (host-staged). For
              its room the script cuts earlier paths' depth (widths
              untouched): phase 21's llama2-7b / 13b to 16 / 20 layers,
              23's qwen3-moe to 2, 24 (a)'s llama2-7b to 16, 26's
              mamba2 to 12, 27's qwen and mamba2 to 4 and llama2-7b to
              8, 28's qwen to 4, 29's qwen3-moe to 2 ((A)) and 1 ((B)).
31. pipeline - the GPipe pipeline (``parallel.pipeline``) on card 0, two
              ranks over gloo: qwen1.5-0.5b's 24 layers at full width as
              2 stages of 12, forward only, 8 microbatches of 1 x 2048.
              Both ranks' outputs must equal the one-device forward of
              the same layers bit for bit; each rank launches the flash
              forward (q_offset 0) and 2 RMSNorms a layer a tick over the
              9 ticks. Prints the bubble fraction, ms a tick and a ring
              shift, and the forward's ms against one device's.
32. tp-families - tensor-parallel training of the MoE and hybrid
              families on card 0, two ranks over gloo: (A)
              qwen3-moe-30b-a3b at full width cut to 2 of its 48 layers,
              F+R at TP = 2 (expert parallelism: 64 experts a rank), 2
              steps of 4 x 2048, head mode with sp off, then on, then
              sequence mode, in one spawn; (B) jamba-v0.1-52b at full
              width cut to 2 layers (attention with its dense FFN, a
              Mamba-2 layer with the 16-expert MoE FFN), F+R at TP = 2,
              2 steps of 2 x 2048. Each rank's step against the
              one-device F+R step on the same batches, which dispatches
              each t-slice at its own capacity (training's multiplier)
              as a rank does and whose routes the ranks take in step 1
              (a near tie flips an expert where sums run in other
              orders; at most 3% of a rank's tokens, each a near tie),
              so both drop the same assignments there (counted): ce and
              loss within 1e-5, aux (the t-slices' mean) within 5e-5
              (a rank's own t-slice's lies beyond: checked), grad_norm
              within 1e-3, the later step at phase 30's limits, the first
              moments and params after step 1 at phase 30's limits
              (sketched), beside each run's distance from the f32
              step's. Each rank launches the flash forward twice and the
              dK/dV and dQ kernels once an attention layer a step, the
              split norm's two passes on each Mamba-2 layer (again in
              the recomputation) and RMSNorm as one device.
              Prints per-rank peak memory and state at rest against one
              device, and the exchange's and the seams' ms and MiB a
              step and share of the step.

Any failed check raises. The last three lines of standard output are the
kernels' JSON record, the card's name and power limit, and
``{"ok": true, "device": {...}}``; the line before them gives the whole
run's time. Each main path (the engine runs, the training run, the
two fine-tuning runs, the speculative engine runs, the nine
lifecycle bursts, phase 23's eight runs, phase 24's training runs,
phase 25's serving and training runs, phase 26's runs, phase 27's
single-device runs and each rank's run, each of phase 28's runs on
each rank and one device, each of phase 30's, phase 31's on each
rank, and each of phase 32's) is driven with every launch
count set to 0 just before it (after the engine's warmup, and in phase
22 (a)/(b) after the warming request) and read just after; so is each
eager twin. Without
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
# phase 24's attention at 4 x 2048: llama2-7b (G = 1) and qwen3-moe-30b-a3b
# (32 query heads over 4 KV heads, G = 8), both D = 128
SLICE_FLASH = (("llama2-7b", dict(b=4, h=32, kv=32, t=2048, d=128)),
               ("qwen3-moe-30b-a3b", dict(b=4, h=32, kv=4, t=2048, d=128)))
# phase 8's causal q_offset cases (B, H, K, T, S, D, q_offset): phase 30's
# two sequence-mode ranks (rank 1's rows over every gathered key, rank 0's
# over keys past its reach, which get zero dK/dV) and an offset off the
# 64-row tile, at D = 64 with G = 1 (qwen) and D = 128 with G = 8
FLASH_OFFSET_CASES = tuple(
    (1, h, kv, 1024, s, d, off) for h, kv, d in ((16, 16, 64), (32, 4, 128))
    for s, off in ((2048, 1024), (2048, 0), (2024, 1000)))
# phase 30's sequence-mode ranks at TP = 2, timed: (rank, S, q_offset)
FLASH_OFFSET_TIMED = ((0, 1024, 0), (1, 2048, 1024))
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
             # a rank's 12 of mamba2's 24 heads at phase 27's TP = 2
             ("TP=2 whole-prompt", 4, 1000, 12, 64, 1, 128, 256, False),
             ("TP=2 chunk step", 1, 64, 12, 64, 1, 128, 256, True),
             ("4 chunks", 2, 1024, 24, 64, 1, 128, 256, True),
             ("odd", 2, 100, 6, 32, 2, 48, 32, True),
             ("fma", 3, 70, 2, 8, 1, 4, 32, True))
# the two mamba2 shapes: the tensor-core body, within this factor of the
# FMA body's max |err| against the plain version on the same inputs
SSD_MAMBA2 = ("whole-prompt", "chunk step", "TP=2 whole-prompt",
              "TP=2 chunk step")
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
             ("gate/up", 2048, 1024, 2816, 1), ("down", 2048, 2816, 1024, 1),
             ("llama2-7b q/k/v", 2048, 4096, 4096, 32),
             ("llama2-7b o", 2048, 4096, 4096, 1),
             ("llama2-7b gate/up", 2048, 4096, 11008, 1),
             ("llama2-7b down", 2048, 11008, 4096, 1))
STEP_NAMES = ("q/k/v", "o", "gate/up", "down")
# the fine-tuning step's projections at M = 4 x 2048 tokens: (name, K, N,
# G, x type, out type, launches per layer per forward pass)
QMM_STEP = (("q/k/v", 1024, 1024, 16, "bf16", "f32", 3),
            ("o", 1024, 1024, 1, "bf16", "bf16", 1),
            ("gate/up", 1024, 2816, 1, "bf16", "f32", 2),
            ("down", 2816, 1024, 1, "f32", "f32", 1))
# llama2-7b's (phase 24 (a)): wq/wk/wv over 32 heads, wo, w_gate/w_up, w_down
QMM_STEP_LLAMA = (("q/k/v", 4096, 4096, 32, "bf16", "f32", 3),
                  ("o", 4096, 4096, 1, "bf16", "bf16", 1),
                  ("gate/up", 4096, 11008, 1, "bf16", "f32", 2),
                  ("down", 11008, 4096, 1, "f32", "f32", 1))
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
# 768 and its gated norm's 1536, qwen3-moe 2048, llama2-7b and jamba
# 4096, the q/k norms' head width 128) and two ragged ones (1000: the last
# vectors of a row fall to some threads only; 999: not a whole number of
# 16-byte vectors, read element by element) at decode, odd and training
# row counts and the q/k norms' rows (qwen3-moe's 32 query heads of a
# decode step's 8 rows, and of a 64-token chunk)
RMS_ROWS = (1, 8, 256, 333, 2048, 8192)
# the gated norm split over ranks: mamba2's d_inner and its per-rank
# widths at TP = 2 and 4; rows of a decode step (8), a 256-token prompt
# (256) and a prefill group of 8 (2,048)
RMS_SPLIT_WIDTH = 1536
RMS_SPLIT_ROWS = (1, 8, 256, 2048)
RMS_DIMS = (128, 768, 1024, 1536, 2048, 4096, 1000, 999)
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
# (T, B, K, D, lengths, int8): the paged read at the per-rank shapes of
# phase 27's TP = 2 (qwen's 8 of 16 KV heads at D = 64, decode and an int8
# chunk step; llama2-7b's 16 of 32 at D = 128), G = 1
PAGED_SHARD_CASES = ((1, 8, 8, 64, [96, 288, 1032, 96, 288, 1032, 96, 288],
                      False),
                     (64, 1, 8, 64, [936], True),
                     (1, 8, 16, 128, [96, 288, 1032, 96, 288, 1032, 96, 288],
                      False))
# (T, B, q heads, KV heads held, the window read, D, lengths, int8): a
# rank that holds every KV head but reads those its q heads map to
# (chatglm3-6b at TP = 4: 8 of 32 q heads, 1 of the 2 KV heads), read in
# place from the pool
PAGED_WINDOW_CASES = ((1, 8, 8, 2, (1, 2), 128,
                       [96, 288, 1032, 96, 288, 1032, 96, 288], False),
                      (64, 1, 8, 2, (0, 1), 128, [936], True))
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
    SSM layer's gated norm, an attention layer's q and k norms under
    ``qk_norm``, and the final norm."""
    return sum(3 if kind == "ssm" else 4 if cfg.qk_norm else 2
               for kind in cfg.layer_kinds()) + 1


def norms_per_train_step(cfg, seq: int, remat: bool) -> int:
    """RMSNorm launches of one training step: each layer's norms (those of
    ``norms_per_forward``; again when full remat recomputes the layer),
    and the final norm in each 512-token loss block, which is
    checkpointed (forward and recompute)."""
    return ((norms_per_forward(cfg) - 1) * (2 if remat else 1)
            + 2 * -(-seq // 512))


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
    n_short = len(cases)
    for t, b, kv, d, lengths, quant in PAGED_SHARD_CASES:
        cases.append(dict(b=b, t=t, h=kv, kv=kv, d=d, bs=16,
                          lengths=lengths, mb=128,
                          n_blocks=sum(-(-x // 16) for x in lengths) + 2,
                          quant=quant))
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
          f"{splits[0]} (the {n_short} short cases), "
          f"{splits[n_short:n_short + len(PAGED_SHARD_CASES)]} (the per-rank "
          f"shapes of TP=2: K=8 D=64 decode and int8 chunk, K=16 D=128 "
          f"decode), then {long} (up to 4,096 positions on a 256-column "
          f"table)")
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
    paged_window_check()


def paged_window_check():
    """The paged read on a window of the pool's KV heads, read in place
    (the pool's other heads stepped over), against the read of a copy of
    the window (bit for bit) and the plain version (``KERNEL_TOL``)."""
    import torch
    from repro_torch.kernels import flash_decode as fd
    worst = 0.0
    for i, (t, b, h, kv, (lo, hi), d, lengths, quant) in enumerate(
            PAGED_WINDOW_CASES):
        q, k, v, ks, vs, table, lens = make_paged_case(
            b=b, t=t, h=h, kv=kv, d=d, bs=16, lengths=lengths, mb=128,
            n_blocks=sum(-(-x // 16) for x in lengths) + 2, quant=quant,
            seed=500 + i)
        win = [None if a is None else a[0][:, :, lo:hi]
               for a in (k, v, ks, vs)]
        check(not win[0].is_contiguous(), "the window is not a window")
        args = (q, win[0], win[1], table, lens, win[2], win[3])
        copy = (q, *(None if a is None else a.contiguous() for a in win[:2]),
                table, lens,
                *(None if a is None else a.contiguous() for a in win[2:]))
        tag = (f"T={t} B={b} {h} q heads on KV heads [{lo}, {hi}) of {kv} "
               f"D={d} {'int8' if quant else 'bf16'}")
        got, want = fd._paged_mq_cuda(*args), fd._paged_mq_cuda(*copy)
        check(all(torch.equal(a, c) for a, c in zip(got, want)),
              f"paged read of a window in place != of its copy at {tag}")
        err, ok = paged_vs_plain(args)
        check(ok, f"paged read of a window differs from plain at {tag}: "
              f"{err}")
        worst = max(worst, err)
    print(f"[kernel] paged read of a window of the pool's KV heads (a "
          f"rank of chatglm3-6b at TP=4: 8 q heads on 1 of 2 KV heads, "
          f"D=128, decode bf16 and an int8 chunk) in place == the read of "
          f"its copy bitwise, == plain within rtol=atol=2e-5 (max |err| "
          f"{worst:.3g})")


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


def moe_window(model, params, x, caches, pos0, kv_quant, moe):
    """The layer stack over a window ``x`` (B, T, d) at positions pos0..:
    an attention layer attends its cached prefix ((k, v) as stored, or
    None) and the window causally, an SSM layer continues its cached
    (conv, state) (None: from zeros), the plain SSD; ``moe(h, p)`` is an
    MoE FFN's output on its normed input. Returns x and the caches
    extended by the window."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.serving.cache import quant_decode, quant_encode
    cfg = model.cfg
    out = []
    for i in range(cfg.n_layers):
        lp, pos, c = model.layer_params(params, i), i % model.period, \
            caches[i]
        if model.kinds[pos] == "ssm":
            x, c = B.ssm_apply(x, lp["mix"], cfg, cache=c, ssd_impl="ref",
                               return_state=c is None)
        else:
            h = L.rmsnorm(x, lp["mix"]["ln"], cfg.norm_eps)
            at = pos0 + torch.arange(x.shape[1], device=x.device)[None]
            q, k, v = B._qkv(h, lp["mix"], cfg, at)
            if kv_quant == "int8":
                k = quant_decode(*quant_encode(k, "int8"), torch.float32)
                v = quant_decode(*quant_encode(v, "int8"), torch.float32)
            if c is not None:
                k, v = torch.cat([c[0], k], 1), torch.cat([c[1], v], 1)
            att = L.naive_attention(q, k, v, causal=True, q_offset=pos0)
            x = x + L.dense(att.to(q.dtype), lp["mix"]["wo"], n_in=2)
            c = (k, v)
        out.append(c)
        if model.fkinds[pos] == "moe":
            x = x + moe(L.rmsnorm(x, lp["ffn"]["ln"], cfg.norm_eps),
                        lp["ffn"])
        else:
            x = B.ffn_apply(x, lp["ffn"], cfg)
    return x, out


# tokens ``forced_moe`` dispatches at a time: an expert takes at most one
# assignment a token, so its rows stay within this however skewed the
# routing (a random router's prompt groups pile thousands of tokens on
# one expert)
FORCED_TOKENS = 512


def forced_moe(h, p, cfg, top_e, keep):
    """The MoE FFN's output on normed ``h`` (B, T, d) with the engine's
    routing: each token's experts ``top_e`` (B, T, k) in the engine's
    choice order, their gates this function's own f32 softmax at those
    experts renormalised over the k, the assignments ``keep`` (B, T, k)
    marks false adding nothing; each expert's SwiGLU
    (``blocks._expert_ffn``) over its assignments, ``FORCED_TOKENS``
    tokens at a time (forced, a token's output depends on no other
    token), the combine in f32 in choice order from zeros, rounded once.
    Also returns, per token, whether this function's own top-k set is
    the engine's."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.quant.qtensor import QTensor
    wg, wu, wd = (p[w].dequantize(h.dtype) if isinstance(p[w], QTensor)
                  else p[w] for w in ("w_gate", "w_up", "w_down"))
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    x = h.reshape(-1, d)
    n, dev = x.shape[0], x.device
    te, kp = top_e.reshape(n, k), keep.reshape(n, k)
    gates = torch.softmax(L.dense(x.float(), p["router"]).float(), dim=-1)
    own = torch.sort(gates, dim=-1, descending=True, stable=True)[1][:, :k]
    same = (own.sort(-1)[0] == te.sort(-1)[0]).all(-1)
    w = gates.gather(1, te)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    out = torch.empty((n, d), dtype=h.dtype, device=dev)
    for t0 in range(0, n, FORCED_TOKENS):
        t1 = min(n, t0 + FORCED_TOKENS)
        m = t1 - t0
        flat = te[t0:t1].reshape(-1)
        counts = torch.bincount(flat, minlength=e)
        cap = int(counts.max())
        order = torch.argsort(flat, stable=True)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.empty_like(flat)
        pos[order] = torch.arange(m * k, device=dev) - starts[flat[order]]
        slot = flat * cap + pos
        buf = torch.zeros((e * cap, d), dtype=h.dtype, device=dev)
        buf[slot] = x[t0 + torch.arange(m * k, device=dev) // k]
        ys = B._expert_ffn(buf.reshape(e, cap, d), wg, wu, wd)
        part = (ys.reshape(e * cap, d)[slot].float()
                * w[t0:t1].reshape(-1)[:, None])
        part = torch.where(kp[t0:t1].reshape(-1)[:, None], part,
                           torch.zeros((), device=dev)).reshape(m, k, d)
        acc = torch.zeros((m, d), dtype=torch.float32, device=dev)
        for j in range(k):
            acc = acc + part[:, j]
        out[t0:t1] = acc.to(h.dtype)
        del buf, ys, part
    return out.reshape(h.shape), same


def moe_reference_rows(model, params, done, kv_quant, prefill_chunk,
                       groups, moe):
    """Teacher-forced logits of each request's outputs ({rid: rows}) on
    an MoE arch, with the engine's routing forced (``forced_moe``): every
    token's experts and dropped assignments in every MoE layer as the
    probed engine recorded them (``moe``, ``MoeProbe.file``); the windows
    as the engine's prefill ran them (its whole-prompt ``groups``, or its
    chunks of ``prefill_chunk`` tokens), then each request's generated
    tokens. Also returns the (token, layer) pairs the reference's own
    router would route as the engine, and all of them."""
    import numpy as np
    import torch
    cfg = model.cfg
    by_rid = {r.rid: r for r in done}
    dev = model.device
    ptrs = moe_layers(model, params)
    agree = [0, 0]
    route = {}

    def forced(h, p):                  # one MoE layer of the window
        i = ptrs[p["router"].data_ptr()]
        y, same = forced_moe(h, p, cfg, route["top_e"][i],
                             route["keep"][i])
        agree[0] += int(same.sum())
        agree[1] += same.numel()
        return y

    def force(parts):                  # [(top_e, keep) (L, T, k)] a row
        for n, j in (("top_e", 0), ("keep", 1)):
            route[n] = torch.stack([torch.as_tensor(a[j]) for a in parts],
                                   1).to(dev)

    def embed(toks):
        return model._embed_in(params, torch.tensor(toks, device=dev))

    def head(x):
        return model._head(params, x)

    rows = {}

    def generated(r, last, caches):    # the outputs after the prompt
        gen = moe["gen"][r.rid]
        force([tuple(np.stack([gen[j][m] for j in range(1, len(r.output))],
                              1) for m in range(2))])
        x, _ = moe_window(model, params, embed([r.output[:-1]]), caches,
                          len(r.tokens), kv_quant, forced)
        rows[r.rid] = torch.cat([last[None], head(x)[0]])

    if prefill_chunk is None:
        for rids in groups:
            toks = [by_rid[rid].tokens for rid in rids]
            force([moe["prompt"][rid] for rid in rids])
            x, caches = moe_window(model, params, embed(toks),
                                   [None] * cfg.n_layers, 0, kv_quant,
                                   forced)
            last = head(x[:, -1:])[:, 0]
            for i, rid in enumerate(rids):
                generated(by_rid[rid], last[i], [
                    tuple(a[i:i + 1] for a in c) if isinstance(c, tuple)
                    else {k: a[i:i + 1] for k, a in c.items()}
                    for c in caches])
    else:
        for r in done:
            caches = [None] * cfg.n_layers
            top_e, keep = moe["prompt"][r.rid]
            for s0 in range(0, len(r.tokens), prefill_chunk):
                toks = r.tokens[s0:s0 + prefill_chunk]
                cut = slice(s0, s0 + len(toks))
                force([(top_e[:, cut], keep[:, cut])])
                x, caches = moe_window(model, params, embed([toks]),
                                       caches, s0, kv_quant, forced)
            generated(r, head(x[:, -1:])[0, 0], caches)
    return rows, agree


def moe_layers(model, params) -> dict:
    """{address of an MoE layer's router weight: its index among the MoE
    layers}: the engine's layer views and ``layer_params``' share it."""
    out = {}
    for i in range(model.cfg.n_layers):
        if model.fkinds[i % model.period] == "moe":
            lp = model.layer_params(params, i)
            out[lp["ffn"]["router"].data_ptr()] = len(out)
    return out


def capacity_keep(top_e, cap: int, n_experts: int):
    """The capacity step in numpy: whether each (token, choice) of one
    call, ``top_e`` (n, k), keeps its row, i.e. has fewer than ``cap``
    earlier assignments to its expert in (token, choice) order."""
    import numpy as np
    flat = top_e.reshape(-1)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_experts)
    starts = np.cumsum(counts) - counts
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - starts[flat[order]]
    return (pos < cap).reshape(top_e.shape)


class MoeProbe:
    """Each MoE call's routing, recorded on the card: a wrapper around
    ``blocks._moe_local`` (and ``_route``, to take the experts the call
    used) copies the call's (B, T, k) experts into this probe's buffer of
    its shape, one (n_moe_layers, B, T, k) int64 tensor a (B, T). Install
    it before an engine's ``warmup``, and its graphs capture the copies;
    ``read`` after a step takes the buffers that step wrote (and marks
    them unwritten, -1), with each call's kept assignments from the
    capacity step of the plain function (``capacity_keep``)."""

    def __init__(self, model, params):
        self.cfg = model.cfg
        self.layers = moe_layers(model, params)
        self.bufs, self.mults = {}, {}

    def install(self) -> None:
        from repro_torch.models import blocks as B
        self.saved = B._route, B._moe_local
        route, local = self.saved
        last = []

        def routed(x, w, cfg):
            out = route(x, w, cfg)
            last[:] = [out[1]]
            return out

        def dispatched(h, p, cfg, capacity_mult):
            out = local(h, p, cfg, capacity_mult)
            self._record(h, p, capacity_mult, last.pop())
            return out

        B._route, B._moe_local = routed, dispatched

    def remove(self) -> None:
        from repro_torch.models import blocks as B
        B._route, B._moe_local = self.saved

    def _record(self, h, p, mult, top_e) -> None:
        import torch
        b, t = h.shape[0], h.numel() // (h.shape[0] * h.shape[-1])
        i = self.layers[p["router"].data_ptr()]
        buf = self.bufs.get((b, t))
        if buf is None:
            buf = self.bufs[(b, t)] = torch.full(
                (len(self.layers), b, t, self.cfg.top_k), -1,
                dtype=torch.int64, device=h.device)
        check(self.mults.setdefault((b, t), mult) == mult,
              f"MoE calls of shape {(b, t)} at two capacity multipliers")
        buf[i].copy_(top_e.reshape(b, t, -1))

    def read(self) -> dict:
        """{(B, T): (top_e, keep) (n_moe_layers, B, T, k)} of the calls
        since the last read."""
        import numpy as np
        from repro_torch.models import blocks as B
        out = {}
        for key, buf in self.bufs.items():
            top_e = buf.to("cpu", copy=True).numpy()
            written = top_e >= 0
            if not written.any():
                continue
            check(bool(written.all()), f"MoE calls of shape {key}: some "
                  f"layers unrecorded in a step")
            buf.fill_(-1)
            b, t = key
            cap = B.capacity(b * t, self.cfg, self.mults[key])
            keep = np.stack([capacity_keep(layer.reshape(b * t, -1), cap,
                                           self.cfg.n_experts)
                             for layer in top_e]).reshape(top_e.shape)
            out[key] = (top_e, keep)
        return out


def teacher_forced(model, params, done, kv_quant, rows=None):
    """Share of generated tokens equal to the dense argmax, and the worst
    near-tie gap (in bf16 ulps of the top logit) among the others.
    ``rows`` ({rid: logits of its outputs}) replaces the dense forward
    (``moe_reference_rows``)."""
    import torch
    match = total = 0
    worst = 0.0
    given = rows
    for r in done:
        if given is None:
            seq = list(r.tokens) + r.output
            toks = torch.tensor([seq[:-1]], dtype=torch.int64,
                                device="cuda")
            with torch.no_grad():
                logits = dense_reference_logits(model, params, toks,
                                                kv_quant).float()
            p0 = len(r.tokens) - 1
            rows = logits[p0:p0 + len(r.output)]
        else:
            rows = given[r.rid].float()
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


def drive_engine(eng, prompts, max_new: int, max_steps: int, probe=None):
    """The engine phases' main path: ``warmup`` for every table bucket of
    the trace (it must leave both pools bitwise as they were), every
    launch count set to 0, the burst served, each decode step's wall and
    SSD launches recorded (and the host inputs of the last decode step
    with every row live, by key). With ``probe`` (a ``MoeProbe``), it is
    installed before the warmup, read after every step and filed by
    request (``track_moe``), and removed after the run. Returns the run's
    record."""
    import torch
    from repro_torch.kernels import ssd as ssdk
    from repro_torch.models import blocks as B
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import Request
    before = pool_bytes(eng, null_block=True)
    lens = sorted({len(p) for p in prompts})
    if probe is not None:
        probe.install()
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
    moe = {"total": 0, "decode": 0, "steps": 0, "prompt": {}, "gen": {}}
    groups, in_step, prefill_group = [], [], eng._prefill_group

    def grouped(group, t):             # whole-prompt groups, in order
        groups.append([r.rid for r in group])
        in_step.append((groups[-1], t))
        return prefill_group(group, t)

    eng._prefill_group = grouped
    if probe is not None:
        track_moe(eng, probe, moe, in_step)
        probe.read()                   # drop the warmup's records
    torch.cuda.synchronize()
    for c in graphs.KERNEL_COUNTERS:   # count the main path's run only
        c.clear()
    t0 = time.monotonic()
    try:
        done = eng.run(max_steps=max_steps)
    finally:
        if probe is not None:
            probe.remove()
    torch.cuda.synchronize()
    return {"done": done, "st": eng.stats(), "wall": time.monotonic() - t0,
            "walls": walls, "ssd_in_decode": ssd_in_decode, "full": full,
            "warm_traces": warm_traces, "traces": dict(eng.trace_counts),
            "graphs": len(eng._graphs), "warm_s": warm_s, "moe": moe,
            "groups": groups}


def track_moe(eng, probe, moe, in_step) -> None:
    """After every engine step, read the probe (``MoeProbe.read``) and
    file each call's (experts, kept) by request: a whole-prompt group's
    rows and a chunk step's live rows under ``moe["prompt"][rid]`` ((L,
    T, k) each, in prompt order), a decode step's slot under
    ``moe["gen"][rid][j]`` ((L, k) each) for the output index j the step
    emitted; count the dropped assignments (every row of a call, padded
    and inactive ones too: they take capacity). A call no request
    explains fails."""
    import numpy as np
    step, decode = eng.step, eng._decode_fused
    decoded = []

    def decoding(live):                # the rows this decode step emits
        slots = [(r, r.slot) for r in live]
        decode(live)
        decoded.extend((r, s) for r, s in slots)

    def stepped():
        before = {r.rid: r.prefilled for r in eng.live_requests()}
        n_fin = len(eng.finished)
        in_step.clear()
        decoded.clear()
        step()
        calls = probe.read()
        for top_e, keep in calls.values():
            moe["total"] += int((~keep).sum())
        moe["steps"] += any(bool((~keep).any())
                            for _, keep in calls.values())
        for rids, t in in_step:        # whole-prompt prefill groups
            top_e, keep = calls.pop((len(rids), t))
            for i, rid in enumerate(rids):
                moe["prompt"][rid] = (top_e[:, i], keep[:, i])
        if decoded:
            top_e, keep = calls.pop((eng.max_batch, 1))
            moe["decode"] += int((~keep).sum())
            for r, slot in decoded:
                moe["gen"].setdefault(r.rid, {})[len(r.output) - 1] = (
                    top_e[:, slot, 0], keep[:, slot, 0])
        chunked = [r for r in list(eng.sched.running) + eng.finished[n_fin:]
                   if r is not None and r.rid in before
                   and r.prefilled != before[r.rid]]
        if eng.prefill_chunk is not None and chunked:
            check(len(chunked) == 1, f"{len(chunked)} chunks in one step")
            r, = chunked
            top_e, keep = calls.pop((1, eng.prefill_chunk))
            p0, n = before[r.rid], r.prefilled - before[r.rid]
            part = (top_e[:, 0, :n], keep[:, 0, :n])
            moe["prompt"][r.rid] = part if p0 == 0 else tuple(
                np.concatenate([a, b], 1)
                for a, b in zip(moe["prompt"][r.rid], part))
        check(not calls, f"MoE calls of shapes {sorted(calls)} in a step "
              f"that no request explains")

    eng.step, eng._decode_fused = stepped, decoding


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


def phase_engine(cfg, params, *, prefill_chunk, kv_quant, cuda_graphs=True,
                 probe=False):
    """Serve the 16-request burst through the engine's entry points and
    hold the run's launch counts and tokens. ``cuda_graphs=False`` is the
    graph phase's eager twin of the same run (its tokens are held to the
    replayed run's, bitwise, instead of to a dense forward). On an MoE
    arch the tokens are held to a teacher-forced forward only in the run
    with ``probe`` (a ``MoeProbe`` records the engine's routing, which
    the forward takes); the caller holds the other runs to that one."""
    import torch
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine
    eng = Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                 kv_quant=kv_quant, prefill_chunk=prefill_chunk,
                 device="cuda", cuda_graphs=cuda_graphs)
    prompts = serving_requests(16, cfg.vocab_size, prompt_lens=SERVE_LENS)
    rec = drive_engine(eng, prompts, SERVE_NEW, 5000,
                       probe=MoeProbe(eng.model, eng.params) if probe
                       else None)
    done, st = rec["done"], rec["st"]
    launches = fd.LAUNCHES["paged_attention"]
    rec["ssd"] = ssdk.LAUNCHES["ssd"]
    check(sum(fa.LAUNCHES.values()) == 0,
          f"the engine launched flash kernels: {dict(fa.LAUNCHES)}")
    steps = st["decode_steps"] + st["chunk_steps"]
    check(len(done) == 16 and st["finished"] == 16,
          f"{st['finished']} of 16 requests finished")
    check(all(len(r.output) == SERVE_NEW for r in done),
          f"a request ended with fewer than {SERVE_NEW} tokens")
    kinds = cfg.layer_kinds()
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    check(launches == n_attn * steps,
          f"kernel launches {launches} != {n_attn} x {steps} steps")
    passes = st["prefill_groups"] + st["chunk_steps"]
    check(rec["ssd"] == n_ssm * passes and sum(rec["ssd_in_decode"]) == 0,
          f"SSD launches {rec['ssd']} != {n_ssm} x {passes} (prefill "
          f"groups + chunk steps), {sum(rec['ssd_in_decode'])} in decode")
    mode = (f"chunk={prefill_chunk}" if prefill_chunk else "whole-prompt")
    how = ("graph replay" if cuda_graphs else "eager") + (
        ", probed" if probe else "")
    run = (f"{cfg.name} {mode} kv={kv_quant}"
           + ("" if cuda_graphs else " eager") + (" probed" if probe else ""))
    forwards = st["prefill_groups"] + steps
    want = norms_per_forward(cfg) * forwards
    what = f"{norms_per_forward(cfg)} x {forwards} forwards"
    moe = rec["moe"]
    if cuda_graphs and not probe:
        rms = count_rmsnorm(run, rn.LAUNCHES["rmsnorm"], want, what)
    else:
        check(rn.LAUNCHES["rmsnorm"] == want, f"{run}: RMSNorm launches "
              f"{rn.LAUNCHES['rmsnorm']} != {want} ({what})")
        rms = f"RMSNorm launches {want} = {what}"
    if cfg.is_moe and probe:
        check(st["preemptions"] == 0, f"{run}: preempted, so the prefill "
              f"the reference reproduces is not the engine's")
        with torch.no_grad():
            rows, agree = moe_reference_rows(
                LM(cfg, ssd_impl="ref", device="cuda"), eng.params, done,
                kv_quant, prefill_chunk, rec["groups"], moe)
        share, worst = teacher_forced(eng.model, eng.params, done, kv_quant,
                                      rows=rows)
        del rows
        tokens = (f"reference-argmax match {share:.4f} (others within "
                  f"{worst:.1f} bf16 ulps, {NEAR_TIE_ULPS} at most) with "
                  f"the engine's routing and drops forced, the reference's "
                  f"own router choosing the engine's expert set at "
                  f"{agree[0]} of {agree[1]} (token, MoE layer) pairs")
    elif cuda_graphs and not cfg.is_moe:
        share, worst = teacher_forced(eng.model, eng.params, done, kv_quant)
        tokens = (f"reference-argmax match {share:.4f} (others within "
                  f"{worst:.1f} bf16 ulps, {NEAR_TIE_ULPS} at most)")
    elif cuda_graphs:
        tokens = "tokens held to the probed run's"
    else:
        tokens = "tokens held to the replayed run's"
    print(f"[engine] {cfg.name} full width, {mode}, kv={kv_quant}, "
          f"{how}: 16/16 finished x "
          f"{SERVE_NEW} tokens in {rec['wall']:.2f}s; {st['decode_steps']} "
          f"decode + {st['chunk_steps']} chunk steps, kernel launches "
          f"{launches} = {n_attn} x {steps}; "
          + (f"SSD launches {rec['ssd']} = {n_ssm} x {passes}, 0 in decode; "
             if n_ssm else "")
          + (f"MoE dropped assignments {moe['total']} in "
             f"{moe['steps']} steps ({moe['decode']} in decode steps); "
             if probe else "")
          + f"{rms}; preemptions "
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


def decode_bound_ms(eng, inputs, experts=None) -> float:
    """Least time (ms) of one decode step on these inputs: every weight
    read once (an untied embedding table only at the batch's rows), the
    live KV (with int8 scales) read once, each row's new KV written once,
    at the card's memory rate; its operations (2 per weight a row) take
    far less at the bf16 peak. With ``experts`` (the distinct experts each
    MoE layer routed the step's rows to, in layer order), an MoE layer's
    expert weights count only those experts'."""
    from repro_torch.models.params import tree_paths
    cfg, kv = eng.cfg, eng.kv_cfg
    rows = int(inputs["active"].sum())
    leaves = [t for path, t in tree_paths(eng.params)
              if path != "embed" or cfg.tie_embeddings]
    n_weights = sum(t.numel() for t in leaves)
    weights = sum(t.numel() * t.element_size() for t in leaves)
    if experts is not None:             # bf16 gate, up and down of one
        per_expert = 3 * cfg.d_model * cfg.d_ff * 2
        weights -= per_expert * (len(experts) * cfg.n_experts - sum(experts))
    if not cfg.tie_embeddings:
        weights += rows * cfg.d_model * eng.params["embed"].element_size()
    per_token = kv.n_layers * 2 * kv.n_kv_heads * (
        kv.head_dim * (1 if kv.kv_quant == "int8" else 2)
        + (4 if kv.kv_quant == "int8" else 0))
    live = int(inputs["lengths"][inputs["active"]].sum())
    # the live rows' SSM (conv, state), read and written once
    ssm = sum(a.numel() * a.element_size() for st in eng._ssm_states.values()
              for a in st.values()) * rows // eng.max_batch
    t_bytes = (weights + 2 * ssm + (live + rows) * per_token) \
        / HBM_BYTES_PER_S
    t_ops = 2.0 * rows * n_weights / PEAK_OPS["bf16"]
    return max(t_bytes, t_ops) * 1e3


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

    def sdpa(i):                          # grouped KV heads as they are
        return F.scaled_dot_product_attention(
            qd, *dense[i % n_layers], attn_mask=mask, scale=scale,
            enable_gqa=h != kv)

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


def flash_vs_plain(q, k, v, do, causal, grad_ulps=BF16_ULPS, strict=True,
                   q_offset=0):
    """Forward and backward kernels against the plain versions on the
    same inputs (the causal mask's query offset ``q_offset``): f32
    outputs and lse within ``KERNEL_TOL``, bf16 outputs within
    ``BF16_ULPS`` (o) and ``grad_ulps`` (dq, dk, dv) bf16 ulps. Returns
    the worst |err| of (o, lse, dq, dk, dv), how many elements of each
    differ at all, and the worst bf16 ulps of the bf16 outputs; with
    ``strict=False`` the outputs whose limit broke instead of failing."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    o, lse = fa._fwd_cuda(q, k, v, causal=causal, sm_scale=None,
                          q_offset=q_offset)
    o_ref, lse_ref = fa._flash_fwd_torch(q, k, v, causal=causal,
                                         q_offset=q_offset)
    grads = fa._bwd_cuda(q, k, v, o, lse, do, causal=causal, sm_scale=None,
                         q_offset=q_offset)
    want = fa._flash_bwd_torch(q, k, v, o, lse, do, causal=causal,
                               q_offset=q_offset)
    torch.cuda.synchronize()
    dims = (q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2],
            q.shape[3])
    tag = (f"B,H,K,T,S,D={dims} {q.dtype} "
           f"{'causal' if causal else 'full'} q_offset={q_offset}")
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
    # phase 24's training shapes at B=1: D = 128, G = 1 and G = 8
    slice_lines = []
    for j, (name, sl) in enumerate(SLICE_FLASH):
        shape = dict(b=1, h=sl["h"], kv=sl["kv"], t=sl["t"], s=sl["t"],
                     d=sl["d"])
        g_ulps = BF16_ULPS_G1_GRADS if sl["h"] == sl["kv"] else BF16_ULPS
        e32, _, _ = flash_vs_plain(*flash_inputs(
            **shape, dtype=torch.float32, seed=90 + j), True)
        e16, d16, u16 = flash_vs_plain(*flash_inputs(
            **shape, dtype=torch.bfloat16, seed=94 + j), True,
            grad_ulps=g_ulps)
        check(fa.fwd_body(torch.bfloat16, sl["d"]) ==
              fa.bwd_body(torch.bfloat16, sl["d"]) == "mma",
              f"flash bodies at {name}'s shape are not the tensor cores")
        slice_lines.append(
            f"{name} B=1 H={sl['h']} K={sl['kv']} T={sl['t']} D={sl['d']} "
            f"(G={sl['h'] // sl['kv']}): f32 max |err| "
            + ", ".join(f"{nm} {e:.3g}" for nm, e in e32.items())
            + f"; bf16 (o within {BF16_ULPS} ulps, dq/dk/dv within "
            f"{g_ulps}) max |err| "
            + ", ".join(f"{nm} {e:.3g}" for nm, e in e16.items())
            + ", max ulps beyond the floor "
            + ", ".join(f"{nm} {u:g}" for nm, u in u16.items())
            + ", elements that differ "
            + ", ".join(f"{nm} {c}" for nm, c in d16.items()))
    print("[flash] training slice shapes == plain: " + "; ".join(slice_lines))
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
    # planted in the kernel build: P's lower parts dropped from dV += P^T dO
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


def phase_flash_offset():
    """Phase 8's causal ``q_offset`` cases (``FLASH_OFFSET_CASES``), bf16
    (the tensor-core bodies) and f32 (the FMA bodies): every kernel
    against its plain version at the phase's limits; the dK/dV kernel's
    f32 output (``kv_f32``) equal, rounded, to its bf16 output bit for bit
    (the sums before that rounding), dQ unchanged, and keys no row reaches
    zero. Then a sequence split over two ranks at T = 2048 against the
    whole sequence: each rank's rows with its offset over the keys it
    reaches give the whole run's o, lse and dq bit for bit, and the two
    ranks' f32 dK/dV partials, summed and rounded once, the whole run's
    dK/dV within the phase's ulps."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    worst_ulps, n = 0.0, 0
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, h, kv, t, s, d, off) in enumerate(FLASH_OFFSET_CASES):
            q, k, v, do = flash_inputs(b=b, h=h, kv=kv, t=t, s=s, d=d,
                                       dtype=dtype, seed=60 + i)
            g_ulps = BF16_ULPS_G1_GRADS if h == kv else BF16_ULPS
            errs, _, ulps = flash_vs_plain(q, k, v, do, True,
                                           grad_ulps=g_ulps, q_offset=off)
            worst[dtype] = max(worst[dtype], *errs.values())
            worst_ulps = max(worst_ulps, *ulps.values(), 0.0)
            o, lse = fa._fwd_cuda(q, k, v, causal=True, sm_scale=None,
                                  q_offset=off)
            dq, dk, dv = fa._bwd_cuda(q, k, v, o, lse, do, causal=True,
                                      sm_scale=None, q_offset=off)
            dq2, dk32, dv32 = fa._bwd_cuda(q, k, v, o, lse, do, causal=True,
                                           sm_scale=None, q_offset=off,
                                           kv_f32=True)
            tag = f"{(b, h, kv, t, s, d)} {dtype} q_offset={off}"
            bad = [f"{nm}: {int((x != y).sum())} elements differ, at keys "
                   f"{sorted(set((x != y).nonzero()[:, 2].tolist()))[:8]}"
                   for nm, x, y in (("dk", dk32.to(dtype), dk),
                                    ("dv", dv32.to(dtype), dv),
                                    ("dq", dq2, dq))
                   if not torch.equal(x, y)]
            check(dk32.dtype == dv32.dtype == torch.float32 and not bad,
                  f"flash dK/dV in f32 at {tag}: not the rounded output's "
                  f"sums ({'; '.join(bad)})")
            reach = t - 1 + off           # the last key a row sees
            if reach + 1 < s:
                check(not bool(dk32[:, :, reach + 1:].any()) and
                      not bool(dv32[:, :, reach + 1:].any()),
                      f"flash dK/dV at {tag}: keys past {reach} not zero")
            n += 1
    split = []
    for h, kv, d in ((16, 16, 64), (32, 4, 128)):
        t = 2048
        g_ulps = BF16_ULPS_G1_GRADS if h == kv else BF16_ULPS
        q, k, v, do = flash_inputs(b=1, h=h, kv=kv, t=t, s=t, d=d,
                                   dtype=torch.bfloat16, seed=70)
        o, lse = fa._fwd_cuda(q, k, v, causal=True, sm_scale=None)
        dq, dk, dv = fa._bwd_cuda(q, k, v, o, lse, do, causal=True,
                                  sm_scale=None)
        dk_sum = torch.zeros(dk.shape, dtype=torch.float32, device="cuda")
        dv_sum = torch.zeros_like(dk_sum)
        for r in range(2):
            lo, hi = r * t // 2, (r + 1) * t // 2
            rows = [x[:, :, lo:hi].contiguous() for x in (q, do)]
            keys = [x[:, :, :hi].contiguous() for x in (k, v)]
            o_r, lse_r = fa._fwd_cuda(rows[0], *keys, causal=True,
                                      sm_scale=None, q_offset=lo)
            dq_r, dk_r, dv_r = fa._bwd_cuda(
                rows[0], *keys, o_r, lse_r, rows[1], causal=True,
                sm_scale=None, q_offset=lo, kv_f32=True)
            check(torch.equal(o_r, o[:, :, lo:hi]) and
                  torch.equal(lse_r, lse[:, :, lo:hi]) and
                  torch.equal(dq_r, dq[:, :, lo:hi]),
                  f"flash rank {r} of 2 (H={h} K={kv} D={d}, q_offset "
                  f"{lo}): o/lse/dq differ from the whole sequence's rows")
            dk_sum[:, :, :hi] += dk_r
            dv_sum[:, :, :hi] += dv_r
        uk, ok_k = bf16_ulp_check(dk_sum.to(torch.bfloat16), dk, g_ulps)
        uv, ok_v = bf16_ulp_check(dv_sum.to(torch.bfloat16), dv, g_ulps)
        check(ok_k and ok_v, f"flash sequence split H={h} K={kv} D={d}: "
              f"summed dK/dV {uk}/{uv} bf16 ulps from the whole run's "
              f"(> {g_ulps})")
        split.append(f"H={h} K={kv} D={d}: dK/dV within {max(uk, uv):g} "
                     f"ulps beyond the floor")
    print(f"[flash] q_offset: {n} cases fwd+bwd kernels == plain (f32 "
          f"within rtol=atol=2e-5, max |err| {worst[torch.float32]:.3g}; "
          f"bf16 within the phase's ulps, max |err| "
          f"{worst[torch.bfloat16]:.3g}, max {worst_ulps:g} ulps beyond the "
          f"floor), dK/dV in f32 == the rounded output's sums bit for bit, "
          f"keys no row reaches zero; a T = 2048 sequence split over 2 "
          f"ranks: each rank's o, lse and dq == the whole run's rows bit "
          f"for bit, the ranks' f32 dK/dV summed and rounded once == the "
          f"whole run's (" + "; ".join(split) + f"); {card_line()}")


def flash_offset_timing():
    """The flash kernels at phase 30's sequence-mode ranks (B = 4, H = K =
    16, D = 64, each rank's 1024 rows of T = 2048: rank 0 over the keys
    [0, 1024) at q_offset 0, rank 1 over [0, 2048) at q_offset 1024),
    beside their bounds counted on the live (row, key) pairs, the plain
    versions and SDPA with the equivalent explicit boolean mask. The
    backward's dK/dV leaves in f32, as sequence mode runs it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    b, h, t, d = 4, 16, 1024, 64
    out = {}
    for rank, s, off in FLASH_OFFSET_TIMED:
        q, k, v, do = flash_inputs(b=b, h=h, kv=h, t=t, s=s, d=d,
                                   dtype=torch.bfloat16, seed=80 + rank)
        errs, _, _ = flash_vs_plain(q, k, v, do, True,
                                    grad_ulps=BF16_ULPS_G1_GRADS,
                                    q_offset=off)
        o, lse = fa._fwd_cuda(q, k, v, causal=True, sm_scale=None,
                              q_offset=off)
        ms = {"fwd": cuda_ms(lambda i: fa._fwd_cuda(
                  q, k, v, causal=True, sm_scale=None, q_offset=off),
                  iters=20),
              "bwd": cuda_ms(lambda i: fa._bwd_cuda(
                  q, k, v, o, lse, do, causal=True, sm_scale=None,
                  q_offset=off, kv_f32=True), iters=10)}
        plain = {"fwd": cuda_ms(lambda i: fa._flash_fwd_torch(
                     q, k, v, causal=True, q_offset=off), iters=5, warmup=1),
                 "bwd": cuda_ms(lambda i: fa._flash_bwd_torch(
                     q, k, v, o, lse, do, causal=True, q_offset=off,
                     kv_f32=True), iters=5, warmup=1)}
        keep = fa._causal_keep(t, s, off, q.device)
        lib_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep), iters=20)
        qg, kg, vg = (x.detach().clone().requires_grad_(True)
                      for x in (q, k, v))
        res = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=keep)
        lib_bwd = cuda_ms(lambda i: torch.autograd.grad(
            res, (qg, kg, vg), do, retain_graph=True), iters=10)
        del res
        pairs = b * h * sum(min(s, i + off + 1) for i in range(t))
        bounds = flash_bounds(b=b, h=h, kv=h, t=t, s=s, d=d, elt=2,
                              pairs=pairs)
        out[rank] = {"ms": ms, "plain": plain, "lib_fwd": lib_fwd,
                     "lib_bwd": lib_bwd, "bounds": bounds, "errs": errs,
                     "pairs": pairs}
        print(f"[timing] flash q_offset={off} (rank {rank} of phase 30's "
              f"TP = 2) B={b} H=K={h} T={t} S={s} D={d} bf16, "
              f"{pairs} live (row, key) pairs: fwd {ms['fwd'] * 1e3:.1f} us "
              f"(bound {bounds['fwd'][0] * 1e3:.2f} us by "
              f"{bounds['fwd'][1]}), bwd with f32 dK/dV "
              f"{ms['bwd'] * 1e3:.1f} us (bound {bounds['bwd'][0] * 1e3:.2f} "
              f"us by {bounds['bwd'][1]}); plain fwd "
              f"{plain['fwd'] * 1e3:.1f} us, bwd {plain['bwd'] * 1e3:.1f} us; "
              f"sdpa with the explicit mask fwd {lib_fwd * 1e3:.1f} us, bwd "
              f"{lib_bwd * 1e3:.1f} us; == plain, max |err| "
              + ", ".join(f"{nm} {e:.3g}" for nm, e in errs.items())
              + f"; {card_line()}")
    print(f"[timing] flash q_offset: rank 1's fwd+bwd "
          f"{(out[1]['ms']['fwd'] + out[1]['ms']['bwd']) * 1e3:.1f} us is "
          f"{(out[1]['ms']['fwd'] + out[1]['ms']['bwd']) / (out[0]['ms']['fwd'] + out[0]['ms']['bwd']):.2f}x "
          f"rank 0's {(out[0]['ms']['fwd'] + out[0]['ms']['bwd']) * 1e3:.1f} "
          f"us ({out[1]['pairs'] / out[0]['pairs']:.2f}x the live pairs)")
    return out


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


# a macro that builds the flash library with P's lower parts dropped from the
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


def flash_bounds(*, b, h, kv, t, s, d, elt, causal=True, pairs=None):
    """Least time (ms) of each kernel's function on this card: bytes of
    its inputs read once and outputs written once over HBM rate, against
    its useful products (causal pairs only when ``causal``, or the live
    (row, key) ``pairs`` given) over the bf16 tensor-core rate. Returns
    {name: (bound_ms, bound_by)}."""
    if pairs is None:
        pairs = (b * h * t * (t + 1) // 2 if causal and t == s
                 else b * h * t * s)
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


def built_bounds(*, b, h, t, d, causal=True):
    """Least time (ms) of the tensor-core kernels as built, at the bf16
    tensor-core rate: a split operand multiplies once a part, so the
    forward runs 1 + 2 products of 2*D per (causal) pair (P in two parts;
    2 of them useful), dK/dV 2 + 6 (P and dS in three), dQ 2 + 2, the
    whole backward 12 (5 useful)."""
    pairs = b * h * t * (t + 1) // 2 if causal else b * h * t * t
    return {name: 2.0 * d * pairs * n / PEAK_OPS["bf16"] * 1e3
            for name, n in (("fwd", 3), ("bwd_dkv", 8), ("bwd_dq", 4),
                            ("bwd", 12))}


def phase_flash_timing(name: str = "qwen1.5-0.5b", sh=None,
                       causal: bool = True):
    """The flash kernels at one training shape (``sh``: b, h, kv, t, d;
    default qwen's ``TRAIN_SHAPE``), causal or not, beside their bounds,
    the plain versions and SDPA (with grouped KV heads where kv < h)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    sh = sh or dict(TRAIN_SHAPE, kv=TRAIN_SHAPE["h"])
    gqa = sh["kv"] != sh["h"]
    g_ulps = BF16_ULPS if gqa else BF16_ULPS_G1_GRADS
    q, k, v, do = flash_inputs(b=sh["b"], h=sh["h"], kv=sh["kv"], t=sh["t"],
                               s=sh["t"], d=sh["d"], dtype=torch.bfloat16,
                               seed=5)
    errs, _, ulps = flash_vs_plain(q, k, v, do, causal, grad_ulps=g_ulps)
    scale = 1.0 / math.sqrt(sh["d"])
    o, lse = fa._fwd_cuda(q, k, v, causal=causal, sm_scale=None)
    delta = fa._delta(o, do)
    # as the backward runs it: the tensor-core dQ kernel computes delta
    # itself (into a buffer the dK/dV kernel then reads)
    mma = fa.bwd_body(q.dtype, sh["d"]) == "mma"
    dq_delta = torch.empty_like(delta) if mma else delta
    ms = {
        "fwd": cuda_ms(lambda i: fa._fwd_cuda(q, k, v, causal=causal,
                                              sm_scale=None), iters=20),
        "bwd_dkv": cuda_ms(lambda i: fa._bwd_dkv_cuda(
            q, k, v, do, lse, delta, causal=causal, scale=scale), iters=10),
        "bwd_dq": cuda_ms(lambda i: fa._bwd_dq_cuda(
            q, k, v, do, lse, dq_delta, causal=causal, scale=scale,
            out=o if mma else None), iters=10),
        "bwd": cuda_ms(lambda i: fa._bwd_cuda(q, k, v, o, lse, do,
                                              causal=causal, sm_scale=None),
                       iters=10),
    }
    plain = {"fwd": cuda_ms(lambda i: fa._flash_fwd_torch(q, k, v,
                                                          causal=causal),
                            iters=5, warmup=1)}
    for kernel, part in (("bwd_dkv", "dkv"), ("bwd_dq", "dq"),
                         ("bwd", "all")):
        plain[kernel] = cuda_ms(lambda i: fa._flash_bwd_torch(
            q, k, v, o, lse, do, causal=causal, part=part), iters=5, warmup=1)
    lib_fwd = cuda_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal, enable_gqa=gqa), iters=20)
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                         enable_gqa=gqa)
    lib_bwd = cuda_ms(lambda i: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters=20)
    del out

    def sdpa_fwd_bwd(i):
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                             enable_gqa=gqa)
        torch.autograd.grad(out, (qg, kg, vg), do)

    lib_fb = cuda_ms(sdpa_fwd_bwd, iters=20)
    bounds = flash_bounds(b=sh["b"], h=sh["h"], kv=sh["kv"], t=sh["t"],
                          s=sh["t"], d=sh["d"], elt=2, causal=causal)
    built = built_bounds(b=sh["b"], h=sh["h"], t=sh["t"], d=sh["d"],
                         causal=causal)
    tag = (f"B={sh['b']} H={sh['h']} K={sh['kv']} T={sh['t']} D={sh['d']} "
           f"{'causal' if causal else 'non-causal'} bf16 ({name})")
    for part in ("fwd", "bwd_dkv", "bwd_dq", "bwd"):
        bd, by = bounds[part]
        body = (fa.fwd_body if part == "fwd" else fa.bwd_body)(
            torch.bfloat16, sh["d"])
        note = f"; {body} body, bound as built {built[part] * 1e3:.2f} us"
        print(f"[timing] flash {part} {tag}: "
              f"{ms[part] * 1e3:.1f} us (bound {bd * 1e3:.2f} us by {by}, "
              f"{bd / ms[part] * 100:.2f}% of it{note}); {card_line()}")
    print(f"[timing] flash {tag} plain fwd {plain['fwd'] * 1e3:.1f} us, plain "
          f"dk/dv {plain['bwd_dkv'] * 1e3:.1f} us, plain dq "
          f"{plain['bwd_dq'] * 1e3:.1f} us, plain bwd (dq, dk, dv) "
          f"{plain['bwd'] * 1e3:.1f} us; sdpa fwd {lib_fwd * 1e3:.1f} us, "
          f"sdpa bwd {lib_bwd * 1e3:.1f} us, sdpa fwd+bwd "
          f"{lib_fb * 1e3:.1f} us; kernels == plain (o within {BF16_ULPS} "
          f"ulps, dq/dk/dv within {g_ulps}), max |err| "
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


def time_ssd(name, b, t, *, init, seed, pad_to=None, h=24, n=128):
    """The SSD kernel at mamba2-130m's widths (H=24, P=64, N=128, chunk
    256; jamba's: H=128, N=16) on B = ``b`` rows of T = ``t`` tokens as
    the engine passes them (padded to a multiple of min(256, T)), or
    padded to ``pad_to``, with a carried state when ``init``, beside its
    bound, its bound as built and its plain version."""
    import torch
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd as ssdk
    p, g, chunk = 64, 1, 256
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
# phase 22: the serving lifecycle (prefix cache, faults, telemetry)
# --------------------------------------------------------------------------

# the prefix-cache trace: a 960-token shared prefix (15 chunks of 64, on a
# chunk boundary as a hit must be), a distinct 64-token suffix each
LIFE_PREFIX, LIFE_SUFFIX, LIFE_BURST = 960, 64, 16
# FaultInjector.from_seed seeds whose NaN lands on a row of that step's
# forward (a request armed while it waits, or while another request's
# chunk runs, is not poisoned): read from the schedule replayed on the CPU
# at smoke size, which schedules as the card does (no EOS: the schedule
# does not depend on the weights)
CHAOS_SEEDS = (5, 23)
CHAOS_NAN_PERIOD = 12
# docs/observability.md's schema v1 (tests/test_telemetry.py pins it)
DOCUMENTED_SCHEMA = {
    "engine": {"steps", "mode", "prefill_chunk", "model_parallel"},
    "requests": {"completed", "finished", "timed_out", "cancelled",
                 "failed", "rejected", "rejected_reasons"},
    "latency": {"e2e", "ttft", "tpot", "queue"},
    "throughput": {"tok_s", "decode_tok_s", "decode_tokens",
                   "prefill_tokens", "decode_time_s", "prefill_time_s"},
    "pool": {"utilization", "owned", "cached_reclaimable", "free"},
    "prefix_cache": {"hit_rate", "cached_blocks", "tokens_reused",
                     "cow_copies"},
    "scheduler": {"preemptions", "queue_depth"},
    "telemetry": {"enabled", "fenced", "events", "events_dropped",
                  "chaos_actions"},
    "timeline": {"recorded", "dropped", "phase_totals_s", "step_kinds"},
}


def life_engine(cfg, params, **kw):
    """Phase 4's chunked engine: 8 slots, 1,024 blocks of 16, chunk 64."""
    from repro_torch.serving.engine import Engine
    return Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                  prefill_chunk=64, device="cuda", **kw)


def drive_life(eng, prompts, max_new: int, warm=None):
    """Phase 22's main path: ``warmup`` (the pools left bitwise), then,
    given ``warm``, that request served to completion and ``reset_stats``
    (the prefix cache keeps what it registered); every launch count set
    to 0, the burst served. Returns the burst's record."""
    import torch
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import Request
    lens = sorted({len(p) for p in prompts})
    before = pool_bytes(eng, null_block=True)
    eng.warmup(max(lens) + max_new, prompt_lens=lens)
    torch.cuda.synchronize()
    check(pools_equal(before, pool_bytes(eng, null_block=True)),
          "warmup changed the pools")
    del before
    warm_traces = dict(eng.trace_counts)
    if warm is not None:
        eng.submit(Request(rid=len(prompts), tokens=warm,
                           max_new_tokens=max_new))
        eng.run(max_steps=5000)
        eng.reset_stats()
    torch.cuda.synchronize()
    for c in graphs.KERNEL_COUNTERS:   # count the burst's run only
        c.clear()
    t0 = time.monotonic()
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
    done = eng.run(max_steps=20000)
    torch.cuda.synchronize()
    return {"done": done, "toks": {r.rid: r.output for r in done},
            "st": eng.stats(), "wall": time.monotonic() - t0,
            "warm_traces": warm_traces, "traces": dict(eng.trace_counts)}


def hold_launches(eng, rec, run: str) -> dict:
    """Phase 4's and 10's launch identities for one burst: the paged read
    once an attention layer a decode or chunk step, the SSD scan once an
    SSM layer a chunk step, RMSNorm once a norm a forward; no capture
    after warmup."""
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
    cfg, st = eng.cfg, rec["st"]
    kinds = cfg.layer_kinds()
    steps = st["decode_steps"] + st["chunk_steps"] + st["verify_steps"]
    got = {"paged": fd.LAUNCHES["paged_attention"],
           "ssd": ssdk.LAUNCHES["ssd"], "rmsnorm": rn.LAUNCHES["rmsnorm"]}
    check(got["paged"] == kinds.count("attn") * steps,
          f"{run}: paged launches {got['paged']} != "
          f"{kinds.count('attn')} x {steps} steps")
    check(got["ssd"] == kinds.count("ssm") * (st["chunk_steps"]
                                              + st["prefill_groups"]),
          f"{run}: SSD launches {got['ssd']} != {kinds.count('ssm')} x "
          f"{st['chunk_steps'] + st['prefill_groups']} prefill passes")
    forwards = steps + st["prefill_groups"]
    count_rmsnorm(run, got["rmsnorm"], norms_per_forward(cfg) * forwards,
                  f"{norms_per_forward(cfg)} x {forwards} forwards")
    check(rec["traces"] == rec["warm_traces"],
          f"{run}: captured while serving: "
          f"{set(rec['traces']) - set(rec['warm_traces'])}")
    return got


def alloc_clean(eng, run: str) -> None:
    """Every block free or parked (one reclaim from free), the free list
    without duplicates, no reference left."""
    alloc = eng.alloc
    free = list(alloc.free)
    check(alloc.n_available == alloc.n_blocks and
          len(free) == len(set(free)) and
          all(rc == 0 for rc in alloc.refcount),
          f"{run}: the allocator is not clean: {alloc.occupancy()}")


def snapshot_mib(eng) -> float:
    """Bytes of the SSM slot snapshots the prefix cache holds, in MiB."""
    return sum(a.numel() * a.element_size()
               for node in eng._prefix.by_block.values()
               if node.ssm is not None
               for leaves in node.ssm.values()
               for a in leaves.values()) / 2 ** 20


def phase_prefix(cfg, params, *, kv_quant="none"):
    """(a), (b): a warming request, then the 16-request shared-prefix
    burst, cache-off and cache-on; bitwise tokens, every burst request a
    hit of 960 tokens, the prefill work and the launches it saves."""
    import torch
    from repro_torch.data.pipeline import shared_prefix_requests
    prompts = shared_prefix_requests(LIFE_BURST + 1, cfg.vocab_size,
                                     prefix_len=LIFE_PREFIX,
                                     suffix_len=LIFE_SUFFIX, seed=5)
    warm, burst = prompts[0], prompts[1:]
    ssm = "ssm" in cfg.layer_kinds()
    recs, cold = {}, {}
    for on in (False, True):
        eng = life_engine(cfg, params, kv_quant=kv_quant, prefix_cache=on)
        if ssm and not on:
            # the state a cold prefill reaches at depth 960 (the warming
            # request's slot right after its 15th chunk)
            tick = eng._prefill_chunk_tick

            def tick_and_keep(tick=tick, eng=eng):
                tick()
                for r in eng.sched.running:
                    if not cold and r is not None and \
                            r.prefilled == LIFE_PREFIX:
                        cold.update(eng._snapshot_ssm_slot(r.slot))
            eng._prefill_chunk_tick = tick_and_keep
        run = f"{cfg.name} prefix cache {'on' if on else 'off'}"
        rec = drive_life(eng, burst, SERVE_NEW, warm=warm)
        st = rec["st"]
        check(st["finished"] == LIFE_BURST and all(
            len(r.output) == SERVE_NEW for r in rec["done"]),
            f"{run}: {st['finished']} of {LIFE_BURST} finished")
        rec["launches"] = hold_launches(eng, rec, run)
        alloc_clean(eng, run)
        n_prompt = LIFE_PREFIX + LIFE_SUFFIX
        want = (LIFE_BURST * LIFE_SUFFIX if on else LIFE_BURST * n_prompt)
        check(st["prefill_tokens"] == want and
              st["chunk_steps"] == want // 64,
              f"{run}: prefill tokens {st['prefill_tokens']}, chunk steps "
              f"{st['chunk_steps']}; want {want}, {want // 64}")
        if on:
            check(st["prefix_cache_hit_rate"] == 1.0 and
                  st["cached_tokens_reused"] == LIFE_BURST * LIFE_PREFIX,
                  f"{run}: hit rate {st['prefix_cache_hit_rate']}, reused "
                  f"{st['cached_tokens_reused']}")
            check(rec["toks"] == recs[False]["toks"],
                  f"{run}: tokens differ from cache-off at rids "
                  f"{[k for k, v in rec['toks'].items() if v != recs[False]['toks'][k]]}")
            rec["snap_mib"] = snapshot_mib(eng) if ssm else 0.0
            if ssm:
                node, _ = eng._prefix.match(burst[0])
                check(node is not None and node.depth * 16 == LIFE_PREFIX,
                      f"{run}: no snapshot node at depth {LIFE_PREFIX}")
                check(all(torch.equal(node.ssm[pos][leaf], a)
                          for pos, leaves in cold.items()
                          for leaf, a in leaves.items()),
                      f"{run}: the restored snapshot is not the state a "
                      f"cold prefill reached at depth {LIFE_PREFIX}")
        recs[on] = rec
        del eng
        free_card()
    off, on = recs[False], recs[True]
    snap = (f"; SSD launches {off['launches']['ssd']} -> "
            f"{on['launches']['ssd']}; SSM snapshots held "
            f"{on['snap_mib']:.1f} MiB; the restored snapshot == the cold "
            f"prefill's state at depth {LIFE_PREFIX}, bitwise"
            if ssm else "")
    print(f"[lifecycle] {cfg.name} prefix cache, kv={kv_quant}, "
          f"{LIFE_BURST} requests of {LIFE_PREFIX} shared + {LIFE_SUFFIX} "
          f"tokens, {SERVE_NEW} new: tokens bitwise cache-off's; hit rate "
          f"{on['st']['prefix_cache_hit_rate']:.2f}, reused "
          f"{on['st']['cached_tokens_reused']} tokens; prefill tokens "
          f"{off['st']['prefill_tokens']} -> {on['st']['prefill_tokens']}, "
          f"chunk steps {off['st']['chunk_steps']} -> "
          f"{on['st']['chunk_steps']}; paged launches "
          f"{off['launches']['paged']} -> {on['launches']['paged']}, "
          f"RMSNorm {off['launches']['rmsnorm']} -> "
          f"{on['launches']['rmsnorm']}{snap}; p50 TTFT "
          f"{off['st']['p50_ttft_s'] * 1e3:.1f} -> "
          f"{on['st']['p50_ttft_s'] * 1e3:.1f} ms, decode "
          f"{off['st']['decode_tok_s']:.1f} -> "
          f"{on['st']['decode_tok_s']:.1f} tok/s, burst wall "
          f"{off['wall']:.2f} -> {on['wall']:.2f} s (readings); no capture "
          f"after warmup; allocator clean; {card_line()}")
    return recs


def phase_telemetry(cfg, params):
    """(d): phase 4's chunked int8 trace telemetry-off, on and fenced:
    tokens, ``trace_counts`` and pool bytes bitwise; the snapshot's
    documented keys; the Chrome export; the fenced host/device split.
    Returns the off run (the fault-free run of (c)) and the launches."""
    import numpy as np
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.serving.telemetry import PHASES, Telemetry
    prompts = serving_requests(16, cfg.vocab_size, prompt_lens=SERVE_LENS)
    recs, launches = {}, {}
    for name, tel in (("off", None), ("on", True),
                      ("fenced", Telemetry(fenced=True))):
        eng = life_engine(cfg, params, kv_quant="int8", telemetry=tel)
        run = f"{cfg.name} chunk=64 int8 telemetry {name}"
        rec = drive_life(eng, prompts, SERVE_NEW)
        launches[name] = hold_launches(eng, rec, run)
        rec["pools"] = pool_bytes(eng, null_block=False)
        if name != "off":
            base = recs["off"]
            check(rec["toks"] == base["toks"],
                  f"{run}: tokens differ from telemetry off")
            check(rec["traces"] == base["traces"],
                  f"{run}: trace_counts differ from telemetry off")
            check(pools_equal(rec["pools"], base["pools"]),
                  f"{run}: pool bytes differ from telemetry off")
            snap = eng.snapshot()
            missing = {s: sorted(keys - set(snap.get(s, {})))
                       for s, keys in DOCUMENTED_SCHEMA.items()
                       if keys - set(snap.get(s, {}))}
            check(not missing, f"{run}: snapshot lacks {missing}")
            tel = eng.telemetry
            rec["timeline"] = list(tel.timeline)
            if name == "on":
                path = ROOT / "build" / "phase22_trace.json"
                path.parent.mkdir(exist_ok=True)
                trace = tel.export_chrome(str(path),
                                          metadata={"run": run})
                rec["events"] = len(trace["traceEvents"])
                rec["trace_path"] = path
            del rec["pools"]
        recs[name] = rec
        del eng
        free_card()
    del recs["off"]["pools"]
    fenced = recs["fenced"]["timeline"]

    def mean_ms(recs_, phase):
        return float(np.mean([r["phases"][phase] for r in recs_])) * 1e3

    decode_only = [r for r in fenced if r["kinds"] == ("decode",)]
    both = [r for r in fenced if set(r["kinds"]) == {"chunk", "decode"}]
    split = "; ".join(
        f"{label} ({len(rs)} steps): " + ", ".join(
            f"{ph} {mean_ms(rs, ph):.3f}" for ph in PHASES) + " ms"
        for label, rs in (("decode-only steps", decode_only),
                          ("chunk + decode steps", both)) if rs)
    st = {k: recs[k]["st"] for k in recs}
    print(f"[lifecycle] {cfg.name} telemetry, phase 4's chunk=64 int8 "
          f"trace: on and fenced == off bitwise (tokens of 16 requests, "
          f"trace_counts, KV pool); snapshot has every documented key; "
          f"Chrome trace {recs['on']['events']} events -> "
          f"{recs['on']['trace_path'].relative_to(ROOT)}; fenced per-step "
          f"host split (mean): {split}; decode tok/s off "
          f"{st['off']['decode_tok_s']:.1f}, on {st['on']['decode_tok_s']:.1f}"
          f", fenced {st['fenced']['decode_tok_s']:.1f}; p50 TTFT off "
          f"{st['off']['p50_ttft_s'] * 1e3:.1f}, on "
          f"{st['on']['p50_ttft_s'] * 1e3:.1f} ms (readings); {card_line()}")
    return recs["off"], launches


def phase_chaos(cfg, params, base):
    """(c): phase 4's chunked int8 burst with the prefix cache on under
    two seeded fault schedules (squeezes, allocator failures, cancels,
    pollution twins, one NaN): survivors bitwise the fault-free run's,
    the NaN-armed request failed, every request accounted once, the
    allocator clean, no capture after warmup."""
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.serving.faults import POLLUTE_RID_BASE, FaultInjector
    prompts = serving_requests(16, cfg.vocab_size, prompt_lens=SERVE_LENS)
    launches = {}
    for seed in CHAOS_SEEDS:
        inj = FaultInjector.from_seed(seed, rids=range(16),
                                      nan_period=CHAOS_NAN_PERIOD, pollute=2)
        eng = life_engine(cfg, params, kv_quant="int8", prefix_cache=True,
                          faults=inj)
        run = f"{cfg.name} chaos seed {seed}"
        rec = drive_life(eng, prompts, SERVE_NEW)
        inj.release_all(eng)
        check(inj.quiescent, f"{run}: the injector holds blocks")
        launches[seed] = hold_launches(eng, rec, run)
        alloc_clean(eng, run)
        st, done = rec["st"], rec["done"]
        armed = [d[0] for _, a, d in inj.log if a == "nan"]
        states = {r.rid: r.state for r in done}
        check(len(armed) == 1 and states.get(armed[0]) == "failed",
              f"{run}: NaN armed on {armed}, states {states}")
        entered = 16 + sum(1 for _, a, _ in inj.log if a == "pollute")
        causes = {k: st[k] for k in ("finished", "timed_out", "cancelled",
                                     "failed")}
        check(sum(causes.values()) == len(done) == entered,
              f"{run}: causes {causes} over {len(done)} done, "
              f"{entered} entered")
        survivors = [r for r in done
                     if r.rid < POLLUTE_RID_BASE and r.state == "finished"]
        bad = [r.rid for r in survivors if r.output != base[r.rid]]
        check(not bad, f"{run}: survivors {bad} differ from the fault-free "
              f"run; log {inj.log}")
        print(f"[lifecycle] {run}: {len(inj.log)} actions "
              f"({', '.join(a for _, a, _ in inj.log)}); causes {causes} "
              f"of {entered} entered; {len(survivors)} survivors bitwise "
              f"the fault-free run; rid {armed[0]} quarantined; hit rate "
              f"{st['prefix_cache_hit_rate']:.3f}; no capture after "
              f"warmup; allocator clean")
        del eng
        free_card()
    return launches


def phase_lifecycle():
    """Phase 22 on qwen1.5-0.5b and mamba2-130m at full width."""
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = get_config("qwen1.5-0.5b")
    params = LM(cfg, device="cuda").init(0)
    base, tel_launches = phase_telemetry(cfg, params)
    chaos_launches = phase_chaos(cfg, params, base["toks"])
    qwen = phase_prefix(cfg, params, kv_quant="int8")
    del params
    free_card()
    cfg = get_config("mamba2-130m")
    params = LM(cfg, device="cuda").init(0)
    mamba = phase_prefix(cfg, params)
    del params
    free_card()
    runs = (list(tel_launches.values()) + list(chaos_launches.values())
            + [r["launches"] for r in (*qwen.values(), *mamba.values())])
    return {k: sum(r[k] for r in runs) for k in ("paged", "ssd")}


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
            if name.removeprefix("llama2-7b ") in STEP_NAMES:
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
    print(f"[qmm] {n} cases ({len(QMM_CASES)} shapes x x/out in "
          f"bf16/f32) kernel == "
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


def phase_qmm_timing(cfg, table=QMM_STEP):
    """The int8 kernel at the fine-tuning step's projections of ``cfg``
    (``table``: qwen's ``QMM_STEP`` or llama2-7b's ``QMM_STEP_LLAMA``) at
    M = 8192 tokens, beside its bounds, the plain version and the
    reference's route."""
    import torch
    from repro_torch.kernels import quant_matmul as qmm
    m = TRAIN_SHAPE["b"] * TRAIN_SHAPE["t"]
    rows = {}
    for i, (name, k, n, g, xt, ot, per_layer) in enumerate(table):
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
        print(f"[timing] int8_matmul {cfg.name} {name} M={m} K={k} N={n} "
              f"G={g} x {xt} "
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


def rms_split_run(x, w, parts: int, run=None, eps: float = 1e-5):
    """The norm of rows ``x (rows, n)`` split into ``parts`` equal parts
    as the ranks compute it: each part's partial sums (the kernel), their
    sum in part order (what the ranks' all_reduce adds), then each part's
    scale pass (``run``: a planted fault around the scale pass)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    n = x.shape[-1]
    xs = [p.contiguous() for p in x.chunk(parts, -1)]
    ws = [p.contiguous() for p in w.chunk(parts)]
    sums = [rn._sumsq_cuda(p) for p in xs]
    total = sums[0].clone()
    for s_ in sums[1:]:
        total += s_
    scale = run or (lambda p, q, ss, own: rn._scaled_cuda(p, q, ss, n, eps))
    return torch.cat([scale(p, q, total, own)
                      for p, q, own in zip(xs, ws, sums)], -1)


def phase_rmsnorm_split():
    """The gated norm of a row split over ranks (the partial-sum pass, a
    sum over the parts, the scale pass) against the plain version, at
    mamba2's per-rank widths; a planted fault; the partial-sum pass
    timed. Returns its record numbers."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    n = RMS_SPLIT_WIDTH
    worst = {"one": 0.0, "whole": 0.0, "sums": 0.0}
    caught = []
    cases = [(rows, parts, xd) for rows in RMS_SPLIT_ROWS
             for parts in (2, 4) for xd in ("f32", "bf16")]
    for i, (rows, parts, xd) in enumerate(cases):
        x, w = rms_case(rows, n, xd, "bf16", seed=300 + i)
        tol = (dict(rtol=2e-5, atol=2e-5) if xd == "f32" else None)
        p0, w0 = x[:, :n // parts].contiguous(), w[:n // parts].contiguous()
        tag = f"rows={rows} {parts} parts of {n} x {xd}"

        def held(got, want, what):
            err = max_err(got.float(), want.float())
            ok = (allclose(got, want, **tol) if tol else
                  bf16_ulp_check(got, want, 1)[1])
            check(ok, f"split RMSNorm {what} differs from plain at {tag}: "
                  f"{err}")
            return err

        worst["one"] = max(worst["one"], held(
            rn.rmsnorm_split(p0, w0, n // parts, lambda t: t)[0],
            rn.rmsnorm_plain(p0, w0), "on one part"))
        worst["whole"] = max(worst["whole"], held(
            rms_split_run(x, w, parts), rn.rmsnorm_plain(x, w),
            "over the parts"))
        got_s, want_s = rn._sumsq_cuda(p0), rn.rmsnorm_sumsq_plain(p0)
        check(allclose(got_s, want_s, **KERNEL_TOL), f"partial sums differ "
              f"from plain at {tag}: {max_err(got_s, want_s)}")
        worst["sums"] = max(worst["sums"], max_err(got_s, want_s) /
                            float(want_s.abs().max()))
        bad = rms_split_run(x, w, parts, run=lambda p, q, ss, own:
                            rn._scaled_cuda(p, q, own, n))
        err = max_err(bad.float(), rn.rmsnorm_plain(x, w).float())
        if not (allclose(bad, rn.rmsnorm_plain(x, w), **tol) if tol else
                bf16_ulp_check(bad, rn.rmsnorm_plain(x, w), 1)[1]):
            caught.append(err)
    check(len(caught) == len(cases), f"planted split-norm fault (each part "
          f"scaled by its own sum) passes {len(cases) - len(caught)} cases")
    # the partial-sum pass at a prefill group's per-rank shape (TP = 2)
    rows, d = RMS_SPLIT_ROWS[-1], n // 2
    ins = [rms_case(rows, d, "f32", "bf16", seed=400 + j)[0]
           for j in range(4)]
    err = max_err(rn._sumsq_cuda(ins[0]), rn.rmsnorm_sumsq_plain(ins[0]))
    ms = graph_ms(lambda i: rn._sumsq_cuda(ins[i % 4]))
    plain_ms = graph_ms(lambda i: rn.rmsnorm_sumsq_plain(ins[i % 4]))
    lib_ms = graph_ms(lambda i: torch.linalg.vecdot(ins[i % 4], ins[i % 4]))
    t_bytes = (rows * d * 4 + rows * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * rows * d / F32_FMA_OPS * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[rmsnorm] split over ranks, {len(cases)} cases (rows "
          f"{RMS_SPLIT_ROWS} x 2 or 4 parts of {n} x x f32/bf16, w bf16): "
          f"one part == rmsnorm_plain of it (max |err| {worst['one']:.3g}), "
          f"the parts' partial sums added and each part scaled == "
          f"rmsnorm_plain of the whole row (max |err| {worst['whole']:.3g}), "
          f"f32 within rtol=atol=2e-5, bf16 within 1 ulp; partial sums == "
          f"plain within 2e-5 (max relative {worst['sums']:.3g}); planted "
          f"fault 'each part scaled by its own sum' caught at "
          f"{len(caught)} of {len(cases)} (max |err| "
          f"{min(caught):.3g}-{max(caught):.3g})")
    print(f"[timing] rmsnorm_sumsq {rows} x {d} f32 (a prefill group's "
          f"rank at TP = 2): {ms * 1e3:.2f} us (bound "
          f"{bound_ms * 1e3:.3f} us by {bound_by}, "
          f"{bound_ms / ms * 100:.2f}% of it), plain {plain_ms * 1e3:.2f} "
          f"us, torch.linalg.vecdot {lib_ms * 1e3:.2f} us; == plain, max "
          f"|err| {err:.3g}; {card_line()}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


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


def spec_splits(model, params, prompts, want, got,
                what: str = "spec-on splits from spec-off"):
    """Streams of a spec-on run against spec-off's: a stream may split only
    at a position where spec-off's own logits (a dense forward over the
    prompt and spec-off's tokens before the split) put the spec-on token
    within ``SPEC_NEAR_TIE_ULPS`` bf16 ulps of the top. Returns the split
    count. (Phase 27 holds TP = 2 streams to TP = 1's by the same rule.)"""
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
              f"rid {rid}: {what} at token {j} "
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
                      eager_twin=False, need_rounds=True):
    """Serve ``prompts`` spec-off, then spec-on (n-gram when ``draft`` is
    False, else a self-draft), with the launch counts of the spec-on run
    held against its stats (paged read once an attention layer a verify
    step, the draft's dense decode read once an attention layer a draft
    decode step, the SSD kernel once an SSM layer a prefill group or
    draft prefill and never in a verify step); with ``eager_twin`` the
    spec-on run again eagerly, held bitwise to the replayed one (phase
    20). ``need_rounds=False``: a proposer silent through the whole run
    (the n-gram one where random weights never repeat a context token)
    is a reading, not a failure."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
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
    ssd = ssdk.LAUNCHES["ssd"]
    kinds = cfg.layer_kinds()
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    steps = st["decode_steps"] + st["chunk_steps"] + st["verify_steps"]
    check(st["decode_steps"] == 0 and st["verify_steps"] > 0 and
          (st["spec_rounds"] > 0 or not need_rounds),
          f"{name}: {st['verify_steps']} verify steps, {st['decode_steps']} "
          f"plain decode steps, {st['spec_rounds']} spec rounds")
    check(paged == n_attn * steps,
          f"{name}: paged launches {paged} != {n_attn} x {steps} steps")
    check(sum(fa.LAUNCHES.values()) == 0,
          f"{name}: the engine launched flash kernels: {dict(fa.LAUNCHES)}")
    n_pre, n_dec = ((proposer.n_prefills, proposer.n_decode_steps)
                    if draft else (0, 0))
    check(dense == n_attn * n_dec,
          f"{name}: dense decode launches {dense} != {n_attn} x "
          f"{n_dec} draft decode steps")
    # the draft proposes inside the decode phase: its prefills are the
    # SSD launches there; a verify step launches none
    check(ssd == n_ssm * (st["prefill_groups"] + n_pre) and
          sum(rec["ssd_in_decode"]) == n_ssm * n_pre,
          f"{name}: SSD launches {ssd} != {n_ssm} x ({st['prefill_groups']}"
          f" prefill groups + {n_pre} draft prefills), "
          f"{sum(rec['ssd_in_decode'])} in the decode phase")
    tie_note = ""
    if draft:
        check(n_dec > 0, f"{name}: the draft never decoded")
        check(st["accept_rate"] > SELF_DRAFT_ACCEPT,
              f"{name}: self-draft accept_rate {st['accept_rate']:.4f} <= "
              f"{SELF_DRAFT_ACCEPT}")
        gaps = rejected_draft_gaps(eng.model, eng.params, prompts,
                                   outs["on"], rounds)
        check(all(g <= NEAR_TIE_ULPS for g in gaps),
              f"{name}: rejected self-draft proposals "
              f"{max(gaps, default=0.0):.1f} bf16 "
              f"ulps below the top (margin {NEAR_TIE_ULPS})")
        tie_note = (f"; {len(gaps)} rejected proposals, each within "
                    f"{max(gaps, default=0.0):.1f} <= {NEAR_TIE_ULPS} bf16 "
                    f"ulps of the top of a dense forward")
    forwards = st["prefill_groups"] + steps + n_pre + n_dec
    rms = count_rmsnorm(f"spec {cfg.name} {name}", norms,
                        norms_per_forward(cfg) * forwards,
                        f"{norms_per_forward(cfg)} x {forwards} forwards")
    splits = spec_splits(eng.model, eng.params, prompts, outs["off"],
                         outs["on"])
    off = stats["off"]
    print(f"[spec] {cfg.name} full width, {name}: {len(prompts)}/"
          f"{len(prompts)} finished x {max_new} tokens both ways; spec-on "
          f"== spec-off except {splits} split(s) at near ties; "
          f"accept_rate {st['accept_rate']:.4f} ({st['spec_accepted_tokens']}"
          f" of {st['spec_proposed_tokens']} in {st['spec_rounds']} rounds),"
          f" depth histogram {st['spec_depth_hist']}; {st['verify_steps']} "
          f"verify steps vs {off['decode_steps']} spec-off decode steps; "
          f"per verify step {n_attn} paged, {norms_per_forward(cfg)} "
          f"RMSNorm, 0 SSD launches: paged launches {paged} = {n_attn} x "
          f"{steps}, dense decode {dense} = {n_attn} x {n_dec} draft decode "
          f"steps ({n_pre} draft prefills), SSD {ssd} = {n_ssm} x "
          f"({st['prefill_groups']} + {n_pre}){tie_note}; {rms}; decode "
          f"tok/s spec-on {st['decode_tok_s']:.1f} vs spec-off "
          f"{off['decode_tok_s']:.1f}; wall {walls['on']:.2f}s vs "
          f"{walls['off']:.2f}s; {card_line()}")
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
    return {"dense": dense, "paged": paged, "ssd": ssd, "st": st,
            "off": off, "outs": outs}


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
            scale=scale, enable_gqa=h != kv)

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


def time_rmsnorm(rows, d, xd="bf16"):
    """The RMSNorm kernel at ``rows`` x ``d`` against its plain version,
    then its time beside its bound, the plain version's and
    ``F.rms_norm``'s, each by CUDA-graph replay over four inputs cycled
    (so a 16 MB operand is not L2-hot)."""
    import torch.nn.functional as F
    from repro_torch.kernels import rmsnorm as rn
    ins = [rms_case(rows, d, xd, "bf16", seed=200 + j) for j in range(4)]
    err, ok = rms_vs_plain(*ins[0])
    check(ok, f"RMSNorm kernel differs from plain at {rows} x {d}: {err}")
    ms = graph_ms(lambda i: rn._rmsnorm_cuda(*ins[i % 4]))
    plain_ms = graph_ms(lambda i: rn.rmsnorm_plain(*ins[i % 4]))
    lib_ms = graph_ms(lambda i: F.rms_norm(ins[i % 4][0], (d,),
                                           ins[i % 4][1], 1e-5))
    bound_ms, bound_by = rms_bound(rows, d, 2, 2)
    print(f"[timing] rmsnorm {rows} x {d} {xd} (w bf16, "
          f"{rn.rows_per_block(rows, d, _dtype(xd))} rows a block): "
          f"{ms * 1e3:.2f} us (bound {bound_ms * 1e3:.3f} us by "
          f"{bound_by}, {bound_ms / ms * 100:.2f}% of it), plain "
          f"{plain_ms * 1e3:.2f} us, F.rms_norm {lib_ms * 1e3:.2f} us; "
          f"== plain, max |err| {err:.3g}; {card_line()}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


def phase_new_kernel_timing(cfg):
    """The RMSNorm kernel at the training step's and a decode step's shape
    (and at phase 24's training rows of 4096 and 2048), and the dense
    decode kernel at the draft model's shape, each beside
    its bound, the plain version and one library call, all as device time
    per call of a CUDA-graph replay (``graph_ms``); the dense decode
    kernel again at B = 8, S = 4,096."""
    rows_out = {}
    for name, rows, d in (
            ("train", 8192, cfg.d_model),
            ("decode", 8, cfg.d_model),
            ("draft", 1, cfg.d_model),
            # phase 24's training rows: llama2-7b's and qwen3-moe's widths
            ("train 4096", 8192, 4096),
            ("train 2048", 8192, 2048)):
        rows_out[name] = time_rmsnorm(rows, d)
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


# --------------------------------------------------------------------------
# phase 23: MoE and the hybrid period at full width
# --------------------------------------------------------------------------

# jamba-v0.1-52b is cut to one period of its 32 layers (attention at
# offset 4, an MoE FFN at the odd offsets, SSD mixers elsewhere): its
# 104 GB of bf16 weights do not fit one 80 GB card, one period's 27 do
JAMBA_LAYERS = 8
# qwen3-moe-30b-a3b serves cut to 2 of its 48 layers (widths untouched):
# at 48 layers (30.5 B parameters) phase 23 took ~230 s, and the script
# must leave room for phases 29 and 30 within its time limit (8 layers
# for phase 29's room, 2 for phase 30's)
MOE_SERVE_LAYERS = 2


def routed_experts(eng, inputs):
    """The distinct experts each MoE layer of this decode step routes the
    live rows to, in layer order: the step rerun eagerly on copies of both
    pools with the router's choices recorded (the graph replays the same
    inputs, so it routes the same)."""
    import torch
    from repro_torch.models import blocks as B
    seen, route = [], B._route

    def recorded(h, w, cfg):
        out = route(h, w, cfg)
        seen.append(out[1])
        return out

    pools = ({k: v.clone() for k, v in eng.kv.state.items()},
             {pos: {leaf: a.clone() for leaf, a in st.items()}
              for pos, st in eng._ssm_states.items()})
    dev_in = {k: eng._dev(a) for k, a in inputs.items()}
    B._route = recorded
    try:
        with torch.no_grad():
            eng._fused_step_impl(eng.params, *pools, **dev_in)
    finally:
        B._route = route
    live = dev_in["active"]
    return [int(torch.unique(e[live]).numel()) for e in seen]


def same_run(name, got, want) -> None:
    """Two runs of one trace through replayed steps: tokens and
    ``stats()`` counters bitwise equal."""
    a = {r.rid: r.output for r in got["done"]}
    b = {r.rid: r.output for r in want["done"]}
    check(a == b, f"{name}: tokens differ at rids "
          f"{[k for k in b if a.get(k) != b[k]]}")
    x, y = counters(got["st"]), counters(want["st"])
    check(x == y, f"{name}: stats() counters differ: "
          f"{ {k: (x[k], y.get(k)) for k in x if x[k] != y.get(k)} }")


def phase_full_width(cfg, what: str, eager_twin: bool = False):
    """``cfg`` at full width (seeded weights, drawn a layer slice at a
    time) through the captured steps: phase 4's two runs (whole-prompt
    bf16 KV, then chunked (64) int8 KV) with phase 4's checks, each run's
    peak device memory, and a full decode step's device time by graph
    replay against its byte bound. With ``eager_twin`` the chunked run is
    served again eagerly and held bitwise to the replayed one (phase 20's
    checks). On an MoE arch also the bound with only the experts that
    step routed to, and each run served again with a ``MoeProbe`` (the
    eager twin is that run), its tokens and counters bitwise the timed
    run's, its tokens held to a forward with its routing forced, its
    dropped assignments printed: the timed runs carry no probe."""
    import torch
    from repro_torch.models.lm import LM
    from repro_torch.models.params import tree_paths
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = LM(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_paths(params))
    print(f"[full] {what}: {n / 1e9:.2f} B parameters ({n * 2 / 2**30:.1f} "
          f"GiB bf16) drawn a layer slice at a time in "
          f"{time.monotonic() - t0:.1f}s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out = []
    for chunk, quant in ((None, "none"), (64, "int8")):
        torch.cuda.reset_peak_memory_stats()
        rec, eng = phase_engine(cfg, params, prefill_chunk=chunk,
                                kv_quant=quant)
        peak = torch.cuda.max_memory_allocated()
        twin = eager_twin and chunk
        if twin:                       # before the replays below rewrite KV
            rec["pools"] = pool_bytes(eng, null_block=False)
        (_, inputs), = rec["full"].items()
        busy = replay_busy_ms(eng, rec["full"])
        every = decode_bound_ms(eng, inputs)
        rows = int(inputs["active"].sum())
        mode = f"chunk={chunk} int8" if chunk else "whole-prompt bf16"
        check(rec["traces"] == rec["warm_traces"],
              f"{cfg.name} captured while serving: "
              f"{set(rec['traces']) - set(rec['warm_traces'])}")
        moe = ""
        if cfg.is_moe:
            experts = routed_experts(eng, inputs)
            routed = decode_bound_ms(eng, inputs, experts=experts)
            moe = (f" and with the {sum(experts) / len(experts):.1f} of "
                   f"{cfg.n_experts} experts a layer that step routed to "
                   f"{routed:.3f} ms ({routed / busy * 100:.1f}%)")
        print(f"[full] {what} {mode}: {rec['graphs']} graphs, 0 captured "
              f"while serving; {wall_line(rec)}; peak device memory "
              f"{peak / 2**30:.2f} GiB (max_memory_allocated); a full decode "
              f"step ({rows} rows, {int(inputs['lengths'].sum())} live "
              f"positions) by graph replay {busy:.3f} ms against its byte "
              f"bound {'with every expert ' if cfg.is_moe else ''}"
              f"{every:.3f} ms ({every / busy * 100:.1f}% of it){moe}; "
              f"{card_line()}")
        if twin or cfg.is_moe:
            pools = f"KV {mib(rec['pools'][0])} MiB" if twin else ""
            del eng
            free_card()
            again, eng = phase_engine(cfg, params, prefill_chunk=chunk,
                                      kv_quant=quant, cuda_graphs=not twin,
                                      probe=cfg.is_moe)
            if twin:
                compare_replay(f"{cfg.name} {mode}", rec, again, eng, pools)
                del rec["pools"]
            else:
                same_run(f"{cfg.name} {mode} probed", again, rec)
                print(f"[full] {what} {mode}: the probed run's tokens and "
                      f"{len(counters(rec['st']))} stats() counters == the "
                      f"timed run's, bitwise")
            del again
        del eng
        free_card()
        out.append(rec)
    del params
    free_card()
    return out


def phase_moe_hybrid():
    """Phase 23: qwen3-moe-30b-a3b at full width (128 experts top-8, q/k
    norms) cut to ``MOE_SERVE_LAYERS`` of its 48 layers and
    jamba-v0.1-52b at full width over one period (8 of its 32 layers) through the engine's captured steps, then the paged
    read and the SSD scan at the shapes these models give them, each
    against its plain version. Returns the runs' paged and SSD launches."""
    import dataclasses
    from repro_torch.configs import get_config
    qwen3 = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                                n_layers=MOE_SERVE_LAYERS)
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                n_layers=JAMBA_LAYERS)
    runs = phase_full_width(qwen3, f"{qwen3.name} full width, "
                            f"{MOE_SERVE_LAYERS} of 48 layers",
                            eager_twin=True)
    runs += phase_full_width(jamba, f"{jamba.name} full width, "
                             f"{JAMBA_LAYERS} of 32 layers (one period)")
    mb = 128
    for name, kw in (("decode B=8 T=1 bf16",
                      dict(b=8, t=1, lengths=[96, 288, 1032, 96, 288, 1032,
                                              96, 288], quant=False,
                           mb=mb)),
                     ("chunk B=1 T=64 ctx=936 int8",
                      dict(b=1, t=64, lengths=[936], quant=True, mb=64))):
        r = time_shape(qwen3, n_blocks=1025, n_layers=qwen3.n_layers, **kw)
        print(f"[timing] paged_attention {qwen3.name} {name} H=32 K=4 "
              f"(G=8) D=128, {r['n_split']} column splits: "
              f"{r['ms'] * 1e3:.2f} us by graph replay (bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, "
              f"{r['bound_ms'] / r['ms'] * 100:.1f}% of it), == plain "
              f"within rtol=atol=2e-5 (max |err| {r['max_abs_err']:.3g}), "
              f"plain {r['plain_ms'] * 1e3:.1f} us, sdpa "
              f"{r['library_ms'] * 1e3:.2f} us by graph replay; "
              f"{card_line()}")
        free_card()
    time_ssd(f"{jamba.name} whole-prompt", 4, 1024, init=False, seed=13,
             h=128, n=16)
    time_ssd(f"{jamba.name} chunk step", 1, 64, init=True, seed=14, h=128,
             n=16)
    return {"paged": sum(r["launches"] for r in runs),
            "ssd": sum(r["ssd"] for r in runs)}


# --------------------------------------------------------------------------
# phase 24: the training slice
# --------------------------------------------------------------------------

# every part trains at 4 x 2048 tokens
SLICE_SHAPE = dict(b=4, t=2048)
# the learning runs: on one fixed batch, with warmup 0 and no weight decay,
# the loss must fall by LEARN_DROP (tests/test_system.py:72's margin)
# within LEARN_STEPS steps; each run stops at the first step that gets
# there. Learning rates, stated before the first run on the card:
LEARN_STEPS = 8
LEARN_DROP = 0.2
LEARN_LR = {"llama2-7b": 1e-3, "Q8+F+R": 1e-3, "Q+F+R": 1e-3,
            "mamba2-130m": 5e-3, "qwen3-moe-30b-a3b": 5e-3}
# qwen3-moe-30b-a3b is cut to 2 of its 48 layers (widths untouched): 1.87 B
# parameters, ~23 GB with bf16 grads and f32 moments
MOE_TRAIN_LAYERS = 2
# the flash-vs-naive and int8-kernel-vs-reference holds at llama2-7b's
# width use phase 7's and phase 13's limits (LOSS_ATOL, GRAD_NORM_RTOL,
# GRAD_COS; FT_LOSS_ATOL)
CKPT_DIR = ROOT / "build" / "phase24_ckpt"


def peak_gib() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def slice_counts(reset: bool = False) -> dict:
    """The launch counters of the kernels a training step runs (flash
    forward and backward, the int8 matmul, RMSNorm); ``reset`` sets them
    to 0 first."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.kernels import rmsnorm as rn
    if reset:
        for c in (fa.LAUNCHES, fa.OFFSETS, qmm.LAUNCHES, qmm.BODIES,
                  rn.LAUNCHES):
            c.clear()
    return {"fwd": fa.LAUNCHES["fwd"], "bwd_dkv": fa.LAUNCHES["bwd_dkv"],
            "bwd_dq": fa.LAUNCHES["bwd_dq"],
            "int8_matmul": qmm.LAUNCHES["int8_matmul"],
            "rmsnorm": rn.LAUNCHES["rmsnorm"]}


def add_counts(total: dict, run: dict) -> None:
    for k, v in run.items():
        total[k] = total.get(k, 0) + v


def fenced_steps(step_fn, state, batch):
    """The learning run: ``step_fn`` on one fixed ``batch``, each step
    fenced by a device sync, stopping at the first step whose loss is
    LEARN_DROP below step 1's (at most LEARN_STEPS). Returns (losses, ms
    per step, the first step's metrics)."""
    import torch
    losses, ms, first = [], [], {}
    for i in range(LEARN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        first = first or {k: float(v) for k, v in met.items()}
        check(math.isfinite(losses[-1]) and math.isfinite(
            float(met["grad_norm"])), f"step {i + 1}: loss {losses[-1]}, "
            f"grad_norm {float(met['grad_norm'])}")
        if losses[-1] <= losses[0] - LEARN_DROP:
            break
    return losses, ms, first


def learn_line(losses, ms) -> str:
    tokens = SLICE_SHAPE["b"] * SLICE_SHAPE["t"]
    steady = ms[1:] or ms
    mean = sum(steady) / len(steady)
    return (f"losses " + ", ".join(f"{x:.4f}" for x in losses)
            + f" (fell {losses[0] - min(losses):.4f} in {len(losses)} "
            f"steps); {mean:.1f} ms/step over steps 2-{len(ms)} "
            f"({tokens / mean * 1e3:.0f} tokens/s)")


def check_learns(name, losses) -> None:
    check(len(losses) <= LEARN_STEPS and
          losses[-1] <= losses[0] - LEARN_DROP,
          f"{name}: the loss did not fall by {LEARN_DROP} within "
          f"{LEARN_STEPS} steps on a fixed batch: {losses}")


def slice_trainer(cfg, label, opt_cfg, steps=4, **kw):
    from repro_torch.core.config import ShapeSpec, technique_from_label
    from repro_torch.core.trainer import Trainer, TrainerConfig
    sh = SLICE_SHAPE
    return Trainer(cfg, ShapeSpec("cli", sh["t"], sh["b"], "train"),
                   technique_from_label(label),
                   TrainerConfig(steps=steps, log_every=1, **kw), opt_cfg,
                   device="cuda")


def slice_llama():
    """(a) llama2-7b QL+Q8+F+R at full width: the flash route against
    naive attention and the int8 kernel route against the reference's
    dequantize-first route on one batch (B seeded nonzero, then zeroed
    again), 4 timed steps through ``Trainer.run`` with the launches read
    by kernel and the frozen base held bitwise, then the learning run."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.launch.build import make_model
    from repro_torch.models.params import tree_paths
    from repro_torch.peft.lora import split_trainable
    from repro_torch.train.optimizer import AdamWConfig
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              n_layers=LLAMA7_LAYERS)
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=LEARN_LR["llama2-7b"], warmup=0, weight_decay=0.0)
    trainer = slice_trainer(cfg, "QL+Q8+F+R", opt)
    model, params = trainer.model, trainer.state["params"]
    check((model.qmm_impl, model.attn_impl, model.remat) ==
          ("kernel", "flash", "full"), "QL+Q8+F+R built another route")
    torch.cuda.synchronize()
    n_total = sum(t.numel() for p, t in tree_paths(params)
                  if not p.endswith("/scale"))
    trainable = tree_paths(split_trainable(params)[0])
    n_train = sum(t.numel() for _, t in trainable)
    base_gb = sum(t.numel() for _, t in tree_paths(params)
                  if t.dtype == torch.int8) / 1e9
    print(f"[slice] (a) llama2-7b ({cfg.n_layers} of 32 layers) QL+Q8+F+R: "
          f"{n_total / 1e9:.3f} B weights, "
          f"int8 base {base_gb:.2f} GB, LoRA rank "
          f"{trainer.technique.lora_rank}: {n_train} trainable; built in "
          f"{time.monotonic() - t0:.1f}s, peak {peak_gib():.2f} GiB")
    batch = trainer._batch_for(0)
    g = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():                # B = 0 at init: A's gradient is 0
        for path, t in trainable:
            if path.endswith("/b"):
                t.copy_(torch.randn(t.shape, generator=g, device="cuda")
                        * 0.02)
    t0 = time.monotonic()
    ref_loss, ref_grads = adapter_loss_and_grads(
        make_model(cfg, trainer.technique, device="cuda", qmm_impl="ref"),
        params, batch)
    k_loss, k_grads = adapter_loss_and_grads(model, params, batch)
    cos = min(float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
        for a, b in zip(k_grads, ref_grads))
    del ref_grads
    check(abs(k_loss - ref_loss) <= FT_LOSS_ATOL and cos >= GRAD_COS,
          f"llama2-7b int8 kernel route vs reference route: loss {k_loss} "
          f"vs {ref_loss} (limit {FT_LOSS_ATOL}), min adapter gradient "
          f"cosine {cos} (limit {GRAD_COS})")
    n_loss, n_grads = adapter_loss_and_grads(
        make_model(cfg, dataclasses.replace(trainer.technique, flash=False),
                   device="cuda"), params, batch)
    norm = lambda gs: math.sqrt(sum(float(torch.sum(  # noqa: E731
        torch.square(x.float()))) for x in gs))
    k_norm, n_norm = norm(k_grads), norm(n_grads)
    fcos = min(float(torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0))
        for a, b in zip(k_grads, n_grads))
    del k_grads, n_grads
    check(abs(k_loss - n_loss) <= LOSS_ATOL
          and abs(k_norm - n_norm) <= GRAD_NORM_RTOL * n_norm
          and fcos >= GRAD_COS,
          f"llama2-7b flash vs naive: loss {k_loss} vs {n_loss} (limit "
          f"{LOSS_ATOL}), adapter grad_norm {k_norm} vs {n_norm} (limit "
          f"{GRAD_NORM_RTOL} relative), min cosine {fcos} (limit "
          f"{GRAD_COS})")
    print(f"[slice] (a) step-0 batch, B seeded nonzero: int8 kernel vs the "
          f"reference's dequantize-first route: loss {k_loss:.6f} vs "
          f"{ref_loss:.6f} (|diff| {abs(k_loss - ref_loss):.3g} <= "
          f"{FT_LOSS_ATOL}), min adapter gradient cosine {cos:.6f} >= "
          f"{GRAD_COS}; flash vs naive (int8 kernel both): loss "
          f"{n_loss:.6f} (|diff| {abs(k_loss - n_loss):.3g} <= {LOSS_ATOL}), "
          f"adapter grad_norm {k_norm:.6f} vs {n_norm:.6f} (rel "
          f"{abs(k_norm - n_norm) / n_norm:.3g} <= {GRAD_NORM_RTOL}), min "
          f"cosine {fcos:.6f} >= {GRAD_COS} ({time.monotonic() - t0:.1f}s)")
    with torch.no_grad():
        for path, t in trainable:
            if path.endswith("/b"):
                t.zero_()
    free_card()
    frozen = {p: t.clone() for p, t in tree_paths(params)
              if not p.endswith(("/a", "/b"))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    slice_counts(reset=True)
    out = trainer.run()
    torch.cuda.synchronize()
    counts = slice_counts()
    bodies = dict(qmm.BODIES)
    steps = out["final_step"]
    check(steps == 4, f"trainer ran {steps} of 4 steps")
    # 7 base projections a layer, twice (R); the untied int8 head once in
    # each 512-token loss block, twice (its checkpoint recomputes it)
    blocks = -(-SLICE_SHAPE["t"] // 512)
    per_step = {"fwd": 2 * cfg.n_layers, "bwd_dkv": cfg.n_layers,
                "bwd_dq": cfg.n_layers,
                "int8_matmul": cfg.n_layers * 7 * 2 + (
                    0 if cfg.tie_embeddings else 2 * blocks),
                "rmsnorm": norms_per_train_step(cfg, SLICE_SHAPE["t"],
                                                remat=True)}
    check(counts == {k: v * steps for k, v in per_step.items()},
          f"llama2-7b launches {counts} != {per_step} x {steps}")
    check(sum(bodies.values()) == counts["int8_matmul"]
          and "simt" not in bodies, f"int8 bodies {bodies}")
    now = dict(tree_paths(params))
    moved = [p for p, t in frozen.items() if not torch.equal(now[p], t)]
    check(not moved, f"llama2-7b frozen leaves changed: {moved[:5]}")
    del frozen, now
    hist = out["history"]
    print(f"[slice] (a) llama2-7b full width, {cfg.n_layers} of 32 layers, "
          f"QL+Q8+F+R, batch "
          f"{SLICE_SHAPE['b']} x {SLICE_SHAPE['t']}: {steps} steps through "
          f"Trainer.run, losses " + ", ".join(f"{h['loss']:.4f}" for h in hist)
          + f"; steps 2-{steps}: {out['step_ms']:.1f} ms/step, "
          f"{out['tokens_per_s']:.0f} tokens/s; launches per step "
          + ", ".join(f"{k} {v // steps}" for k, v in counts.items())
          + f" (int8 by body {bodies}); frozen base bit-unchanged; peak "
          f"{peak_gib():.2f} GiB; {card_line()}")
    slice_counts(reset=True)
    losses, ms, _ = fenced_steps(trainer.step_fn, trainer.state, batch)
    learn = slice_counts()
    check_learns("llama2-7b QL+Q8+F+R", losses)
    print(f"[slice] (a) llama2-7b adapters learn (one fixed batch, lr "
          f"{opt.lr}, warmup 0, no weight decay): {learn_line(losses, ms)}; "
          f"peak {peak_gib():.2f} GiB")
    add_counts(counts, learn)
    del trainer, params, model
    free_card()
    return counts


def slice_quant(cfg):
    """(b) qwen1.5-0.5b Q8 then Q (nf4), each with F+R (naive attention
    without recomputation would hold ~51 GB of f32 scores and
    probabilities at 4 x 2048): 2 timed steps through
    ``Trainer.run`` whose new codes are those of ``quantize_int8`` /
    ``quantize_nf4`` of the updated view, bitwise, the 8-bit moments'
    bytes against f32 moments', then the learning run from a fresh state
    (the 8-bit second moment decodes to 0 where its block's absmax rounds
    it away, and AdamW's step there grows without bound: the reference's
    runs blow up within a few steps, so the learning run starts with
    fresh moments)."""
    import torch
    from repro_torch.models.params import tree_paths
    from repro_torch.quant.qtensor import QTensor, quantize_int8, quantize_nf4
    from repro_torch.train import step as tstep
    from repro_torch.train.optimizer import AdamWConfig, Opt8
    counts = {}
    is_q = lambda x: isinstance(x, QTensor)              # noqa: E731
    for label in ("Q8+F+R", "Q+F+R"):
        torch.cuda.reset_peak_memory_stats()
        opt = AdamWConfig(lr=LEARN_LR[label], warmup=0, weight_decay=0.0,
                          state_bits=8)
        trainer = slice_trainer(cfg, label, opt, steps=2)
        mismatched, calls = [], []
        orig = tstep.requant_like

        def checked(view, like):
            orig(view, like)
            calls.append(1)
            new = dict(tree_paths(view))
            for path, q in tree_paths(like, is_leaf=is_q):
                if not is_q(q):
                    continue
                want = (quantize_int8(new[path]) if q.kind == "int8" else
                        quantize_nf4(new[path], stacked=q.data.ndim == 2))
                for (_, a), (_, b) in zip(tree_paths(q), tree_paths(want)):
                    if not torch.equal(a, b):
                        mismatched.append(path)

        tstep.requant_like = checked
        try:
            slice_counts(reset=True)
            out = trainer.run()
        finally:
            tstep.requant_like = orig
        torch.cuda.synchronize()
        add_counts(counts, slice_counts())
        check(len(calls) == out["final_step"] and not mismatched,
              f"{label}: {len(calls)} requantizations checked over "
              f"{out['final_step']} steps; codes differing from quantizing "
              f"the updated view: {mismatched[:5]}")
        o8 = [v for name in ("m", "v") for _, v in tree_paths(
            trainer.state["opt"][name], is_leaf=lambda x: isinstance(x, Opt8))]
        check(o8 and all(isinstance(v, Opt8) for v in o8),
              f"{label}: moments are not 8-bit")
        b8 = sum(v.q.numel() + 4 * v.scale.numel() for v in o8)
        b32 = sum(4 * math.prod(v.shape) for v in o8)
        check(abs(b8 / b32 - (1 / 4 + 1 / 256)) < 0.01,
              f"{label}: moment bytes {b8} over f32's {b32}")
        kinds = {q.kind for _, q in tree_paths(trainer.state["params"],
                                                is_leaf=is_q) if is_q(q)}
        print(f"[slice] (b) qwen1.5-0.5b {label} ({'/'.join(sorted(kinds))} "
              f"base, 8-bit moments), batch {SLICE_SHAPE['b']} x "
              f"{SLICE_SHAPE['t']}: {out['final_step']} steps through "
              f"Trainer.run, losses "
              + ", ".join(f"{h['loss']:.4f}" for h in out["history"])
              + f", step 2 {out['step_ms']:.1f} ms, {out['tokens_per_s']:.0f} "
              f"tokens/s; the codes after each step == quantizing the "
              f"updated view, bitwise; moments {b8 / 2**20:.1f} MiB against "
              f"{b32 / 2**20:.1f} MiB in f32 ({b8 / b32:.5f}; 1/4 + 1/256 = "
              f"{1 / 4 + 1 / 256:.5f}); peak {peak_gib():.2f} GiB")
        del trainer
        free_card()
        trainer = slice_trainer(cfg, label, opt)
        slice_counts(reset=True)
        batch = trainer._batch_for(0)
        losses, ms, _ = fenced_steps(trainer.step_fn, trainer.state, batch)
        add_counts(counts, slice_counts())
        check_learns(f"qwen1.5-0.5b {label}", losses)
        print(f"[slice] (b) {label} learns (one fixed batch, lr {opt.lr}): "
              f"{learn_line(losses, ms)}; peak {peak_gib():.2f} GiB; "
              f"{card_line()}")
        del trainer
        free_card()
    return counts


def slice_learn(cfg, label, name, extra=None):
    """(c), (d): ``label`` on ``cfg`` on one fixed batch, the learning run
    (the first step's metrics read by ``extra``)."""
    import torch
    from repro_torch.train.optimizer import AdamWConfig
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=LEARN_LR[cfg.name], warmup=0, weight_decay=0.0)
    trainer = slice_trainer(cfg, label, opt)
    batch = trainer._batch_for(0)
    slice_counts(reset=True)
    losses, ms, first = fenced_steps(trainer.step_fn, trainer.state, batch)
    counts = slice_counts()
    check_learns(name, losses)
    print(f"[slice] {name}, {label}, batch {SLICE_SHAPE['b']} x "
          f"{SLICE_SHAPE['t']} (one fixed batch, lr {opt.lr}, warmup 0, no "
          f"weight decay): {learn_line(losses, ms)}; step 1 ce "
          f"{first['ce']:.4f} aux {first['aux']:.4f}; peak "
          f"{peak_gib():.2f} GiB; {card_line()}")
    if extra:
        extra(trainer, batch, first)
    del trainer
    free_card()
    return counts


def moe_train_drops(trainer, batch, first):
    """(d): aux finite and positive, and the assignments the capacity step
    drops in one forward of the fixed batch (experts recorded from
    ``blocks._route``, the capacity step in numpy)."""
    import numpy as np
    import torch
    from repro_torch.models import blocks as B
    check(math.isfinite(first["aux"]) and first["aux"] > 0,
          f"qwen3-moe aux {first['aux']}")
    cfg = trainer.cfg
    seen = []
    orig = B._route

    def recorded(h, w, c):
        out = orig(h, w, c)
        seen.append(out[1].cpu().numpy())
        return out

    B._route = recorded
    try:
        with torch.no_grad():
            trainer.model.loss(trainer.state["params"], batch)
    finally:
        B._route = orig
    n = SLICE_SHAPE["b"] * SLICE_SHAPE["t"]
    cap = B.capacity(n, cfg, 1.0)
    dropped = [int((~capacity_keep(e.reshape(n, -1), cap,
                                   cfg.n_experts)).sum()) for e in seen]
    used = [len(np.unique(e)) for e in seen]
    print(f"[slice] (d) qwen3-moe-30b-a3b ({MOE_TRAIN_LAYERS} of 48 layers) "
          f"step-1 aux {first['aux']:.4f} (finite, > 0); capacity {cap} rows "
          f"an expert (factor {cfg.capacity_factor}, multiplier 1.0) for "
          f"{n * cfg.top_k} assignments a layer: dropped "
          + ", ".join(f"{d} ({d / (n * cfg.top_k) * 100:.2f}%)"
                      for d in dropped)
          + f" by layer; experts used {used} of {cfg.n_experts}")


def slice_resume(cfg):
    """(e) qwen1.5-0.5b F+R+Z3: 4 steps straight; 2 steps and a blocking
    save, then a new Trainer resuming to step 4 with async saves every
    step; params, moments and step counters bitwise the straight run's.
    Prints the blocking save time and bytes and the step that overlaps
    an async save."""
    import shutil
    import torch
    from repro_torch.models.params import tree_paths
    from repro_torch.train.optimizer import AdamWConfig
    opt = AdamWConfig(lr=1e-3, warmup=1)
    counts = {}
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    straight = slice_trainer(cfg, "F+R+Z3", opt)
    slice_counts(reset=True)
    straight.run()
    add_counts(counts, slice_counts())
    want = [(p, t.detach().clone()) for p, t in tree_paths(straight.state)]
    del straight
    free_card()
    first = slice_trainer(cfg, "F+R+Z3", opt, steps=2,
                          checkpoint_dir=str(CKPT_DIR), checkpoint_every=100)
    slice_counts(reset=True)
    first.run()
    add_counts(counts, slice_counts())
    t0 = time.perf_counter()
    first.ckpt.save(2, first.state, blocking=True)
    save_s = time.perf_counter() - t0
    on_disk = sum(f.stat().st_size for f in (CKPT_DIR / "step_000000002")
                  .iterdir())
    del first
    free_card()
    t0 = time.perf_counter()
    resumed = slice_trainer(cfg, "F+R+Z3", opt, checkpoint_dir=str(CKPT_DIR),
                            checkpoint_every=1, resume="auto")
    restore_s = time.perf_counter() - t0
    check(resumed.start_step == 2, f"resumed at {resumed.start_step}")
    slice_counts(reset=True)
    out = resumed.run()
    add_counts(counts, slice_counts())
    steps_ms = [x * 1e3 for x in resumed.timer.records["step"]]
    got = tree_paths(resumed.state)
    check([p for p, _ in got] == [p for p, _ in want],
          "resumed state has other leaves")
    diff = [p for (p, a), (_, b) in zip(got, want)
            if a.dtype != b.dtype or not torch.equal(a.detach(), b)]
    check(not diff, f"resumed run differs from the straight run at "
          f"{len(diff)} leaves: {diff[:6]}")
    check(resumed.ckpt.all_steps() == [2, 3, 4],
          f"checkpoints {resumed.ckpt.all_steps()}")
    print(f"[slice] (e) qwen1.5-0.5b F+R+Z3 checkpoint and resume: 2 steps, "
          f"a blocking save of {on_disk / 1e9:.3f} GB written ({len(want)} "
          f"leaves) in {save_s:.2f} s ({on_disk / save_s / 1e9:.2f} GB/s), "
          f"a new Trainer restored step "
          f"2 in {restore_s:.2f} s (its init included) and ran to step "
          f"{out['final_step']} saving every step asynchronously: step 3 "
          f"{steps_ms[0]:.1f} ms, step 4 (overlapping step 3's async save) "
          f"{steps_ms[1]:.1f} ms; params, moments and step counters bitwise "
          f"those of 4 straight steps; peak {peak_gib():.2f} GiB; "
          f"{card_line()}")
    del resumed, want, got
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free_card()
    return counts


def phase_training_slice() -> dict:
    """Phase 24: (a)-(e). Returns the kernels' launches over its main-path
    runs."""
    import dataclasses
    from repro_torch.configs import get_config
    t0 = time.monotonic()
    total = {}
    add_counts(total, slice_llama())
    qwen = get_config("qwen1.5-0.5b")
    add_counts(total, slice_quant(qwen))
    add_counts(total, slice_learn(get_config("mamba2-130m"), "F+R",
                                  "(c) mamba2-130m full width"))
    moe = dataclasses.replace(get_config("qwen3-moe-30b-a3b"),
                              n_layers=MOE_TRAIN_LAYERS)
    add_counts(total, slice_learn(
        moe, "F+R", f"(d) qwen3-moe-30b-a3b full width, {MOE_TRAIN_LAYERS} of "
        f"48 layers", extra=moe_train_drops))
    add_counts(total, slice_resume(qwen))
    RMSNORM_RUNS["training slice (phase 24)"] = total["rmsnorm"]
    print(f"[slice] phase 24 launches over its main-path runs: "
          + ", ".join(f"{k} {v}" for k, v in total.items())
          + f"; phase 24 took {time.monotonic() - t0:.1f}s")
    return total


# --------------------------------------------------------------------------
# phase 25: the encoder-decoder and vision-language families
# --------------------------------------------------------------------------

# 8 requests a family and 64 greedy decode steps each: seamless with 1,024
# seeded frames and a 64-token prompt, internvl2 with 256 seeded patches
# and a 256-token prompt, in caches of max_len positions (prompt, patches
# included, and the new tokens: never the reference's clipping default)
FAMILY_ROWS = 8
FAMILY_NEW = 64
FAMILY_PROMPT = {"seamless-m4t-large-v2": 64, "internvl2-26b": 256}
FAMILY_MAX_LEN = {"seamless-m4t-large-v2": 128, "internvl2-26b": 576}
# F+R training on one fixed batch of B = 4 and 1,024 positions: seamless
# 1,024 frames for the encoder and 1,024 tokens, internvl2 256 patches and
# 768 tokens; internvl2 cut to 2 of its 48 layers, widths untouched (48
# layers of bf16 weights and gradients and f32 moments need ~318 GB).
# Stated before the first run on the card: the loss falls within 3 steps
# at lr 1e-3, warmup 0, no weight decay
FAMILY_TRAIN = dict(b=4, t=1024)
FAMILY_TRAIN_STEPS = 3
FAMILY_LR = 1e-3
# flash against naive attention on the same params and batch: the naive
# read rounds its probabilities to bf16, the flash kernels do not
# (tests/test_torch_train.py's loss limit; 2.3e-3 and 2.7e-3 at smoke
# size on the CPU)
FAMILY_LOSS_ATOL = 2e-3
INTERNVL_TRAIN_LAYERS = 2
# the seamless encoder's self-attention: 8 requests, 16 heads of 64 over
# 1,024 frames, non-causal
ENC_FLASH = dict(b=8, h=16, kv=16, t=1024, d=64)


def family_norms(cfg, *, decode: bool) -> int:
    """RMSNorm launches of one model-level forward of an encdec or vlm
    config: two a decoder layer (three with cross-attention) and the final
    norm; an encdec prefill or forward also runs the encoder (two a layer
    and ``enc_final_ln``)."""
    dec = cfg.n_layers * (3 if cfg.n_enc_layers else 2) + 1
    if decode or not cfg.n_enc_layers:
        return dec
    return dec + 2 * cfg.n_enc_layers + 1


def loss_blocks(t: int) -> int:
    """The checkpointed loss blocks of ``LM.loss`` over ``t`` labels."""
    tc = min(512, t)
    while t % tc:
        tc //= 2
    return t // tc


def draw_params(cfg, what):
    """``cfg``'s seeded weights on the card, a layer slice at a time."""
    import torch
    from repro_torch.models.lm import LM
    from repro_torch.models.params import tree_paths
    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats()
    params = LM(cfg, device="cuda").init(0)
    torch.cuda.synchronize()
    n = sum(t.numel() for _, t in tree_paths(params))
    print(f"[family] {what}: {n / 1e9:.2f} B parameters ({n * 2 / 2**30:.1f} "
          f"GiB bf16) drawn in {time.monotonic() - t0:.1f}s, peak "
          f"{peak_gib():.2f} GiB")
    return params


def family_serve(cfg, params, what):
    """The family's serving main path through ``LM``'s entry points (the
    engine serves neither frontend): ``prefill`` of 8 requests with their
    seeded frontend embeddings, then 64 greedy ``decode_step``s, with the
    launches of the run (flash forward once a layer of the prefill, the
    encoder's included; the dense decode read once a decoder layer a step;
    RMSNorm once a norm a forward) and a teacher-forced ``forward`` over
    the prompt and the generated tokens holding each token to its argmax
    or a bf16 near tie (``SPEC_NEAR_TIE_ULPS``) of it."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.build import random_batch
    from repro_torch.models.lm import LM
    from repro_torch.serving import graphs
    model = LM(cfg, attn_impl="flash", device="cuda")
    t_prompt, max_len = FAMILY_PROMPT[cfg.name], FAMILY_MAX_LEN[cfg.name]
    n_front = cfg.frontend_len if cfg.family == "vlm" else 0
    batch = random_batch(cfg, FAMILY_ROWS, n_front + t_prompt, seed=25,
                         with_labels=False, device="cuda")
    toks, fe = batch["tokens"], batch["frontend_embeds"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in graphs.KERNEL_COUNTERS:       # count the main path's run only
        c.clear()
    t0 = time.perf_counter()
    logits, cache, n = model.prefill(params, toks, max_len=max_len,
                                     frontend_embeds=fe)
    out = [logits.argmax(-1)]
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(FAMILY_NEW):
        logits, cache = model.decode_step(params, cache,
                                          out[-1][:, None].int(), n)
        n = n + 1
        out.append(logits.argmax(-1))
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    peak = peak_gib()
    launches = {"fwd": fa.LAUNCHES["fwd"],
                "bwd_dkv": fa.LAUNCHES["bwd_dkv"],
                "dense_decode": fd.LAUNCHES["dense_decode"],
                "paged_attention": fd.LAUNCHES["paged_attention"],
                "rmsnorm": rn.LAUNCHES["rmsnorm"]}
    check(launches["fwd"] == cfg.n_layers + cfg.n_enc_layers and
          launches["bwd_dkv"] == 0 and launches["paged_attention"] == 0,
          f"{what}: flash forward launches {launches['fwd']} != "
          f"{cfg.n_layers} + {cfg.n_enc_layers} layers ({launches})")
    check(launches["dense_decode"] == cfg.n_layers * FAMILY_NEW,
          f"{what}: dense decode launches {launches['dense_decode']} != "
          f"{cfg.n_layers} x {FAMILY_NEW} steps")
    want = (family_norms(cfg, decode=False)
            + FAMILY_NEW * family_norms(cfg, decode=True))
    rms = count_rmsnorm(what, launches["rmsnorm"], want,
                        f"{family_norms(cfg, decode=False)} + {FAMILY_NEW} x "
                        f"{family_norms(cfg, decode=True)} forwards")
    check(int(n[0]) == n_front + t_prompt + FAMILY_NEW and
          int(n[0]) <= max_len, f"{what}: lengths {n.tolist()}")
    gen = torch.stack(out, 1)                          # (B, 65)
    seq = torch.cat([toks, gen[:, :FAMILY_NEW].int()], 1)
    with torch.no_grad():
        full = model.forward(params, seq, frontend_embeds=fe)
    p0 = n_front + t_prompt - 1
    rows = full[:, p0:p0 + FAMILY_NEW + 1].float()     # (B, 65, V)
    check(bool(torch.isfinite(rows).all()), f"{what}: non-finite logits")
    top, arg = rows.max(-1)
    mine = rows.gather(-1, gen[..., None].long())[..., 0]
    ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - 7)
    gap = ((top - mine) / ulp)
    share = float((arg == gen).float().mean())
    worst = float(gap.max())
    check(worst <= SPEC_NEAR_TIE_ULPS, f"{what}: a generated token is "
          f"{worst:.1f} bf16 ulps below the teacher-forced argmax")
    del full, rows, cache
    tok_s = FAMILY_ROWS * FAMILY_NEW / dec_s
    print(f"[family] {what}, flash: prefill of {FAMILY_ROWS} requests "
          f"({n_front + t_prompt} positions each"
          + (f", {cfg.frontend_len} frames through the encoder"
             if cfg.n_enc_layers else "")
          + f") {prefill_ms:.1f} ms, {FAMILY_NEW} decode steps "
          f"{dec_s * 1e3:.1f} ms ({tok_s:.1f} tok/s), peak {peak:.2f} GiB; "
          f"launches: flash forward {launches['fwd']} = {cfg.n_layers} + "
          f"{cfg.n_enc_layers}, dense decode {launches['dense_decode']} = "
          f"{cfg.n_layers} x {FAMILY_NEW} (G = {cfg.n_heads // cfg.n_kv_heads},"
          f" D = {cfg.head_dim}), {rms}; teacher-forced argmax match "
          f"{share:.4f}, others within {worst:.2f} <= {SPEC_NEAR_TIE_ULPS} "
          f"bf16 ulps; {card_line()}")
    return {"launches": launches, "prefill_ms": prefill_ms, "tok_s": tok_s,
            "peak": peak}


def family_train(cfg, what):
    """F+R through ``build_train``'s step on one fixed seeded batch
    (``FAMILY_TRAIN``, frontend embeddings included): the flash loss
    against the naive one on the same params and batch (|Δloss| printed,
    held to ``FAMILY_LOSS_ATOL``), then ``FAMILY_TRAIN_STEPS`` steps
    whose losses must be finite and fall, with the flash and RMSNorm
    launches per step (the encoder runs once a step, the decoder twice
    under remat)."""
    import torch
    from repro_torch.core.config import technique_from_label
    from repro_torch.launch.build import build_train, random_batch
    from repro_torch.models.lm import LM
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state
    torch.cuda.reset_peak_memory_stats()
    opt = AdamWConfig(lr=FAMILY_LR, warmup=0, weight_decay=0.0)
    step, tech, model, opt = build_train(cfg, technique_from_label("F+R"),
                                         opt, device="cuda")
    state, _ = init_train_state(model, tech, 0, opt)
    b, t = FAMILY_TRAIN["b"], FAMILY_TRAIN["t"]
    batch = random_batch(cfg, b, t, seed=26, device="cuda")
    with torch.no_grad():
        lf = float(model.loss(state["params"], batch)[0])
        ln = float(LM(cfg, attn_impl="naive", device="cuda").loss(
            state["params"], batch)[0])
    dloss = abs(lf - ln)
    check(math.isfinite(lf) and dloss < FAMILY_LOSS_ATOL,
          f"{what}: flash loss {lf} vs naive {ln}")
    slice_counts(reset=True)
    losses, ms = [], []
    for i in range(FAMILY_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        check(math.isfinite(losses[-1]) and
              math.isfinite(float(met["grad_norm"])),
              f"{what}: step {i + 1} loss {losses[-1]}")
    counts = slice_counts()
    check(losses[-1] < losses[0], f"{what}: the loss did not fall on a "
          f"fixed batch: {losses}")
    n_enc, n_dec = cfg.n_enc_layers, cfg.n_layers
    per = {"fwd": n_enc + 2 * n_dec, "bwd_dkv": n_enc + n_dec,
           "bwd_dq": n_enc + n_dec}
    for k, v in per.items():
        check(counts[k] == v * FAMILY_TRAIN_STEPS, f"{what}: flash {k} "
              f"launches {counts[k]} != {v} x {FAMILY_TRAIN_STEPS} steps")
    t_lab = batch["labels"].shape[1]
    norms = ((2 * n_enc + 1 if n_enc else 0)
             + 2 * (family_norms(cfg, decode=True) - 1)
             + 2 * loss_blocks(t_lab))
    count_rmsnorm(f"{what} training", counts["rmsnorm"],
                  norms * FAMILY_TRAIN_STEPS,
                  f"{norms} x {FAMILY_TRAIN_STEPS} steps")
    tokens = b * t_lab
    mean = sum(ms[1:]) / max(len(ms) - 1, 1)
    print(f"[family] {what} F+R, batch {b} x {t} positions "
          + (f"({cfg.frontend_len} frames + {t_lab} tokens) "
             if n_enc else f"({cfg.frontend_len} patches + {t_lab} tokens) ")
          + f"(one fixed batch, lr {opt.lr}, warmup 0, no weight decay): "
          f"flash vs naive |dloss| {dloss:.3g} (limit {FAMILY_LOSS_ATOL}); "
          f"losses "
          + ", ".join(f"{x:.4f}" for x in losses)
          + f" (fell {losses[0] - min(losses):.4f}); step ms "
          + ", ".join(f"{x:.1f}" for x in ms)
          + f" ({tokens / mean * 1e3:.0f} tokens/s over steps 2-{len(ms)}); "
          f"launches per step: flash fwd {per['fwd']}, dK/dV and dQ "
          f"{per['bwd_dkv']} each, RMSNorm {norms}; peak {peak_gib():.2f} "
          f"GiB; {card_line()}")
    del state, step, model
    free_card()
    return counts


def phase_families() -> dict:
    """Phase 25: seamless-m4t-large-v2 and internvl2-26b at full width
    (seeded weights): served through ``prefill`` and ``decode_step``,
    trained F+R (internvl2 cut to 2 of 48 layers); the seamless encoder's
    non-causal flash kernels, the dense decode read at both families' (G,
    D) and RMSNorm at 6,144 against their plain versions and timed.
    Returns the launches of its main-path runs and the timings."""
    import dataclasses
    from repro_torch.configs import get_config
    t0 = time.monotonic()
    total = {}
    seamless = get_config("seamless-m4t-large-v2")
    params = draw_params(seamless, f"{seamless.name} full width")
    run = family_serve(seamless, params, f"{seamless.name} full width")
    add_counts(total, run["launches"])
    del params
    free_card()
    enc = phase_flash_timing(f"{seamless.name} encoder", ENC_FLASH,
                             causal=False)
    free_card()
    add_counts(total, family_train(seamless, f"{seamless.name} full width"))
    dense_g1 = time_dense_decode(seamless, b=FAMILY_ROWS, s=128, live=128)
    internvl = get_config("internvl2-26b")
    params = draw_params(internvl, f"{internvl.name} full width")
    run = family_serve(internvl, params, f"{internvl.name} full width")
    add_counts(total, run["launches"])
    del params
    free_card()
    cut = dataclasses.replace(internvl, n_layers=INTERNVL_TRAIN_LAYERS)
    add_counts(total, family_train(
        cut, f"{internvl.name} full width, {INTERNVL_TRAIN_LAYERS} of 48 "
        f"layers"))
    dense_g6 = time_dense_decode(internvl, b=FAMILY_ROWS, s=576, live=576)
    rms = {rows: time_rmsnorm(rows, internvl.d_model)
           for rows in (FAMILY_ROWS, FAMILY_ROWS * 512)}
    free_card()
    print(f"[family] phase 25 launches over its main-path runs: "
          + ", ".join(f"{k} {v}" for k, v in total.items())
          + f"; phase 25 took {time.monotonic() - t0:.1f}s")
    return {"launches": total, "enc": enc, "dense_g1": dense_g1,
            "dense_g6": dense_g6, "rms": rms}


# --------------------------------------------------------------------------
# phase 26: decoding the SSM families
# --------------------------------------------------------------------------

# the self-draft's 4 requests; the rollback run scripts one good proposal
# then a garbage tail on them, so every round accepts some but not all
SSM_DRAFT_NEW = 32
SSM_ROLLBACK_SNAPS = 8
# the SSM pool after a round with partial acceptance against spec-off's at
# the same length: the verify step's projections sum B*T rows where decode
# sums B, so the states differ by roundoff carried through bf16 residuals;
# held to the bf16 bound of the CPU tests' caches (3e-2), relative to the
# state's largest magnitude
SSM_STATE_RTOL = 3e-2


@contextlib.contextmanager
def moe_keeps_every_assignment(cfg):
    """Every MoE call of the model and the engine at the capacity that
    drops nothing (``n_experts / capacity_factor`` times the mean load,
    so each expert takes all of a call's assignments): without drops a
    token's output does not depend on its step's other rows, and spec-on
    verify steps (B x T rows) compare with spec-off decode steps (B
    rows). With drops the comparison would test the routing, not
    speculation (the reference's semantics make a dropped token's output
    depend on its step)."""
    from repro_torch.models import lm
    from repro_torch.serving import engine
    keep = cfg.n_experts / cfg.capacity_factor
    old = dict(lm.CAPACITY_MULT), engine.MOE_CAPACITY_MULT
    lm.CAPACITY_MULT.update({k: max(v, keep)
                             for k, v in lm.CAPACITY_MULT.items()})
    engine.MOE_CAPACITY_MULT = max(engine.MOE_CAPACITY_MULT, keep)
    try:
        yield keep
    finally:
        lm.CAPACITY_MULT.update(old[0])
        engine.MOE_CAPACITY_MULT = old[1]


def model_level_decode(cfg, params, prompts, engine_out, max_new):
    """mamba2 through ``LM.prefill`` and ``max_new`` greedy
    ``decode_step``s (the model-level SSM cache, stepped in place) on the
    engine's prompts: its tokens against the engine's spec-off stream, a
    split allowed only at a near tie (``spec_splits``)."""
    import torch
    from repro_torch.models.lm import LM
    from repro_torch.serving import graphs
    model = LM(cfg, ssd_impl="kernel", device="cuda")
    toks = torch.tensor(prompts, dtype=torch.int32, device="cuda")
    for c in graphs.KERNEL_COUNTERS:
        c.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, n = model.prefill(params, toks)
    out = [logits.argmax(-1)]
    for _ in range(max_new):
        logits, cache = model.decode_step(params, cache,
                                          out[-1][:, None].int(), n)
        n = n + 1
        out.append(logits.argmax(-1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
    ssd, norms = ssdk.LAUNCHES["ssd"], rn.LAUNCHES["rmsnorm"]
    check(ssd == cfg.n_layers, f"model-level decode: SSD launches {ssd} != "
          f"{cfg.n_layers} (the prefill only)")
    count_rmsnorm(f"{cfg.name} model-level decode", norms,
                  norms_per_forward(cfg) * (1 + max_new),
                  f"{norms_per_forward(cfg)} x {1 + max_new} forwards")
    gen = torch.stack(out, 1).tolist()
    got = {rid: row[:len(engine_out[rid])] for rid, row in enumerate(gen)}
    splits = spec_splits(model, params, prompts, engine_out, got)
    print(f"[ssm] {cfg.name} model-level prefill of {len(prompts)} x "
          f"{len(prompts[0])} tokens and {max_new} decode_steps "
          f"({len(prompts) * (1 + max_new) / wall:.1f} tok/s, eager): "
          f"tokens == the engine's spec-off stream except {splits} "
          f"split(s) at near ties; SSD launches {ssd} (prefill), 0 in "
          f"decode; {card_line()}")


def ssm_rollback(cfg, params, prompts, want, name):
    """Spec-on with a scripted proposer (one good token from spec-off's
    stream ``want``, then a garbage tail: every round accepts some but
    not all; the stream equal to spec-off's up to a split at a near tie),
    the SSM slot snapshot after each of the first rounds with partial
    acceptance, then spec-off recording the same (request, length)
    snapshots: each pair within ``SSM_STATE_RTOL`` (pairs past a split
    are not compared: their tokens differ)."""
    from repro_torch.models.lm import LM
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.scheduler import RUNNING

    class Scripted:
        def propose(self, req, k):
            ref = want[req.rid]
            i = len(req.output)
            props = ref[i:i + 1]
            return (props + [(ref[0] + 1) % cfg.vocab_size] * k)[:k]

    max_new = len(want[0])

    def serve(spec, keys):
        eng = Engine(cfg, params, max_batch=8, n_blocks=1024, block_size=16,
                     speculate=spec, spec_depth=4, device="cuda")
        eng.warmup(max(map(len, prompts)) + max_new,
                   prompt_lens=sorted({len(p) for p in prompts}))
        partial, snaps = [], {}
        if eng.spec is not None:
            record = eng.spec.record

            def noted(req, *, proposed, accepted):
                if 0 < accepted < proposed:
                    partial.append(req)
                record(req, proposed=proposed, accepted=accepted)

            eng.spec.record = noted
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
        while eng.waiting or any(r is not None for r in eng.running):
            partial.clear()
            eng.step()
            live = [r for r in eng.running if r is not None]
            for r in (partial if keys is None else live):
                key = (r.rid, r.length - 1)
                if r.state != RUNNING or key in snaps or (
                        keys is not None and key not in keys) or (
                        keys is None and len(snaps) >= SSM_ROLLBACK_SNAPS):
                    continue
                snaps[key] = {(pos, leaf): a[:, r.slot].clone()
                              for pos, st in eng._ssm_states.items()
                              for leaf, a in st.items()}
        out = {r.rid: r.output for r in eng.finished}
        st = eng.stats()
        del eng
        free_card()
        return out, snaps, st

    got, on, st = serve(Scripted(), None)
    splits = spec_splits(LM(cfg, ssd_impl="kernel", device="cuda"), params,
                         prompts, want, got)
    # a snapshot after consuming output[:n] is comparable while the
    # streams agree on output[:n]
    agree = {rid: next((i for i, (a, b) in enumerate(zip(want[rid], out))
                        if a != b), len(out)) for rid, out in got.items()}
    on = {key: v for key, v in on.items()
          if key[1] - len(prompts[key[0]]) < agree[key[0]]}
    check(0.0 < st["accept_rate"] < 1.0 and on,
          f"no comparable round with partial acceptance (accept_rate "
          f"{st['accept_rate']})")
    _, off, _ = serve(None, set(on))
    check(set(off) == set(on), f"spec-off never reached {set(on) - set(off)}")
    worst = 0.0
    for key, snap in on.items():
        for leaf, a in snap.items():
            b = off[key][leaf]
            rel = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            worst = max(worst, rel)
    check(worst <= SSM_STATE_RTOL, f"the SSM pool after partial acceptance "
          f"is {worst:.3g} of its scale from spec-off's")
    print(f"[ssm] {cfg.name} {name} rollback: scripted proposer (1 good "
          f"token, then garbage) on {len(prompts)} requests x {max_new} "
          f"tokens, accept_rate "
          f"{st['accept_rate']:.4f}, tokens == spec-off's except {splits} "
          f"split(s) at near ties; after {len(on)} rounds with partial "
          f"acceptance each slot's (conv, state) within {worst:.3g} "
          f"(relative to its largest magnitude; limit {SSM_STATE_RTOL}) of "
          f"spec-off's at the same length; {card_line()}")


# phase 26's mamba2-130m runs cut to 12 of its 24 layers (widths untouched)
# since the script needed room for phase 30
SSM_SPEC_LAYERS = 12


def phase_ssm_decoding() -> dict:
    """Phase 26: mamba2's model-level decode against the engine's spec-off
    stream; speculation through the replayed steps on mamba2 (n-gram on
    16 repetitive prompts, a self-draft on 4 requests, the rollback after
    partial acceptance) and on jamba-v0.1-52b over one period (n-gram, no
    MoE drops: ``moe_keeps_every_assignment``); the paged read at jamba's
    widest verify window against its plain version. Returns the runs'
    launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import repetitive_requests, serving_requests
    t0 = time.monotonic()
    mamba = dataclasses.replace(get_config("mamba2-130m"),
                                n_layers=SSM_SPEC_LAYERS)
    params = draw_params(mamba, f"{mamba.name} full width, "
                         f"{SSM_SPEC_LAYERS} of 24 layers")
    rep = repetitive_requests(16, mamba.vocab_size, prompt_len=256)
    ngram = phase_spec_engine(mamba, params,
                              name="n-gram depth 4, 16 repetitive requests",
                              prompts=rep, max_new=SERVE_NEW, draft=False,
                              need_rounds=False)
    model_level_decode(mamba, params, rep, ngram["outs"]["off"], SERVE_NEW)
    four = serving_requests(4, mamba.vocab_size, prompt_lens=[64, 256],
                            seed=1)
    draft = phase_spec_engine(mamba, params,
                              name="self-draft depth 4, 4 requests",
                              prompts=four, max_new=SSM_DRAFT_NEW,
                              draft=True)
    ssm_rollback(mamba, params, four, draft["outs"]["off"], "self-draft's")
    del params
    free_card()
    jamba = dataclasses.replace(get_config("jamba-v0.1-52b"),
                                n_layers=JAMBA_LAYERS)
    params = draw_params(jamba, f"{jamba.name} full width, {JAMBA_LAYERS} "
                         f"of 32 layers")
    with moe_keeps_every_assignment(jamba) as keep:
        print(f"[ssm] {jamba.name}: MoE capacity multiplier {keep:g} in "
              f"every call (no assignment dropped)")
        rep = repetitive_requests(16, jamba.vocab_size, prompt_len=256)
        jam = phase_spec_engine(
            jamba, params, name="n-gram depth 4, 16 repetitive requests",
            prompts=rep, max_new=SERVE_NEW, draft=False, need_rounds=False)
        # windows wider than one token at full width: the n-gram
        # proposer may stay silent on random weights
        ssm_rollback(jamba, params, rep[:4],
                     {i: jam["outs"]["off"][i] for i in range(4)},
                     "n-gram prompts'")
    del params
    free_card()
    wide = time_shape(jamba, b=8, t=5, lengths=[320] * 8, quant=False,
                      mb=32, n_blocks=1025, n_layers=4)
    print(f"[timing] paged_attention {jamba.name} verify B=8 T=5 H=32 K=8 "
          f"(G=4) D=128 bf16, {wide['n_split']} column splits: "
          f"{wide['ms'] * 1e3:.2f} us by graph replay (bound "
          f"{wide['bound_ms'] * 1e3:.2f} us by {wide['bound_by']}, "
          f"{wide['bound_ms'] / wide['ms'] * 100:.1f}% of it), == plain "
          f"within rtol=atol=2e-5 (max |err| {wide['max_abs_err']:.3g}), "
          f"plain {wide['plain_ms'] * 1e3:.1f} us, sdpa "
          f"{wide['library_ms'] * 1e3:.2f} us by graph replay; "
          f"{card_line()}")
    free_card()
    runs = (ngram, draft, jam)
    print(f"[ssm] phase 26 took {time.monotonic() - t0:.1f}s")
    return {"paged": sum(r["paged"] for r in runs),
            "ssd": sum(r["ssd"] for r in runs),
            "dense_decode": sum(r["dense"] for r in runs), "verify": wide}


# --------------------------------------------------------------------------
# phase 27: tensor-parallel serving, two ranks sharing the card
# --------------------------------------------------------------------------

TP_DEGREE = 2
TP_LENS = [64, 256]                # prompts, cycled over 8 requests
TP_REQUESTS = 8
TP_NEW = 32
# (config, engine arguments): qwen chunked with int8 KV, llama2-7b and
# mamba2-130m whole-prompt with bf16 KV
TP_RUNS = (("qwen1.5-0.5b", dict(prefill_chunk=64, kv_quant="int8")),
           ("llama2-7b", dict(kv_quant="none")),
           ("mamba2-130m", dict(kv_quant="none")))
TP_POOL = dict(max_batch=8, n_blocks=1024, block_size=16)
# llama2-7b serves cut to 16 of its 32 layers (widths untouched) since
# the script needed room for phase 29; since phase 30 llama2-7b to 8, and
# qwen1.5-0.5b and mamba2-130m to 6 of their 24; since phase 31 those two
# to 4
TP_LAYERS = {"llama2-7b": 8, "qwen1.5-0.5b": 4, "mamba2-130m": 4}


def tp_config(name):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=TP_LAYERS.get(name,
                                                           cfg.n_layers))


# the largest gap, at any position of a teacher-forced stream, between
# TP = 2's logits and TP = 1's, in bf16 ulps of the row's top logit
TP_FORCED_ULPS = 16


@contextlib.contextmanager
def tp2_sum_order():
    """TP = 1 summing in TP = 2's order, on one device: each row-parallel
    product (``layers.dense_row`` with no model axis) as two f32 halves
    of its contraction added, then rounded once; the gated norm's squares
    summed by halves (the split norm's two kernel passes); the
    column-parallel products by each rank's columns (the q/k/v
    projections by halves of their heads, mamba2's in_proj and conv by
    ``sharding.fused_segments``: a product of few rows on a rank's
    columns is not the whole product's columns); and the paged read
    split over as many column spans as a rank's K/2 KV heads give it
    (``paged_splits``); every other op as TP = 1's. Needs the heads,
    the KV heads and the SSD heads even."""
    from types import SimpleNamespace

    import torch
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as S
    dense_row, gated, qkv = L.dense_row, B._gated_norm, B._qkv
    ssm_pre, splits = B._ssm_pre, fd.paged_splits

    def halves(x, w, ctx, n_in=1, out_dtype=None, qmm_impl="kernel"):
        if ctx is not None or w.shape[0] < 2:     # mamba2's empty FFN
            return dense_row(x, w, ctx, n_in, out_dtype, qmm_impl)
        out_dt = out_dtype or torch.promote_types(x.dtype, w.dtype)
        d, n = x.ndim - n_in, w.shape[0]
        ys = [L.dense(a.contiguous(), b.contiguous(), n_in,
                      out_dtype=torch.float32, qmm_impl=qmm_impl)
              for a, b in zip(x.split(n // 2, d), w.split(n // 2, 0))]
        return (ys[0] + ys[1]).to(out_dt)

    def gated_halves(y, z, w, cfg, ctx):
        if ctx is not None:
            return gated(y, z, w, cfg, ctx)
        g = y * L.silu(z)
        return rms_split_run(g.reshape(-1, g.shape[-1]), w, 2,
                             eps=cfg.norm_eps).reshape(g.shape)

    def qkv_halves(x, p, cfg, positions, rope=True, qmm_impl="kernel",
                   ctx=None):
        if ctx is not None:
            return qkv(x, p, cfg, positions, rope, qmm_impl, ctx)
        parts = []
        for r in range(2):
            pr = dict(p)
            for n, keys in ((cfg.n_heads, ("wq", "bq")),
                            (cfg.n_kv_heads, ("wk", "wv", "bk", "bv"))):
                for key in keys:
                    if key in p:
                        w, h = p[key], n // 2
                        pr[key] = w.narrow(w.ndim - 2, r * h, h).contiguous()
            parts.append(qkv(x, pr, cfg, positions, rope, qmm_impl))
        return tuple(torch.cat(t, dim=-2) for t in zip(*parts))

    def rank_cut(t, name, cfg, r):
        """A rank's cut of the last axis of ``t`` (in_proj columns, conv
        channels), as ``sharding.shard_params`` cuts it."""
        pieces, start = [], 0
        for n, is_cut in S.fused_segments(name, cfg, t.shape[-1]):
            seg = t.narrow(-1, start, n)
            start += n
            pieces.append(seg.narrow(-1, r * n // 2, n // 2) if is_cut
                          else seg)
        return torch.cat(pieces, -1).contiguous()

    def ssm_pre_halves(h, p, cfg, conv_state=None, capture_tail=False,
                       n_valid=None, ctx=None):
        if ctx is not None:
            return ssm_pre(h, p, cfg, conv_state, capture_tail, n_valid,
                           ctx)
        outs = []
        for r in range(2):
            pr = dict(p)
            for key in ("in_proj", "conv_w", "conv_b"):
                pr[key] = rank_cut(p[key], key, cfg, r)
            cs_r = (None if conv_state is None
                    else rank_cut(conv_state, "conv_w", cfg, r))
            outs.append(ssm_pre(h, pr, cfg, cs_r, capture_tail, n_valid,
                                S.ShardCtx(SimpleNamespace(
                                    shape={S.MODEL: 2}, rank=r), cfg)))
        (z0, x0, b0, c0, d0, t0), (z1, x1, _, _, d1, t1) = outs
        tail = None
        if t0 is not None:                # x of both ranks, B and C once
            half = cfg.d_inner // 2
            tail = torch.cat([t0[..., :half], t1[..., :half],
                              t0[..., half:]], -1)
        return (torch.cat([z0, z1], -1), torch.cat([x0, x1], 2), b0, c0,
                torch.cat([d0, d1], -1), tail)

    def rank_splits(b, n_kv, mb, n_sm):
        return splits(b, max(n_kv // 2, 1), mb, n_sm)

    L.dense_row, B._gated_norm, B._qkv = halves, gated_halves, qkv_halves
    B._ssm_pre, fd.paged_splits = ssm_pre_halves, rank_splits
    try:
        yield
    finally:
        L.dense_row, B._gated_norm, B._qkv = dense_row, gated, qkv
        B._ssm_pre, fd.paged_splits = ssm_pre, splits


def tp_forced(eng, cfg, dev, prompts, streams):
    """TP = 1's ``streams`` teacher forced through this rank's sharded
    model (every rank: its collectives) and, on rank 0, through TP = 1's
    model and TP = 1 in TP = 2's order of sums (:func:`tp2_sum_order`).
    Returns, over every position, the largest logit gap of each pair in
    bf16 ulps of the row's top TP = 1 logit, and the positions whose
    argmax differs."""
    import torch
    from repro_torch.models.lm import LM
    rank0 = eng._ctx.rank == 0
    if rank0:
        full = LM(cfg, device=dev).init(0)
        one = LM(cfg, ssd_impl="kernel", device=dev)
    gaps = {"tp": 0.0, "emu": 0.0, "tp_emu": 0.0}
    flips = dict.fromkeys(gaps, 0)
    positions = 0
    v = cfg.vocab_size
    for rid in sorted(streams):
        toks = torch.tensor([prompts[rid] + streams[rid][:-1]],
                            dtype=torch.int64, device=dev)
        z2 = eng.model.forward(eng.params, toks)[0, :, :v].float()
        if not rank0:
            continue
        z1 = one.forward(full, toks)[0, :, :v].float()
        with tp2_sum_order():
            ze = one.forward(full, toks)[0, :, :v].float()
        top = z1.max(-1).values
        ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(
            1e-30))) - 7)
        for key, a, b in (("tp", z2, z1), ("emu", ze, z1),
                          ("tp_emu", z2, ze)):
            gaps[key] = max(gaps[key], float(
                ((a - b).abs().max(-1).values / ulp).max()))
            flips[key] += int((a.argmax(-1) != b.argmax(-1)).sum())
        positions += toks.shape[1]
    return {"gaps": gaps, "flips": flips, "positions": positions}


def tp_serve(mesh, name, engine_kw, prompts, max_new, streams=None):
    """One rank of phase 27 (``mesh=None``: the single-device run): the
    full-width seeded weights drawn on the rank's card, the engine built
    over its slice (``Engine(mesh=)``, steps eager), every launch count
    set to 0, the burst served. Each collective is timed between two
    synchronizes (what it adds on the host), and each decode step's
    wall, so the record gives the decode steps' share spent in
    collectives. Then, given TP = 1's ``streams``, :func:`tp_forced`.
    Returns the record."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
    from repro_torch.models.lm import LM
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import Engine, Request
    cfg = tp_config(name)
    dev = mesh.device if mesh is not None else torch.device("cuda")
    params = LM(cfg, device=dev).init(0)
    eng = Engine(cfg, params, mesh=mesh, device=dev, cuda_graphs=False,
                 **TP_POOL, **engine_kw)
    del params
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    coll = {"s": 0.0, "n": 0}
    dec = {"s": 0.0, "coll_s": 0.0, "coll_n": 0, "steps": 0}
    if eng._ctx is not None:
        reduce = eng._ctx.all_reduce

        def timed_reduce(t, region=None):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            reduce(t, region)
            torch.cuda.synchronize(dev)
            coll["s"] += time.perf_counter() - t0
            coll["n"] += 1
            return t

        eng._ctx.all_reduce = timed_reduce
    decode = eng._decode_fused

    def timed_decode(live):
        if not live:
            return decode(live)
        s0, n0, t0 = coll["s"], coll["n"], time.perf_counter()
        decode(live)
        torch.cuda.synchronize(dev)
        dec["s"] += time.perf_counter() - t0
        dec["coll_s"] += coll["s"] - s0
        dec["coll_n"] += coll["n"] - n0
        dec["steps"] += 1

    eng._decode_fused = timed_decode
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
    torch.cuda.synchronize(dev)
    for c in graphs.KERNEL_COUNTERS:   # count the main path's run only
        c.clear()
    t0 = time.monotonic()
    done = eng.run(max_steps=5000)
    torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0
    rec = {"out": {r.rid: list(r.output) for r in done},
           "st": counters(eng.stats()),
           "decode_tok_s": eng.stats()["decode_tok_s"], "wall": wall,
           "paged": fd.LAUNCHES["paged_attention"],
           "ssd": ssdk.LAUNCHES["ssd"], "rmsnorm": rn.LAUNCHES["rmsnorm"],
           "sumsq": rn.LAUNCHES["rmsnorm_sumsq"],
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "pool_mib": eng.kv.hbm_bytes() / 2 ** 20, "dec": dec,
           "kv_heads": eng.kv_cfg.n_kv_heads, "device": str(dev)}
    if streams is not None:
        rec["forced"] = tp_forced(eng, cfg, dev, prompts, streams)
    return rec


def tp_launches(cfg, rec, run: str) -> None:
    """A rank's launches: the paged read once an attention layer a decode
    and chunk step, the SSD scan once an SSM layer a prefill group and
    chunk step, RMSNorm once a norm of a forward (a split gated norm's
    scale pass included) and its partial-sum pass once an SSM layer a
    forward where the model axis splits the SSD heads; each must have
    run."""
    st = rec["st"]
    kinds = cfg.layer_kinds()
    n_attn, n_ssm = kinds.count("attn"), kinds.count("ssm")
    steps = st["decode_steps"] + st["chunk_steps"]
    check(rec["paged"] == n_attn * steps,
          f"{run}: paged launches {rec['paged']} != {n_attn} x {steps}")
    check(rec["ssd"] == n_ssm * (st["prefill_groups"] + st["chunk_steps"]),
          f"{run}: SSD launches {rec['ssd']} != {n_ssm} x (prefill groups "
          f"+ chunk steps)")
    forwards = st["prefill_groups"] + steps
    count_rmsnorm(run, rec["rmsnorm"], norms_per_forward(cfg) * forwards,
                  f"{norms_per_forward(cfg)} x {forwards} forwards")
    split = bool(cfg.n_ssm_heads) and cfg.n_ssm_heads % TP_DEGREE == 0
    want = n_ssm * forwards if split else 0
    check(rec["sumsq"] == want, f"{run}: split-norm partial-sum launches "
          f"{rec['sumsq']} != {want} ({n_ssm} x {forwards} forwards)")
    check(rec["paged"] > 0 if n_attn else rec["ssd"] > 0,
          f"{run}: the path's kernel never launched")


def phase_tp() -> dict:
    """Phase 27: the engine sharded over two ranks that share card 0
    (gloo; the steps eager), at full width: qwen1.5-0.5b chunked with
    int8 KV, llama2-7b and mamba2-130m whole-prompt. Each config is
    served first on one device in this process, then on the two ranks;
    every rank's tokens must equal the single-device run's up to a
    counted split at a 4-ulp bf16 near tie of its logits, and every rank
    must launch the paged read, the SSD scan, RMSNorm and the split
    norm's partial-sum pass as its heads give them. TP = 1's streams,
    teacher forced, hold TP = 2's logits within ``TP_FORCED_ULPS`` of TP
    = 1's at every position and equal, bit for bit, to those of TP = 1
    in TP = 2's order of sums (:func:`tp2_sum_order`); that order also
    serves the burst on one device, its streams' splits from TP = 2's
    printed.
    Prints per-rank peak memory, decode tok/s and the share of a decode
    step spent in collectives. With two or more cards it also runs nccl,
    one card per rank. Returns the ranks' launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.lm import LM
    t0 = time.monotonic()
    total = {"paged": 0, "ssd": 0, "sumsq": 0}
    outs = {}
    card = card_line()
    for name, kw in TP_RUNS:
        cfg = tp_config(name)
        prompts = serving_requests(TP_REQUESTS, cfg.vocab_size,
                                   prompt_lens=TP_LENS)
        one = tp_serve(None, name, kw, prompts, TP_NEW)
        free_card()
        with tp2_sum_order():
            emu = tp_serve(None, name, kw, prompts, TP_NEW)
        free_card()
        ranks = spawn_ranks(tp_serve, TP_DEGREE, backend="gloo",
                            args=(name, kw, prompts, TP_NEW, one["out"]))
        outs[name] = ranks[0]["out"]
        cut = (f" ({cfg.n_layers} of {get_config(name).n_layers} layers)"
               if name in TP_LAYERS else "")
        what = f"{name}{cut} TP={TP_DEGREE} " + ", ".join(
            f"{k}={v}" for k, v in kw.items())
        for r, rec in enumerate(ranks):
            check(rec["out"] == ranks[0]["out"],
                  f"{what}: rank {r}'s tokens differ from rank 0's")
            check(rec["st"]["finished"] == TP_REQUESTS,
                  f"{what} rank {r}: {rec['st']['finished']} of "
                  f"{TP_REQUESTS} finished")
            tp_launches(cfg, rec, f"{what} rank {r}")
            total["paged"] += rec["paged"]
            total["ssd"] += rec["ssd"]
            total["sumsq"] += rec["sumsq"]
        splits = 0
        if ranks[0]["out"] != one["out"]:      # the forward only where due
            model = LM(cfg, device="cuda")
            splits = spec_splits(model, model.init(0), prompts, one["out"],
                                 ranks[0]["out"],
                                 what="TP=2 splits from TP=1")
            del model
            free_card()
        emu_splits = sum(emu["out"][rid] != out
                         for rid, out in ranks[0]["out"].items())
        fc = ranks[0]["forced"]
        g, fl = fc["gaps"], fc["flips"]
        check(g["tp"] <= TP_FORCED_ULPS, f"{what}: teacher forced, TP=2's "
              f"logits are {g['tp']:.2f} bf16 ulps of the top from TP=1's "
              f"(limit {TP_FORCED_ULPS})")
        check(g["tp_emu"] == 0 and fl["tp_emu"] == 0, f"{what}: teacher "
              f"forced, TP=2's logits are {g['tp_emu']:.3f} ulps from TP=1 "
              f"in TP=2's order of sums ({fl['tp_emu']} argmax differing), "
              f"not equal")
        for r, rec in enumerate(ranks):
            d = rec["dec"]
            print(f"[tp] {what} rank {r} on {rec['device']}: "
                  f"{rec['kv_heads']} KV heads a pool ({rec['pool_mib']:.0f} "
                  f"MiB), peak {rec['peak_gib']:.2f} GiB, decode "
                  f"{rec['decode_tok_s']:.1f} tok/s, {d['steps']} decode "
                  f"steps, {d['coll_n'] / max(d['steps'], 1):.0f} "
                  f"collectives a decode step taking "
                  f"{d['coll_s'] / max(d['s'], 1e-9) * 100:.1f}% of its "
                  f"wall ({d['coll_s'] / max(d['coll_n'], 1) * 1e3:.3f} ms "
                  f"each, {d['s'] / max(d['steps'], 1) * 1e3:.2f} ms a "
                  f"step); launches paged {rec['paged']}, SSD {rec['ssd']}, "
                  f"RMSNorm {rec['rmsnorm']}; {card}")
        print(f"[tp] {what}: teacher forced over TP=1's {len(prompts)} "
              f"streams ({fc['positions']} positions), the largest logit "
              f"gap in bf16 ulps of the row's top (argmax differing at): "
              f"TP=2 vs TP=1 {g['tp']:.3f} ({fl['tp']}), TP=1 in TP=2's "
              f"order of sums vs TP=1 {g['emu']:.3f} ({fl['emu']}), TP=2 "
              f"vs TP=1 in TP=2's order {g['tp_emu']:.3f} "
              f"({fl['tp_emu']}); served streams differing from TP=2's: "
              f"TP=1 {splits}, TP=1 in TP=2's order {emu_splits} of "
              f"{len(prompts)}; {card}")
        print(f"[tp] {what}: tokens of both ranks == TP=1 with {splits} "
              f"split(s) at a bf16 near tie (4 ulps); TP=1 on one device: "
              f"peak {one['peak_gib']:.2f} GiB, decode "
              f"{one['decode_tok_s']:.1f} tok/s ({one['dec']['steps']} decode "
              f"steps, "
              f"{one['dec']['s'] / max(one['dec']['steps'], 1) * 1e3:.2f} "
              f"ms a step), eager; {card}")
    if torch.cuda.device_count() >= TP_DEGREE:
        name, kw = TP_RUNS[0]
        cfg = tp_config(name)
        prompts = serving_requests(TP_REQUESTS, cfg.vocab_size,
                                   prompt_lens=TP_LENS)
        ranks = spawn_ranks(tp_serve, TP_DEGREE, backend="nccl",
                            args=(name, kw, prompts, TP_NEW))
        check(all(r["out"] == outs[name] for r in ranks),
              "nccl ranks' tokens differ from the gloo ranks'")
        print(f"[tp] {name} TP={TP_DEGREE} over nccl, one card per rank: "
              f"decode {ranks[0]['decode_tok_s']:.1f} tok/s; {card}")
    else:
        print(f"[tp] nccl, one card per rank: not run "
              f"({torch.cuda.device_count()} card on this machine)")
    print(f"[tp] phase 27 took {time.monotonic() - t0:.1f}s")
    return total


# --------------------------------------------------------------------------
# phase 28: data-parallel training over two ranks sharing the card
# --------------------------------------------------------------------------

DP_DEGREE = 2
DP_SHAPE = dict(b=4, t=2048)        # phase 24's global batch
# the stages, each from fresh seeded state, in one spawn: Z0 (F+R), Z1,
# Z2, Z3 and Z3+O on qwen1.5-0.5b, then mamba2-130m F+R+Z3, 2 steps each
# (qwen's 3 until the script needed room for phase 29); a rank runs one
# micro-batch of its 2 rows, and the one-device oracle (grad_accum = 2)
# runs the same rows as its two micro-batches
DP_RUNS = (("qwen1.5-0.5b", "F+R", 2), ("qwen1.5-0.5b", "F+R+Z1", 2),
           ("qwen1.5-0.5b", "F+R+Z2", 2), ("qwen1.5-0.5b", "F+R+Z3", 2),
           ("qwen1.5-0.5b", "F+R+Z3+O", 2), ("mamba2-130m", "F+R+Z3", 2))
DP_LR = 1e-3                        # warmup 0: every step moves the params
# qwen's stages run cut to 6 of its 24 layers (widths untouched) since the
# script needed room for phase 30, to 4 since phase 31
DP_LAYERS = {"qwen1.5-0.5b": 4}


def dp_config(name):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=DP_LAYERS.get(name,
                                                           cfg.n_layers))


def dp_batches(cfg, steps: int, rows: int = DP_SHAPE["b"]):
    """The global batches of ``steps`` steps, ``rows`` x 2048 each
    (``SyntheticLM``, packed: every row holds as many labels, so a rank's
    loss is its micro-batch mean)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=DP_SHAPE["t"],
                                  global_batch=rows, seed=0))
    return [data.batch_at(i) for i in range(steps)]


def leaf_sums(state, lay=None) -> dict:
    """Per-leaf hashes of the whole state's bytes, taken on the card: two
    sums over the leaf's elements' bits (bf16 as int16, f32 and int32 as
    int32), plain and weighted by the element's flat index + 1 in the
    whole leaf, each mod 2^64. Both are linear in the elements, so the
    hash of a sharded leaf's gathered bytes is the sum of every rank's
    sum over its piece at the piece's indices in the whole leaf
    (:func:`gathered_sums`), and no byte has to move. Returns ``{path:
    (sharded, h1, h2)}``; with ``lay`` (a rank's ``DPLayout``) a sharded
    leaf's sums are this rank's part."""
    import torch
    from repro_torch.models.params import keystr_paths
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
            torch.int32: torch.int32}
    out = {}
    for path, t in keystr_paths(state):
        t = t.detach().to("cuda")
        cut = lay.state_cut(path) if lay is not None else None
        sharded = cut is not None and cut.dim is not None
        shape = list(t.shape)
        if sharded:
            shape[cut.dim] *= cut.parts
        idx = torch.arange(1, math.prod(shape) + 1,
                           device=t.device).view(shape)
        if sharded:
            lo, hi = cut.bounds(shape[cut.dim])
            idx = idx.narrow(cut.dim, lo, hi - lo)
        w = t.contiguous().view(bits[t.dtype]).to(torch.int64)
        out[path] = (sharded, int(w.sum()) % 2**64,
                     int((w * idx).sum()) % 2**64)
    return out


SHA_THREADS = 4                     # hashlib releases the GIL on big buffers


def piece_sha(state, lay=None) -> dict:
    """sha256 of each leaf's bytes as this rank holds them: ``{path: (dim,
    lo, hi, digest)}``, ``dim`` the dim the data axis cuts and ``[lo,
    hi)`` this rank's piece of the whole leaf along it (``dim`` None: the
    whole leaf); with ``lay`` None every leaf is whole."""
    from repro_torch.models.params import keystr_paths
    where, host = {}, {}
    for path, t in keystr_paths(state):
        cut = lay.state_cut(path) if lay is not None else None
        if cut is None or cut.dim is None:
            where[path] = (None, None, None)
        else:
            where[path] = (cut.dim,) + cut.bounds(t.shape[cut.dim] *
                                                  cut.parts)
        host[path] = t.detach().cpu()
    digest = sha_all(host)
    return {p: where[p] + (digest[p],) for p in where}


def sha_all(tensors: dict) -> dict:
    """sha256 of each host tensor's bytes in row-major order, hashed in
    ``SHA_THREADS`` threads."""
    import hashlib
    from concurrent.futures import ThreadPoolExecutor
    import torch

    def one(t):
        b = t.contiguous().reshape(-1).view(torch.uint8)
        return hashlib.sha256(b.numpy()).hexdigest()

    with ThreadPoolExecutor(SHA_THREADS) as ex:
        return dict(zip(tensors, ex.map(one, tensors.values())))


def sha_mismatches(whole: dict, pieces: dict) -> list:
    """The leaves whose piece sha256 in ``pieces`` (a rank's
    :func:`piece_sha`) is not that of the same piece of ``whole`` (the
    one-device run's final state on the host, ``{path: tensor}``)."""
    mine = {}
    for path, (dim, lo, hi, _) in pieces.items():
        if path in whole:
            w = whole[path]
            mine[path] = w if dim is None else w.narrow(dim, lo, hi - lo)
    digest = sha_all(mine)
    return ([p for p, v in pieces.items() if digest.get(p) != v[3]]
            + [p for p in whole if p not in pieces])


def gathered_sums(ranks_sums: list) -> list:
    """Each rank's view of the whole state's hashes: a sharded leaf's
    partial sums added over the ranks (mod 2^64), a whole leaf's the
    rank's own."""
    out = []
    for mine in ranks_sums:
        got = {}
        for path, (sharded, h1, h2) in mine.items():
            if sharded:
                h1 = sum(r[path][1] for r in ranks_sums) % 2**64
                h2 = sum(r[path][2] for r in ranks_sums) % 2**64
            got[path] = (h1, h2)
        out.append(got)
    return out


def state_bytes(state, extra=()) -> dict:
    """Bytes of a state's tensors (and ``extra`` tensors) by where they
    live: the card, pinned host memory, pageable host memory."""
    from repro_torch.models.params import keystr_paths
    out = {"card": 0, "pinned": 0, "host": 0}
    for t in [t for _, t in keystr_paths(state)] + list(extra):
        n = t.numel() * t.element_size()
        out["card" if t.is_cuda else "pinned" if t.is_pinned()
            else "host"] += n
    return out


def dp_run(mesh, name, label, batches, accum=1):
    """One run of phase 28: the seeded full-width state on this rank's
    card (one device when ``mesh`` is None, ``grad_accum`` ``accum``), the
    kernels' launch counts set to 0, the steps fenced one by one, each
    data-axis collective timed between two synchronizes. Returns the
    losses (bits and values), grad_norms, step ms, the collectives' count
    and seconds, the launches, peak memory over the steps, the state's
    bytes at rest (with the persistent gradient buffer) and the per-leaf
    linear hashes of the whole final state; and the sha256 of each of the
    rank's pieces (:func:`piece_sha`), or on one device the final state
    itself on the host."""
    import dataclasses
    import struct
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import technique_from_label
    from repro_torch.core.perfscope import Timer
    from repro_torch.launch.build import make_model
    from repro_torch.models.params import keystr_paths
    from repro_torch.parallel.sharding import make_shard_ctx
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (DPLayout, build_train_step,
                                        init_train_state)
    cfg = dp_config(name)
    tech = dataclasses.replace(technique_from_label(label), grad_accum=accum)
    ctx = make_shard_ctx(cfg, tech, mesh) if mesh is not None else None
    dev = mesh.device if mesh is not None else torch.device("cuda")
    model = make_model(cfg, tech, device=dev, ctx=ctx)
    opt = AdamWConfig(lr=DP_LR, warmup=0)
    state, _ = init_train_state(model, tech, 0, opt, ctx=ctx)
    step = build_train_step(model, tech, opt, ctx=ctx)
    timer = Timer()
    if ctx is not None:
        ctx.comm_timer = timer
    free_card()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    slice_counts(reset=True)
    rec = {"loss": [], "loss_f": [], "grad_norm": [], "ms": [], "coll": []}
    for b in batches:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if ctx is not None:
            lo, hi = ctx.batch_sharding(DP_SHAPE["b"])
            batch = {k: v[lo:hi] for k, v in batch.items()}
        n0, s0 = len(timer.records["collective"]), \
            sum(timer.records["collective"])
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize(dev)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["coll"].append((len(timer.records["collective"]) - n0,
                            sum(timer.records["collective"]) - s0))
        loss = float(met["loss"])
        rec["loss"].append(struct.unpack("<I", struct.pack("<f", loss))[0])
        rec["loss_f"].append(loss)
        rec["grad_norm"].append(float(met["grad_norm"]))
    rec["launches"] = slice_counts()
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if ctx is not None:
        ctx.comm_timer = None
    buf = getattr(step, "grad_buffer", {})
    rec["at_rest"] = state_bytes(state, buf.values())
    rec["grad_buffer"] = sum(t.numel() * 4 for t in buf.values())
    rec["allocated_gib"] = torch.cuda.memory_allocated(dev) / 2**30
    lay = DPLayout(model, tech, ctx) if ctx is not None else None
    rec["sums"] = leaf_sums(state, lay)
    if ctx is None:                     # the oracle: its whole final state
        rec["whole"] = {p: t.detach().cpu() for p, t in keystr_paths(state)}
    else:
        rec["sha"] = piece_sha(state, lay)
    rec["device"] = str(dev)
    del state, step, model
    free_card()
    return rec


def dp_rank_runs(mesh, runs):
    """Every run of phase 28 in turn on one set of ranks."""
    return [dp_run(mesh, name, label, batches)
            for name, label, batches in runs]


def phase_dp() -> dict:
    """Phase 28: training over a data axis of two ranks that share card
    0 (gloo). qwen1.5-0.5b at full width, F+R at 4 x 2048, 3 steps: the
    one-device oracle (grad_accum 2) in this process, then, in one
    spawn, Z0, Z1, Z2, Z3 and Z3+O in turn from fresh seeded state, then
    mamba2-130m F+R+Z3 for 2 steps against its own oracle. Every stage's
    per-step loss must equal the oracle's bit for bit, and so must its
    final params and moments (per-leaf linear hashes of the gathered
    bytes, and the sha256 of each rank's pieces), on both ranks; every
    rank must launch the flash kernels and RMSNorm as
    its micro-batch gives them. Prints each stage's per-rank peak memory,
    state bytes at rest on the card and in pinned host memory, step ms
    and the share of a step spent in collectives. With two or more cards
    it also runs Z3 over nccl, one card per rank. Returns the ranks'
    launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.monotonic()
    card = card_line()
    runs, oracles = [], {}
    for name, label, steps in DP_RUNS:
        cfg = dp_config(name)
        batches = dp_batches(cfg, steps)
        if name not in oracles:
            oracles[name] = dp_run(None, name, "F+R", batches,
                                   accum=DP_DEGREE)
            o = oracles[name]
            print(f"[dp] {name} ({cfg.n_layers} layers) one device, "
                  f"grad_accum {DP_DEGREE}, "
                  f"{steps} steps of {DP_SHAPE['b']} x {DP_SHAPE['t']}: "
                  f"losses " + ", ".join(f"{x:.6f}" for x in o["loss_f"])
                  + f"; {sum(o['ms'][1:]) / max(len(o['ms']) - 1, 1):.1f} "
                  f"ms a step after the first; peak {o['peak_gib']:.2f} "
                  f"GiB; state at rest {o['at_rest']['card'] / 1e9:.3f} GB "
                  f"on the card; {card}")
        runs.append((name, label, batches))
    t1 = time.monotonic()
    ranks = spawn_ranks(dp_rank_runs, 1, data=DP_DEGREE, backend="gloo",
                        args=(runs,))
    total = {}
    rest = {}
    for i, (name, label, batches) in enumerate(runs):
        cfg = dp_config(name)
        want = oracles[name]
        sums = {p: v[1:] for p, v in want["sums"].items()}
        for rec, got in zip([recs[i] for recs in ranks], gathered_sums(
                [recs[i]["sums"] for recs in ranks])):
            rec["whole_sums"] = got
        norms = norms_per_train_step(cfg, DP_SHAPE["t"], remat=True)
        n_attn = cfg.layer_kinds().count("attn")
        for r, recs in enumerate(ranks):
            rec = recs[i]
            what = f"{name} {label} dp={DP_DEGREE} rank {r}"
            check(rec["loss"] == want["loss"], f"{what}: losses "
                  f"{rec['loss_f']} != the one-device grad_accum "
                  f"{DP_DEGREE} run's {want['loss_f']} (bit for bit)")
            bad = [p for p in sums if rec["whole_sums"].get(p) != sums[p]]
            check(not bad and set(rec["whole_sums"]) == set(sums),
                  f"{what}: final state differs from the one-device run's "
                  f"at {bad[:4]}")
            bad = sha_mismatches(want["whole"], rec["sha"])
            check(not bad, f"{what}: the sha256 of this rank's pieces "
                  f"differs from that of the one-device run's at {bad[:4]}")
            check(all(math.isclose(a, b, rel_tol=1e-6) for a, b in
                      zip(rec["grad_norm"], want["grad_norm"])),
                  f"{what}: grad_norm {rec['grad_norm']} vs "
                  f"{want['grad_norm']} beyond rtol 1e-6")
            la, n = rec["launches"], len(batches)
            check(la["fwd"] == 2 * n_attn * n and la["bwd_dkv"] == n_attn * n
                  and la["bwd_dq"] == n_attn * n,
                  f"{what}: flash launches {la} != {2 * n_attn}/{n_attn}/"
                  f"{n_attn} a step")
            check(la["rmsnorm"] == norms * n, f"{what}: RMSNorm launches "
                  f"{la['rmsnorm']} != {norms} a step x {n}")
            check(la["rmsnorm"] > 0 and (la["fwd"] > 0 or not n_attn),
                  f"{what}: the path's kernels never launched")
            add_counts(total, la)
            cn = sum(c[0] for c in rec["coll"][1:])
            cs = sum(c[1] for c in rec["coll"][1:])
            ms = sum(rec["ms"][1:])
            ar = rec["at_rest"]
            rest[(name, label, r)] = ar
            print(f"[dp] {what} on {rec['device']}: losses == one device "
                  f"bit for bit, final params and moments == one device "
                  f"(per-leaf linear hashes of the gathered bytes, and the "
                  f"sha256 of each of this rank's pieces); peak {rec['peak_gib']:.2f} GiB; "
                  f"state at rest {ar['card'] / 1e9:.3f} GB on the card "
                  f"(of which the gradient buffer "
                  f"{rec['grad_buffer'] / 1e9:.3f}), "
                  f"{ar['pinned'] / 1e9:.3f} GB pinned host; allocated at "
                  f"rest {rec['allocated_gib']:.2f} GiB; "
                  f"{ms / max(n - 1, 1):.1f} ms a step after the first, "
                  f"{cn / max(n - 1, 1):.0f} collectives a step taking "
                  f"{cs * 1e3 / max(ms, 1e-9) * 100:.1f}% of it "
                  f"({cs * 1e3 / max(cn, 1):.2f} ms each); launches fwd "
                  f"{la['fwd']}, bwd {la['bwd_dkv']} + {la['bwd_dq']}, "
                  f"RMSNorm {la['rmsnorm']}; {card}")
    order = [lb for n, lb, _ in DP_RUNS if n == "qwen1.5-0.5b"]
    for r in range(DP_DEGREE):
        card_bytes = [rest[("qwen1.5-0.5b", lb, r)]["card"] for lb in order]
        check(all(a > b for a, b in zip(card_bytes, card_bytes[1:])),
              f"qwen rank {r}: state at rest on the card does not fall "
              f"Z0 > Z1 > Z2 > Z3 > Z3+O: {card_bytes}")
    for o in oracles.values():
        del o["whole"]
    RMSNORM_RUNS["data-parallel ranks (phase 28)"] = total["rmsnorm"]
    if torch.cuda.device_count() >= DP_DEGREE:
        name, label, batches = runs[3]
        got = spawn_ranks(dp_rank_runs, 1, data=DP_DEGREE, backend="nccl",
                          args=([(name, label, batches)],))
        check(all(g[0]["loss"] == oracles[name]["loss"] for g in got),
              "nccl ranks' losses differ from the one-device run's")
        print(f"[dp] {name} {label} over nccl, one card per rank: "
              f"{sum(got[0][0]['ms'][1:]) / 2:.1f} ms a step; {card}")
    else:
        print(f"[dp] nccl, one card per rank: not run "
              f"({torch.cuda.device_count()} card on this machine)")
    print(f"[dp] phase 28 launches over the ranks' runs: " + ", ".join(
        f"{k} {v}" for k, v in total.items()) + f"; the ranks took "
        f"{time.monotonic() - t1:.1f}s; phase 28 took "
        f"{time.monotonic() - t0:.1f}s")
    return total


# --------------------------------------------------------------------------
# phase 29: MoE over ranks (expert-parallel serving, MoE under a data axis)
# --------------------------------------------------------------------------

EP_DEGREE = 2
# qwen3-moe-30b-a3b cut to 2 of its 48 layers (widths untouched: d 2048,
# 128 experts top-8, expert d_ff 768, 32/4 heads of 128; 4 layers until
# the script needed room for phase 30); jamba over one period (8 of 32
# layers), its 16 experts split 8 a rank
EP_QWEN_LAYERS = 2
# (B)'s qwen3-moe depth: 2 layers until the script needed room for phase 30
EP_DP_LAYERS = 1
EP_RUNS = (("qwen3-moe-30b-a3b", EP_QWEN_LAYERS),
           ("jamba-v0.1-52b", JAMBA_LAYERS))
EP_ENGINE = dict(prefill_chunk=64, kv_quant="int8")
EP_NEW = 16
# (B): qwen3-moe cut to EP_DP_LAYERS of 48, F+R+Z3 at dp 2 on phase 28's 4 x
# 2048 global batch, 2 steps from the seed, against the one-device step on
# the whole batch (grad_accum 1)
MOE_DP_STEPS = 2
MOE_DP_LR = 1e-3
SKETCH_K = 16          # projections of a leaf (linear: pieces add up)
# the limits of (B), per leaf of the state after step 1, on the sketched
# distances (a JL estimate of |a - b| / |b|, its error ~18% at K = 16):
# the first moments within 2^-5 of their norm, the second within 2^-4.
# Each rank's bf16 gradient rounds once and the whole batch's once (the
# CPU tests hold 2^-8 and 2^-7 there, where a product's rows do not
# depend on its row count); on the card every product of the two sides
# has another row count, so cuBLAS sums in other orders throughout, and
# a leaf whose gradient is a cancelling sum over all tokens (a norm's
# weight) reads several times that (0.87% on an MoE layer's norm on the
# H100 against 2^-8 x 1.5). The params within half of their own
# update (the reference comparison's limit: Adam's first step moves an
# element about lr x sign(g), so an element whose gradient sits near 0
# may move the other way)
MOE_DP_M_REL = 2.0 ** -5
MOE_DP_V_REL = 2.0 ** -4
MOE_DP_P_REL = 0.5
# after step 2 the moments carry step 2's gradients, taken at params that
# Adam's first step left apart where a gradient sat near 0 (up to 2 lr an
# element): only the params' limit holds there, the moments are printed.
# Per step, relative: loss and aux within f32 rounding of the order of
# sums at step 1, grad_norm within the ranks' bf16 roundings; step 2's
# after those params
MOE_DP_STEP_RTOL = {"loss": (1e-5, 1e-3), "aux": (1e-5, 1e-3),
                    "grad_norm": (1e-3, 1e-2)}


def ep_config(name, layers):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), n_layers=layers)


def ep_emulated_moe(moe_local, h, p, cfg, capacity_mult, ctx=None):
    """``blocks._moe_ep`` at degree ``EP_DEGREE`` on one device, op for op
    at the ranks' shapes: each virtual rank routes its slice of t (or
    every token), sorts into its (E·cap + 1) buffer, the blocks are
    regrouped as the all-to-all regroups them, each virtual rank's
    experts (its E/2 contiguous ones) run over ``(E/2, 2·cap, D)``, the
    rows go back and each combines its tokens; the t slices are
    concatenated. A call under a context is the one-device dispatch."""
    import torch
    from repro_torch.models import blocks as B
    if ctx is not None or cfg.n_experts % EP_DEGREE:
        return (moe_local(h, p, cfg, capacity_mult) if ctx is None else
                moe_local(h, p, cfg, capacity_mult, ctx))
    m = EP_DEGREE
    wg, wu, wd = B._expert_weights(p, h.dtype)
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    e_loc = e // m
    t = h.shape[1]
    split_t = t % m == 0 and t > 1
    sends, tails = [], []
    for r in range(m):
        hh = h.narrow(1, r * (t // m), t // m) if split_t else h
        x = hh.reshape(-1, d)
        n = x.shape[0]
        top_w, top_e, _ = B._route(x, p["router"], cfg)
        cap = B.capacity(n, cfg, capacity_mult)
        slot, keep = B._slots(top_e, e, cap)
        sends.append(B._dispatch(x, slot, k, e * cap).reshape(
            m, e_loc * cap, d))
        tails.append((hh.shape, slot, keep, top_w, n))
    ys = []
    for j in range(m):
        recv = torch.stack([sends[i][j] for i in range(m)])
        xs = recv.reshape(m, e_loc, cap, d).transpose(0, 1).reshape(
            e_loc, m * cap, d)
        lo, hi = j * e_loc, (j + 1) * e_loc
        y = B._expert_ffn(xs, wg[lo:hi], wu[lo:hi], wd[lo:hi])
        ys.append(y.reshape(e_loc, m, cap, d).transpose(0, 1).reshape(
            m, e_loc * cap, d))
    outs = []
    for i, (shape, slot, keep, top_w, n) in enumerate(tails):
        back = torch.stack([ys[j][i] for j in range(m)])
        outs.append(B._combine(back.reshape(e * cap, d), slot, keep, top_w,
                               n, k, h.dtype).reshape(shape))
    y = torch.cat(outs, dim=1) if split_t else outs[0]
    return y, torch.zeros((), device=h.device)


@contextlib.contextmanager
def ep2_sum_order():
    """TP = 1 in TP = 2's order of sums (:func:`tp2_sum_order`) with the
    MoE FFN as :func:`ep_emulated_moe`."""
    from repro_torch.models import blocks as B
    moe_local = B._moe_local
    B._moe_local = (lambda *a, **kw: ep_emulated_moe(moe_local, *a, **kw))
    try:
        with tp2_sum_order():
            yield
    finally:
        B._moe_local = moe_local


class DropCount:
    """The dropped and all (token, choice) assignments of every MoE
    dispatch, added on the card (no sync) by a wrapper around
    ``blocks._slots``: under expert parallelism each rank's own shard's
    (a decode step routes every row on every rank)."""

    def __init__(self, device):
        import torch
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)
        self.total = 0

    def __enter__(self):
        from repro_torch.models import blocks as B
        self.saved = slots = B._slots

        def counted(top_e, e, cap, ctx=None):
            slot, keep = (slots(top_e, e, cap) if ctx is None else
                          slots(top_e, e, cap, ctx))
            self.dropped += (~keep).sum()
            self.total += keep.numel()
            return slot, keep

        B._slots = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks as B
        B._slots = self.saved


def ep_serve(mesh, name, layers, prompts, max_new, streams=None):
    """One rank of phase 29 (A) (``mesh=None``: TP = 1 on one device):
    the config cut to ``layers``, its seeded weights drawn on the card
    (a rank draws its own pieces, a layer slice at a time: the whole
    tree is never on the card twice), the engine (steps eager), every
    launch count set to 0, the burst served with the dropped assignments
    counted and each exchange of the expert-parallel dispatch timed
    between two synchronizes. Given TP = 1's ``streams``, each stream
    teacher forced through this rank's model: the sha256 of its logits'
    bytes. Returns the record."""
    import hashlib
    import torch
    from repro_torch.core.perfscope import Timer
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
    from repro_torch.models.lm import LM
    from repro_torch.models.params import tree_paths
    from repro_torch.parallel.sharding import make_serving_ctx
    from repro_torch.serving import graphs
    from repro_torch.serving.engine import Engine, Request
    cfg = ep_config(name, layers)
    dev = mesh.device if mesh is not None else torch.device("cuda")
    t0 = time.monotonic()
    params = LM(cfg, device=dev, ctx=make_serving_ctx(cfg, mesh)).init(
        0, pieces=True)
    torch.cuda.synchronize(dev)
    drawn_s = time.monotonic() - t0
    eng = Engine(cfg, params, mesh=mesh, device=dev, cuda_graphs=False,
                 **TP_POOL, **EP_ENGINE)
    del params
    free_card()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = Timer()
    if eng._ctx is not None:
        eng._ctx.comm_timer = timer
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
    torch.cuda.synchronize(dev)
    for c in graphs.KERNEL_COUNTERS:   # count the main path's run only
        c.clear()
    t0 = time.monotonic()
    with DropCount(dev) as drops:
        done = eng.run(max_steps=5000)
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0
    st = eng.stats()
    rec = {"out": {r.rid: list(r.output) for r in done},
           "st": counters(st), "decode_tok_s": st["decode_tok_s"],
           "wall": wall, "drawn_s": drawn_s,
           "paged": fd.LAUNCHES["paged_attention"],
           "ssd": ssdk.LAUNCHES["ssd"], "rmsnorm": rn.LAUNCHES["rmsnorm"],
           "sumsq": rn.LAUNCHES["rmsnorm_sumsq"],
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "dropped": int(drops.dropped), "assignments": drops.total,
           "exchange_n": len(timer.records["exchange"]),
           "exchange_s": sum(timer.records["exchange"]),
           "exchange_bytes": (eng._ctx.exchange_bytes
                              if eng._ctx is not None else 0),
           "weights_gib": sum(t.numel() * t.element_size() for _, t in
                              tree_paths(eng.params)) / 2 ** 30,
           "device": str(dev)}
    if eng._ctx is not None:
        eng._ctx.comm_timer = None
    if streams is not None:
        v = cfg.vocab_size
        rec["forced"] = {}
        with torch.no_grad():
            for rid in sorted(streams):
                toks = torch.tensor([prompts[rid] + streams[rid][:-1]],
                                    dtype=torch.int64, device=dev)
                z = eng.model.forward(eng.params, toks)[0, :, :v]
                rec["forced"][rid] = hashlib.sha256(
                    z.contiguous().cpu().view(torch.uint8).numpy()
                ).hexdigest()
    del eng
    free_card()
    return rec


def ep_forced_one(cfg, prompts, streams):
    """On one device, after the ranks have exited: TP = 1's seeded model
    and each of TP = 1's ``streams`` teacher forced through it as it is
    and in TP = 2's order of sums (:func:`ep2_sum_order`). Returns the
    sha256 of each stream's logits in TP = 2's order, the largest gap of
    the two in bf16 ulps of the row's top TP = 1 logit, and the positions
    whose argmax differs."""
    import hashlib
    import torch
    from repro_torch.models.lm import LM
    model = LM(cfg, ssd_impl="kernel", device="cuda")
    params = model.init(0)
    v = cfg.vocab_size
    out = {"sha": {}, "gap": 0.0, "flips": 0, "positions": 0}
    with torch.no_grad():
        for rid in sorted(streams):
            toks = torch.tensor([prompts[rid] + streams[rid][:-1]],
                                dtype=torch.int64, device="cuda")
            z1 = model.forward(params, toks)[0, :, :v]
            with ep2_sum_order():
                ze = model.forward(params, toks)[0, :, :v]
            out["sha"][rid] = hashlib.sha256(
                ze.contiguous().cpu().view(torch.uint8).numpy()).hexdigest()
            z1, ze = z1.float(), ze.float()
            top = z1.max(-1).values
            ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(
                1e-30))) - 7)
            out["gap"] = max(out["gap"], float(
                ((ze - z1).abs().max(-1).values / ulp).max()))
            out["flips"] += int((ze.argmax(-1) != z1.argmax(-1)).sum())
            out["positions"] += toks.shape[1]
    del model, params
    free_card()
    return out


def leaf_sketch(state, lay=None, ctx=None, device="cuda") -> dict:
    """``{path: (own, (SKETCH_K,) float64)}``: each leaf's values (as f32)
    projected onto SKETCH_K pseudo-random vectors whose entries are a
    hash of the element's flat index in the whole leaf (uniform in
    [-0.5, 0.5): the top 24 bits of the index's splitmix64 hash times an
    odd constant of the vector's own), on the card. Linear, so a sharded
    leaf's projection is the sum over the ranks of each rank's over its
    piece (with ``lay`` and ``ctx``, a rank's ``DPLayout`` and context:
    its TP cut, then its ZeRO cut) and no byte moves; ``own`` says
    whether this rank's piece enters that sum (a piece an axis repeats
    is counted on that axis's rank 0 only; one device: every leaf, own). The RMS of two runs'
    projections' differences estimates the distance of the leaves
    (Johnson-Lindenstrauss) up to the same factor as their RMS estimates
    a leaf's norm."""
    import torch
    from repro_torch.models.params import keystr_paths
    wrap = lambda c: c - (1 << 64) if c >= 1 << 63 else c   # as int64
    golden = 0x9E3779B97F4A7C15
    odds = torch.tensor([wrap(golden * (2 * j + 1) % (1 << 64))
                         for j in range(SKETCH_K)], dtype=torch.int64,
                        device=device)

    def srl(z, n):                        # logical shift right
        return (z >> n) & ((1 << (64 - n)) - 1)

    def hashed(i):                        # splitmix64's finaliser
        z = i + wrap(golden)
        z = (z ^ srl(z, 30)) * wrap(0xBF58476D1CE4E5B9)
        z = (z ^ srl(z, 27)) * wrap(0x94D049BB133111EB)
        return z ^ srl(z, 31)

    from repro_torch.parallel import zero as Z
    out = {}
    for path, t in keystr_paths(state):
        if lay is None:
            cuts, own = (), True
        else:
            tc, zc = lay.state_cut(path, tp=True), lay.state_cut(path)
            cuts = tuple(c for c in (tc, zc) if c.dim is not None)
            own = ((tc.dim is not None or ctx.rank == 0) and
                   (zc.dim is not None or ctx.mesh.data_rank == 0))
        # each level's shape, the whole leaf's first
        shapes = [tuple(t.shape)]
        for c in reversed(cuts):
            shapes.insert(0, Z.whole_shape(shapes[0], c))
        # a fused SSM leaf's B and C runs: every model rank holds them
        # whole, model rank 0 counts them
        skip = (cuts[0].whole_runs() if cuts and cuts[0].segs
                and ctx.rank != 0 else [])
        whole_stride = torch.tensor(
            [math.prod(shapes[0][d + 1:]) for d in range(t.ndim)],
            dtype=torch.int64, device=device)
        flat = t.detach().to(device).reshape(-1)
        acc = torch.zeros(SKETCH_K, dtype=torch.float64, device=device)
        step = 1 << 22
        for c0 in range(0, flat.numel(), step):
            q = torch.arange(c0, min(c0 + step, flat.numel()),
                             device=device)
            coords = []
            for n in reversed(shapes[-1]):
                coords.insert(0, q % n)
                q = q // n
            vals = flat[c0:c0 + step].float()
            for level in range(len(cuts) - 1, -1, -1):
                c = cuts[level]
                x = coords[c.dim]
                if level == 0 and skip:
                    hit = torch.zeros_like(x, dtype=torch.bool)
                    for at, n in skip:
                        hit |= (x >= at) & (x < at + n)
                    vals = torch.where(hit, torch.zeros_like(vals), vals)
                runs = c.ranges(shapes[level][c.dim])
                at = torch.tensor([r[2] for r in runs], device=device)
                lo = torch.tensor([r[0] for r in runs], device=device)
                k = torch.bucketize(x, at, right=True) - 1
                coords[c.dim] = lo[k] + x - at[k]
            idx = sum(cd * whole_stride[d] for d, cd in enumerate(coords)) \
                if coords else torch.zeros_like(vals, dtype=torch.int64)
            r = hashed(idx)[:, None] * odds
            r >>= 40                      # in [-2^23, 2^23)
            acc += (vals @ r.float()).double() * 2.0 ** -24
        out[path] = (own, acc.cpu().numpy())
    return out


def whole_sketch(ranks_sketches: list) -> dict:
    """The whole state's sketches: each leaf's owned pieces' projections
    added over the ranks."""
    return {p: sum(r[p][1] for r in ranks_sketches if r[p][0])
            for p in ranks_sketches[0]}


@contextlib.contextmanager
def recorded_routes(calls: list):
    """``blocks._route`` with a copy of each call's experts appended to
    ``calls`` (on the device: no sync)."""
    from repro_torch.models import blocks as B
    orig = B._route

    def recorded(h, w, cfg, ctx=None):
        out = orig(h, w, cfg) if ctx is None else orig(h, w, cfg, ctx)
        calls.append(out[1].reshape(-1, cfg.top_k).clone())
        return out

    B._route = recorded
    try:
        yield
    finally:
        B._route = orig


@contextlib.contextmanager
def forced_routes(routes: list, flips: list, gaps: list = None):
    """``blocks._route`` on one device or a model rank taking the experts
    of another run's calls (``routes``: arrays (tokens, k)): each call
    takes the one of its shape that agrees most with its own choice (the
    forward and the recomputation call each layer). Where that one
    differs, its gates are gathered at those experts and renormalised,
    and the program's own load-balancing loss gains what the changed
    first choices change in it (nothing where no first choice changed);
    ``flips`` gains the tokens whose expert set it changed and ``gaps``
    the most by which a forced expert's gate fell short of the token's
    own k-th, relative to it (a near tie: the two sides' products sum
    in other orders)."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    orig = B._route

    def forced(h, w, cfg, ctx=None):
        top_w, top_e, aux = (orig(h, w, cfg) if ctx is None else
                             orig(h, w, cfg, ctx))
        e, k = cfg.n_experts, cfg.top_k
        own = top_e.reshape(-1, k)
        cands = [torch.from_numpy(r).to(own.device) for r in routes
                 if r.shape == tuple(own.shape)]
        want = max(cands, key=lambda c: int((c == own).all(-1).sum()))
        changed = (want.sort(-1)[0] != own.sort(-1)[0]).any(-1)
        flips.append(int(changed.sum()))
        if torch.equal(want, own):
            return top_w, top_e, aux
        gates = torch.softmax(L.dense(h.float(), w).float(), -1).reshape(
            -1, e)
        tw = gates.gather(-1, want)
        if gaps is not None and flips[-1]:
            kth = gates.gather(-1, own[:, -1:])[:, 0]
            short = (kth - tw.min(-1).values) / kth
            gaps.append(float(short[changed].max()))
        tw = tw / torch.clamp_min(tw.sum(-1, keepdim=True), 1e-9)
        ids = torch.arange(e, device=want.device)
        moved = ((want[:, :1] == ids).float().mean(0)
                 - (own[:, :1] == ids).float().mean(0))
        aux = aux + e * (gates.mean(0) * moved).sum()
        return tw.reshape(top_w.shape), want.reshape(top_e.shape), aux

    B._route = forced
    try:
        yield
    finally:
        B._route = orig


def moe_dp_run(mesh, layers, batches, routes=None):
    """One run of phase 29 (B): qwen3-moe cut to ``layers``, F+R+Z3 over
    this rank's rows (``mesh=None``: F+R on one device, the whole batch,
    grad_accum 1), from the seed; the kernels' launch counts set to 0,
    each step fenced, each data-axis collective timed between two
    synchronizes. Returns the per-step loss, ce, aux and grad_norm, step
    ms, the collectives, launches, peak memory, the state at rest, the
    sketches of the whole state after each step (:func:`leaf_sketch`; a
    rank's: its pieces' part) and, on one device, of the initial params
    (the ranks draw the same tree and keep their pieces). A rank
    records each step's experts of each MoE layer (its rows); the one
    device takes ``routes`` (the ranks' records joined, a list a step)
    and forces them (:func:`forced_routes`): the two sides' products sum
    in other orders (another number of rows), so a near tie of two gates
    may flip an expert, and the comparison holds what remains."""
    import torch
    from repro_torch.core.config import technique_from_label
    from repro_torch.core.perfscope import Timer
    from repro_torch.launch.build import make_model
    from repro_torch.parallel.sharding import make_shard_ctx
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (DPLayout, build_train_step,
                                        init_train_state)
    cfg = ep_config("qwen3-moe-30b-a3b", layers)
    tech = technique_from_label("F+R+Z3" if mesh is not None else "F+R")
    ctx = make_shard_ctx(cfg, tech, mesh) if mesh is not None else None
    dev = mesh.device if mesh is not None else torch.device("cuda")
    model = make_model(cfg, tech, device=dev, ctx=ctx)
    opt = AdamWConfig(lr=MOE_DP_LR, warmup=0)
    state, _ = init_train_state(model, tech, 0, opt, ctx=ctx)
    lay = DPLayout(model, tech, ctx) if ctx is not None else None
    rec = {"init": leaf_sketch(state["params"]) if ctx is None else None}
    step = build_train_step(model, tech, opt, ctx=ctx)
    timer = Timer()
    if ctx is not None:
        ctx.comm_timer = timer
    free_card()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    slice_counts(reset=True)
    for key in ("loss", "ce", "aux", "grad_norm", "ms", "coll"):
        rec[key] = []
    rec["routes"], rec["flips"] = [], []
    n_moe = sum(k == "moe" for k in cfg.ffn_kinds())
    for i, b in enumerate(batches):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if ctx is not None:
            lo, hi = ctx.batch_sharding(DP_SHAPE["b"])
            batch = {k: v[lo:hi] for k, v in batch.items()}
        n0, s0 = len(timer.records["collective"]), \
            sum(timer.records["collective"])
        calls, flips = [], []
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with (recorded_routes(calls) if routes is None else
              forced_routes(routes[i], flips)):
            state, met = step(state, batch)
        torch.cuda.synchronize(dev)
        rec["routes"].append([c.cpu().numpy() for c in calls[:n_moe]])
        rec["flips"].append(sum(flips))
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        rec["coll"].append((len(timer.records["collective"]) - n0,
                            sum(timer.records["collective"]) - s0))
        for key in ("loss", "ce", "aux", "grad_norm"):
            rec[key].append(float(met[key]))
        rec.setdefault("state", []).append(leaf_sketch(state, lay, ctx))
    rec["launches"] = slice_counts()
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if ctx is not None:
        ctx.comm_timer = None
    buf = getattr(step, "grad_buffer", {})
    rec["at_rest"] = state_bytes(state, buf.values())
    rec["device"] = str(dev)
    del state, step, model
    free_card()
    return rec


def ep_rank_runs(mesh, serve_runs, dp_args):
    """Phase 29 on one rank: the (A) runs in turn on the model axis,
    then (B) on the same two processes seen as a data axis."""
    import dataclasses
    t0 = time.monotonic()
    out = [ep_serve(mesh, *run) for run in serve_runs]
    t1 = time.monotonic()
    data = dataclasses.replace(
        mesh, shape={"data": EP_DEGREE, "model": 1}, rank=0,
        ranks=(mesh.ranks[mesh.rank],), group=None, data_rank=mesh.rank,
        data_ranks=mesh.ranks, data_group=mesh.group)
    dp = moe_dp_run(data, *dp_args)
    dp["part_s"] = (t1 - t0, time.monotonic() - t1)
    return out, dp


def sketch_rel(a, b):
    """The sketched distance of two runs' leaf over the sketched norm of
    the second (``b``)."""
    import numpy as np
    return float(np.sqrt(np.mean((a - b) ** 2)) /
                 max(np.sqrt(np.mean(b ** 2)), 1e-300))


def phase_moe_ranks() -> dict:
    """Phase 29: MoE over two ranks that share card 0 (gloo). (A)
    expert-parallel serving: qwen3-moe-30b-a3b at full width cut to
    ``EP_QWEN_LAYERS`` layers and jamba-v0.1-52b over one period, 8
    requests chunked (64) with int8 KV, TP = 1 first on one device, then
    both ranks (each drawing its own pieces); every rank's tokens equal
    rank 0's, the served streams that split from TP = 1 are counted, and
    TP = 1's streams teacher forced through each rank's model give, bit
    for bit, TP = 1's logits in TP = 2's order of sums
    (:func:`ep2_sum_order`, computed after the ranks exit). (B) qwen3-moe
    cut to ``EP_DP_LAYERS``, F+R+Z3 at dp 2 (the same two processes as a data
    axis), 2 steps of the 4 x 2048 global batch, against the one-device
    F+R step on the whole batch: loss, ce, aux and grad_norm per step,
    and the final params and moments by sketches. Prints the dropped
    assignments on both sides, per-rank peak memory, the exchange's
    bytes and ms a step (host-staged) and each rank's decode tok/s.
    Returns the ranks' launches."""
    import numpy as np
    import torch
    from repro_torch.data.pipeline import serving_requests
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.monotonic()
    card = card_line()
    serve_runs, ones = [], {}
    for name, layers in EP_RUNS:
        cfg = ep_config(name, layers)
        prompts = serving_requests(TP_REQUESTS, cfg.vocab_size,
                                   prompt_lens=TP_LENS)
        ones[name] = ep_serve(None, name, layers, prompts, EP_NEW)
        serve_runs.append((name, layers, prompts, EP_NEW,
                           ones[name]["out"]))
    dp_cfg = ep_config("qwen3-moe-30b-a3b", EP_DP_LAYERS)
    batches = dp_batches(dp_cfg, MOE_DP_STEPS)
    t1 = time.monotonic()
    ranks = spawn_ranks(ep_rank_runs, EP_DEGREE, backend="gloo",
                        args=(serve_runs, (EP_DP_LAYERS, batches)))
    t_ranks = time.monotonic() - t1
    total = {"paged": 0, "ssd": 0, "sumsq": 0, "rmsnorm": 0}
    for i, (name, layers, prompts, _, streams) in enumerate(serve_runs):
        cfg = ep_config(name, layers)
        one = ones[name]
        recs = [r[0][i] for r in ranks]
        what = (f"{name} ({layers} of {get_cfg_layers(name)} layers) "
                f"TP={EP_DEGREE} EP, chunk 64, int8 KV")
        for r, rec in enumerate(recs):
            check(rec["out"] == recs[0]["out"],
                  f"{what}: rank {r}'s tokens differ from rank 0's")
            check(rec["st"]["finished"] == TP_REQUESTS,
                  f"{what} rank {r}: {rec['st']['finished']} of "
                  f"{TP_REQUESTS} finished")
            tp_launches(cfg, rec, f"{what} rank {r}")
            check(rec["exchange_n"] > 0 and rec["exchange_bytes"] > 0,
                  f"{what} rank {r}: the expert-parallel exchange never ran")
            for key in ("paged", "ssd", "sumsq"):
                total[key] += rec[key]
        forced = ep_forced_one(cfg, prompts, streams)
        for r, rec in enumerate(recs):
            bad = [rid for rid in streams
                   if rec["forced"][rid] != forced["sha"][rid]]
            check(not bad, f"{what} rank {r}: teacher forced, the logits "
                  f"of streams {bad} differ from TP=1's in TP=2's order of "
                  f"sums (sha256 of the bytes)")
        splits = sum(recs[0]["out"][rid] != out
                     for rid, out in one["out"].items())
        for r, rec in enumerate(recs):
            steps = rec["st"]["decode_steps"] + rec["st"]["chunk_steps"]
            print(f"[ep] {what} rank {r} on {rec['device']}: weights "
                  f"{rec['weights_gib']:.2f} GiB drawn as pieces in "
                  f"{rec['drawn_s']:.1f}s, peak {rec['peak_gib']:.2f} GiB "
                  f"(TP=1 {one['peak_gib']:.2f}); decode "
                  f"{rec['decode_tok_s']:.1f} tok/s (TP=1 "
                  f"{one['decode_tok_s']:.1f}); {steps} steps "
                  f"({rec['st']['decode_steps']} decode, "
                  f"{rec['st']['chunk_steps']} chunk), wall "
                  f"{rec['wall']:.1f}s (TP=1 {one['wall']:.1f}s); the "
                  f"exchange (host-staged gloo all_reduce of int32 words) "
                  f"{rec['exchange_n'] / max(steps, 1):.1f} a step, "
                  f"{rec['exchange_bytes'] / max(steps, 1) / 2**20:.2f} MiB "
                  f"and {rec['exchange_s'] * 1e3 / max(steps, 1):.2f} ms a "
                  f"step ({rec['exchange_s'] * 1e3 / rec['exchange_n']:.3f} "
                  f"ms, {rec['exchange_bytes'] / max(rec['exchange_s'], 1e-9) / 1e9:.3f} "
                  f"GB/s each); dropped {rec['dropped']} of "
                  f"{rec['assignments']} assignments of its shards (TP=1: "
                  f"{one['dropped']} of {one['assignments']}); launches "
                  f"paged {rec['paged']}, SSD {rec['ssd']}, RMSNorm "
                  f"{rec['rmsnorm']}, split-norm partial sums "
                  f"{rec['sumsq']}; {card}")
        print(f"[ep] {what}: teacher forced over TP=1's {len(streams)} "
              f"streams ({forced['positions']} positions), both ranks' "
              f"logits == TP=1's in TP=2's order of sums bit for bit "
              f"(sha256); that order against TP=1: largest gap "
              f"{forced['gap']:.3f} bf16 ulps of the row's top, argmax "
              f"differing at {forced['flips']}; served streams of TP=2 "
              f"splitting from TP=1's: {splits} of {len(streams)}; {card}")
    t_a = time.monotonic() - t0
    # (B): the one-device oracle after the ranks have exited, routed as
    # the ranks routed
    t2 = time.monotonic()
    recs = [r[1] for r in ranks]
    import numpy as np
    joined = [[np.concatenate([r["routes"][s_i][j] for r in recs])
               for j in range(len(recs[0]["routes"][s_i]))]
              for s_i in range(len(batches))]
    oracle = moe_dp_run(None, EP_DP_LAYERS, batches, routes=joined)
    check_moe_dp(recs, oracle, len(batches), dp_cfg, card, total)
    RMSNORM_RUNS["MoE over ranks (phase 29)"] = total["rmsnorm"]
    print(f"[ep] phase 29 launches over the ranks' runs: " + ", ".join(
        f"{k} {v}" for k, v in total.items()) + f"; the ranks took "
        f"{t_ranks:.1f}s (rank 0: (A) {recs[0]['part_s'][0]:.1f}s, (B) "
        f"{recs[0]['part_s'][1]:.1f}s), (A)'s one-device runs and checks "
        f"{t_a - t_ranks:.1f}s, (B)'s one-device run and checks "
        f"{time.monotonic() - t2:.1f}s; phase 29 took "
        f"{time.monotonic() - t0:.1f}s")
    return total


def _moe_dp_limit(key, s_i):
    if key in MOE_DP_STEP_RTOL:
        return f"{MOE_DP_STEP_RTOL[key][s_i]:g}"
    if key == "params":
        return f"{MOE_DP_P_REL:g}"
    lim = MOE_DP_M_REL if key == "m" else MOE_DP_V_REL
    return f"{lim:.3g}" if s_i == 0 else "not held"


def check_moe_dp(recs, oracle, n_steps, dp_cfg, card, total) -> None:
    """Phase 29 (B)'s holds and prints: the ranks' records ``recs``
    against the one-device ``oracle`` (:func:`moe_dp_run`): per step
    loss, aux and grad_norm within ``MOE_DP_STEP_RTOL`` and aux equal on
    the ranks; the launches; the state after each step by sketches
    (params within ``MOE_DP_P_REL`` of their update, moments after step
    1 within ``MOE_DP_M_REL`` / ``MOE_DP_V_REL`` of their norm; every
    other leaf equal). Adds the launches to ``total``."""
    import numpy as np
    what = (f"qwen3-moe-30b-a3b ({EP_DP_LAYERS} of 48 layers) F+R+Z3 "
            f"dp={EP_DEGREE}, {DP_SHAPE['b']} x {DP_SHAPE['t']} global")
    n_attn = EP_DP_LAYERS
    norms = norms_per_train_step(dp_cfg, DP_SHAPE["t"], remat=True)
    worst = {}
    for r, rec in enumerate(recs):
        check(rec["aux"] == recs[0]["aux"], f"{what}: aux differs between "
              f"ranks: {rec['aux']} vs {recs[0]['aux']}")
        for key, tols in MOE_DP_STEP_RTOL.items():
            for s_i, (a, b, tol) in enumerate(zip(rec[key], oracle[key],
                                                  tols)):
                rel = abs(a - b) / abs(b)
                worst[(key, s_i)] = max(worst.get((key, s_i), 0.0), rel)
                check(rel <= tol, f"{what} rank {r}: step {s_i + 1} {key} "
                      f"{a} vs one device {b} (rel {rel:.3g} > {tol})")
        la, n = rec["launches"], n_steps
        check(la["fwd"] == 2 * n_attn * n and la["bwd_dkv"] == n_attn * n
              and la["bwd_dq"] == n_attn * n and la["rmsnorm"] == norms * n,
              f"{what} rank {r}: launches {la} != flash {2 * n_attn}/"
              f"{n_attn}/{n_attn} and RMSNorm {norms} a step")
        total["rmsnorm"] += la["rmsnorm"]
        for k in ("fwd", "bwd_dkv", "bwd_dq"):
            total[k] = total.get(k, 0) + la[k]
    for s_i in range(n_steps):
        got = whole_sketch([r["state"][s_i] for r in recs])
        for p, (_, w) in oracle["state"][s_i].items():
            if p.startswith("['params']"):
                key, tol = "params", MOE_DP_P_REL
                base = oracle["init"][p[len("['params']"):]][1]
                if not np.any(w != base):
                    continue
                rel = (float(np.sqrt(np.mean((got[p] - w) ** 2))) /
                       float(np.sqrt(np.mean((w - base) ** 2))))
            elif p.startswith(("['opt']['m']", "['opt']['v']")):
                key = "m" if p.startswith("['opt']['m']") else "v"
                tol = (MOE_DP_M_REL if key == "m" else MOE_DP_V_REL) \
                    if s_i == 0 else None
                rel = sketch_rel(got[p], w)
            else:
                check(np.array_equal(got[p], w), f"{what}: {p} after step "
                      f"{s_i + 1} differs from one device's")
                continue
            worst[(key, s_i)] = max(worst.get((key, s_i), 0.0), rel)
            check(tol is None or rel <= tol, f"{what}: {p} after step "
                  f"{s_i + 1}: sketched distance {rel:.3g} of its "
                  f"{'update' if key == 'params' else 'norm'} > {tol}")
    for r, rec in enumerate(recs):
        cn = sum(c[0] for c in rec["coll"])
        cs = sum(c[1] for c in rec["coll"])
        print(f"[ep] {what} rank {r} on {rec['device']}: loss "
              + ", ".join(f"{x:.6f}" for x in rec["loss"])
              + f" (one device " + ", ".join(f"{x:.6f}" for x in
                                             oracle["loss"])
              + f"), aux " + ", ".join(f"{x:.6f}" for x in rec["aux"])
              + f" on both ranks (one device " + ", ".join(
                  f"{x:.6f}" for x in oracle["aux"]) + f"); peak "
              f"{rec['peak_gib']:.2f} GiB (one device "
              f"{oracle['peak_gib']:.2f}); state at rest "
              f"{rec['at_rest']['card'] / 1e9:.3f} GB on the card (one "
              f"device {oracle['at_rest']['card'] / 1e9:.3f}); step ms "
              + ", ".join(f"{x:.1f}" for x in rec["ms"])
              + f" (one device " + ", ".join(f"{x:.1f}" for x in
                                             oracle["ms"])
              + f"), {cn / len(rec['ms']):.0f} collectives a step taking "
              f"{cs * 1e3 / max(sum(rec['ms']), 1e-9) * 100:.1f}% of it; "
              f"launches {rec['launches']}; {card}")
    print(f"[ep] {what}: against the one-device step on the whole batch, "
          f"worst reading (limit) by step: " + "; ".join(
              f"{k} step {s_i + 1} {v:.3g} ({_moe_dp_limit(k, s_i)})"
              for (k, s_i), v in sorted(worst.items()))
          + f" (moments: sketched distance over norm, params: over their "
          f"own update; {SKETCH_K}-projection sketches of every leaf); the "
          f"one device routed as the ranks did: its own router would have "
          f"chosen another expert set for "
          + ", ".join(str(f) for f in oracle["flips"])
          + f" (token, call) pairs by step, of "
          f"{DP_SHAPE['b'] * DP_SHAPE['t'] * MOE_TRAIN_LAYERS} a forward "
          f"(each layer called twice a step: forward and recomputation); "
          f"{card}")


# --------------------------------------------------------------------------
# phase 30: tensor-parallel training (Megatron TP and sequence parallelism
# over a model axis; the 2-D data x model mesh under ZeRO)
# --------------------------------------------------------------------------

TPT_DEGREE = 2
TPT_STEPS = 2
# (A): qwen1.5-0.5b at full width, F+R on phase 28's 4 x 2048 global batch
# at TP = 2, sequence parallelism off then on, then sequence (context-
# parallel) attention; (B): the (2, 2) mesh, F+R+Z3 with sequence
# parallelism, in head mode then in sequence mode, qwen cut to 2 of its 24
# layers (4 before phase 31; widths untouched), against one device at
# grad_accum 2
TPT_MESH_LAYERS = 2
# the CPU cases' limits (tests/test_torch_tp_train.py): step 1's loss and
# ce relative, grad_norm relative; later steps' loss (absolute) and
# grad_norm; after step 1 each first moment's distance over its norm and
# each param's over its own update (sketched: a JL estimate, ~18% error at
# K = 16), and the update's cosine. Beside them the phase prints how far
# each run lies from the f32 step's (the same seeded params in f32) and
# how far apart two one-device bf16 steps lie (grad_accum 1 and 2)
TPT_LOSS_RTOL = 1e-5
TPT_NORM_RTOL = 1e-3
TPT_LATER = (1e-2, 0.03)
TPT_M_REL = 2.0 ** -5
TPT_P_REL = 0.5
TPT_P_COS = 0.9


@contextlib.contextmanager
def tp_train_order(cfg, tp: int, sp: bool):
    """One device computing the dense family's training forward as ``tp``
    model ranks do, every op at a rank's shapes: each attention block and
    FFN once a rank on its heads and MLP columns (under sequence
    parallelism each norm on a rank's rows of T), the row-parallel f32
    partials added in rank order and rounded once; each loss block's
    logits a rank's vocab slice at a time, the max over the slices, each
    slice's sum of exponentials and label logit added in rank order
    (``models.lm.vocab_parallel_ce``'s arithmetic). Two ranks add as
    gloo's all-reduce adds them. tests/torch_tp_train_worker.py's
    ``tp_order`` on the card."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LMmod
    attn, ffn, block_ce = B.attn_apply, B.ffn_apply, LMmod.LM._block_ce
    h_, k_, f_ = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.d_ff // tp

    def cut(w, dim, n, r):
        return w.narrow(dim, r * n, n).contiguous()

    def norm(x, w):
        if not sp:
            return L.rmsnorm(x, w, cfg.norm_eps)
        t = x.shape[1]
        return torch.cat([L.rmsnorm(x[:, r * t // tp:(r + 1) * t // tp]
                                    .contiguous(), w, cfg.norm_eps)
                          for r in range(tp)], 1)

    def attn_tp(x, p, c, *, positions, attn_impl="naive", qmm_impl="kernel",
                **kw):
        h = norm(x, p["ln"])
        y = None
        for r in range(tp):
            pr = dict(p)
            for key, n in (("wq", h_), ("wk", k_), ("wv", k_)):
                pr[key] = cut(p[key], 1, n, r)
            for key, n in (("bq", h_), ("bk", k_), ("bv", k_)):
                if key in p:
                    pr[key] = cut(p[key], 0, n, r)
            q, k, v = B._qkv(h, pr, c, positions)
            o = L.attention(q, k, v, mode=attn_impl, causal=True)
            part = L.dense(o, cut(p["wo"], 0, h_, r), 2,
                           out_dtype=torch.float32)
            y = part if y is None else y + part
        return x + y.to(x.dtype), None

    def ffn_tp(x, p, c, qmm_impl="kernel", ctx=None):
        h = norm(x, p["ln"])
        y = None
        for r in range(tp):
            g = L.dense(h, cut(p["w_gate"], 1, f_, r),
                        out_dtype=torch.float32)
            u = L.dense(h, cut(p["w_up"], 1, f_, r), out_dtype=torch.float32)
            part = L.dense(L.silu(g) * u, cut(p["w_down"], 0, f_, r),
                           out_dtype=torch.float32)
            y = part if y is None else y + part
        return x + y.to(x.dtype)

    def block_ce_tp(self, params, xb, lb):
        x = L.rmsnorm(xb, params["final_ln"], cfg.norm_eps)
        v = self.vocab // tp
        logits = [L.dense(x, params["embed"][r * v:(r + 1) * v].T
                          if cfg.tie_embeddings else
                          cut(params["head"], 1, v, r)).float()
                  for r in range(tp)]
        m = torch.stack([lg.amax(-1) for lg in logits]).amax(0)
        s = lab = None
        for r, lg in enumerate(logits):
            idx = lb.long() - r * v
            own = (idx >= 0) & (idx < v)
            got = lg.gather(-1, idx.clamp(0, v - 1)[..., None])[..., 0]
            sr = torch.exp(lg - m[..., None]).sum(-1)
            lr = torch.where(own, got, torch.zeros((), device=got.device))
            s, lab = (sr, lr) if s is None else (s + sr, lab + lr)
        mask = (lb >= 0).float()
        return ((m + torch.log(s) - lab) * mask).sum(), mask.sum()

    B.attn_apply, B.ffn_apply, LMmod.LM._block_ce = attn_tp, ffn_tp, \
        block_ce_tp
    try:
        yield
    finally:
        B.attn_apply, B.ffn_apply, LMmod.LM._block_ce = attn, ffn, block_ce


def tpt_run(mesh, label, sp, batches, accum=1, layers=None, mode="auto"):
    """One run of phase 30: qwen1.5-0.5b (``layers`` of them) seeded on
    this rank's card (one device when ``mesh`` is None, ``grad_accum``
    ``accum``; attention mode ``mode`` over the model axis), the
    kernels' launch counts set to 0, the steps fenced one by one, each
    seam, k/v and step collective timed between two synchronizes.
    Returns the losses (bits and values), ce, grad_norms, step ms, the
    seams', k/v collectives' and step collectives' counts and seconds,
    the launches (and the flash launches by q_offset), peak memory, the
    state's bytes at rest (with the gradient buffer), the sketches of the
    params before step 1 and of the params and first moments after it,
    and in sequence mode this rank's flash fwd and bwd at its shape
    (:func:`seq_flash_us`)."""
    import dataclasses
    import struct
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import technique_from_label
    from repro_torch.core.perfscope import Timer
    from repro_torch.launch.build import make_model
    from repro_torch.parallel.sharding import make_shard_ctx
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (DPLayout, build_train_step,
                                        init_train_state)
    cfg = get_config("qwen1.5-0.5b")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    tech = dataclasses.replace(technique_from_label(label), grad_accum=accum,
                               sp=sp, attn_mode=mode)
    ctx = make_shard_ctx(cfg, tech, mesh) if mesh is not None else None
    dev = mesh.device if mesh is not None else torch.device("cuda")
    model = make_model(cfg, tech, device=dev, ctx=ctx)
    opt = AdamWConfig(lr=DP_LR, warmup=0)
    state, _ = init_train_state(model, tech, 0, opt, ctx=ctx)
    lay = DPLayout(model, tech, ctx) if ctx is not None else None

    def bits(x):
        return struct.unpack("<I", struct.pack("<f", float(x)))[0]

    rec = {"loss": [], "loss_f": [], "ce": [], "grad_norm": [], "ms": [],
           "seam": [], "coll": [], "kv": [],
           "mode": ctx.attn_mode if ctx is not None else None}
    rec["sk0"] = leaf_sketch({"params": state["params"]}, lay, ctx, dev)
    step = build_train_step(model, tech, opt, ctx=ctx)
    timer = Timer()
    if ctx is not None:
        ctx.comm_timer = timer
    free_card()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    slice_counts(reset=True)
    for i, b in enumerate(batches):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        if ctx is not None:
            lo, hi = ctx.batch_sharding(DP_SHAPE["b"])
            batch = {k: v[lo:hi] for k, v in batch.items()}
        n0 = {k: (len(timer.records[k]), sum(timer.records[k]))
              for k in ("seam", "collective", "kv")}
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize(dev)
        rec["ms"].append((time.perf_counter() - t0) * 1e3)
        for k, key in (("seam", "seam"), ("collective", "coll"),
                       ("kv", "kv")):
            rec[key].append((len(timer.records[k]) - n0[k][0],
                             sum(timer.records[k]) - n0[k][1]))
        rec["loss"].append(bits(met["loss"]))
        rec["loss_f"].append(float(met["loss"]))
        rec["ce"].append(float(met["ce"]))
        rec["grad_norm"].append(float(met["grad_norm"]))
        if i == 0:
            rec["sk1"] = leaf_sketch({"params": state["params"],
                                    "opt": {"m": state["opt"]["m"]}},
                                   lay, ctx, dev)
    rec["launches"] = slice_counts()
    from repro_torch.kernels import flash_attention as fa
    rec["offsets"] = dict(fa.OFFSETS)
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    if ctx is not None and ctx.attn_mode == "seq":
        rec["flash_us"] = seq_flash_us(ctx)
    if ctx is not None:
        ctx.comm_timer = None
        rec["seam_bytes"] = ctx.seam_bytes
    buf = getattr(step, "grad_buffer", {})
    rec["at_rest"] = state_bytes(state, buf.values())
    rec["device"] = str(dev)
    del state, step, model
    free_card()
    return rec


def seq_flash_us(ctx) -> tuple:
    """This rank's flash forward and backward (dK/dV in f32, as sequence
    mode runs it) in us at phase 30's sequence-mode shape (its rows of
    the batch, H = K = 16, D = 64, its T/tp rows of T = 2048 over the
    keys it reaches, at its q_offset), timed by events while every other
    rank waits at a barrier (they share the card)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    t = DP_SHAPE["t"]
    lo, hi = ctx.own_rows(t)
    out = None
    for g in range(dist.get_world_size()):
        if g == dist.get_rank():
            q, k, v, do = flash_inputs(b=DP_SHAPE["b"] // ctx.dp_size,
                                       h=16, kv=16, t=hi - lo, s=hi, d=64,
                                       dtype=torch.bfloat16, seed=ctx.rank)
            o, lse = fa._fwd_cuda(q, k, v, causal=True, sm_scale=None,
                                  q_offset=lo)
            out = (cuda_ms(lambda i: fa._fwd_cuda(
                       q, k, v, causal=True, sm_scale=None, q_offset=lo),
                       iters=10) * 1e3,
                   cuda_ms(lambda i: fa._bwd_cuda(
                       q, k, v, o, lse, do, causal=True, sm_scale=None,
                       q_offset=lo, kv_f32=True), iters=10) * 1e3)
            del q, k, v, do, o, lse
        dist.barrier()
    return out


def tpt_rank_runs(mesh, runs):
    """Every run of phase 30 (A) or (B) in turn on one set of ranks."""
    return [tpt_run(mesh, *run) for run in runs]


def tpt_refs(batches, layers=None, emulate: bool = True) -> dict:
    """The one-device references of phase 30 from qwen1.5-0.5b's seeded
    params (``layers`` of them) on the first of ``batches``: with
    ``emulate`` the loss bits of the forward in TP = 2's order of sums
    (:func:`tp_train_order`) without and with sequence parallelism
    (``"emulated"``: {sp: bits}); and the sketches of 0.1 x the f32
    gradient of those params (Adam's first moment after one step, taken
    in f32; ``"truth"``), keyed as a state's first moments, and that
    gradient's norm (``"norm"``)."""
    import dataclasses
    import struct
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import technique_from_label
    from repro_torch.launch.build import make_model
    from repro_torch.models.params import keystr_map, keystr_paths
    cfg = get_config("qwen1.5-0.5b")
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model = make_model(cfg, technique_from_label("F+R"), device="cuda")
    params = model.init(0)
    b = {k: torch.from_numpy(v).to("cuda") for k, v in batches[0].items()}
    out = {"emulated": {}}
    for sp in ((False, True) if emulate else ()):
        with torch.no_grad(), tp_train_order(cfg, TPT_DEGREE, sp):
            loss = float(model.loss(params, b)[0])
        out["emulated"][sp] = struct.unpack("<I", struct.pack("<f", loss))[0]
    params = keystr_map(lambda p, t: t.float().requires_grad_(True), params)
    loss, _ = model.loss(params, b)
    paths = keystr_paths(params)
    grads = dict(zip([p for p, _ in paths], torch.autograd.grad(
        loss, [t for _, t in paths])))
    m = keystr_map(lambda p, t: grads[p] * 0.1, params)
    out["truth"] = {p: v for p, (_, v) in
                    leaf_sketch({"opt": {"m": m}}).items()}
    out["norm"] = float(torch.sqrt(sum(torch.sum(torch.square(g))
                                       for g in grads.values())))
    del params, grads, m, model, loss
    free_card()
    return out


def tpt_check(what, rec, want, n_layers, truth, ce=True):
    """One TP run against its one-device oracle at the CPU cases' limits
    (the state after step 1 by its sketches); returns the readings, with
    each first moment's distance from the f32 step's (``truth``) beside
    the one-device step's."""
    import numpy as np
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    check(rel(rec["loss_f"][0], want["loss_f"][0]) <= TPT_LOSS_RTOL,
          f"{what}: step-1 loss {rec['loss_f'][0]} vs one device "
          f"{want['loss_f'][0]} beyond rtol {TPT_LOSS_RTOL}")
    if ce:
        check(rel(rec["ce"][0], want["ce"][0]) <= TPT_LOSS_RTOL,
              f"{what}: step-1 ce {rec['ce'][0]} vs {want['ce'][0]}")
    check(rel(rec["grad_norm"][0], want["grad_norm"][0]) <= TPT_NORM_RTOL,
          f"{what}: step-1 grad_norm {rec['grad_norm'][0]} vs "
          f"{want['grad_norm'][0]} beyond rtol {TPT_NORM_RTOL}")
    for a, b, g, h in zip(rec["loss_f"][1:], want["loss_f"][1:],
                          rec["grad_norm"][1:], want["grad_norm"][1:]):
        check(abs(a - b) <= TPT_LATER[0] and rel(g, h) <= TPT_LATER[1],
              f"{what}: a later step's loss {a} / grad_norm {g} vs "
              f"{b} / {h} beyond {TPT_LATER}")
    sk0, sk1, w0, w1 = rec["whole0"], rec["whole1"], want["whole0"], \
        want["whole1"]
    worst = {"m": 0.0, "p": 0.0, "cos": 1.0, "f32": (0.0, ""),
             "ratio": (0.0, ""), "one": (0.0, "")}
    for path, wv in w1.items():
        if path.startswith("['opt']['m']"):
            r = sketch_rel(sk1[path], wv)
            worst["m"] = max(worst["m"], r)
            check(r <= TPT_M_REL, f"{what}: first moment {path} {r:.4f} "
                  f"of its norm from one device's (> {TPT_M_REL})")
            mine, one = (sketch_rel(x, truth[path]) for x in (sk1[path], wv))
            worst["f32"] = max(worst["f32"], (mine, path))
            worst["ratio"] = max(worst["ratio"], (mine / max(one, 1e-30),
                                                  path))
            worst["one"] = max(worst["one"], (one, path))
        else:
            upd = wv - w0[path]
            if not np.any(upd):
                continue
            d = sk1[path] - sk0[path]
            r = float(np.sqrt(np.mean((sk1[path] - wv) ** 2)) /
                      np.sqrt(np.mean(upd ** 2)))
            cos = float(d @ upd / (np.linalg.norm(d) * np.linalg.norm(upd)))
            worst["p"], worst["cos"] = max(worst["p"], r), min(worst["cos"],
                                                               cos)
            check(r < TPT_P_REL and cos >= TPT_P_COS, f"{what}: param {path} "
                  f"{r:.4f} of its update from one device's (limit "
                  f"{TPT_P_REL}), cosine {cos:.4f} (limit {TPT_P_COS})")
    la, n = rec["launches"], len(rec["ms"])
    check(la["fwd"] == 2 * n_layers * n and la["bwd_dkv"] == n_layers * n
          and la["bwd_dq"] == n_layers * n,
          f"{what}: flash launches {la} != {2 * n_layers}/{n_layers}/"
          f"{n_layers} a step")
    return worst


def _tpt_wholes(recs: list) -> None:
    """Each run's whole sketches (before and after step 1) from its ranks'
    (or the one device's) pieces, set on every record."""
    w0 = whole_sketch([r["sk0"] for r in recs])
    w1 = whole_sketch([r["sk1"] for r in recs])
    for r in recs:
        r["whole0"], r["whole1"] = w0, w1


def tpt_control_line(one, two, truth, card) -> str:
    """How far apart two one-device bf16 F+R steps lie after step 1 (the
    whole batch, and grad_accum 2: the same function, other roundings),
    by their first moments' sketches, and each from the f32 step's."""
    far = lambda a, b: max((sketch_rel(a[p], b[p]), p) for p in truth)
    apart, path = far(two["whole1"], one["whole1"])
    return (f"[tp-train] control: two one-device bf16 F+R steps (grad_accum "
            f"1 and 2) lie up to {apart:.4f} of a first moment's norm apart "
            f"after step 1 ({path}); from the f32 step's up to "
            f"{far(one['whole1'], truth)[0]:.4f} and "
            f"{far(two['whole1'], truth)[0]:.4f} (sketched); {card}")


def _tpt_line(what, rec, want, worst, f32_norm, card) -> str:
    n = len(rec["ms"])
    ms = sum(rec["ms"][1:])
    sn, ss = (sum(c[i] for c in rec["seam"][1:]) for i in (0, 1))
    cn, cs = (sum(c[i] for c in rec["coll"][1:]) for i in (0, 1))
    la = rec["launches"]
    f32 = (f"from the f32 step's up to {worst['f32'][0]:.4f} "
           f"({worst['f32'][1]}), at most {worst['ratio'][0]:.2f}x the "
           f"one-device bf16 step's distance ({worst['ratio'][1]}), that "
           f"step's own largest {worst['one'][0]:.4f} ({worst['one'][1]})")
    return (f"[tp-train] {what} on {rec['device']}: step-1 loss "
            f"{rec['loss_f'][0]:.6f} (one device {want['loss_f'][0]:.6f}), "
            f"grad_norm {rec['grad_norm'][0]:.6f} (one device "
            f"{want['grad_norm'][0]:.6f}, the f32 step's {f32_norm:.6f}"
            f"); after step 1 first moments within {worst['m']:.4f} of "
            f"one device's ({f32}), params within {worst['p']:.4f} of their "
            f"update "
            f"(cosine >= {worst['cos']:.4f}) (sketched); peak "
            f"{rec['peak_gib']:.2f} GiB (one device {want['peak_gib']:.2f}); "
            f"state at rest {rec['at_rest']['card'] / 1e9:.3f} GB on the "
            f"card (one device {want['at_rest']['card'] / 1e9:.3f}); "
            f"{ms / max(n - 1, 1):.1f} ms a step after the first (one "
            f"device {sum(want['ms'][1:]) / max(n - 1, 1):.1f}), "
            f"{sn / max(n - 1, 1):.0f} seam collectives a step "
            f"({ss * 1e3 / max(sn, 1):.2f} ms each, "
            f"{ss * 1e3 / max(ms, 1e-9) * 100:.1f}% of the step) and "
            f"{cn / max(n - 1, 1):.0f} step collectives "
            f"({cs * 1e3 / max(cn, 1):.2f} ms each, "
            f"{cs * 1e3 / max(ms, 1e-9) * 100:.1f}%), host-staged (gloo); "
            f"launches fwd {la['fwd']}, bwd {la['bwd_dkv']} + "
            f"{la['bwd_dq']}, RMSNorm {la['rmsnorm']}; {card}")


def check_seq_ranks(recs, oracle, refs, n_layers, norms, total, card,
                    run, ce=True) -> None:
    """A sequence-mode run of phase 30 (``run`` names it; ``recs`` in
    global rank order, model rank g % TPT_DEGREE) against its one-device
    step at the same limits: each rank in sequence mode, the ranks'
    losses alike, RMSNorm as one device launches it, and every flash
    launch at the rank's own q_offset (its first row, r x T/2): two
    forwards (the recomputation's) and one of each backward kernel an
    attention layer a step, on all 16 heads (the attention leaves are
    whole on every rank); one k/v gather a forward and one f32 sum of the
    k/v cotangents a backward. Prints each rank's readings with its k/v
    collectives and its flash us."""
    t = DP_SHAPE["t"]
    for g, rec in enumerate(recs):
        r = g % TPT_DEGREE
        what = f"{run}, rank {g}"
        check(rec["mode"] == "seq", f"{what}: the context is in "
              f"{rec['mode']} mode")
        check(rec["loss"] == recs[0]["loss"],
              f"{what}: losses differ between the ranks")
        worst = tpt_check(what, rec, oracle, n_layers, refs["truth"], ce=ce)
        check(rec["launches"]["rmsnorm"] == norms * TPT_STEPS,
              f"{what}: RMSNorm launches {rec['launches']['rmsnorm']} != "
              f"{norms} a step")
        lo = r * t // TPT_DEGREE
        n = n_layers * TPT_STEPS
        want = {("fwd", lo): 2 * n, ("bwd_dq", lo): n, ("bwd_dkv", lo): n}
        check(rec["offsets"] == want, f"{what}: flash launches by "
              f"(kernel, q_offset) {rec['offsets']} != {want}")
        steps = len(rec["ms"])
        kn = [c[0] for c in rec["kv"]]
        check(kn == [3 * n_layers] * steps, f"{what}: k/v collectives a "
              f"step {kn} != {3 * n_layers}")
        add_counts(total, rec["launches"])
        for key, kernel in (("offset_fwd", "fwd"), ("offset_bwd", "bwd_dkv")):
            total[key] = total.get(key, 0) + sum(
                v for (k, o), v in rec["offsets"].items()
                if k == kernel and o > 0)
        ms = sum(rec["ms"][1:])
        ks = sum(c[1] for c in rec["kv"][1:])
        kc = sum(c[0] for c in rec["kv"][1:])
        fwd_us, bwd_us = rec["flash_us"]
        print(_tpt_line(what, rec, oracle, worst, refs["norm"], card)
              + f"; k/v: {kc // max(steps - 1, 1)} collectives a step (a "
              f"gather a forward, again in the recomputation, and an f32 "
              f"sum of the cotangents a backward, an attention layer), "
              f"{ks * 1e3 / max(kc, 1):.2f} ms each, "
              f"{ks * 1e3 / max(ms, 1e-9) * 100:.1f}% of the step, "
              f"host-staged (gloo); flash at q_offset {lo} over "
              f"{lo + t // TPT_DEGREE} keys: fwd {fwd_us:.1f} us, bwd "
              f"(f32 dK/dV) {bwd_us:.1f} us")
    (f0, b0), (f1, b1) = recs[0]["flash_us"], recs[-1]["flash_us"]
    print(f"[tp-train] sequence mode: the last rank's flash fwd+bwd "
          f"{f1 + b1:.1f} us against rank 0's {f0 + b0:.1f} us "
          f"({(f1 + b1) / (f0 + b0):.2f}x: causal work on a contiguous T "
          f"split is uneven); {card}")


def phase_tp_train() -> dict:
    """Phase 30: tensor-parallel training on card 0, ranks over gloo.
    (A) qwen1.5-0.5b at full width, F+R, 2 steps of 4 x 2048 at TP = 2,
    sequence parallelism off then on, then the attention in sequence
    (context-parallel) mode with sp off (:func:`check_seq_ranks`), in
    one spawn, against the
    one-device F+R run on the same batches (this process) at the CPU
    cases' limits (beside them each run's distance from the f32 step's,
    and a control, one device at grad_accum 2: how far two one-device
    bf16 steps lie apart); teacher forced, each head-mode run's
    step-1 loss must equal the one-device forward in TP = 2's order of
    sums bit for bit. (B) the
    (2, 2) mesh, 4 ranks, F+R+Z3 with sequence parallelism, in head mode
    and then in sequence mode, qwen cut to TPT_MESH_LAYERS of its 24
    layers, against one device at grad_accum 2. Every rank
    must launch the flash kernels (in head mode on its H/2 heads, in
    sequence mode on all H at its q_offset) twice and once an
    attention layer a step and RMSNorm as the one-device step does.
    Prints per rank peak memory and state at rest against one device,
    the seams' and the step's collectives a step, ms each and their share
    of the step (host-staged), and the launches. Returns the ranks'
    launches."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_ranks
    t0 = time.monotonic()
    card = card_line()
    cfg = get_config("qwen1.5-0.5b")
    batches = dp_batches(cfg, TPT_STEPS)
    refs = tpt_refs(batches)
    emulated, truth = refs["emulated"], refs["truth"]
    oracle = tpt_run(None, "F+R", False, batches)
    accum2 = tpt_run(None, "F+R", False, batches, 2)
    _tpt_wholes([oracle])
    _tpt_wholes([accum2])
    print(tpt_control_line(oracle, accum2, truth, card))
    del accum2
    total = {}
    runs = [("F+R", sp, batches) for sp in (False, True)]
    runs.append(("F+R", False, batches, 1, None, "seq"))
    ranks = spawn_ranks(tpt_rank_runs, TPT_DEGREE, backend="gloo",
                        args=(runs,))
    norms = norms_per_train_step(cfg, DP_SHAPE["t"], remat=True)
    for i, sp in enumerate((False, True)):
        recs = [rr[i] for rr in ranks]
        _tpt_wholes(recs)
        for r, rec in enumerate(recs):
            what = (f"qwen1.5-0.5b F+R{' +sp' if sp else ''} at TP = "
                    f"{TPT_DEGREE}, rank {r}")
            check(rec["loss"] == recs[0]["loss"],
                  f"{what}: losses differ between the ranks")
            check(rec["loss"][0] == emulated[sp],
                  f"{what}: step-1 loss {rec['loss_f'][0]!r} != the one-"
                  f"device forward in TP = 2's order of sums (bits "
                  f"{rec['loss'][0]:#x} vs {emulated[sp]:#x})")
            worst = tpt_check(what, rec, oracle, cfg.n_layers, truth)
            check(rec["launches"]["rmsnorm"] == norms * TPT_STEPS,
                  f"{what}: RMSNorm launches {rec['launches']['rmsnorm']} "
                  f"!= {norms} a step")
            add_counts(total, rec["launches"])
            print(_tpt_line(what, rec, oracle, worst, refs["norm"], card) +
                  "; step-1 loss == the one-device forward in TP = 2's "
                  "order of sums bit for bit")
    seq = [rr[2] for rr in ranks]
    _tpt_wholes(seq)
    check_seq_ranks(seq, oracle, refs, cfg.n_layers, norms, total, card,
                    f"qwen1.5-0.5b F+R attn_mode=seq at TP = {TPT_DEGREE}")
    t1 = time.monotonic()
    small = dataclasses.replace(cfg, n_layers=TPT_MESH_LAYERS)
    refs_b = tpt_refs(batches, TPT_MESH_LAYERS, emulate=False)
    oracle_b = tpt_run(None, "F+R", False, batches, 2, TPT_MESH_LAYERS)
    _tpt_wholes([oracle_b])
    ranks = spawn_ranks(tpt_rank_runs, TPT_DEGREE, data=2, backend="gloo",
                        args=([("F+R+Z3", True, batches, 1,
                                TPT_MESH_LAYERS),
                               ("F+R+Z3", True, batches, 1,
                                TPT_MESH_LAYERS, "seq")],))
    recs = [rr[0] for rr in ranks]
    _tpt_wholes(recs)
    norms = norms_per_train_step(small, DP_SHAPE["t"], remat=True)
    for g, rec in enumerate(recs):
        what = (f"qwen1.5-0.5b ({TPT_MESH_LAYERS} of 24 layers) F+R+Z3 +sp "
                f"on the (2 data x 2 model) mesh, rank {g}")
        check(rec["loss"] == recs[0]["loss"],
              f"{what}: losses differ between the ranks")
        worst = tpt_check(what, rec, oracle_b, TPT_MESH_LAYERS,
                          refs_b["truth"], ce=False)
        check(rec["launches"]["rmsnorm"] == norms * TPT_STEPS,
              f"{what}: RMSNorm launches {rec['launches']['rmsnorm']} != "
              f"{norms} a step")
        add_counts(total, rec["launches"])
        print(_tpt_line(what, rec, oracle_b, worst, refs_b["norm"], card) +
              " (one device: grad_accum 2)")
    seq = [rr[1] for rr in ranks]
    _tpt_wholes(seq)
    check_seq_ranks(seq, oracle_b, refs_b, TPT_MESH_LAYERS, norms, total,
                    card, f"qwen1.5-0.5b ({TPT_MESH_LAYERS} of 24 layers) "
                    f"F+R+Z3 +sp attn_mode=seq on the (2 data x 2 model) "
                    f"mesh", ce=False)
    RMSNORM_RUNS["tensor-parallel ranks (phase 30)"] = total["rmsnorm"]
    print(f"[tp-train] phase 30 launches over the ranks' runs: " + ", ".join(
        f"{k} {v}" for k, v in total.items()) + f"; (A) took "
        f"{t1 - t0:.1f}s, (B) {time.monotonic() - t1:.1f}s; phase 30 took "
        f"{time.monotonic() - t0:.1f}s")
    return total


# phase 31: qwen1.5-0.5b's 24 layers as 2 pipeline stages of 12, forward
# only, over 8 microbatches of 1 x 2048 tokens
PIPE_STAGES = 2
PIPE_MICRO = 8
PIPE_T = 2048


def pipe_setup(dev):
    """Phase 31's model (qwen1.5-0.5b at full width, seeded, the flash
    kernels: ``F``), its stacked layer params, its stage function (the
    layers of a stage in turn, forward only) and the embedded
    microbatches (PIPE_MICRO, 1, PIPE_T, d_model) of seeded tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.config import technique_from_label
    from repro_torch.launch.build import make_model
    from repro_torch.models.params import tree_paths, tree_unstack
    cfg = get_config("qwen1.5-0.5b")
    model = make_model(cfg, technique_from_label("F"), device=dev)
    params = model.init(0)
    g = torch.Generator().manual_seed(31)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, 1, PIPE_T),
                           generator=g).to(dev)
    positions = torch.arange(PIPE_T, device=dev)[None, :]

    def stage_fn(p, x):
        n = tree_paths(p)[0][1].shape[0]
        for lp in tree_unstack(p, n):
            x, _ = model._layer(x, lp, positions, 0)
        return x

    with torch.no_grad():
        x = torch.stack([model._embed_in(params, tokens[m], None)
                         for m in range(PIPE_MICRO)])
    return model, params["blocks"]["pos0"], stage_fn, x


def _sha(t) -> str:
    import hashlib
    import torch
    return hashlib.sha256(t.detach().contiguous().view(torch.int16).cpu()
                          .numpy().tobytes()).hexdigest()


def pipe_rank_run(mesh):
    """Phase 31 on one rank: the GPipe forward over the model axis
    (``parallel.pipeline``), its launches counted from 0, each stage run
    ("tick") and ring shift ("shift") timed between two synchronizes.
    Returns the outputs' digest, the launches, the flash launches by
    q_offset, the timer's records, the forward's ms and peak memory."""
    import torch
    from repro_torch.core.perfscope import Timer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.parallel import pipeline as PP
    dev = mesh.device
    model, stacked, stage_fn, x = pipe_setup(dev)
    timer = Timer()
    fwd = PP.pipeline_forward(mesh, "model", stage_fn, PIPE_MICRO,
                              timer=timer)
    stages = PP.split_stages(stacked, PIPE_STAGES)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    slice_counts(reset=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        out = fwd(stages, x)
    torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t0) * 1e3
    return {"sha": _sha(out), "launches": slice_counts(),
            "offsets": dict(fa.OFFSETS), "records": dict(timer.records),
            "ms": ms, "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "finite": bool(torch.isfinite(out).all()),
            "shape": tuple(out.shape)}


def phase_pipeline() -> dict:
    """Phase 31: the GPipe pipeline (``parallel.pipeline``) on card 0,
    two ranks over gloo, qwen1.5-0.5b's 24 layers at full width as 2
    stages of 12, forward only, 8 microbatches of 1 x 2048: its outputs
    on both ranks equal bit for bit the one-device forward of the same
    24 layers on each microbatch (this process). Every rank runs its
    stage each of the M + S - 1 ticks (the bubble's on zeros): flash
    forward and 2 RMSNorms a layer a tick, at q_offset 0. Prints the
    bubble fraction, ms a tick and a ring shift, and the forward's ms
    against one device's. Returns the ranks' launches."""
    import torch
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.parallel import pipeline as PP
    t0 = time.monotonic()
    card = card_line()
    ranks = spawn_ranks(pipe_rank_run, PIPE_STAGES, backend="gloo")
    model, stacked, stage_fn, x = pipe_setup("cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.no_grad():
        want = torch.stack([stage_fn(stacked, x[m])
                            for m in range(PIPE_MICRO)])
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t1) * 1e3
    want_sha = _sha(want)
    check(bool(torch.isfinite(want).all()), "phase 31: the one-device "
          "forward is not finite")
    del model, stacked, x, want
    free_card()
    ticks = PIPE_MICRO + PIPE_STAGES - 1
    per_stage = get_cfg_layers("qwen1.5-0.5b") // PIPE_STAGES
    total = {}
    for r, rec in enumerate(ranks):
        what = f"phase 31 pipeline rank {r}"
        check(rec["finite"] and rec["sha"] == want_sha,
              f"{what}: outputs {rec['shape']} differ from the one-device "
              f"forward of the same layers (digest {rec['sha'][:12]} vs "
              f"{want_sha[:12]})")
        la = rec["launches"]
        check(la["fwd"] == per_stage * ticks and
              la["bwd_dkv"] == la["bwd_dq"] == 0 and
              rec["offsets"] == {("fwd", 0): per_stage * ticks},
              f"{what}: flash launches {la} / {rec['offsets']} != "
              f"{per_stage} a tick over {ticks} ticks at q_offset 0")
        check(la["rmsnorm"] == 2 * per_stage * ticks,
              f"{what}: RMSNorm launches {la['rmsnorm']} != "
              f"{2 * per_stage * ticks}")
        add_counts(total, la)
        tick, shift = rec["records"]["tick"], rec["records"]["shift"]
        print(f"[pipeline] rank {r} (stage {r}: layers "
              f"{r * per_stage}-{(r + 1) * per_stage - 1}) on card 0: "
              f"outputs == the one-device forward bit for bit; {ticks} "
              f"ticks, {sum(tick) / len(tick) * 1e3:.2f} ms a tick (a "
              f"stage's {per_stage} layers on 1 x {PIPE_T}), "
              f"{len(shift)} ring shifts of {sum(shift) / len(shift) * 1e3:.2f} "
              f"ms each (host-staged, gloo), the forward "
              f"{rec['ms']:.1f} ms (one device {one_ms:.1f} ms for the "
              f"{PIPE_MICRO} microbatches); peak {rec['peak_gib']:.2f} GiB; "
              f"launches fwd {la['fwd']}, RMSNorm {la['rmsnorm']}; {card}")
    RMSNORM_RUNS["pipeline ranks (phase 31)"] = total["rmsnorm"]
    print(f"[pipeline] phase 31: bubble fraction "
          f"{PP.bubble_fraction(PIPE_MICRO, PIPE_STAGES):.4f} "
          f"(({PIPE_STAGES} - 1) / ({PIPE_MICRO} + {PIPE_STAGES} - 1)); "
          f"took {time.monotonic() - t0:.1f}s")
    return total


# llama2-7b and llama2-13b serve at full width cut to 16 of their 32 and
# 20 of their 40 layers since the script needed room for phase 30; the
# training slice's llama2-7b (phase 24 (a)) trains 16 of its 32
LLAMA7_LAYERS = 16
LLAMA13_LAYERS = 20


# --------------------------------------------------------------------------
# phase 32: tensor-parallel training of the MoE and hybrid families
# (expert parallelism's backward, the Mamba-2 block's seams under autograd)
# --------------------------------------------------------------------------

TPF_DEGREE = 2
TPF_STEPS = 2
# (A) qwen3-moe-30b-a3b cut to 2 of its 48 layers on phase 28's 4 x 2048
# global batch; (B) jamba-v0.1-52b cut to 2 layers (attention + its dense
# FFN, Mamba-2 + the MoE FFN: widths untouched) on 2 x 2048
TPF_RUNS = {"qwen3-moe-30b-a3b": dict(b=4, layers=dict(n_layers=2)),
            "jamba-v0.1-52b": dict(b=2, layers=dict(
                n_layers=2, attn_period=2, attn_offset=0, moe_every=2,
                moe_offset=1))}
# the load-balancing loss against the one device's t-slices' mean: each
# is an f32 mean of softmax gates of a product of bf16 hidden states,
# which TP rounds in other places. Readings (H100 80GB HBM3, 700 W):
# 1.2e-5 (qwen3-moe), 5.6e-6 (jamba); what a rank reports without the
# mean over the axis (its own t-slice's loss) lies 1.9% (qwen3-moe) and
# 3.9% (jamba) from it, and the phase checks that it lies beyond
TPF_AUX_RTOL = 5e-5
# the ranks take the one device's experts in step 1 where a near tie
# flips an expert set: at most this share of a rank's (token, call) pairs
# (readings on that card: qwen3-moe 1.32% and 0.98%, 8 of 128 experts a
# token; jamba 0.39% and 0.49%), and each forced expert's gate at most
# this far below the token's own k-th gate, relative to it (readings:
# up to 0.011)
TPF_FLIP_SHARE = 0.03
TPF_TIE_GAP = 0.03


def tpf_config(name):
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), **TPF_RUNS[name]["layers"])


@contextlib.contextmanager
def tpf_counted(drops: list, parts: int = 0, slices: list = None):
    """Every MoE call's dropped assignments added into ``drops`` (one
    device tensor: no sync). With ``parts``, the one-device dispatch runs
    as ``parts`` model ranks route (``blocks._moe_local`` on each t-slice
    of the batch's rows at that slice's own capacity, the load-balancing
    loss the slices' mean: the reference's per-shard expert-parallel
    semantics), so the one device drops what the ranks drop; ``slices``
    gains each call's slices' losses (a stacked device tensor)."""
    import torch
    from repro_torch.models import blocks as B
    slots, local = B._slots, B._moe_local

    def counted(top_e, e, cap, ctx=None):
        slot, keep = (slots(top_e, e, cap) if ctx is None else
                      slots(top_e, e, cap, ctx))
        if not drops:
            drops.append(torch.zeros((), dtype=torch.int64,
                                     device=keep.device))
        drops[0] += (~keep).sum()
        return slot, keep

    def sliced(h, p, cfg, capacity_mult, ctx=None):
        w = h.shape[1] // parts
        outs = [local(h[:, r * w:(r + 1) * w], p, cfg, capacity_mult)
                for r in range(parts)]
        if slices is not None:
            slices.append(torch.stack([a.detach() for _, a in outs]))
        return (torch.cat([o for o, _ in outs], 1),
                sum(a for _, a in outs) / parts)

    B._slots = counted
    if parts:
        B._moe_local = sliced
    try:
        yield
    finally:
        B._slots, B._moe_local = slots, local


def tpf_run(mesh, name, sp, mode, batches, routes=None):
    """One run of phase 32: ``name`` (:func:`tpf_config`) F+R seeded on
    this rank's card (one device when ``mesh`` is None: its MoE dispatch
    per t-slice as the ranks route, :func:`tpf_counted`, each step's
    experts recorded), sequence parallelism ``sp``, attention mode
    ``mode``, on a rank the first step routed as the one device routed
    (``routes``: the one device's records, :func:`forced_routes`, as the
    CPU tests force the first step only); the launch counts set to 0,
    each step fenced, each exchange, seam and step collective timed
    between two synchronizes. Returns the per-step loss, ce, aux,
    grad_norm, ms and dropped assignments, the collectives' counts and
    seconds by region, the exchange's bytes, the routes and each t-slice's
    summed load-balancing loss of step 1 (one device) or the forced
    tokens and their largest gate gap (a rank), the launches (the split
    norm's partial-sum pass too), peak memory, the state at rest and the
    sketches of the params before step 1 and of the params and first
    moments after it."""
    import dataclasses
    import torch
    from repro_torch.core.config import technique_from_label
    from repro_torch.core.perfscope import Timer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.build import make_model
    from repro_torch.parallel.sharding import make_shard_ctx
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (DPLayout, build_train_step,
                                        init_train_state)
    cfg = tpf_config(name)
    tech = dataclasses.replace(technique_from_label("F+R"), sp=sp,
                               attn_mode=mode)
    ctx = make_shard_ctx(cfg, tech, mesh) if mesh is not None else None
    dev = mesh.device if mesh is not None else torch.device("cuda")
    model = make_model(cfg, tech, device=dev, ctx=ctx)
    opt = AdamWConfig(lr=DP_LR, warmup=0)
    state, _ = init_train_state(model, tech, 0, opt, ctx=ctx)
    lay = DPLayout(model, tech, ctx) if ctx is not None else None
    regions = ("exchange", "seam", "collective", "kv")
    rec = {k: [] for k in ("loss_f", "ce", "aux", "grad_norm", "ms",
                           "xbytes", "routes", "flips", "gaps",
                           "drops") + regions}
    rec["mode"] = ctx.attn_mode if ctx is not None else None
    rec["sk0"] = leaf_sketch({"params": state["params"]}, lay, ctx, dev)
    step = build_train_step(model, tech, opt, ctx=ctx)
    timer = Timer()
    if ctx is not None:
        ctx.comm_timer = timer
    free_card()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    slice_counts(reset=True)
    drops, slices = [], []
    with tpf_counted(drops, TPF_DEGREE if ctx is None else 0, slices):
        for i, b in enumerate(batches):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            n0 = {k: (len(timer.records[k]), sum(timer.records[k]))
                  for k in regions}
            x0 = ctx.exchange_bytes if ctx is not None else 0
            calls, flips, gaps = [], [], []
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with (recorded_routes(calls) if ctx is None else
                  forced_routes(routes, flips, gaps) if i == 0 else
                  contextlib.nullcontext()):
                state, met = step(state, batch)
            torch.cuda.synchronize(dev)
            rec["ms"].append((time.perf_counter() - t0) * 1e3)
            if i == 0 and ctx is None:
                rec["routes"] = [c.cpu().numpy() for c in calls]
                n_moe = cfg.ffn_kinds().count("moe")
                rec["slice_aux"] = [float(a) for a in sum(slices[:n_moe])]
            rec["flips"].append(sum(flips))
            rec["gaps"].append(max(gaps, default=0.0))
            rec["drops"].append(int(drops[0]) - sum(rec["drops"])
                                if drops else 0)
            for k in regions:
                rec[k].append((len(timer.records[k]) - n0[k][0],
                               sum(timer.records[k]) - n0[k][1]))
            rec["xbytes"].append((ctx.exchange_bytes - x0) if ctx else 0)
            for k in ("ce", "aux", "grad_norm"):
                rec[k].append(float(met[k]))
            rec["loss_f"].append(float(met["loss"]))
            if i == 0:
                rec["sk1"] = leaf_sketch({"params": state["params"],
                                          "opt": {"m": state["opt"]["m"]}},
                                         lay, ctx, dev)
    rec["coll"] = rec["collective"]
    rec["launches"] = slice_counts()
    rec["launches"]["rmsnorm_sumsq"] = rn.LAUNCHES["rmsnorm_sumsq"]
    for key, kernel in (("offset_fwd", "fwd"), ("offset_bwd", "bwd_dkv")):
        rec["launches"][key] = sum(v for (k, o), v in fa.OFFSETS.items()
                                   if k == kernel and o > 0)
    rec["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if ctx is not None:
        ctx.comm_timer = None
    buf = getattr(step, "grad_buffer", {})
    rec["at_rest"] = state_bytes(state, buf.values())
    rec["device"] = str(dev)
    del state, step, model
    free_card()
    return rec


def tpf_rank_runs(mesh, runs):
    """Phase 32's runs of one part in turn on one set of ranks."""
    return [tpf_run(mesh, *run) for run in runs]


def tpf_truth(name, batches) -> dict:
    """The f32 step's first moments of phase 32's ``name``: 0.1 x the
    gradient of the seeded params taken in f32 on the first batch, the
    MoE dispatch per t-slice (:func:`tpf_counted`), sketched
    (``"truth"``), and that gradient's norm (``"norm"``)."""
    import torch
    from repro_torch.core.config import technique_from_label
    from repro_torch.launch.build import make_model
    from repro_torch.models.params import keystr_map, keystr_paths
    cfg = tpf_config(name)
    model = make_model(cfg, technique_from_label("F+R"), device="cuda")
    params = keystr_map(lambda p, t: t.float().requires_grad_(True),
                        model.init(0))
    b = {k: torch.from_numpy(v).to("cuda") for k, v in batches[0].items()}
    paths = keystr_paths(params)
    with tpf_counted([], TPF_DEGREE):
        loss, _ = model.loss(params, b)       # (the recomputation too)
        grads = dict(zip([p for p, _ in paths], torch.autograd.grad(
            loss, [t for _, t in paths])))
    del loss
    # the sketch is linear: 0.1 x the gradient's
    out = {"truth": {p: 0.1 * v for p, (_, v) in leaf_sketch(
               {"opt": {"m": keystr_map(lambda p, t: grads[p], params)}}
           ).items()},
           "norm": float(torch.sqrt(sum(torch.sum(torch.square(g))
                                        for g in grads.values())))}
    del params, grads, model
    free_card()
    return out


def tpf_check(what, rec, want, cfg, truth, card, rows: int) -> dict:
    """One rank's run of phase 32 against the one-device run: ce, loss
    and aux, grad_norm, the later steps and, after step 1, the sketched
    first moments and params (:func:`tpt_check`'s limits); the flash
    launches (twice and once an attention layer a step), the split
    norm's passes (the partial-sum pass twice a Mamba-2 layer a step,
    the forward and its recomputation) and RMSNorm as one device; the
    step-1 tokens forced to the one device's experts (``rows`` x 2048 a
    step) few and each a near tie. Prints the readings; returns the
    launches."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    for key, tol in (("ce", TPT_LOSS_RTOL), ("aux", TPF_AUX_RTOL)):
        check(rel(rec[key][0], want[key][0]) <= tol,
              f"{what}: step-1 {key} {rec[key][0]} vs one device "
              f"{want[key][0]} beyond rtol {tol}")
    pairs = (rows * DP_SHAPE["t"] // TPF_DEGREE * 2
             * cfg.ffn_kinds().count("moe"))
    check(rec["flips"][0] <= TPF_FLIP_SHARE * pairs and
          rec["gaps"][0] <= TPF_TIE_GAP,
          f"{what}: {rec['flips'][0]} of {pairs} (token, call) pairs routed "
          f"to the one device's experts in step 1 (limit "
          f"{TPF_FLIP_SHARE:.0%}), a forced gate up to {rec['gaps'][0]:.3g} "
          f"below the token's own k-th (limit {TPF_TIE_GAP})")
    n_attn = cfg.layer_kinds().count("attn")
    n_ssm = cfg.layer_kinds().count("ssm")
    worst = tpt_check(what, rec, want, n_attn, truth["truth"])
    la, steps = rec["launches"], len(rec["ms"])
    check(la["rmsnorm"] == want["launches"]["rmsnorm"],
          f"{what}: RMSNorm launches {la['rmsnorm']} != one device's "
          f"{want['launches']['rmsnorm']}")
    check(la["rmsnorm_sumsq"] == 2 * n_ssm * steps,
          f"{what}: split norm partial-sum passes {la['rmsnorm_sumsq']} != "
          f"{2 * n_ssm} a step")
    n1 = max(steps - 1, 1)
    ms = sum(rec["ms"][1:])
    parts = []
    for k in ("exchange", "seam", "collective", "kv"):
        cn = sum(c[0] for c in rec[k][1:])
        cs = sum(c[1] for c in rec[k][1:])
        if cn:
            parts.append(f"{k} {cn / n1:.0f} a step, {cs * 1e3 / n1:.1f} ms "
                         f"({cs * 1e3 / max(ms, 1e-9) * 100:.1f}%)")
    print(_tpt_line(what, rec, want, worst, truth["norm"], card)
          + f"; aux {rec['aux'][0]:.6f} (one device's t-slices "
          f"{want['aux'][0]:.6f}), ce {rec['ce'][0]:.6f} (one device "
          f"{want['ce'][0]:.6f}); collectives: " + "; ".join(parts)
          + f"; the exchange carried "
          f"{sum(rec['xbytes'][1:]) / n1 / 2 ** 20:.1f} MiB a step; "
          f"split-norm partial-sum passes {la['rmsnorm_sumsq']}; "
          f"assignments dropped by step {rec['drops']}; step 1 routed "
          f"{rec['flips'][0]} of {pairs} (token, call) pairs "
          f"({rec['flips'][0] / pairs:.2%}) to the one device's experts, a "
          f"forced gate up to {rec['gaps'][0]:.3g} below the token's own "
          f"k-th; step 2 unforced")
    return la


def phase_tp_families() -> dict:
    """Phase 32: tensor-parallel training of the MoE and hybrid families on
    card 0, ranks over gloo. (A) qwen3-moe-30b-a3b at full width cut to 2
    of its 48 layers, F+R at TP = 2 (expert parallelism, 64 experts a
    rank), 2 steps of 4 x 2048, head mode with sp off, then on, then
    sequence mode, in one spawn. (B) jamba-v0.1-52b at full width cut to 2
    layers (attention and its dense FFN, a Mamba-2 layer and the 16-expert
    MoE FFN), F+R at TP = 2 (8 experts and 64 SSD heads a rank), 2 steps
    of 2 x 2048. Each against the one-device F+R step on the same batches
    (run first, in this process, and freed before the ranks start), which
    dispatches each t-slice at its own capacity as a rank does (the
    training multiplier, 1.0; :func:`tpf_counted`) and whose routes the
    ranks take in step 1 (:func:`forced_routes`), so both drop the same
    assignments there (:func:`tpf_check`). Returns the ranks' launches."""
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models import lm
    t0 = time.monotonic()
    card = card_line()
    total: dict = {}
    spans = []
    for name, run in TPF_RUNS.items():
        t1 = time.monotonic()
        cfg = tpf_config(name)
        batches = dp_batches(cfg, TPF_STEPS, run["b"])
        truth = tpf_truth(name, batches)
        oracle = tpf_run(None, name, False, "auto", batches)
        _tpt_wholes([oracle])
        routes = oracle.pop("routes")
        own_slice = max(abs(a - oracle["aux"][0]) for a in
                        oracle["slice_aux"]) / oracle["aux"][0]
        check(own_slice > TPF_AUX_RTOL, f"{name}: a rank's own t-slice "
              f"load-balancing loss lies {own_slice:.3g} from the mean, "
              f"within the limit {TPF_AUX_RTOL}")
        modes = ([(False, "head"), (True, "head"), (False, "seq")]
                 if name.startswith("qwen3") else [(False, "head")])
        print(f"[tp-families] {name} ({cfg.n_layers} of "
              f"{get_cfg_layers(name)} layers, full width) at TP = "
              f"{TPF_DEGREE}, capacity multiplier "
              f"{lm.CAPACITY_MULT['train']} (training's), each t-slice at "
              f"its own capacity: one device dropped {oracle['drops']} "
              f"assignments by step; its t-slices' load-balancing losses "
              f"{', '.join(f'{a:.6f}' for a in oracle['slice_aux'])} "
              f"(mean {oracle['aux'][0]:.6f}: a slice's own lies up to "
              f"{own_slice:.3g} from it, limit {TPF_AUX_RTOL}); one device "
              f"peak "
              f"{oracle['peak_gib']:.2f} GiB, state at rest "
              f"{oracle['at_rest']['card'] / 1e9:.3f} GB, "
              f"{sum(oracle['ms'][1:]) / max(TPF_STEPS - 1, 1):.1f} ms a "
              f"step after the first; {card}")
        ranks = spawn_ranks(tpf_rank_runs, TPF_DEGREE, backend="gloo",
                            args=([(name, sp, mode, batches, routes)
                                   for sp, mode in modes],))
        for i, (sp, mode) in enumerate(modes):
            recs = [rr[i] for rr in ranks]
            _tpt_wholes(recs)
            check(sum(r["drops"][0] for r in recs) == oracle["drops"][0],
                  f"{name} {mode}{' +sp' if sp else ''}: the ranks dropped "
                  f"{[r['drops'][0] for r in recs]} assignments in step 1, "
                  f"one device {oracle['drops'][0]}")
            for r, rec in enumerate(recs):
                what = (f"{name} F+R{' +sp' if sp else ''} attn_mode="
                        f"{mode} at TP = {TPF_DEGREE}, rank {r}")
                check(rec["mode"] == mode, f"{what}: the context is in "
                      f"{rec['mode']} mode")
                check(rec["loss_f"] == recs[0]["loss_f"],
                      f"{what}: losses differ between the ranks")
                add_counts(total, tpf_check(what, rec, oracle, cfg, truth,
                                            card, run["b"]))
        spans.append(f"{name} {time.monotonic() - t1:.1f}s")
    RMSNORM_RUNS["tensor-parallel families (phase 32)"] = total["rmsnorm"]
    print(f"[tp-families] phase 32 launches over the ranks' runs: "
          + ", ".join(f"{k} {v}" for k, v in total.items()) + "; "
          + ", ".join(spans) + f"; phase 32 took "
          f"{time.monotonic() - t0:.1f}s")
    return total


def get_cfg_layers(name) -> int:
    from repro_torch.configs import get_config
    return get_config(name).n_layers


def main() -> None:
    import dataclasses
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

    def mark(what):
        print(f"[time] {what} ended {time.monotonic() - t_start:.1f}s "
              f"after the start")

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
    mark("dense products and the paged read against plain")

    cfg = get_config("qwen1.5-0.5b")
    params = LM(cfg, device="cuda").init(0)
    run_a, run_b = phase_graphs_dense(cfg, params)
    mark("qwen serving")
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
    llama = dataclasses.replace(get_config("llama2-7b"),
                                n_layers=LLAMA7_LAYERS)
    llama_runs = phase_full_width(llama, f"{llama.name} full width, "
                                  f"{LLAMA7_LAYERS} of 32 layers")
    llama13 = dataclasses.replace(get_config("llama2-13b"),
                                  n_layers=LLAMA13_LAYERS)
    llama_runs += phase_full_width(llama13, f"{llama13.name} full width, "
                                   f"{LLAMA13_LAYERS} of 40 layers")
    mark("llama2 serving")
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
    phase_flash_offset()
    mark("flash against plain")
    train_launches, _ = phase_train(get_config("qwen1.5-0.5b"))
    mark("qwen training")
    ft = phase_flash_timing()
    for name, sl in SLICE_FLASH:
        phase_flash_timing(name, sl)
    fo = flash_offset_timing()
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

    # the q_offset forms at phase 30's last sequence-mode rank (q_offset
    # 1024 over 2048 keys); their launches are the main path's at a
    # q_offset above 0, counted after phase 30
    for name, part in (("fwd", "fwd"), ("bwd", "bwd")):
        o = fo[1]
        record["kernels"].append({
            "name": f"flash_attention_{name}_q_offset",
            "route": "cuda",
            "source": flash_src,
            "replaces": f"src/repro/kernels/flash_attention.py:"
                        f"{76 if name == 'fwd' else 203}",
            "launches": 0,
            "max_abs_err": max(o["errs"][e] for e in (
                ("o", "lse") if name == "fwd" else ("dq", "dk", "dv"))),
            "ms": o["ms"][part],
            "plain_ms": o["plain"][part],
            "bound_ms": o["bounds"][part][0],
            "bound_by": o["bounds"][part][1],
            "library_ms": o["lib_fwd"] if name == "fwd" else o["lib_bwd"],
        })

    phase_ssd_vs_plain()
    cfg = get_config("mamba2-130m")
    params = LM(cfg, device="cuda").init(0)
    ssd_launches = phase_graphs_ssm(cfg, params)
    mark("mamba2 serving")
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
    mark("fine-tuning")
    rows, _ = phase_qmm_timing(cfg)
    phase_qmm_timing(get_config("llama2-7b"), QMM_STEP_LLAMA)
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
    rms_split = phase_rmsnorm_split()
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
    mark("rmsnorm, dense decode, speculation")
    life = phase_lifecycle()
    mark("phase 22 lifecycle")
    moe = phase_moe_hybrid()
    mark("phase 23 MoE and hybrid")
    trained = phase_training_slice()
    mark("phase 24 training slice")
    families = phase_families()
    mark("phase 25 families")
    ssm = phase_ssm_decoding()
    mark("phase 26 SSM decoding")
    tp = phase_tp()
    mark("phase 27 TP")
    dp = phase_dp()
    mark("phase 28 DP")
    ep = phase_moe_ranks()
    mark("phase 29 MoE over ranks")
    tpt = phase_tp_train()
    mark("phase 30 TP training")
    pipe = phase_pipeline()
    mark("phase 31 pipeline")
    tpf = phase_tp_families()
    mark("phase 32 TP training of the MoE and hybrid families")
    fam = families["launches"]
    slice_launches = {
        "flash_attention_fwd": (trained["fwd"] + fam["fwd"] + dp["fwd"]
                                + ep["fwd"] + tpt["fwd"] + pipe["fwd"]
                                + tpf["fwd"]),
        "flash_attention_bwd_dkv": (trained["bwd_dkv"] + fam["bwd_dkv"]
                                    + dp["bwd_dkv"] + ep["bwd_dkv"]
                                    + tpt["bwd_dkv"] + tpf["bwd_dkv"]),
        "flash_attention_bwd_dq": (trained["bwd_dq"] + fam["bwd_dq"]
                                   + dp["bwd_dq"] + ep["bwd_dq"]
                                   + tpt["bwd_dq"] + tpf["bwd_dq"]),
        "flash_attention_bwd": (trained["bwd_dkv"] + fam["bwd_dkv"]
                                + dp["bwd_dkv"] + ep["bwd_dkv"]
                                + tpt["bwd_dkv"] + tpf["bwd_dkv"]),
        "int8_matmul": trained["int8_matmul"]}
    for entry in record["kernels"]:
        if entry["name"] == "paged_attention":
            entry["launches"] += (life["paged"] + moe["paged"] + ssm["paged"]
                                  + tp["paged"] + ep["paged"])
        if entry["name"] == "ssd_chunked_kernel":
            entry["launches"] += (life["ssd"] + moe["ssd"] + ssm["ssd"]
                                  + tp["ssd"] + ep["ssd"])
        entry["launches"] += slice_launches.get(entry["name"], 0)
        if entry["name"] == "flash_attention_fwd_q_offset":
            entry["launches"] = tpt["offset_fwd"] + tpf["offset_fwd"]
        if entry["name"] == "flash_attention_bwd_q_offset":
            entry["launches"] = tpt["offset_bwd"] + tpf["offset_bwd"]
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
        "name": "rmsnorm_sumsq",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm.py:24",
        "launches": tp["sumsq"] + ep["sumsq"] + tpf["rmsnorm_sumsq"],
        "max_abs_err": rms_split["max_abs_err"],
        "ms": rms_split["ms"],
        "plain_ms": rms_split["plain_ms"],
        "bound_ms": rms_split["bound_ms"],
        "bound_by": rms_split["bound_by"],
        "library_ms": rms_split["library_ms"],
    })
    record["kernels"].append({
        "name": "dense_decode",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/dense_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:93",
        "launches": (self_draft["dense"] + ngram["dense"]
                     + fam["dense_decode"] + ssm["dense_decode"]),
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
