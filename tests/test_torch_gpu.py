"""The port's CUDA kernels on the card: the paged read against its plain
version, the bitwise T=1 == decode contract and the launch count of an
engine run; the flash-attention kernels (forward, dK/dV, dQ) against
their plain versions, their autograd wrapper against autograd through
naive attention, and their launch counts in a train step; the SSD kernel
against its plain version (with and without a carried state, the chunk
step at its live length, several chunks of state passing), its bodies
(the tensor cores at mamba2's shapes, within twice the FMA body's error)
and its launch count in a mamba2 engine run; the int8 weight-only matmul kernel
against its plain version, its x gradient against autograd through the
plain version, and its launch count in a QL+Q8 fine-tuning step; the
RMSNorm kernel against its plain version, its autograd wrapper against
autograd through the plain version and its launch counts in a train
step; the dense decode kernel against its plain version (also on the
models' strided cache layout); the launch counts of a speculative
engine run (n-gram and self-draft); the tensor-core flash forward (its
body dispatch, against the plain version and its CPU emulation); and the
paged read split over pages (against the plain version and its split
emulation, rows bitwise the single-token reads, the split counts at the
engine's shapes, replay in a CUDA graph); and the engine's steps as CUDA
graphs (replay bitwise the eager engine for decode, chunk and verify
steps on qwen and mamba2, nothing captured after warmup, warmup leaving
both pools as it found them, each replay adding its graph's launches);
and the rest of one-device training (the flash kernels at the training
slice's D = 128 shapes, G = 1 and G = 8, where the dK/dV kernel sums its
group's heads outside the tensor cores' accumulators; the MoE experts'
batched product's gradient; a step of every family and of quantized full
training; the ``Prefetcher``'s copies to the card); and the
encoder-decoder and vision-language families (prefill, decode and F+R
steps through the kernels) and model-level decode of the SSM families,
with verify steps of SSM layers among the replayed graphs.

These tests import neither ``jax`` nor the JAX package, so they also run
on the GPU host: ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py``. Without a card they skip."""
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import serving_requests
from repro_torch.kernels import flash_decode as fd
from repro_torch.models.lm import LM
from repro_torch.serving.cache import quant_encode
from repro_torch.serving.engine import Engine, Request

TOL = dict(rtol=2e-5, atol=2e-5)     # the repo's f32 kernel tolerance
# the reference's SSD kernel test (tests/test_kernels.py:328): kernel and
# plain version each scan the decay, and f32 cumulative decays near -200
# round ~1e-5 apart (read on the card: y within 4.6e-4, state 8.4e-5, at
# mamba2's whole-prompt shape; 2e-5 fails there)
SSD_TOL = dict(rtol=2e-3, atol=2e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _case(dev, t, h, kv, d, quant, seed=0):
    """Rows: full (5 live pages), short (2 pages of a 6-wide bucket) and
    zero-length; block_size 16 as the engine uses."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, bs, mb, n_blocks = 3, 16, 6, 24
    q = torch.randn((b, t, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((n_blocks, bs, kv, d), generator=g, device=dev)
    v = torch.randn((n_blocks, bs, kv, d), generator=g, device=dev)
    k, v = k.bfloat16(), v.bfloat16()
    ks = vs = None
    if quant:
        k, ks = quant_encode(k, "int8")
        v, vs = quant_encode(v, "int8")
    table = torch.tensor([[5, 2, 9, 1, 7, 11], [3, 8, 0, 0, 0, 0],
                          [0, 0, 0, 0, 0, 0]], dtype=torch.int32, device=dev)
    lengths = torch.tensor([5 * bs - 3, bs + 2, 0], dtype=torch.int32,
                           device=dev)
    return q, k, v, table, lengths, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 8, 64])
@pytest.mark.parametrize("h,kv,d", [(4, 2, 64), (16, 16, 64), (4, 1, 128),
                                    (32, 4, 128)])
@pytest.mark.parametrize("quant", [False, True])
def test_kernel_matches_plain(cuda, t, h, kv, d, quant):
    args = _case(cuda, t, h, kv, d, quant)
    want = fd._paged_prefix_torch(*args)
    before = fd.LAUNCHES["paged_attention"]
    got = fd.paged_flash_prefix_partial(*args[:5], k_scale=args[5],
                                        v_scale=args[6])
    torch.cuda.synchronize()
    assert fd.LAUNCHES["paged_attention"] == before + 1
    for a, b in zip(want, got):
        torch.testing.assert_close(b, a, **TOL)
    o, m, l = got
    assert torch.all(o[2] == 0) and torch.all(l[2] == 0)
    assert torch.all(m[2] == -1e30)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_t1_prefix_read_is_decode_read_bitwise(cuda, quant):
    q, k, v, table, lengths, ks, vs = _case(cuda, 1, 4, 2, 64, quant)
    one = fd.paged_flash_decode_partial(q[:, 0], k, v, table, lengths,
                                        k_scale=ks, v_scale=vs)
    mq = fd.paged_flash_prefix_partial(q, k, v, table, lengths,
                                       k_scale=ks, v_scale=vs)
    for a, b in zip(one, mq):
        assert torch.equal(a, b[:, 0])


@pytest.mark.gpu
@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_engine_reads_through_the_kernel(cuda, prefill_chunk):
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = LM(cfg, device=cuda).init(0)
    eng = Engine(cfg, params, max_batch=4, n_blocks=64, block_size=4,
                 kv_quant="int8", prefill_chunk=prefill_chunk, device=cuda)
    for i, p in enumerate(serving_requests(6, cfg.vocab_size,
                                           prompt_lens=[5, 12, 9])):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=6))
    fd.LAUNCHES.clear()
    done = eng.run()
    st = eng.stats()
    assert len(done) == 6 and all(len(r.output) == 6 for r in done)
    assert fd.LAUNCHES["paged_attention"] == cfg.n_layers * (
        st["decode_steps"] + st["chunk_steps"])


# --------------------------------------------------------------------------
# flash attention kernels
# --------------------------------------------------------------------------

# bf16 outputs against the plain version in bf16 ulps of the larger
# magnitude, beyond an absolute floor for sums that cancel to near zero:
# both sum in f32 and round once (chip_smoke.py's limits)
BF16_ULPS, BF16_ATOL = 2, 1e-5
# tests/test_kernels.py:31-36 (causal only where T == S), G in {1,2,4,8},
# D in {64,128}, and ragged lengths that end inside a 64-row tile
FLASH_CASES = ([(1, 128, 128, 4, 4, 128, c) for c in (True, False)]
               + [(2, 256, 256, 4, 2, 128, c) for c in (True, False)]
               + [(1, 256, 256, 8, 1, 64, c) for c in (True, False)]
               + [(2, 128, 384, 4, 4, 128, False)]
               + [(1, 192, 192, 8, 8 // g, d, True) for g in (1, 2, 4, 8)
                  for d in (64, 128)]
               + [(2, 100, 100, 4, 2, 64, True), (1, 70, 130, 2, 1, 64,
                                                   False)])


def _assert_flash_close(a, b, ulps=BF16_ULPS, atol=BF16_ATOL):
    if a.dtype != torch.bfloat16:
        torch.testing.assert_close(a, b, **TOL)
        return
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp_min(2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    diff = (a - b).abs()
    assert bool((diff <= atol + ulps * ulp).all()), \
        f"{float(((diff - atol).clamp_min(0) / ulp).max())} bf16 ulps " \
        f"beyond {atol} > {ulps}"


def _flash_case(dev, b, t, s, h, kv, d, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((b, h, t, d), generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, kv, s, d), generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.gpu
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_kernels_match_plain(cuda, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    *shape, causal = case
    q, k, v, do = _flash_case(cuda, *shape, dtype)
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa._flash_fwd_torch(q, k, v, causal=causal)
    _assert_flash_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa._flash_bwd_torch(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _assert_flash_close(a, b)
    assert {n: fa.LAUNCHES[n] - before.get(n, 0)
            for n in ("fwd", "bwd_dkv", "bwd_dq")} == {
        "fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("t,s,off", [(256, 512, 256), (256, 512, 0),
                                     (200, 460, 137)],
                         ids=["rank1", "past-reach", "off-tile"])
@pytest.mark.parametrize("h,kv,d", [(4, 4, 64), (8, 1, 128), (4, 2, 48)],
                         ids=["g1-d64", "g8-d128", "g2-d48"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_kernels_take_a_causal_q_offset(cuda, t, s, off, h, kv, d,
                                              dtype):
    """Every body with a causal ``q_offset`` (row i sees key j <= i +
    q_offset) against its plain version, the offset counted by
    ``OFFSETS``; the dK/dV kernel's f32 output rounded is its
    bf16/f32 output bit for bit, and keys no row reaches get zero."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_case(cuda, 2, t, s, h, kv, d, dtype, seed=off)
    before = dict(fa.OFFSETS)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True, q_offset=off)
    o_ref, lse_ref = fa._flash_fwd_torch(q, k, v, causal=True, q_offset=off)
    _assert_flash_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                 q_offset=off)
    want = fa._flash_bwd_torch(q, k, v, o, lse, do, causal=True,
                               q_offset=off)
    for a, b in zip(got, want):
        _assert_flash_close(a, b)
    dq, dk32, dv32 = fa.flash_attention_bwd(q, k, v, o, lse, do,
                                            causal=True, q_offset=off,
                                            kv_f32=True)
    assert torch.equal(dq, got[0])
    assert torch.equal(dk32.to(dtype), got[1])
    assert torch.equal(dv32.to(dtype), got[2])
    if t + off < s:
        assert not dk32[:, :, t + off:].any()
        assert not dv32[:, :, t + off:].any()
    assert {n: fa.OFFSETS[(n, off)] - before.get((n, off), 0)
            for n in ("fwd", "bwd_dkv", "bwd_dq")} == {
        "fwd": 1, "bwd_dkv": 2, "bwd_dq": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_kernels_match_plain_at_training_shape(cuda, dtype):
    """qwen1.5-0.5b's attention at T=2048 (B=1, H=16, D=64, causal): f32
    within 2e-5; bf16 o within 2 ulps and dq/dk/dv within 1 (G=1: no sum
    over heads, so only the forward's online rescaling reorders a sum)."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_case(cuda, 1, 2048, 2048, 16, 16, 64, dtype)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fa._flash_fwd_torch(q, k, v, causal=True)
    _assert_flash_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa._flash_bwd_torch(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, want):
        _assert_flash_close(a, b, ulps=1)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv", [(32, 32), (32, 4)],
                         ids=["llama2-7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_kernels_match_plain_at_the_slice_training_shapes(cuda, h, kv,
                                                                dtype):
    """The training slice's attention at T=2048, D=128, causal, B=1:
    llama2-7b (32 heads, G=1) and qwen3-moe-30b-a3b (32 query heads over
    4 KV heads: dK/dV sum over a group's 8 query heads). f32 within 2e-5;
    bf16 o within 2 ulps, dq/dk/dv within 1 at G=1 and 2 at G=8 (the
    group's sum reorders f32 adds), as the kernel-test shapes hold G=8."""
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = _flash_case(cuda, 1, 2048, 2048, h, kv, 128, dtype)
    assert fa.fwd_body(dtype, 128) == fa.bwd_body(dtype, 128) == (
        "mma" if dtype == torch.bfloat16 else "simt")
    o, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = fa._flash_fwd_torch(q, k, v, causal=True)
    _assert_flash_close(o, o_ref)
    torch.testing.assert_close(lse, lse_ref, **TOL)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = fa._flash_bwd_torch(q, k, v, o, lse, do, causal=True)
    for a, b in zip(got, want):
        _assert_flash_close(a, b, ulps=1 if h == kv else BF16_ULPS)


@pytest.mark.gpu
def test_flash_gradient_matches_naive_autograd(cuda):
    """The autograd.Function through the kernels against autograd through
    the materialized-score attention, f32 (tests/test_kernels.py:65's
    2e-3: the two sum in different orders and naive rounds nothing)."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((2, 256, 8, 64), generator=g, device=cuda)
    k, v = (torch.randn((2, 256, 2, 64), generator=g, device=cuda)
            for _ in range(2))
    w = torch.randn((2, 256, 8, 64), generator=g, device=cuda)
    res = []
    for mode in ("naive", "flash"):
        xs = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = L.attention(*xs, mode=mode, causal=True)
        res.append((out.detach(), *torch.autograd.grad((out * w).sum(), xs)))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("label,per_layer", [
    ("F+R", {"fwd": 2, "bwd_dkv": 1, "bwd_dq": 1}),
    ("F", {"fwd": 1, "bwd_dkv": 1, "bwd_dq": 1}),
    ("Naive", {"fwd": 0, "bwd_dkv": 0, "bwd_dq": 0})])
def test_train_step_launch_counts(cuda, label, per_layer):
    """Full-width qwen1.5-0.5b, one step of 1 x 256 tokens: per layer the
    forward kernel once, and once more when full remat recomputes the
    layer in the backward; each backward kernel once; none without F.
    F+R is 48/24/24 over the 24 layers."""
    from repro_torch.core.config import technique_from_label
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.build import make_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state
    cfg = get_config("qwen1.5-0.5b")
    tech = technique_from_label(label)
    model = make_model(cfg, tech, device=cuda)
    opt = AdamWConfig(lr=1e-3, warmup=0)
    state, _ = init_train_state(model, tech, 0, opt)
    step = build_train_step(model, tech, opt)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, 256), generator=g,
                              dtype=torch.int32).to(cuda)
             for k in ("tokens", "labels")}
    fa.LAUNCHES.clear()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert {n: fa.LAUNCHES[n] for n in per_layer} == {
        n: cfg.n_layers * c for n, c in per_layer.items()}


# --------------------------------------------------------------------------
# SSD kernel
# --------------------------------------------------------------------------

# (B, T, H, P, G, N, chunk, carried state): mamba2-130m's whole-prompt and
# chunk-step shapes (the chunk step at its live length: T=64 against a
# 256 chunk, and a ragged 40), four and eight chunks with a carried state
# (the state pass carries across them), the smoke config's, and ragged /
# grouped small ones
SSD_CASES = [(4, 1000, 24, 64, 1, 128, 256, False),
             (1, 64, 24, 64, 1, 128, 256, True),
             (1, 40, 24, 64, 1, 128, 256, True),
             (2, 1024, 24, 64, 1, 128, 256, True),
             (1, 512, 4, 64, 1, 128, 64, True),
             (2, 70, 8, 16, 1, 16, 32, True),
             (2, 100, 6, 32, 2, 48, 32, False),
             (1, 200, 4, 128, 4, 64, 96, True),
             (3, 17, 2, 8, 1, 4, 256, False),
             (4, 1024, 128, 64, 1, 16, 256, False),
             (1, 64, 128, 64, 1, 16, 256, True)]
# mamba2-130m's whole prompt and chunk step (jamba-v0.1-52b's are the
# last two: 128 heads of 64, state 16)
SSD_MAMBA2 = SSD_CASES[:2]


def _ssd_args(dev, case):
    from repro_torch.kernels import ops as kops
    b, t, h, p, g, n, chunk, init = case
    gen = torch.Generator(device=dev).manual_seed(t)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x, B, C = rn(b, t, h, p) * 0.5, rn(b, t, g, n) * 0.5, rn(b, t, g, n) * 0.5
    dt = torch.nn.functional.softplus(rn(b, t, h))
    A = -torch.exp(rn(h) * 0.3)
    s0 = rn(b, h, p, n) * 0.5 if init else None
    return kops.ssd_inputs(x, B, C, dt, A, chunk, s0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_kernel_matches_plain(cuda, case):
    """y and the final state within ``SSD_TOL`` of the plain version on
    the same inputs; one launch counted a call, under the body the shape
    takes."""
    from repro_torch.kernels import ssd as ssdk
    chunk, p, n = case[6], case[3], case[5]
    args = _ssd_args(cuda, case)
    before = ssdk.LAUNCHES["ssd"]
    bodies = dict(ssdk.BODIES)
    got = ssdk.ssd_chunked_kernel(*args[:4], chunk=chunk, init_state=args[4])
    want = ssdk.ssd_chunked_plain(*args[:4], chunk=chunk, init_state=args[4])
    torch.cuda.synchronize()
    assert ssdk.LAUNCHES["ssd"] == before + 1
    body = ssdk.ssd_body(n, p)
    assert ssdk.BODIES[body] == bodies.get(body, 0) + 1
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **SSD_TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SSD_MAMBA2, ids=str)
def test_ssd_mamba2_shapes_run_the_tensor_cores(cuda, case):
    """Both mamba2 shapes take the tensor-core body, and its worst |err|
    against the plain version is within 2x the FMA body's on the same
    inputs (y and the state each)."""
    from repro_torch.kernels import ssd as ssdk
    chunk, p, n = case[6], case[3], case[5]
    assert ssdk.ssd_body(n, p) == "mma"
    args = _ssd_args(cuda, case)
    want = ssdk.ssd_chunked_plain(*args[:4], chunk=chunk, init_state=args[4])
    errs = {}
    for body in ("mma", "fma"):
        got = ssdk._ssd_cuda(*args[:4], chunk=chunk, init_state=args[4],
                             body=body)
        errs[body] = [(a - w).abs().max().item() for a, w in zip(got, want)]
    for e_mma, e_fma in zip(errs["mma"], errs["fma"]):
        assert e_mma <= 2 * e_fma, errs


@pytest.mark.gpu
@pytest.mark.parametrize("prefill_chunk", [None, 8])
def test_mamba2_engine_runs_prefill_through_the_ssd_kernel(cuda,
                                                           prefill_chunk):
    """One SSD launch per layer per prefill group or chunk step, none in
    decode, no attention kernel."""
    from repro_torch.kernels import ssd as ssdk
    cfg = get_config("mamba2-130m", reduced=True)
    params = LM(cfg, device=cuda).init(0)
    eng = Engine(cfg, params, max_batch=4, n_blocks=64, block_size=4,
                 prefill_chunk=prefill_chunk, device=cuda)
    for i, p in enumerate(serving_requests(6, cfg.vocab_size,
                                           prompt_lens=[5, 12, 9, 40])):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=6))
    ssdk.LAUNCHES.clear()
    fd.LAUNCHES.clear()
    done = eng.run()
    st = eng.stats()
    assert len(done) == 6 and all(len(r.output) == 6 for r in done)
    assert ssdk.LAUNCHES["ssd"] == cfg.n_layers * (
        st["prefill_groups"] + st["chunk_steps"]) > 0
    assert fd.LAUNCHES["paged_attention"] == 0


# --------------------------------------------------------------------------
# int8 weight-only matmul kernel
# --------------------------------------------------------------------------

# (M, K, N, G): tests/test_kernels.py:362's shapes, decode-size M, K and N
# off the 128 x 128 x 64 (32) tiles, G = 16 head groups, and qwen1.5-0.5b's
# four fine-tuning projections (q/k/v, o, gate/up, down) at M = 512
QMM_CASES = [(128, 256, 128, 1), (64, 512, 384, 1), (1, 1024, 1024, 16),
             (7, 1000, 1040, 16), (7, 1000, 300, 1), (200, 130, 70, 1),
             (512, 1024, 1024, 16), (512, 1024, 1024, 1),
             (512, 1024, 2816, 1), (512, 2816, 1024, 1),
             # llama2-7b's four fine-tuning projections (q/k/v over 32 heads)
             (512, 4096, 4096, 32), (512, 4096, 4096, 1),
             (512, 4096, 11008, 1), (512, 11008, 4096, 1)]


def _qmm_case(dev, m, k, n, g, x_dtype, seed=0):
    """x ~ N(0, 1) and a weight ~ N(0, 1/K), as the model's fan-in-scaled
    init, quantized by ``quantize_int8`` as (K, G, N/G) so its scales are
    (K, G): the layout ``layers.dense`` hands the kernel."""
    from repro_torch.quant.qtensor import quantize_int8
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(x_dtype)
    w = torch.randn((k, g, n // g), generator=gen, device=dev) / k ** 0.5
    qt = quantize_int8(w.bfloat16())
    return x, qt.data.reshape(k, n), qt.scale.reshape(k, g)


@pytest.mark.gpu
@pytest.mark.parametrize("case", QMM_CASES, ids=str)
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16)],
    ids=["bf16-bf16", "bf16-f32", "f32-f32", "f32-bf16"])
def test_int8_matmul_kernel_matches_plain(cuda, case, x_dtype, out_dtype):
    """f32 outputs within 2e-5, bf16 within 1 bf16 ulp beyond a 1e-5
    floor: both dequantize to the same f32 weight and sum in f32, in
    different orders, then round once."""
    from repro_torch.kernels import quant_matmul as qmm
    x, w_q, scale = _qmm_case(cuda, *case, x_dtype)
    before = qmm.LAUNCHES["int8_matmul"]
    got = qmm.int8_matmul_kernel(x, w_q, scale, out_dtype=out_dtype)
    want = qmm.int8_matmul_plain(x, w_q, scale, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qmm.LAUNCHES["int8_matmul"] == before + 1
    assert got.dtype == out_dtype and got.shape == want.shape
    _assert_flash_close(got, want, ulps=1)


@pytest.mark.gpu
def test_int8_matmul_body_dispatch(cuda):
    """The fine-tuning step's four projections (M = 8192) and every shape
    with N % 16 == 0 and K a whole number of 16-byte x chunks run the
    tensor cores, the scale on x only for f32 x with G = 1; the rest the
    SIMT body. Each launch counts under the body it ran."""
    from repro_torch.kernels import quant_matmul as qmm
    bf16, f32 = torch.bfloat16, torch.float32
    for k, n, g, x_dtype in ((1024, 1024, 16, bf16), (1024, 1024, 1, bf16),
                             (1024, 2816, 1, bf16), (2816, 1024, 1, f32)):
        want = "mma_x" if x_dtype == f32 else "mma_w"
        assert qmm.qmm_body(x_dtype, 8192, n, k, g) == want
    for m, k, n, g in QMM_CASES:
        for x_dtype in (bf16, f32):
            body = qmm.qmm_body(x_dtype, m, n, k, g)
            assert body == ("simt" if n % 16 else
                            "mma_x" if (x_dtype, g) == (f32, 1) else "mma_w")
            assert qmm.k_tile(x_dtype, m, n, k, g) == (
                64 if (body, x_dtype) == ("mma_w", bf16) else 32)
    x, w_q, scale = _qmm_case(cuda, 7, 1000, 300, 1, bf16)
    qmm.BODIES.clear()
    qmm.int8_matmul_kernel(x, w_q, scale)
    x, w_q, scale = _qmm_case(cuda, 64, 512, 384, 1, f32)
    qmm.int8_matmul_kernel(x, w_q, scale)
    assert dict(qmm.BODIES) == {"simt": 1, "mma_x": 1}


@pytest.mark.gpu
def test_int8_matmul_gradient_matches_plain_autograd(cuda):
    """``ops.int8_matmul``'s dx against autograd through the plain version
    (the same f32 product, transposed), f32 and bf16 x."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import quant_matmul as qmm
    for x_dtype in (torch.float32, torch.bfloat16):
        x, w_q, scale = _qmm_case(cuda, 96, 320, 256, 4, x_dtype, seed=3)
        x = x.reshape(2, 48, 320)
        dy = torch.randn((2, 48, 256), device=cuda)
        grads = []
        for fn in (lambda t: kops.int8_matmul(t, w_q, scale,
                                              out_dtype=torch.float32),
                   lambda t: qmm.int8_matmul_plain(
                       t.reshape(96, 320), w_q, scale,
                       out_dtype=torch.float32).reshape(2, 48, 256)):
            xg = x.clone().requires_grad_(True)
            grads.append(torch.autograd.grad((fn(xg) * dy).sum(), xg)[0])
        assert grads[0].dtype == x_dtype
        _assert_flash_close(grads[0], grads[1], ulps=1)


@pytest.mark.gpu
@pytest.mark.parametrize("label,per_layer", [("QL+Q8+F+R", 14),
                                             ("QL+Q8+F", 7), ("L+F+R", 0)])
def test_finetune_step_launches_the_int8_kernel(cuda, label, per_layer):
    """Full-width qwen1.5-0.5b, one step of 1 x 256 tokens: the int8 kernel
    once per base projection (q, k, v, o, gate, up, down) per forward,
    twice under full remat; never on a bf16 base."""
    from repro_torch.core.config import technique_from_label
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.launch.build import make_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state
    cfg = get_config("qwen1.5-0.5b")
    tech = technique_from_label(label)
    model = make_model(cfg, tech, device=cuda)
    opt = AdamWConfig(lr=1e-3, warmup=0)
    state, _ = init_train_state(model, tech, 0, opt)
    step = build_train_step(model, tech, opt)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, 256), generator=g,
                              dtype=torch.int32).to(cuda)
             for k in ("tokens", "labels")}
    qmm.LAUNCHES.clear()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert qmm.LAUNCHES["int8_matmul"] == cfg.n_layers * per_layer


# --------------------------------------------------------------------------
# RMSNorm kernel
# --------------------------------------------------------------------------

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _rms_case(dev, rows, d, xd, wd, seed=0):
    """Rows at magnitudes 1e-3..10 (eps matters in the small ones)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    scale = 10.0 ** (torch.rand((rows, 1), generator=g, device=dev) * 4 - 3)
    x = (torch.randn((rows, d), generator=g, device=dev) * scale)
    w = torch.randn(d, generator=g, device=dev) + 1.0
    return x.to(DTYPES[xd]), w.to(DTYPES[wd])


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 256, 333, 2048, 8192])
@pytest.mark.parametrize("d", [128, 768, 1024, 1536, 2048, 4096, 1000,
                               999])
@pytest.mark.parametrize("xd,wd", [("bf16", "bf16"), ("bf16", "f32"),
                                   ("f32", "bf16"), ("f32", "f32")])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, xd, wd):
    """f32 out within 2e-5, bf16 out within one bf16 ulp (both round one
    f32 value once; only the order of the sum of squares differs), also
    at ragged D: 1000 (the last vectors of a row fall to some threads
    only) and 999 (read element by element), and at the q/k norms' head
    width 128 (f32 rows: 256 a decode step of qwen3-moe, 2,048 a 64-token
    chunk), qwen3-moe's d_model 2048 and llama2-7b's 4096 (8192 rows: the
    training slice's)."""
    from repro_torch.kernels import rmsnorm as rn
    x, w = _rms_case(cuda, rows, d, xd, wd, seed=rows + d)
    before = rn.LAUNCHES["rmsnorm"]
    got = rn.rmsnorm(x, w)
    want = rn.rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rmsnorm"] == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    _assert_flash_close(got, want, ulps=1)


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 2048])
@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("xd", ["bf16", "f32"])
def test_rmsnorm_split_kernel_matches_plain(cuda, rows, parts, xd):
    """The norm of mamba2's d_inner rows split into ``parts``: each
    part's partial sums (the kernel's first pass), added over the parts,
    then each part's scale pass, against the plain norm of the whole row
    (f32 within 2e-5, bf16 within one ulp); each pass counts one launch."""
    from repro_torch.kernels import rmsnorm as rn
    n = 1536
    x, w = _rms_case(cuda, rows, n, xd, "bf16", seed=rows + parts)
    xs = [p.contiguous() for p in x.chunk(parts, -1)]
    ws = [p.contiguous() for p in w.chunk(parts)]
    before = dict(rn.LAUNCHES)
    sums = [rn._sumsq_cuda(p) for p in xs]
    for p, ss in zip(xs, sums):
        torch.testing.assert_close(ss, rn.rmsnorm_sumsq_plain(p), **TOL)
    total = torch.stack(sums).sum(0)
    got = torch.cat([rn._scaled_cuda(p, q, total, n)
                     for p, q in zip(xs, ws)], -1)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rmsnorm_sumsq"] == before.get("rmsnorm_sumsq",
                                                      0) + parts
    assert rn.LAUNCHES["rmsnorm"] == before.get("rmsnorm", 0) + parts
    _assert_flash_close(got, rn.rmsnorm_plain(x, w), ulps=1)


@pytest.mark.gpu
def test_rmsnorm_rows_per_block(cuda):
    """One row a block below 1,024 rows; above, as many rows as a
    256-thread block holds at up to four 16-byte vectors a thread."""
    from repro_torch.kernels import rmsnorm as rn
    bf16, f32 = torch.bfloat16, torch.float32
    for rows in (1, 8, 333, 1023):
        assert rn.rows_per_block(rows, 1024, bf16) == 1
    assert rn.rows_per_block(8192, 1024, bf16) == 8
    assert rn.rows_per_block(8192, 768, bf16) == 8
    assert rn.rows_per_block(8192, 1536, f32) == 2
    assert rn.rows_per_block(8192, 8192, f32) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("xd,wd", [("bf16", "bf16"), ("f32", "bf16")])
def test_rmsnorm_gradient_matches_plain_autograd(cuda, xd, wd):
    """The wrapper (kernel forward, analytic backward) against autograd
    through the plain version at a training shape: dx and dw within one
    bf16 ulp (bf16) or 2e-5 (f32)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import rmsnorm as rn
    x, w = _rms_case(cuda, 2048, 1024, xd, wd, seed=3)
    dy = torch.randn(x.shape, device=cuda).to(x.dtype)
    grads = []
    for fn in (kops.rmsnorm, rn.rmsnorm_plain):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(xg, wg), (xg, wg), dy))
    for a, b in zip(*grads):
        assert a.dtype == b.dtype
        _assert_flash_close(a, b, ulps=1)


@pytest.mark.gpu
@pytest.mark.parametrize("label,per_layer", [("F+R", 4), ("F", 2),
                                             ("QL+Q8+F+R", 4)])
def test_train_step_launches_the_rmsnorm_kernel(cuda, label, per_layer):
    """Full-width qwen1.5-0.5b, one step of 1 x 256 tokens: two norms a
    layer, run again when full remat recomputes the layer, and the final
    norm in the loss's one checkpointed block (forward and recompute)."""
    from repro_torch.core.config import technique_from_label
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.build import make_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import build_train_step, init_train_state
    cfg = get_config("qwen1.5-0.5b")
    tech = technique_from_label(label)
    model = make_model(cfg, tech, device=cuda)
    opt = AdamWConfig(lr=1e-3, warmup=0)
    state, _ = init_train_state(model, tech, 0, opt)
    step = build_train_step(model, tech, opt)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (1, 256), generator=g,
                              dtype=torch.int32).to(cuda)
             for k in ("tokens", "labels")}
    rn.LAUNCHES.clear()
    state, met = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert rn.LAUNCHES["rmsnorm"] == cfg.n_layers * per_layer + 2


# --------------------------------------------------------------------------
# Dense-cache decode kernel
# --------------------------------------------------------------------------

# (B, S, H, K, D, lengths): tests/test_kernels.py:72-75, the draft
# model's shape (qwen1.5-0.5b at batch 1, S = context + k), G = 2, G = 8,
# a zero-length row and a length past S
DENSE_CASES = [(2, 256, 4, 4, 128, [128, 256]),
               (3, 512, 8, 2, 128, [256, 512, 128]),
               (2, 256, 4, 1, 64, [128, 256]),
               (1, 65, 16, 16, 64, [61]), (1, 1068, 16, 16, 64, [1064]),
               (3, 300, 8, 4, 64, [300, 0, 37]),
               (2, 100, 16, 2, 32, [100, 250])]


def _dense_case(dev, b, s, h, kv, d, lengths, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, kv, s, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, kv, s, d), generator=g, device=dev).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("case", DENSE_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dense_decode_kernel_matches_plain(cuda, case, dtype):
    """Normalized output, m and l within 2e-5 of the plain version (both
    in f32); a zero-length row is o = 0, l = 0, m = -1e30."""
    args = _dense_case(cuda, *case, dtype, seed=case[1])
    before = fd.LAUNCHES["dense_decode"]
    o, m, l = fd.flash_decode_partial(*args)
    wo, wm, wl = fd._dense_decode_torch(*args)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["dense_decode"] == before + 1
    torch.testing.assert_close(o / l.clamp_min(1e-30),
                               wo / wl.clamp_min(1e-30), **TOL)
    torch.testing.assert_close(m, wm, **TOL)
    torch.testing.assert_close(l, wl, **TOL)
    empty = args[3] == 0
    assert bool((o[empty] == 0).all() and (l[empty] == 0).all())
    assert bool((m[empty] == -1e30).all())


@pytest.mark.gpu
def test_dense_decode_reads_the_model_layout_in_place(cuda):
    """``ops.flash_decode`` hands the kernel a transposed view of the
    (B, S, K, D) cache: equal to the plain version on the same view."""
    from repro_torch.kernels import ops as kops
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 1, 16, 64), generator=g, device=cuda).bfloat16()
    k = torch.randn((2, 200, 16, 64), generator=g, device=cuda).bfloat16()
    v = torch.randn((2, 200, 16, 64), generator=g, device=cuda).bfloat16()
    lens = torch.tensor([200, 77], dtype=torch.int32, device=cuda)
    got = kops.flash_decode(q, k, v, lens)
    want = fd._dense_decode_torch(q[:, 0], k.transpose(1, 2),
                                  v.transpose(1, 2), lens, sm_scale=0.125)
    want = (want[0] / want[2]).bfloat16()[:, None]
    _assert_flash_close(got, want, ulps=1)


@pytest.mark.gpu
@pytest.mark.parametrize("spec", ["ngram", "self-draft"])
def test_spec_engine_launch_counts(cuda, spec):
    """Smoke qwen1.5-0.5b with speculation on the card: the paged read once
    a layer per verify step, the dense decode read once a layer per draft
    decode step, RMSNorm 2 x layers + 1 per forward (engine steps and
    draft forwards), every request finished with its budget (agreement
    with spec-off, up to bf16 near ties, is chip_smoke.py's check)."""
    from repro_torch.data.pipeline import repetitive_requests
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.serving.speculate import DraftModelProposer
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = LM(cfg, device=cuda).init(0)
    prompts = repetitive_requests(4, cfg.vocab_size, prompt_len=20,
                                  pattern_len=6)
    for mode in ("off", spec):
        draft = (DraftModelProposer(cfg, params, device=cuda)
                 if mode == "self-draft" else None)
        eng = Engine(cfg, params, max_batch=4, n_blocks=64, block_size=4,
                     speculate=draft or mode, spec_depth=4, device=cuda)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=10))
        fd.LAUNCHES.clear()
        rn.LAUNCHES.clear()
        done = eng.run()
        st = eng.stats()
        assert len(done) == 4 and all(len(r.output) == 10 for r in done)
        steps = st["decode_steps"] + st["chunk_steps"] + st["verify_steps"]
        assert fd.LAUNCHES["paged_attention"] == cfg.n_layers * steps
        drafted = ((draft.n_prefills, draft.n_decode_steps) if draft
                   else (0, 0))
        assert fd.LAUNCHES["dense_decode"] == cfg.n_layers * drafted[1]
        forwards = steps + st["prefill_groups"] + sum(drafted)
        assert rn.LAUNCHES["rmsnorm"] == (2 * cfg.n_layers + 1) * forwards
        if mode != "off":
            assert st["spec_rounds"] > 0 and st["decode_steps"] == 0
    if spec == "self-draft":
        assert drafted[1] > 0


# --------------------------------------------------------------------------
# Split dense decode: many splits, planted split faults, graph replay
# --------------------------------------------------------------------------

# (B, S, H, K, D, lengths): long caches that the kernel splits many ways,
# G in {1, 2, 8}, D in {64, 128}, lengths that leave whole splits empty
# and one that reaches S
SPLIT_CASES = [(1, 4096, 16, 16, 64, [4096]), (4, 4096, 8, 4, 128,
                                               [4096, 3000, 17, 0]),
               (8, 4096, 16, 16, 64, [4096, 1, 2048, 4095, 333, 64, 0,
                                      4000]),
               (1, 8192, 8, 1, 128, [8192]), (4, 8192, 16, 2, 64,
                                             [8192, 100, 7000, 5]),
               (8, 8192, 8, 4, 64, [8192, 0, 1, 8191, 4096, 4097, 63, 64])]


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_dense_decode_split_kernel_matches_plain(cuda, case, dtype):
    """The split kernel at its own split count and at forced ones (1, 3,
    64) against the plain version (2e-5 on the normalized output, m, l)."""
    args = _dense_case(cuda, *case, dtype, seed=case[1] + case[0])
    wo, wm, wl = fd._dense_decode_torch(*args)
    n_auto = fd.dense_splits(case[0], case[3], case[1],
                             torch.cuda.get_device_properties(
                                 cuda).multi_processor_count)
    assert n_auto > 1 or case[0] * case[3] >= 264
    for n_split in (None, 1, 3, 64):
        o, m, l = fd._dense_decode_cuda(*args, n_split=n_split)
        torch.cuda.synchronize()
        torch.testing.assert_close(o / l.clamp_min(1e-30),
                                   wo / wl.clamp_min(1e-30), **TOL)
        torch.testing.assert_close(m, wm, **TOL)
        torch.testing.assert_close(l, wl, **TOL)
        empty = args[3] == 0
        assert bool((o[empty] == 0).all() and (l[empty] == 0).all())
        assert bool((m[empty] == -1e30).all())


def _split_parts(q, k, v, lens, n_split):
    """Each split's partial, from the kernel run on that split's positions
    alone (one launch per row and split)."""
    parts = []
    for lo, hi in fd.split_spans(lens, k.shape[2], n_split):
        rows = []
        for r in range(q.shape[0]):
            a, b = int(lo[r]), int(hi[r])
            rows.append(fd._dense_decode_cuda(
                q[r:r + 1], k[r:r + 1, :, a:b], v[r:r + 1, :, a:b],
                torch.tensor([b - a], dtype=torch.int32, device=q.device),
                n_split=1))
        parts.append(tuple(torch.cat(x) for x in zip(*rows)))
    return parts


@pytest.mark.gpu
@pytest.mark.parametrize("fault", ["split dropped", "no rescale"])
def test_dense_decode_split_faults_break_the_limit(cuda, fault):
    """The per-split partials merged as the kernel merges them equal the
    kernel; one split dropped, or the partials summed without the rescale
    to the common max, breaks 2e-5."""
    case = (2, 4096, 8, 4, 64, [4096, 2500])
    q, k, v, lens = _dense_case(cuda, *case, torch.float32, seed=11)
    n_split = 8
    parts = _split_parts(q, k, v, lens, n_split)
    want = fd._dense_decode_cuda(q, k, v, lens, n_split=n_split)
    good = fd.merge_split_partials(parts)
    for a, b in zip(good, want):
        torch.testing.assert_close(a, b, **TOL)
    if fault == "split dropped":
        bad = fd.merge_split_partials(parts[:3] + parts[4:])
    else:
        bad = (sum(p[0] for p in parts), torch.stack(
            [p[1] for p in parts]).amax(0), sum(p[2] for p in parts))
    norm = [x[0] / x[2].clamp_min(1e-30) for x in (bad, want)]
    assert not (torch.allclose(*norm, **TOL) and
                torch.allclose(bad[2], want[2], **TOL))


@pytest.mark.gpu
def test_dense_decode_split_kernel_replays_in_a_cuda_graph(cuda):
    """Captured once at the draft's shape and replayed on new inputs
    copied into the captured buffers: each replay equals the plain
    version, and the split counters stay zero between calls."""
    q, k, v, lens = _dense_case(cuda, 1, 1068, 16, 16, 64, [1064],
                                torch.bfloat16, seed=3)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    kv = (kt.transpose(1, 2), vt.transpose(1, 2))     # the models' layout
    fd._dense_decode_cuda(q, *kv, lens)               # sizes the counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd._dense_decode_cuda(q, *kv, lens)
    for seed in (4, 5, 6):
        g = torch.Generator(device=cuda).manual_seed(seed)
        for x in (q, kt, vt):
            x.copy_(torch.randn(x.shape, generator=g, device=cuda))
        lens.fill_(100 * seed)
        graph.replay()
        torch.cuda.synchronize()
        want = fd._dense_decode_torch(q, *kv, lens)
        torch.testing.assert_close(out[0] / out[2], want[0] / want[2],
                                   **TOL)
        torch.testing.assert_close(out[1], want[1], **TOL)
        assert int(fd._COUNTERS[q.device].abs().sum()) == 0


# --------------------------------------------------------------------------
# flash backward on the tensor cores
# --------------------------------------------------------------------------

# (B, T, S, H, K, D, causal): G in {1, 2, 4, 8} x D in {64, 128}, causal
# and full, T and S off the 64-row tiles
MMA_BWD_CASES = [(1, t, s, 8, 8 // g, d, c) for g in (1, 2, 4, 8)
                 for d in (64, 128)
                 for t, s, c in ((100, 100, True), (70, 130, False))]


@pytest.mark.gpu
@pytest.mark.parametrize("case", MMA_BWD_CASES, ids=str)
def test_flash_backward_runs_the_tensor_cores(cuda, case):
    """bf16 at D 64 and 128 takes the mma body; its dq, dk and dv are
    within one bf16 ulp of the plain version at G = 1 and two elsewhere
    (the limits of the FMA body), beyond the 1e-5 floor."""
    from repro_torch.kernels import flash_attention as fa
    *shape, causal = case
    q, k, v, do = _flash_case(cuda, *shape, torch.bfloat16, seed=7)
    assert fa.bwd_body(torch.bfloat16, shape[-1]) == "mma"
    assert fa.bwd_body(torch.float32, shape[-1]) == "simt"
    o, lse = fa._flash_fwd_torch(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa._flash_bwd_torch(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    ulps = 1 if shape[3] == shape[4] else BF16_ULPS
    for a, b in zip(got, want):
        _assert_flash_close(a, b, ulps=ulps)


# --------------------------------------------------------------------------
# dense on the tensor cores
# --------------------------------------------------------------------------

# qwen1.5-0.5b's projections: (name, x shape after the rows, w shape, out)
QWEN_PROJ = [("q/k/v", (1024,), (1024, 16, 64), torch.float32),
             ("o", (16, 64), (16, 64, 1024), None),
             ("gate/up", (1024,), (1024, 2816), torch.float32),
             ("head", (1024,), (1024, 151936), None)]


def _dense_floor(k, ref):
    """chip_smoke.py's floor for a bf16 product output: 16 x the f32
    roundoff of a K-term sum at the output's scale (sqrt(K) 2^-24 rms),
    never below ``BF16_ATOL``."""
    rms = float(torch.linalg.vector_norm(ref, dtype=torch.float32)
                / ref.numel() ** 0.5)
    return max(BF16_ATOL, 16 * k ** 0.5 * 2.0 ** -24 * rms)


def _dense_grads(fn, x, w, dy):
    xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fn(xg, wg)
    return (y.detach(), *torch.autograd.grad(y, (xg, wg), dy))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [8, 512])
@pytest.mark.parametrize("proj", QWEN_PROJ, ids=[p[0] for p in QWEN_PROJ])
def test_dense_tensor_core_route_matches_f32_route(cuda, rows, proj):
    """``dense`` on bf16 CUDA operands against the f32 route on the same
    tensors: bf16 outputs and gradients within one bf16 ulp beyond the
    sums' f32 roundoff floor, f32 outputs within 2e-5; an f32 output
    rounded through bf16 breaks that limit."""
    from repro_torch.core.device import resolve_device
    from repro_torch.models import layers as L
    resolve_device(cuda)            # the card's numerics switches
    _, xs, ws, out = proj
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn((rows, *xs), generator=g, device=cuda).bfloat16()
    w = (torch.randn(ws, generator=g, device=cuda) * 0.03).bfloat16()
    n_in = len(xs)
    out_dt = out or torch.bfloat16
    dy = torch.randn((rows, *ws[n_in:]), generator=g, device=cuda).to(out_dt)

    def f32_route(a, b):
        k = a[0].numel()
        y = L._dense_f32(a.reshape(rows, k), b.reshape(k, -1), out_dt)
        return y.reshape(rows, *ws[n_in:])

    got = _dense_grads(lambda a, b: L.dense(a, b, n_in, out_dtype=out), x,
                       w, dy)
    want = _dense_grads(f32_route, x, w, dy)
    assert L.tensor_core_route(x.dtype, w.dtype, out_dt)
    n_out = want[0][0].numel()
    for a, b, k_sum in zip(got, want, (x[0].numel(), n_out, rows)):
        assert a.dtype == b.dtype
        _assert_flash_close(a, b, ulps=1, atol=_dense_floor(k_sum, b))
    if out_dt == torch.float32:
        k = x[0].numel()
        bad = torch.matmul(x.reshape(rows, k), w.reshape(k, -1)).float()
        assert not torch.allclose(bad, want[0].reshape(rows, -1), **TOL)


@pytest.mark.gpu
def test_dense_keeps_the_f32_route_for_an_f32_operand(cuda):
    """swiglu's down projection reads the f32 gate chain: its product is
    the f32 route's, bit for bit."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(0)
    h = torch.randn((8, 2816), generator=g, device=cuda)
    w = (torch.randn((2816, 1024), generator=g, device=cuda) * 0.02
         ).bfloat16()
    assert not L.tensor_core_route(h.dtype, w.dtype, torch.float32)
    assert torch.equal(L.dense(h, w), L._dense_f32(h, w, torch.float32))


# --------------------------------------------------------------------------
# flash forward on the tensor cores
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_flash_forward_body_dispatch(cuda):
    """bf16 at D 64 and 128 runs the mma forward, as the backward; f32 and
    other head_dims keep the FMA body."""
    from repro_torch.kernels import flash_attention as fa
    for d in (64, 128):
        assert fa.fwd_body(torch.bfloat16, d) == "mma"
        assert fa.fwd_body(torch.float32, d) == "simt"
    for d in (16, 32, 96):
        assert fa.fwd_body(torch.bfloat16, d) == "simt"


@pytest.mark.gpu
@pytest.mark.parametrize("case", MMA_BWD_CASES + [
    (1, 2048, 2048, 16, 16, 64, True), (2, 128, 384, 4, 4, 128, False)],
    ids=str)
def test_flash_forward_runs_the_tensor_cores(cuda, case):
    """The mma forward against the plain version (o within two bf16 ulps
    beyond the 1e-5 floor, lse within 2e-5) and against its own CPU
    emulation ``_flash_fwd_split_torch`` (the same limits)."""
    from repro_torch.kernels import flash_attention as fa
    *shape, causal = case
    q, k, v, _ = _flash_case(cuda, *shape, torch.bfloat16, seed=8)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    for want_o, want_l in (fa._flash_fwd_torch(q, k, v, causal=causal),
                           fa._flash_fwd_split_torch(q, k, v,
                                                     causal=causal)):
        _assert_flash_close(o, want_o)
        torch.testing.assert_close(lse, want_l, **TOL)


# --------------------------------------------------------------------------
# the paged read split over pages
# --------------------------------------------------------------------------

# (B, T, H, K, D, lengths, table columns, int8): the engine's decode and
# chunk shapes, a verify window, and long contexts on a wide table
PAGED_SPLIT_CASES = [
    (8, 1, 16, 16, 64, [96, 288, 1032, 96, 288, 1032, 96, 288], 128, False),
    (1, 64, 16, 16, 64, [936], 64, True),
    (8, 5, 16, 16, 64, [96, 288, 1032, 96, 288, 1032, 96, 0], 128, False),
    (4, 4, 8, 2, 128, [4096, 17, 0, 2000], 256, True),
    (2, 64, 8, 4, 64, [3000, 40], 256, False)]


def _paged_split_case(dev, b, t, h, kv, d, lengths, mb, quant, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    bs = 16
    n_blocks = sum(-(-x // bs) for x in lengths) + 2
    q = torch.randn((b, t, h, d), generator=g, device=dev).bfloat16()
    k = torch.randn((n_blocks, bs, kv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((n_blocks, bs, kv, d), generator=g, device=dev).bfloat16()
    ks = vs = None
    if quant:
        k, ks = quant_encode(k, "int8")
        v, vs = quant_encode(v, "int8")
    perm = torch.randperm(n_blocks - 1, generator=g, device=dev) + 1
    table = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    used = 0
    for i, ln in enumerate(lengths):
        nb = -(-ln // bs)
        table[i, :nb] = perm[used:used + nb].int()
        used += nb
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, table, lens, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("t,quant", [(1, False), (64, True)])
def test_paged_read_of_a_head_window_is_the_copy_read(cuda, t, quant):
    """A rank holding both of a pool's KV heads that reads one (chatglm3
    at TP = 4: 8 q heads on KV head 1 of 2, D = 128) reads the window in
    place: bit for bit the read of its copy, and within 2e-5 of plain."""
    q, k, v, table, lens, ks, vs = _paged_split_case(
        cuda, 8 if t == 1 else 1, t, 8, 2, 128,
        [96, 288, 1032, 96, 288, 1032, 96, 288] if t == 1 else [936], 128,
        quant)
    win = [None if a is None else a[:, :, 1:2] for a in (k, v, ks, vs)]
    args = (q, win[0], win[1], table, lens, win[2], win[3])
    copy = tuple(a if a is None or a.is_contiguous() else a.contiguous()
                 for a in args)
    got, want = fd._paged_mq_cuda(*args), fd._paged_mq_cuda(*copy)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    plain = fd._paged_prefix_torch(*args)
    torch.testing.assert_close(got[0] / got[2].clamp_min(1e-30),
                               plain[0] / plain[2].clamp_min(1e-30), **TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES, ids=str)
def test_paged_split_kernel_matches_plain(cuda, case):
    """The kernel at its own split count and at forced ones (1, 3, 7)
    against the plain version and against the plain version's emulation
    of the same split count (2e-5 on the normalized output, m, l); the
    zero-length row stays empty."""
    args = _paged_split_case(cuda, *case)
    want = fd._paged_prefix_torch(*args)
    for n_split in (None, 1, 3, 7):
        o, m, l = fd._paged_mq_cuda(*args, n_split=n_split)
        torch.cuda.synchronize()
        n = n_split or fd.paged_splits(case[0], case[3], case[6],
                                       torch.cuda.get_device_properties(
                                           cuda).multi_processor_count)
        for wo, wm, wl in (want, fd._paged_prefix_torch(*args, n_split=n)):
            torch.testing.assert_close(o / l.clamp_min(1e-30),
                                       wo / wl.clamp_min(1e-30), **TOL)
            torch.testing.assert_close(m, wm, **TOL)
            torch.testing.assert_close(l, wl, **TOL)
        empty = args[4] == 0
        assert bool((o[empty] == 0).all() and (l[empty] == 0).all())
        assert bool((m[empty] == -1e30).all())


@pytest.mark.gpu
@pytest.mark.parametrize("case", PAGED_SPLIT_CASES, ids=str)
def test_paged_rows_are_the_single_token_reads_bitwise(cuda, case):
    """Row t of a T-wide read is the T=1 read of q[:, t] bit for bit (the
    split count and each row's arithmetic do not depend on T)."""
    q, *rest = _paged_split_case(cuda, *case, seed=1)
    full = fd._paged_mq_cuda(q, *rest)
    for t in range(q.shape[1]):
        one = fd._paged_mq_cuda(q[:, t:t + 1].contiguous(), *rest)
        for a, b in zip(full, one):
            assert torch.equal(a[:, t:t + 1], b)


@pytest.mark.gpu
def test_paged_split_counts_at_the_engine_shapes(cuda):
    """This card's split counts at the decode shape (B=8, K=16, 128
    columns) and the chunk shape (B=1, K=16, 64 columns): 7 and 16 on an
    H100's 132 SMs; more than one on any card."""
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    dec, chunk = (fd.paged_splits(8, 16, 128, n_sm),
                  fd.paged_splits(1, 16, 64, n_sm))
    assert dec > 1 and chunk > 1
    if n_sm == 132:
        assert (dec, chunk) == (7, 16)


@pytest.mark.gpu
def test_paged_split_kernel_replays_in_a_cuda_graph(cuda):
    """Captured once at the decode shape and replayed on new lengths
    written into the captured buffer: each replay equals the plain version,
    and the split counters stay zero between calls."""
    args = list(_paged_split_case(cuda, *PAGED_SPLIT_CASES[0], seed=2))
    fd._paged_mq_cuda(*args)                    # sizes the counters
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd._paged_mq_cuda(*args)
    lens = args[4]
    for scale in (1, 2, 3):
        lens.copy_(torch.tensor([90, 200, 1030, 17, 1, 0, 96, 288],
                                dtype=torch.int32, device=cuda) // scale)
        graph.replay()
        torch.cuda.synchronize()
        want = fd._paged_prefix_torch(*args)
        torch.testing.assert_close(out[0] / out[2].clamp_min(1e-30),
                                   want[0] / want[2].clamp_min(1e-30), **TOL)
        torch.testing.assert_close(out[1], want[1], **TOL)
        assert int(fd._PAGED_COUNTERS[lens.device].abs().sum()) == 0


# --------------------------------------------------------------------------
# The engine's steps as CUDA graphs: replay against the eager engine
# --------------------------------------------------------------------------

# (arch, engine options, prompt lengths): decode, chunk (int8 KV; mamba2
# on a pool small enough to preempt) and verify steps
GRAPH_CASES = {
    "qwen whole-prompt": ("qwen1.5-0.5b", dict(n_blocks=64), [5, 12, 9]),
    "qwen chunk=8 int8": ("qwen1.5-0.5b", dict(
        n_blocks=64, prefill_chunk=8, kv_quant="int8"), [5, 12, 9, 40]),
    "mamba2 chunk=8": ("mamba2-130m", dict(n_blocks=20, prefill_chunk=8),
                       [6, 17, 40]),
    "qwen ngram": ("qwen1.5-0.5b", dict(n_blocks=64, speculate="ngram",
                                        spec_depth=4), None),
    "qwen3-moe chunk=8 int8": ("qwen3-moe-30b-a3b", dict(
        n_blocks=64, prefill_chunk=8, kv_quant="int8"), [5, 12, 9, 40]),
    "qwen3-moe ngram": ("qwen3-moe-30b-a3b", dict(
        n_blocks=64, speculate="ngram", spec_depth=4), None),
    "jamba chunk=8": ("jamba-v0.1-52b", dict(n_blocks=64, prefill_chunk=8),
                      [6, 17, 40]),
    # verify steps with SSM layers (the per-token scan and the rollback
    # gather into the slot pool)
    "mamba2 ngram": ("mamba2-130m", dict(n_blocks=64, speculate="ngram",
                                         spec_depth=4), None),
    "jamba ngram": ("jamba-v0.1-52b", dict(n_blocks=64, speculate="ngram",
                                           spec_depth=4), None),
}


def _graph_run(cuda, case, cuda_graphs):
    from repro_torch.data.pipeline import repetitive_requests
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssd as ssdk
    arch, kw, lens = GRAPH_CASES[case]
    cfg = get_config(arch, reduced=True)
    params = LM(cfg, device=cuda).init(0)
    eng = Engine(cfg, params, max_batch=4, block_size=4, device=cuda,
                 cuda_graphs=cuda_graphs, **kw)
    prompts = (repetitive_requests(6, cfg.vocab_size, prompt_len=20,
                                   pattern_len=6) if lens is None else
               serving_requests(8, cfg.vocab_size, prompt_lens=lens))
    lens = sorted({len(p) for p in prompts})
    eng.warmup(max(lens) + 8, prompt_lens=lens)
    warm = dict(eng.trace_counts)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=8))
    for c in (fd.LAUNCHES, rn.LAUNCHES, ssdk.LAUNCHES):
        c.clear()
    done = eng.run()
    torch.cuda.synchronize()
    st = eng.stats()
    steps = st["decode_steps"] + st["chunk_steps"] + st["verify_steps"]
    kinds = cfg.layer_kinds()
    assert fd.LAUNCHES["paged_attention"] == kinds.count("attn") * steps
    forwards = steps + st["prefill_groups"]
    norms = sum(3 if k == "ssm" else 4 if cfg.qk_norm else 2
                for k in kinds) + 1
    assert rn.LAUNCHES["rmsnorm"] == norms * forwards
    assert ssdk.LAUNCHES["ssd"] == kinds.count("ssm") * (
        st["prefill_groups"] + st["chunk_steps"])
    if arch == "mamba2-130m" and "prefill_chunk" in kw:
        assert st["preemptions"] > 0
    assert len(done) == len(prompts)
    pools = ({k: v.clone() for k, v in eng.kv.pool().items()},
             [a.clone() for st_ in eng._ssm_states.values()
              for a in st_.values()])
    return eng, warm, {r.rid: r.output for r in done}, st, pools


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_replay_is_the_eager_engine_bitwise(cuda, case):
    """Smoke size on the card, after ``warmup`` for every bucket of the
    trace: the replaying engine's tokens, ``stats()`` counters and final
    KV pool (its null block aside: inactive rows' appends race there) and
    SSM pool equal the eager engine's bit for bit; it captured one graph a
    key in warmup and none while serving; and the launch counts hold
    through replay (paged read once a layer a decode, chunk or verify
    step, RMSNorm once a norm a forward, SSD once a layer a prefill
    pass)."""
    eng, warm, toks, st, pools = _graph_run(cuda, case, True)
    assert dict(eng.trace_counts) == warm and len(eng._graphs) == len(warm)
    eager, _, toks_e, st_e, pools_e = _graph_run(cuda, case, False)
    assert not eager._graphs
    assert toks == toks_e
    assert ({k: v for k, v in st.items() if not k.endswith("_s")} ==
            {k: v for k, v in st_e.items() if not k.endswith("_s")})
    for k in pools[0]:
        assert torch.equal(pools[0][k], pools_e[0][k]), k
    for a, b in zip(pools[1], pools_e[1]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_warmup_mid_burst_leaves_the_pools_on_the_card(cuda):
    """``warmup`` with live requests in both pools (mamba2's SSM slots,
    its dummy KV pool; qwen's KV pages) captures every bucket and leaves
    every byte of both, the null block included."""
    for arch, kw in (("mamba2-130m", dict(prefill_chunk=8)),
                     ("qwen1.5-0.5b", dict(prefill_chunk=8,
                                           kv_quant="int8"))):
        cfg = get_config(arch, reduced=True)
        eng = Engine(cfg, LM(cfg, device=cuda).init(0), max_batch=4,
                     n_blocks=64, block_size=4, device=cuda, **kw)
        for i, p in enumerate(serving_requests(4, cfg.vocab_size,
                                               prompt_lens=[6, 17, 40])):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=8))
        for _ in range(5):
            eng.step()
        before = [a.clone() for a in eng.kv.state.values()] + [
            a.clone() for st in eng._ssm_states.values()
            for a in st.values()]
        eng.warmup(48, prompt_lens=[6, 17, 40])
        torch.cuda.synchronize()
        after = list(eng.kv.state.values()) + [
            a for st in eng._ssm_states.values() for a in st.values()]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        assert len(eng._graphs) == len(eng.trace_counts) > 0


@pytest.mark.gpu
def test_replay_adds_each_graph_launches(cuda):
    """A decode graph of smoke qwen records one paged read a layer and
    2 x layers + 1 RMSNorm launches; the capture leaves the counters as
    they were and each replay adds that record once."""
    import numpy as np
    from repro_torch.kernels import rmsnorm as rn
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    eng = Engine(cfg, LM(cfg, device=cuda).init(0), max_batch=4,
                 n_blocks=64, block_size=4, device=cuda)
    eng.warmup(16)
    fd.LAUNCHES.clear()
    rn.LAUNCHES.clear()
    (key, graph), = eng._graphs.items()
    assert key == ("decode", 1, 4)
    want = {"paged_attention": cfg.n_layers, "rmsnorm": 2 * cfg.n_layers + 1}
    got = {k: n for c in graph.launches for k, n in c.items()}
    assert got == want
    inputs = dict(tokens=np.zeros(4, np.int32), lengths=np.zeros(4, np.int32),
                  table=np.zeros((4, 4), np.int32),
                  active=np.zeros(4, bool))
    for i in range(1, 4):
        graph.replay(inputs)
        assert fd.LAUNCHES["paged_attention"] == i * cfg.n_layers
        assert rn.LAUNCHES["rmsnorm"] == i * (2 * cfg.n_layers + 1)


# --------------------------------------------------------------------------
# The lifecycle slice on the card: the NaN mask through replayed graphs,
# in-place cache ops under captured graphs, the prefix cache, legacy mode
# --------------------------------------------------------------------------

# (arch, engine options, fault step, (rid, period)): a NaN armed while
# the rid decodes, and while it pages its prompt out
NAN_GRAPH_CASES = {
    "decode": ("qwen1.5-0.5b", dict(max_batch=3), 3, (2, 0)),
    "chunk": ("qwen1.5-0.5b", dict(max_batch=2, prefill_chunk=4,
                                   kv_quant="int8"), 1, (0, 1)),
}


def _lifecycle_run(cuda, arch, kw, prompts, max_new, faults=None,
                   drip=False, **more):
    cfg = get_config(arch, reduced=True)
    eng = Engine(cfg, LM(cfg, device=cuda).init(0), block_size=8,
                 device=cuda, faults=faults, **{**dict(n_blocks=48), **kw},
                 **more)
    lens = sorted({len(p) for p in prompts})
    eng.warmup(max(lens) + max_new, prompt_lens=lens)
    warm = dict(eng.trace_counts)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=list(p), max_new_tokens=max_new))
        if drip:
            eng.step()
    done = eng.run()
    torch.cuda.synchronize()
    return eng, warm, {r.rid: (r.state, list(r.output)) for r in done}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(NAN_GRAPH_CASES))
def test_armed_nan_through_replayed_graphs(cuda, case):
    """A NaN armed through a replayed decode or chunk graph quarantines
    exactly the armed row; every other request keeps the tokens of the
    unarmed replayed run bit for bit, and nothing was captured after
    warmup (the mask is one more static input)."""
    from repro_torch.serving.faults import FaultInjector, StepFaults
    arch, kw, step, nan = NAN_GRAPH_CASES[case]
    cfg = get_config(arch, reduced=True)
    prompts = serving_requests(4, cfg.vocab_size, prompt_lens=[12])
    _, _, base = _lifecycle_run(cuda, arch, kw, prompts, 5)
    inj = FaultInjector({step: StepFaults(nan=nan)})
    eng, warm, got = _lifecycle_run(cuda, arch, kw, prompts, 5, faults=inj)
    assert inj.log == [(step, "nan", nan)]
    assert dict(eng.trace_counts) == warm and len(eng._graphs) == len(warm)
    for rid, (state, out) in got.items():
        if rid == nan[0]:
            assert state == "failed"
        else:
            assert (state, out) == base[rid]
    assert eng.alloc.n_free == eng.alloc.n_blocks


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_in_place_cache_ops_keep_the_graphs_pools(cuda, arch):
    """``copy_block``, block scrubs and SSM snapshot restores (a drip-fed
    shared-prefix trace with the prefix cache on) write the pools in
    place: every pool tensor keeps its address, so the captured graphs
    read the live pools, and the replaying engine equals the eager one
    bit for bit (tokens, prefix counters, pool bytes)."""
    from repro_torch.data.pipeline import shared_prefix_requests
    from repro_torch.serving import cache as C
    cfg = get_config(arch, reduced=True)
    kw = dict(max_batch=2, prefill_chunk=8 if arch.startswith("qwen")
              else 32, prefix_cache=True)
    prompts = shared_prefix_requests(4, cfg.vocab_size, prefix_len=32 if
                                     arch.startswith("qwen") else 64,
                                     suffix_len=8, seed=3)
    runs = []
    for graphs in (True, False):
        eng = Engine(cfg, LM(cfg, device=cuda).init(0), block_size=8,
                     n_blocks=48, device=cuda, cuda_graphs=graphs, **kw)
        eng.warmup(80, prompt_lens=[len(prompts[0])])
        ptrs = [a.data_ptr() for a in eng.kv.state.values()] + [
            a.data_ptr() for st in eng._ssm_states.values()
            for a in st.values()]
        C.copy_block(eng.kv.state, 0, 1)
        C.scrub_blocks(eng.kv.state, [0, 1])
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, tokens=list(p), max_new_tokens=6))
            eng.step()
        done = eng.run()
        torch.cuda.synchronize()
        assert ptrs == [a.data_ptr() for a in eng.kv.state.values()] + [
            a.data_ptr() for st in eng._ssm_states.values()
            for a in st.values()]
        assert eng.prefix_hits > 0
        runs.append(({r.rid: r.output for r in done},
                     (eng.prefix_hits, eng.prefix_tokens_reused),
                     [a.clone() for a in eng.kv.pool().values()],
                     [a.clone() for st in eng._ssm_states.values()
                      for a in st.values()]))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2] + runs[0][3], runs[1][2] + runs[1][3]):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-130m"])
def test_prefix_cache_on_equals_off_on_the_card(cuda, arch):
    from repro_torch.data.pipeline import shared_prefix_requests
    cfg = get_config(arch, reduced=True)
    qwen = arch.startswith("qwen")
    kw = dict(max_batch=2, prefill_chunk=8 if qwen else 32,
              kv_quant="int8" if qwen else "none")
    prompts = shared_prefix_requests(4, cfg.vocab_size, prefix_len=24 if
                                     qwen else 64, suffix_len=8, seed=3)
    _, _, off = _lifecycle_run(cuda, arch, kw, prompts, 6, drip=True)
    eng, warm, on = _lifecycle_run(cuda, arch, {**kw, "prefix_cache": True},
                                   prompts, 6, drip=True)
    assert on == off
    assert eng.stats()["prefix_cache_hit_rate"] > 0.0
    assert dict(eng.trace_counts) == warm


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kv_quant", [("qwen1.5-0.5b", "none"),
                                           ("qwen1.5-0.5b", "int8"),
                                           ("mamba2-130m", "none")])
def test_legacy_matches_fused_on_the_card(cuda, arch, kv_quant):
    """The legacy oracle (eager, naive f32 attention over the gathered
    pages, the RMSNorm kernel) emits the replayed fused steps' tokens."""
    cfg = get_config(arch, reduced=True)
    prompts = serving_requests(5, cfg.vocab_size, prompt_lens=[12])
    outs = {}
    for mode in ("legacy", "fused"):
        _, _, outs[mode] = _lifecycle_run(
            cuda, arch, dict(max_batch=3, kv_quant=kv_quant), prompts, 5,
            mode=mode)
    assert outs["legacy"] == outs["fused"]


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True])
def test_paged_row_read_is_the_same_at_any_table_width(cuda, quant):
    """A row's kernel read with its table padded to wider buckets (more
    dead columns, more launched splits: 2 to 17 here) is bit for bit the
    same: a row splits its own live columns, at least 4 a split, so the
    batch's longest row, which sizes the engine's decode table, cannot
    change another row's read."""
    q, k, v, table, lengths, ks, vs = _case(cuda, 1, 16, 16, 64, quant)
    outs, splits = [], []
    for mb in (8, 16, 32, 64, 128):
        wide = torch.zeros((table.shape[0], mb), dtype=table.dtype,
                           device=cuda)
        wide[:, :table.shape[1]] = table
        outs.append(fd.paged_flash_prefix_partial(
            q, k, v, wide, lengths, k_scale=ks, v_scale=vs))
        splits.append(fd.paged_splits(3, 16, mb, torch.cuda.
                                      get_device_properties(cuda)
                                      .multi_processor_count))
    assert len(set(splits)) > 2
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the rest of one-device training
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_dense_batched_f32_output_gradient_matches_the_f32_route(cuda):
    """The MoE experts' gate/up products on the card (bf16 operands, f32
    output through ``bmm.dtype``, which has no derivative there) carry
    ``_BmmF32Out``'s gradient: the output and both gradients against the
    f32 route (both widened to f32), within the route's roundoff."""
    from repro_torch.models import layers as L
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((4, 96, 256), generator=g, device=cuda).bfloat16()
    w = (torch.randn((4, 256, 160), generator=g, device=cuda) / 16
         ).bfloat16()
    dy = torch.randn((4, 96, 160), generator=g, device=cuda)
    outs = []
    for route in ("card", "f32"):
        xs, ws = (t.clone().requires_grad_(True) for t in (x, w))
        y = (L.dense_batched(xs, ws, out_dtype=torch.float32)
             if route == "card" else
             L._dense_f32(xs, ws, torch.float32))
        outs.append((y.detach(), *torch.autograd.grad((y * dy).sum(),
                                                      (xs, ws))))
    assert outs[0][0].dtype == torch.float32
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        assert a.dtype == torch.bfloat16
        _assert_flash_close(a, b, ulps=1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,label", [
    ("qwen3-moe-30b-a3b", "F+R"), ("mamba2-130m", "F+R"),
    ("jamba-v0.1-52b", "F+R"), ("qwen1.5-0.5b", "Q8"),
    ("qwen1.5-0.5b", "Q")])
def test_train_steps_run_every_family_on_the_card(cuda, arch, label):
    """Smoke configs on the card: two steps of every family and of
    quantized full training, losses and gradient norms finite, the MoE
    load-balancing loss positive where there are MoE layers, the flash
    kernels launched by attention layers and the RMSNorm kernel by every
    norm."""
    from repro_torch.configs import get_config as cfg_of
    from repro_torch.core.config import technique_from_label
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.launch.build import make_model
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (build_train_step, default_opt_cfg,
                                        init_train_state)
    cfg = cfg_of(arch, reduced=True)
    tech = technique_from_label(label)
    model = make_model(cfg, tech, device=cuda)
    opt = AdamWConfig(lr=1e-3, warmup=0,
                      state_bits=default_opt_cfg(tech).state_bits)
    state, _ = init_train_state(model, tech, 0, opt)
    step = build_train_step(model, tech, opt)
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                              dtype=torch.int32).to(cuda)
             for k in ("tokens", "labels")}
    fa.LAUNCHES.clear()
    rn.LAUNCHES.clear()
    for _ in range(2):
        state, met = step(state, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert (float(met["aux"]) > 0) == cfg.is_moe
    n_attn = sum(k == "attn" for k in cfg.layer_kinds())
    assert fa.LAUNCHES["bwd_dq"] == (2 * n_attn if tech.flash else 0)
    assert rn.LAUNCHES["rmsnorm"] > 0


@pytest.mark.gpu
def test_prefetcher_copies_batches_to_the_card(cuda):
    """The worker copies each batch through pinned memory on its own
    stream; the consumer's stream waits on the copy: every batch equals
    ``batch_at`` of its step, in order."""
    from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticLM
    ds = SyntheticLM(DataConfig(vocab_size=1000, seq_len=256,
                                global_batch=4))
    pf = Prefetcher(iter(ds), device=cuda, depth=2)
    try:
        for step in range(6):
            got = next(pf)
            for k, want in ds.batch_at(step).items():
                assert got[k].is_cuda
                assert torch.equal(got[k].cpu(), torch.from_numpy(want))
    finally:
        pf.stop()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "internvl2-26b"])
def test_encdec_and_vlm_on_the_card(cuda, arch):
    """Smoke configs on the card: a flash prefill with frontend embeddings
    and four greedy decode steps, each token the teacher-forced forward's
    argmax or a 4-ulp near tie of it; the flash forward once a layer of
    the prefill (the encoder's non-causal ones included), the dense decode
    read once a decoder layer a step; two F+R steps through the train
    step, finite, the flash backward once a layer a step."""
    from repro_torch.core.config import technique_from_label
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.build import build_train, random_batch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import init_train_state
    cfg = get_config(arch, reduced=True)
    model = LM(cfg, attn_impl="flash", device=cuda)
    params = model.init(0)
    n_front = cfg.frontend_len if cfg.family == "vlm" else 0
    batch = random_batch(cfg, 2, n_front + 12, with_labels=False,
                         device=cuda)
    fa.LAUNCHES.clear()
    fd.LAUNCHES.clear()
    logits, cache, n = model.prefill(params, batch["tokens"], max_len=24,
                                     frontend_embeds=batch["frontend_embeds"])
    out = [logits.argmax(-1)]
    for _ in range(4):
        logits, cache = model.decode_step(params, cache,
                                          out[-1][:, None].int(), n)
        n = n + 1
        out.append(logits.argmax(-1))
    torch.cuda.synchronize()
    assert fa.LAUNCHES["fwd"] == cfg.n_layers + cfg.n_enc_layers
    assert fd.LAUNCHES["dense_decode"] == 4 * cfg.n_layers
    gen = torch.stack(out, 1)
    seq = torch.cat([batch["tokens"], gen[:, :4].int()], 1)
    full = model.forward(params, seq,
                         frontend_embeds=batch["frontend_embeds"]).float()
    rows = full[:, n_front + 11:]
    top = rows.max(-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
    assert bool((rows.gather(-1, gen[..., None].long())[..., 0]
                 >= top - 4 * ulp).all())
    step, tech, tmodel, opt = build_train(
        cfg, technique_from_label("F+R"), AdamWConfig(lr=1e-3, warmup=0),
        device=cuda)
    state, _ = init_train_state(tmodel, tech, 0, opt)
    train = random_batch(cfg, 2, n_front + 32, device=cuda)
    fa.LAUNCHES.clear()
    for _ in range(2):
        state, met = step(state, train)
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"]) and torch.isfinite(met["grad_norm"])
    assert fa.LAUNCHES["bwd_dq"] == 2 * (cfg.n_layers + cfg.n_enc_layers)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-v0.1-52b"])
def test_ssm_model_decode_on_the_card(cuda, arch):
    """Smoke configs on the card: ``prefill`` (the SSD kernel) and six
    greedy ``decode_step``s (the SSM cache stepped in place), each token
    the teacher-forced forward's argmax or a 4-ulp near tie of it; the SSD
    kernel launched by the prefill only."""
    from repro_torch.kernels import ssd as ssdk
    cfg = get_config(arch, reduced=True)
    model = LM(cfg, ssd_impl="kernel", device=cuda)
    params = model.init(0)
    toks = torch.randint(1, cfg.vocab_size, (2, 20),
                         generator=torch.Generator().manual_seed(0),
                         dtype=torch.int32).to(cuda)
    ssdk.LAUNCHES.clear()
    logits, cache, n = model.prefill(params, toks, max_len=32)
    out = [logits.argmax(-1)]
    for _ in range(6):
        logits, cache = model.decode_step(params, cache,
                                          out[-1][:, None].int(), n)
        n = n + 1
        out.append(logits.argmax(-1))
    torch.cuda.synchronize()
    assert ssdk.LAUNCHES["ssd"] == cfg.layer_kinds().count("ssm")
    gen = torch.stack(out, 1)
    full = model.forward(params, torch.cat([toks, gen[:, :6].int()],
                                           1)).float()
    rows = full[:, 19:]
    top = rows.max(-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top.abs())) - 7)
    assert bool((rows.gather(-1, gen[..., None].long())[..., 0]
                 >= top - 4 * ulp).all())
