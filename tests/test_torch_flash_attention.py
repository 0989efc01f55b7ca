"""Flash attention: the port's plain versions against the JAX package's
Pallas kernels (interpret mode on the CPU, as tests/test_kernels.py runs
them) and its jnp oracle, the autograd wrapper against ``jax.grad``
through the reference's ``custom_vjp``, a float64 gradient check, and the
CUDA wrappers' refusals on the CPU. The CUDA kernels' own tests, which
need a card and no JAX, are in tests/test_torch_gpu.py."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jfa
from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.models import layers as TL

# tests/test_kernels.py's tolerances, by dtype
TOL = {"bf16": dict(atol=3e-2, rtol=3e-2), "f32": dict(atol=2e-5, rtol=2e-5)}
NP_DT = {"bf16": ml_dtypes.bfloat16, "f32": np.float32}

# tests/test_kernels.py:31-36; causal only where T == S (its contract)
SHAPES = [(1, 128, 128, 4, 4, 128), (2, 256, 256, 4, 2, 128),
          (1, 256, 256, 8, 1, 64), (2, 128, 384, 4, 4, 128)]
CASES = [(shape, causal) for shape in SHAPES for causal in (True, False)
         if not (causal and shape[1] != shape[2])]


def _rand(rng, shape, dt):
    return rng.standard_normal(shape).astype(np.float32).astype(NP_DT[dt])


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape,causal", CASES,
                         ids=[f"{s}-{'causal' if c else 'full'}"
                              for s, c in CASES])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_forward_matches_pallas_and_oracle(shape, causal, dt):
    """Model layout (B,T,H,D) through both packages' ``ops`` wrappers;
    the reference pads head_dim to 128 lanes, the port does not."""
    b, t, s, h, kv, d = shape
    rng = np.random.default_rng(0)
    q = _rand(rng, (b, t, h, d), dt)
    k = _rand(rng, (b, s, kv, d), dt)
    v = _rand(rng, (b, s, kv, d), dt)
    got = _f32(tops.flash_attention(_torch(q), _torch(k), _torch(v),
                                    causal=causal))
    assert got.shape == (b, t, h, d)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    np.testing.assert_allclose(
        got, _f32(ops.flash_attention(jq, jk, jv, causal=causal)), **TOL[dt])
    np.testing.assert_allclose(
        got, _f32(ref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **TOL[dt])


@pytest.mark.parametrize("shape,causal", [(SHAPES[1], True),
                                          (SHAPES[3], False)],
                         ids=["gqa-causal", "cross-full"])
def test_plain_kernels_match_pallas_kernels(shape, causal):
    """(o, lse) and (dq, dk, dv) of the plain versions against the TPU
    kernels' own outputs in the kernels' layout (B,H,T,D), f32."""
    b, t, s, h, kv, d = shape
    rng = np.random.default_rng(1)
    q = _rand(rng, (b, h, t, d), "f32")
    k = _rand(rng, (b, kv, s, d), "f32")
    v = _rand(rng, (b, kv, s, d), "f32")
    do = _rand(rng, (b, h, t, d), "f32")
    jo, jl = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     interpret=True)
    to, tl = tfa._flash_fwd_torch(_torch(q), _torch(k), _torch(v),
                                  causal=causal)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (b, h, t, 1)
    np.testing.assert_allclose(_f32(to), _f32(jo), **TOL["f32"])
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["f32"])
    jg = jfa.flash_attention_bwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jo, jl, jnp.asarray(do),
                                 causal=causal, interpret=True)
    tg = tfa._flash_bwd_torch(_torch(q), _torch(k), _torch(v),
                              _torch(np.asarray(jo)), _torch(np.asarray(jl)),
                              _torch(do), causal=causal)
    for name, a, c in zip(("dq", "dk", "dv"), tg, jg):
        np.testing.assert_allclose(_f32(a), _f32(c), err_msg=name,
                                   **TOL["f32"])


def test_gradient_matches_jax_grad_through_custom_vjp():
    """tests/test_kernels.py:52's shape; the loss sum(out**2) through the
    port's autograd.Function against jax.grad through ops.flash_attention,
    both f32."""
    b, t, h, kv, d = 1, 128, 4, 2, 128
    rng = np.random.default_rng(2)
    q = _rand(rng, (b, t, h, d), "f32")
    k = _rand(rng, (b, t, kv, d), "f32")
    v = _rand(rng, (b, t, kv, d), "f32")
    want = jax.grad(
        lambda q_, k_, v_: jnp.sum(ops.flash_attention(q_, k_, v_) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_torch(a).requires_grad_(True) for a in (q, k, v))
    torch.sum(tops.flash_attention(tq, tk, tv) ** 2).backward()
    for name, a, c in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        np.testing.assert_allclose(_f32(a.grad), _f32(c), err_msg=name,
                                   **TOL["f32"])


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_parts_equal_the_whole(causal):
    """The dK/dV and dQ kernels' plain functions, each alone, give the
    whole plain backward's outputs bit for bit (GQA, G = 2)."""
    rng = np.random.default_rng(6)
    q, do = (_torch(_rand(rng, (1, 4, 16, 8), "bf16")) for _ in range(2))
    k, v = (_torch(_rand(rng, (1, 2, 16, 8), "bf16")) for _ in range(2))
    o, lse = tfa._flash_fwd_torch(q, k, v, causal=causal)
    whole = tfa._flash_bwd_torch(q, k, v, o, lse, do, causal=causal)
    dq, dk0, dv0 = tfa._flash_bwd_torch(q, k, v, o, lse, do, causal=causal,
                                        part="dq")
    dq0, dk, dv = tfa._flash_bwd_torch(q, k, v, o, lse, do, causal=causal,
                                       part="dkv")
    assert dk0 is None and dv0 is None and dq0 is None
    for a, b in zip((dq, dk, dv), whole):
        assert torch.equal(a, b)


def test_autograd_function_passes_gradcheck_f64():
    """Tiny causal GQA case in float64 (the plain versions keep f64)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 5, 4, 3), generator=g, dtype=torch.float64)
    k = torch.randn((1, 5, 2, 3), generator=g, dtype=torch.float64)
    v = torch.randn((1, 5, 2, 3), generator=g, dtype=torch.float64)
    for x in (q, k, v):
        x.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b_, c: tops.flash_attention(a, b_, c, causal=True),
        (q, k, v))


def test_flash_equals_naive_with_gradients():
    """layers.attention's two modes compute one function: values and
    gradients agree in f32 (naive rounds nothing in f32)."""
    rng = np.random.default_rng(3)
    q, k, v = (_torch(_rand(rng, (2, 16, 4, 8), "f32")).requires_grad_(True)
               for _ in range(3))
    w = _torch(_rand(rng, (2, 16, 4, 8), "f32"))
    outs = []
    for mode in ("naive", "flash"):
        out = TL.attention(q, k, v, mode=mode, causal=True)
        grads = torch.autograd.grad((out * w).sum(), (q, k, v))
        outs.append((out.detach(), *grads))
    for a, c in zip(*outs):
        torch.testing.assert_close(a, c, rtol=2e-5, atol=2e-5)


def test_flash_rejects_offsets_the_reference_ignores():
    """The reference's ``ops.flash_attention`` drops ``q_offset`` and
    ``kv_len``. The port still raises on ``kv_len``, and applies
    ``q_offset`` as the reference's oracle does (f32, 2e-5)."""
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="kv_len"):
        tops.flash_attention(x, x, x, kv_len=torch.tensor([3]))
    rng = np.random.default_rng(8)
    q = _rand(rng, (1, 4, 2, 8), "f32")
    k, v = (_rand(rng, (1, 9, 2, 8), "f32") for _ in range(2))
    got = tops.flash_attention(_torch(q), _torch(k), _torch(v), q_offset=2)
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_offset=2)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL["f32"])


# (T, S, q_offset): an offset on the kernels' 64-row tile, one off it,
# and keys past every row's reach (S > T + q_offset), which get zero dK/dV
OFFSETS = [(16, 80, 64), (16, 60, 37), (16, 100, 20)]


@pytest.mark.parametrize("t,s,off", OFFSETS,
                         ids=["on-tile", "off-tile", "past-reach"])
@pytest.mark.parametrize("g", [1, 2])
def test_plain_q_offset_matches_reference_oracle(t, s, off, g):
    """The plain forward and backward with a causal ``q_offset`` (model
    layout, through the autograd wrapper) against the reference's oracle
    ``flash_attention_ref(q_offset=)`` and its ``jax.vjp``, f32, within
    rtol = atol = 2e-5."""
    b, kv, d = 2, 2, 8
    rng = np.random.default_rng(9)
    q = _rand(rng, (b, t, kv * g, d), "f32")
    k, v = (_rand(rng, (b, s, kv, d), "f32") for _ in range(2))
    w = _rand(rng, (b, t, kv * g, d), "f32")
    jout, vjp = jax.vjp(lambda q_, k_, v_: ref.flash_attention_ref(
        q_, k_, v_, q_offset=off), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    jgrads = vjp(jnp.asarray(w))
    tq, tk, tv = (_torch(a).requires_grad_(True) for a in (q, k, v))
    out = tops.flash_attention(tq, tk, tv, q_offset=off)
    tgrads = torch.autograd.grad(out, (tq, tk, tv), _torch(w))
    np.testing.assert_allclose(_f32(out), _f32(jout), **TOL["f32"])
    for name, a, c in zip(("dq", "dk", "dv"), tgrads, jgrads):
        np.testing.assert_allclose(_f32(a), _f32(c), err_msg=name,
                                   **TOL["f32"])
    if s > t + off:               # keys no row reaches
        assert not tgrads[1][:, t + off:].any()
        assert not tgrads[2][:, t + off:].any()


@pytest.mark.parametrize("tp", [2, 4])
def test_rank_rows_equal_the_whole_sequence(tp):
    """A sequence split over ``tp`` ranks: each rank's rows of the plain
    versions, with its offset over the keys it reaches (those gathered
    from every rank), give the whole sequence's o and lse rows bit for
    bit, and its dq rows too; the ranks' dK/dV partials over those keys,
    kept in f32 (``kv_f32``) and summed, give the whole run's dK/dV (f32,
    2e-5)."""
    b, h, kv, t, d = 1, 4, 2, 32, 8
    rng = np.random.default_rng(10)
    q, do = (_torch(_rand(rng, (b, h, t, d), "f32")) for _ in range(2))
    k, v = (_torch(_rand(rng, (b, kv, t, d), "f32")) for _ in range(2))
    o, lse = tfa._flash_fwd_torch(q, k, v)
    dq, dk, dv = tfa._flash_bwd_torch(q, k, v, o, lse, do)
    dk_sum, dv_sum = torch.zeros_like(dk), torch.zeros_like(dv)
    for r in range(tp):
        lo, hi = r * t // tp, (r + 1) * t // tp
        qr, dor = q[:, :, lo:hi], do[:, :, lo:hi]
        kr, vr = k[:, :, :hi], v[:, :, :hi]
        o_r, lse_r = tfa._flash_fwd_torch(qr, kr, vr, q_offset=lo)
        assert torch.equal(o_r, o[:, :, lo:hi])
        assert torch.equal(lse_r, lse[:, :, lo:hi])
        dq_r, dk_r, dv_r = tfa._flash_bwd_torch(qr, kr, vr, o_r, lse_r, dor,
                                                q_offset=lo, kv_f32=True)
        assert torch.equal(dq_r, dq[:, :, lo:hi])
        dk_sum[:, :, :hi] += dk_r
        dv_sum[:, :, :hi] += dv_r
    torch.testing.assert_close(dk_sum, dk, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(dv_sum, dv, rtol=2e-5, atol=2e-5)


def test_kv_f32_is_the_rounded_outputs_sums():
    """The plain backward's f32 dK/dV (``kv_f32``), rounded, are its bf16
    dK/dV bit for bit, and dq is unchanged (bf16, G = 2, an offset)."""
    rng = np.random.default_rng(11)
    q, do = (_torch(_rand(rng, (1, 4, 16, 8), "bf16")) for _ in range(2))
    k, v = (_torch(_rand(rng, (1, 2, 40, 8), "bf16")) for _ in range(2))
    o, lse = tfa._flash_fwd_torch(q, k, v, q_offset=9)
    dq, dk, dv = tfa._flash_bwd_torch(q, k, v, o, lse, do, q_offset=9)
    dq2, dk32, dv32 = tfa._flash_bwd_torch(q, k, v, o, lse, do, q_offset=9,
                                           kv_f32=True)
    assert dk32.dtype == dv32.dtype == torch.float32
    assert torch.equal(dq2, dq)
    assert torch.equal(dk32.to(torch.bfloat16), dk)
    assert torch.equal(dv32.to(torch.bfloat16), dv)


def test_cuda_path_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """The kernel wrappers take no CPU detour: what the kernels cannot
    take raises, CPU tensors included, and without nvcc the build raises
    before it writes anything."""
    q = torch.zeros((1, 2, 64, 64))
    k = torch.zeros((1, 1, 64, 64))
    with pytest.raises(ValueError, match="bf16/f32"):
        tfa._fwd_cuda(q.double(), k.double(), k.double(), causal=True,
                      sm_scale=None)
    wide = torch.zeros((1, 2, 64, 192))
    with pytest.raises(ValueError, match="head_dim"):
        tfa._fwd_cuda(wide, wide[:, :1], wide[:, :1], causal=True,
                      sm_scale=None)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa._fwd_cuda(q, k, k, causal=True, sm_scale=None)
    lse = torch.zeros((1, 2, 64, 1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa._bwd_cuda(q, k, k, q, lse, q, causal=True, sm_scale=None)
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    tfa._entries.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            tfa._entries()
    finally:
        tfa._entries.cache_clear()
    assert not (tmp_path / "build").exists()
    assert sum(tfa.LAUNCHES.values()) == 0


def _bf16_ulps_beyond(a, b, atol=1e-5):
    """Worst |a - b| beyond ``atol``, in bf16 ulps of the larger
    magnitude (chip_smoke.py's rule for bf16 outputs)."""
    a, b = _f32(a), _f32(b)
    mag = np.maximum(np.abs(a), np.abs(b)).clip(2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.max(np.clip(np.abs(a - b) - atol, 0, None) / ulp))


# (B, T, S, H, K, D, causal): G in {1, 2, 4}, D in {64, 128}, causal and
# full, T != S (the reference's blocks must divide T and S)
SPLIT_CASES = [(1, 128, 128, 4, 4, 64, True), (1, 128, 128, 4, 2, 128, True),
               (1, 64, 256, 4, 1, 64, False), (2, 128, 128, 2, 2, 128, False)]


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_backward_matches_pallas_kernel(case):
    """The tensor-core body's arithmetic (P and dS as bf16 hi + lo, every
    product in f32) against the TPU kernels' backward in interpret mode on
    the same bf16 inputs: dq, dk, dv within one bf16 ulp at G = 1 and two
    at G > 1, beyond a 1e-5 floor (chip_smoke.py's flash limits)."""
    b, t, s, h, kv, d, causal = case
    rng = np.random.default_rng(9)
    q, do = (_rand(rng, (b, h, t, d), "bf16") for _ in range(2))
    k, v = (_rand(rng, (b, kv, s, d), "bf16") for _ in range(2))
    jo, jl = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     interpret=True)
    jg = jfa.flash_attention_bwd(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jo, jl, jnp.asarray(do),
                                 causal=causal, interpret=True)
    tg = tfa._flash_bwd_split_torch(
        _torch(q), _torch(k), _torch(v), _torch(np.asarray(jo)),
        _torch(np.asarray(jl)), _torch(do), causal=causal)
    ulps = 1 if h == kv else 2
    for name, a, c in zip(("dq", "dk", "dv"), tg, jg):
        assert a.dtype == torch.bfloat16
        assert _bf16_ulps_beyond(a, c) <= ulps, name


def test_hi_lo_split_rebuilds_f32_to_2_pow_minus_16():
    """hi = bf16(x), lo = bf16(x - hi): hi + lo is x within 2^-16 |x|
    over magnitudes 1e-20..1e20, and hi alone is not (2^-9)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-20, 20, 100_000))
                         .astype(np.float32))
    hi, lo = tfa.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    rel = ((hi.float() + lo.float()) - x).abs() / x.abs()
    assert float(rel.max()) <= 2.0 ** -16
    assert float(((hi.float() - x).abs() / x.abs()).max()) > 2.0 ** -10


def test_three_part_split_rebuilds_f32_to_2_pow_minus_24():
    """Three bf16 parts (the f32-output ``dense`` gradient's cotangent)
    sum to x within 2^-24 |x|, an f32 rounding."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal(100_000)
                          * 10.0 ** rng.uniform(-20, 20, 100_000))
                         .astype(np.float32))
    parts = tfa.split_bf16(x, 3)
    assert len(parts) == 3 and all(p.dtype == torch.bfloat16 for p in parts)
    back = (parts[0].float() + parts[1].float()) + parts[2].float()
    assert float(((back - x).abs() / x.abs()).max()) <= 2.0 ** -24


@pytest.fixture
def one_thread():
    """torch's CPU ops on the calling thread: in some processes one
    worker of torch's thread pool evaluates f32 exp at ~1.5e-4 relative
    error (see tests/test_torch_ssd.py), above the lse limit here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (B, T, S, H, K, D, causal): D in {64, 128} x causal and full x G in
# {1, 2}; causal only where T == S (the reference's contract)
FWD_SPLIT_CASES = [(1, 128, 128, 2, 2, 64, True), (1, 128, 128, 4, 2, 64, True),
                   (1, 128, 128, 2, 2, 128, True),
                   (1, 128, 128, 4, 2, 128, True),
                   (1, 64, 256, 2, 2, 64, False), (1, 64, 256, 4, 2, 64, False),
                   (2, 64, 128, 2, 2, 128, False),
                   (1, 64, 256, 4, 2, 128, False)]


@pytest.mark.parametrize("case", FWD_SPLIT_CASES, ids=str)
def test_split_forward_matches_pallas_kernel(one_thread, case):
    """The tensor-core forward's arithmetic (S from the bf16 values, the
    scale after, P as bf16 hi + lo) against the TPU kernel's forward in
    interpret mode on the same bf16 inputs, and against the plain
    version: o within two bf16 ulps beyond a 1e-5 floor, lse (f32) within
    rtol = atol = 2e-5 (chip_smoke.py's flash limits)."""
    b, t, s, h, kv, d, causal = case
    rng = np.random.default_rng(10)
    q = _rand(rng, (b, h, t, d), "bf16")
    k, v = (_rand(rng, (b, kv, s, d), "bf16") for _ in range(2))
    jo, jl = jfa.flash_attention_fwd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     interpret=True)
    args = (_torch(q), _torch(k), _torch(v))
    to, tl = tfa._flash_fwd_split_torch(*args, causal=causal)
    assert to.dtype == torch.bfloat16 and tl.dtype == torch.float32
    po, pl = tfa._flash_fwd_torch(*args, causal=causal)
    for want_o, want_l in ((jo, jl), (po, pl)):
        assert _bf16_ulps_beyond(to, want_o) <= 2
        np.testing.assert_allclose(_f32(tl), _f32(want_l), **TOL["f32"])
