"""The int8 weight-only matmul's plain version and autograd wrapper against
the JAX package on the same numpy-seeded inputs: the reference's Pallas
kernel (``ops.int8_matmul``, interpret mode on the CPU, as its own tests
run it) and its oracle ``ref.int8_matmul_ref``; the grouped-scale form
against a per-head loop of the reference kernel; and x's gradient against
``jax.grad``. The CUDA kernel itself runs only on the card
(``tests/test_torch_gpu.py``); here the wrapper takes the plain version
because the tensors lie on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant.qtensor import quantize_int8 as jquantize_int8
from repro_torch.bridge import from_jax_numpy
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.kernels import quant_matmul as qmm

# the repo's f32 kernel tolerance (tests/test_kernels.py:22); XLA's CPU dot
# and torch's matmul sum the same f32 products in different orders
TOL = dict(rtol=2e-5, atol=2e-5)
BF16_ATOL = 1e-5


def _case(m, k, n, x_dtype, seed=0, heads=None):
    """x ~ N(0, 1); w ~ N(0, 1/K), the model's fan-in-scaled init, in
    bf16, quantized by the reference (int8 codes and f32 last-axis
    scales); w is (K, heads, N/heads) when ``heads`` is given."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(x_dtype)
    shape = (k, n) if heads is None else (k, heads, n // heads)
    w = (rng.standard_normal(shape) / np.sqrt(k)).astype(jnp.bfloat16)
    qt = jax.device_get(jquantize_int8(jnp.asarray(w)))
    return x, np.asarray(qt.data), np.asarray(qt.scale)


def _assert_bf16_close(got, want, ulps=1):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want)).clip(2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    assert np.all(np.abs(got - want) <= BF16_ATOL + ulps * ulp)


def _assert_close(got: torch.Tensor, want):
    if got.dtype == torch.bfloat16:
        _assert_bf16_close(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (64, 512, 384),
                                   (7, 96, 40)])
@pytest.mark.parametrize("x_dtype", [jnp.bfloat16, np.float32],
                         ids=["bf16", "f32"])
def test_plain_matches_the_reference_kernel_and_oracle(m, k, n, x_dtype):
    """f32 outputs within 2e-5, bf16 within one bf16 ulp (beyond a 1e-5
    floor) of both the reference kernel and its oracle; the output takes
    x's type, as the reference's does."""
    x, q, s = _case(m, k, n, x_dtype, seed=m)
    before = qmm.LAUNCHES["int8_matmul"]
    got = qmm.int8_matmul_kernel(from_jax_numpy(x), from_jax_numpy(q),
                                 from_jax_numpy(s))
    assert qmm.LAUNCHES["int8_matmul"] == before      # the CPU launches none
    assert got.dtype == from_jax_numpy(x).dtype and got.shape == (m, n)
    for want in (jops.int8_matmul(jnp.asarray(x), jnp.asarray(q),
                                  jnp.asarray(s)),
                 jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(s))):
        _assert_close(got, np.asarray(want, np.float32))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_output_type_is_one_rounding_of_the_f32_product(out_dtype):
    """``out_dtype`` f32 keeps the accumulator (the q/k/v and gate/up
    projections ask for it); bf16 rounds it once. Either is the f32
    product with the weight dequantized to f32, exactly."""
    x, q, s = _case(33, 80, 48, jnp.bfloat16, seed=5)
    tx, tq, ts = (from_jax_numpy(a) for a in (x, q, s))
    got = qmm.int8_matmul_plain(tx, tq, ts, out_dtype=out_dtype)
    exact = tx.float() @ (tq.float() * ts)
    assert got.dtype == out_dtype
    assert torch.equal(got, exact.to(out_dtype))


@pytest.mark.parametrize("heads", [4, 16])
def test_grouped_scales_equal_a_per_head_loop_of_the_reference(heads):
    """q/k/v: w (K, H, hd) quantized over its last axis has scales
    (K, H, 1); the port passes them as (K, G=H) in one call, and each
    head's columns equal the reference kernel on that head alone."""
    k, hd = 64, 16
    x, q, s = _case(48, k, heads * hd, np.float32, seed=heads, heads=heads)
    got = qmm.int8_matmul_plain(
        from_jax_numpy(x), from_jax_numpy(q.reshape(k, heads * hd)),
        from_jax_numpy(s.reshape(k, heads)))
    want = np.concatenate(
        [np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(q[:, h]),
                                     jnp.asarray(s[:, h])))
         for h in range(heads)], axis=-1)
    _assert_close(got, want)


@pytest.mark.parametrize("x_dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_x_gradient_matches_jax_grad(x_dtype):
    """``ops.int8_matmul``'s dx (``dy @ Wᵀ`` on the f32 weight) against
    ``jax.grad`` of the reference oracle, over leading batch axes; x's
    type in and out, no gradient for the frozen codes and scales."""
    x, q, s = _case(24, 80, 48, x_dtype, seed=9)
    x3 = x.reshape(2, 12, 80)
    rng = np.random.default_rng(10)
    dy = rng.standard_normal((2, 12, 48)).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(
        jref.int8_matmul_ref(a, jnp.asarray(q), jnp.asarray(s)).astype(
            jnp.float32) * dy))(jnp.asarray(x3))
    tx = from_jax_numpy(x3).requires_grad_(True)
    tq, ts = from_jax_numpy(q), from_jax_numpy(s)
    y = kops.int8_matmul(tx, tq, ts)
    assert y.shape == (2, 12, 48) and y.dtype == tx.dtype
    (got,) = torch.autograd.grad((y.float() * torch.from_numpy(dy)).sum(),
                                 tx)
    assert got.dtype == tx.dtype and not tq.requires_grad
    _assert_close(got, np.asarray(want, np.float32))


def test_cuda_wrapper_refuses_host_tensors():
    x, q, s = _case(4, 32, 16, np.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        qmm._qmm_cuda(*(from_jax_numpy(a) for a in (x, q, s)))


def test_a_missing_compiler_raises_instead_of_falling_back(monkeypatch,
                                                            tmp_path):
    """Without nvcc (or with a failed build) the kernel's entry point
    raises; no path swaps in the plain version for a card's tensors."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(_build, "_LIBS", {})
    qmm._entries.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc"):
            qmm._entries()
    finally:
        qmm._entries.cache_clear()


# --------------------------------------------------------------------------
# the tensor-core body's split arithmetic (``_qmm_split_torch``)
# --------------------------------------------------------------------------

# (M, K, N, G): tests/test_kernels.py's shapes, a grouped one (4 heads of
# 16) and ragged ones (M, K and N off every tile; 65-wide groups)
SPLIT_CASES = [(128, 256, 128, 1), (64, 512, 384, 1), (48, 64, 64, 4),
               (7, 130, 70, 1), (7, 1000, 1040, 16)]


def _grouped_case(m, k, n, g, x_dtype, seed):
    """``_case`` with the weight quantized as (K, G, N/G): codes (K, N),
    scales (K, G), as ``layers.dense`` hands them to the kernel."""
    heads = None if g == 1 else g
    x, q, s = _case(m, k, n, x_dtype, seed=seed, heads=heads)
    return x, q.reshape(k, n), s.reshape(k, g)


def _reference_kernel(x, q, s):
    """The JAX package's Pallas kernel, one call per column group."""
    g, k = s.shape[1], q.shape[0]
    cols = q.shape[1] // g
    return np.concatenate(
        [np.asarray(jops.int8_matmul(
            jnp.asarray(x), jnp.asarray(q[:, h * cols:(h + 1) * cols]),
            jnp.asarray(s[:, h:h + 1])), np.float32) for h in range(g)],
        axis=-1)


def _placements(g):
    return ("w", "x") if g == 1 else ("w",)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
@pytest.mark.parametrize("x_dtype", [jnp.bfloat16, np.float32],
                         ids=["bf16", "f32"])
def test_split_arithmetic_matches_the_reference_kernel_and_plain(case,
                                                                 x_dtype):
    """Each placement of the scale, both x types: the sum of the bf16 part
    products equals the reference kernel (interpret mode, x's type out)
    and the plain version (f32 out) within the repo's 2e-5, bf16 outputs
    within one bf16 ulp."""
    m, k, n, g = case
    x, q, s = _grouped_case(m, k, n, g, x_dtype, seed=k + n)
    tx, tq, ts = (from_jax_numpy(a) for a in (x, q, s))
    ref = _reference_kernel(x, q, s)
    plain = qmm.int8_matmul_plain(tx, tq, ts, out_dtype=torch.float32)
    for placement in _placements(g):
        got = qmm._qmm_split_torch(tx, tq, ts, placement=placement)
        assert got.dtype == tx.dtype and got.shape == (m, n)
        _assert_close(got, ref)
        got32 = qmm._qmm_split_torch(tx, tq, ts, placement=placement,
                                     out_dtype=torch.float32)
        torch.testing.assert_close(got32, plain, **TOL)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
@pytest.mark.parametrize("x_dtype", [jnp.bfloat16, np.float32],
                         ids=["bf16", "f32"])
def test_split_hi_parts_alone_break_the_limit(case, x_dtype):
    """The planted build's arithmetic: the split operands' hi parts alone
    are off the plain version by ~2^-9 of each term, far past 2e-5."""
    m, k, n, g = case
    x, q, s = _grouped_case(m, k, n, g, x_dtype, seed=k + n)
    tx, tq, ts = (from_jax_numpy(a) for a in (x, q, s))
    plain = qmm.int8_matmul_plain(tx, tq, ts, out_dtype=torch.float32)
    for placement in _placements(g):
        bad = qmm._qmm_split_torch(tx, tq, ts, placement=placement,
                                   hi_only=True, out_dtype=torch.float32)
        assert not torch.allclose(bad, plain, **TOL)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_three_bf16_parts_rebuild_the_scaled_operand_exactly(case):
    """``split_bf16(q·s, 3)`` and ``split_bf16(x·s, 3)`` (f32 x and bf16
    x) sum to their f32 operand exactly, and the codes are exact in bf16:
    every part product the kernel runs is an exact piece of a term."""
    from repro_torch.kernels.flash_attention import split_bf16
    m, k, n, g = case
    for x_dtype in (np.float32, jnp.bfloat16):
        x, q, s = _grouped_case(m, k, n, g, x_dtype, seed=k + n)
        tx, tq, ts = (from_jax_numpy(a) for a in (x, q, s))
        w = qmm.dequantize_groups(tq, ts)
        xs = tx.float() * ts[:, :1].T
        for v in (w, xs):
            parts = split_bf16(v, 3)
            assert all(p.dtype == torch.bfloat16 for p in parts)
            rebuilt = sum(p.double() for p in parts)
            assert torch.equal(rebuilt, v.double())
        assert torch.equal(tq.to(torch.bfloat16).float(), tq.float())
