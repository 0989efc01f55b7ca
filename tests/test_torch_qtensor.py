"""The port's quantizers against the JAX package's on the same numpy-seeded
bf16 weights: int8 and nf4 codes, scales and dequantized values, and the
leaves ``quantize_tree`` picks.

int8 is elementwise after one absmax, so it is bit-equal everywhere. nf4's
double quantization subtracts the mean of each row's block scales; XLA
and torch sum that mean in different orders, which agree at qwen1.5-0.5b's
block counts per layer (64 and 128 at smoke size, 16,384 for the
full-width attention weights) but may round one f32 ulp apart at others,
so the other shapes hold the codes and the int8 block scales bit-equal
and the two f32 double-quant values to one ulp."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models.lm import LM as JLM
from repro.quant import qtensor as jq
from repro_torch.bridge import from_jax_numpy, to_numpy
from repro_torch.models.params import tree_paths
from repro_torch.quant import qtensor as pq

# (shape, stacked): qwen1.5-0.5b smoke wq and w_down, a full-width wq
# layer pair, and an odd shape whose flat length is not a block multiple
SHAPES = [((2, 64, 4, 16), True), ((2, 128, 64), True),
          ((2, 1024, 16, 64), True), ((64, 128), False),
          ((3, 100, 70), True), ((1000, 333), False)]


MODEL_BLOCKS = (64, 128, 16384)


def _bf16(shape, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(jnp.bfloat16)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _same_bits(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("shape,stacked", SHAPES, ids=str)
def test_int8_matches_the_reference_bitwise(shape, stacked):
    w = _bf16(shape, seed=len(shape))
    jt = jq.quantize_int8(jnp.asarray(w))
    pt = pq.quantize_int8(from_jax_numpy(w))
    assert (pt.kind, pt.shape, pt.scale2) == ("int8", shape, None)
    assert pt.dtype_orig == torch.bfloat16
    assert _same_bits(to_numpy(pt.data), jax.device_get(jt.data))
    assert _same_bits(to_numpy(pt.scale), jax.device_get(jt.scale))
    assert tuple(pt.scale.shape) == shape[:-1] + (1,)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        assert _same_bits(to_numpy(pt.dequantize(dtype)),
                          jax.device_get(jt.dequantize(jdt)))


def test_int8_rounds_half_to_even():
    """|w| / scale lands on x.5 for these weights: both frameworks round
    to even (NUM discipline of cache.py's encode)."""
    w = np.array([[127.0, 0.5, 1.5, 2.5, -2.5, -0.5]], np.float32)
    pt = pq.quantize_int8(torch.from_numpy(w))
    jt = jq.quantize_int8(jnp.asarray(w))
    assert pt.data.tolist() == [[127, 0, 2, 2, -2, 0]]
    assert np.array_equal(np.asarray(jt.data), pt.data.numpy())


@pytest.mark.parametrize("shape,stacked", SHAPES, ids=str)
def test_nf4_matches_the_reference(shape, stacked):
    w = _bf16(shape, seed=7 + len(shape))
    jt = jax.device_get(jq.quantize_nf4(jnp.asarray(w), stacked=stacked))
    pt = pq.quantize_nf4(from_jax_numpy(w), stacked=stacked)
    assert (pt.kind, pt.shape) == ("nf4", tuple(jt.shape))
    assert _same_bits(to_numpy(pt.data), jt.data)
    assert _same_bits(to_numpy(pt.scale), jt.scale)
    model_shape = (np.prod(shape[1:] if stacked else shape) // pq.NF4_BLOCK
                   in MODEL_BLOCKS)
    for got, want in zip(pt.scale2, jt.scale2):
        got = to_numpy(got)
        if model_shape:
            assert _same_bits(got, want)
        else:
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
    # dequantize the reference's own codes and scales: bit-equal
    ref_in_port = from_jax_numpy(jt)
    for dtype, jdt in ((torch.bfloat16, jnp.bfloat16),
                       (torch.float32, jnp.float32)):
        assert _same_bits(to_numpy(ref_in_port.dequantize(dtype)),
                          jax.device_get(jt.dequantize(jdt)))


def test_nf4_stacked_slice_dequantizes_per_layer():
    """A per-layer slice of a stacked nf4 QTensor (data (packed,), scales
    (nb,)) dequantizes to that layer's rows, as lax.scan slices it."""
    w = from_jax_numpy(_bf16((3, 64, 48), seed=3))
    qt = pq.quantize_nf4(w, stacked=True)
    whole = qt.dequantize(torch.float32)
    assert whole.shape == (3, 64, 48)
    for i in range(3):
        sl = pq.QTensor(qt.data[i], qt.scale[i],
                        tuple(s[i] for s in qt.scale2), "nf4", qt.shape,
                        qt.dtype_orig)
        assert torch.equal(sl.dequantize(torch.float32), whole[i])


@pytest.mark.parametrize("kind", ["int8", "nf4"])
def test_quantize_tree_picks_the_reference_leaves(kind):
    """The same leaves quantized (large matrices) and kept (norms,
    biases), with the same kinds and static shapes, on the smoke params;
    int8 leaves bit-equal."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    params = jax.device_get(JLM(cfg).init(jax.random.PRNGKey(0)))
    jtree = jax.device_get(jq.quantize_tree(
        jax.tree_util.tree_map(jnp.asarray, params), kind))
    ptree = pq.quantize_tree(from_jax_numpy(params), kind)
    is_q = lambda x: isinstance(x, (jq.QTensor, pq.QTensor))  # noqa: E731
    want = dict(tree_paths(from_jax_numpy(jtree), is_leaf=is_q))
    got = dict(tree_paths(ptree, is_leaf=is_q))
    assert got.keys() == want.keys()
    quantized = sorted(p for p, v in got.items() if is_q(v))
    assert quantized == sorted(p for p, v in want.items() if is_q(v))
    assert quantized == ["blocks/pos0/ffn/w_down", "blocks/pos0/ffn/w_gate",
                         "blocks/pos0/ffn/w_up", "blocks/pos0/mix/wk",
                         "blocks/pos0/mix/wo", "blocks/pos0/mix/wq",
                         "blocks/pos0/mix/wv", "embed"]
    for path in quantized:
        assert (got[path].kind, got[path].shape) == (
            want[path].kind, want[path].shape), path
        if kind == "int8":
            for f in ("data", "scale"):
                assert torch.equal(getattr(got[path], f),
                                   getattr(want[path], f)), (path, f)
