"""Dense-cache decode partials: the port's plain version against the JAX
package's ``flash_decode_partial`` (the Pallas kernel in interpret mode)
at the reference kernel test's shapes, two half-cache partials merged as
in tests/test_kernels.py:87, ragged S against ``flash_decode_ref``, a
zero-length row, and the model-layout wrapper. The CUDA kernel's own
tests, which need a card and no JAX, are in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops

TOL = dict(rtol=2e-5, atol=2e-5)     # the repo's f32 kernel tolerance
# tests/test_kernels.py:72-75 (B, S, H, K, D)
SHAPES = [(2, 256, 4, 4, 128), (3, 512, 8, 2, 128), (2, 256, 4, 1, 64)]


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU ops on the calling thread: in some processes one
    worker of torch's thread pool evaluates f32 exp at ~1.5e-4 relative
    error (see tests/test_torch_ssd.py), above these tests' limits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(b, s, h, kv, d, lengths, seed=0):
    """q (B, H, D) and k/v in the kernel layout (B, K, S, D), f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, s, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


def _t(*arrs):
    return [torch.from_numpy(a.copy()) for a in arrs]


def _normalized(o, l):
    return np.asarray(o) / np.maximum(np.asarray(l), 1e-30)


@pytest.mark.parametrize("b,s,h,kv,d", SHAPES)
def test_partials_match_pallas_kernel(b, s, h, kv, d):
    q, k, v, lens = _case(b, s, h, kv, d, [s // 2, s, max(s // 4, 1)][:b])
    oj, mj, lj = jfd.flash_decode_partial(
        *[jnp.asarray(a) for a in (q, k, v, lens)], interpret=True)
    before = tfd.LAUNCHES["dense_decode"]
    ot, mt, lt = tfd.flash_decode_partial(*_t(q, k, v, lens))
    assert tfd.LAUNCHES["dense_decode"] == before  # CPU: the plain version
    assert ot.dtype == mt.dtype == lt.dtype == torch.float32
    np.testing.assert_allclose(_normalized(ot, lt), _normalized(oj, lj),
                               **TOL)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_half_cache_partials_merge_to_the_full_answer():
    """tests/test_kernels.py:87: two half-cache partials LSE-merge to the
    full-cache answer (2e-4, that test's limit)."""
    b, s, kv, h, d = 2, 512, 2, 4, 128
    q, k, v, lens = _case(b, s, h, kv, d, [300, 512])
    half = s // 2
    qt, kt, vt, lt = _t(q, k, v, lens)
    p0 = tfd.flash_decode_partial(qt, kt[:, :, :half], vt[:, :, :half],
                                  torch.clamp(lt, max=half))
    p1 = tfd.flash_decode_partial(qt, kt[:, :, half:], vt[:, :, half:],
                                  torch.clamp(lt - half, min=0))
    merged = tfd.merge_partials([p0, p1])
    want = rref.flash_decode_ref(jnp.asarray(q)[:, None],
                                 jnp.asarray(k).swapaxes(1, 2),
                                 jnp.asarray(v).swapaxes(1, 2),
                                 jnp.asarray(lens))[:, 0]
    np.testing.assert_allclose(merged.numpy(), np.asarray(want),
                               atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("s,bk", [(65, 256), (100, 32), (1068, 256)])
def test_ragged_s_matches_reference_oracle(s, bk):
    """S that no block divides (the draft model's max_len = context + k),
    which the TPU wrapper refuses: the plain version's last block is
    ragged. Held against the definitional ``flash_decode_ref``."""
    b, h, kv, d = 3, 4, 2, 16
    q, k, v, lens = _case(b, s, h, kv, d, [s, s - 7, 1], seed=s)
    o, m, l = tfd._dense_decode_torch(*_t(q, k, v, lens), bk=bk)
    want = rref.flash_decode_ref(jnp.asarray(q)[:, None],
                                 jnp.asarray(k).swapaxes(1, 2),
                                 jnp.asarray(v).swapaxes(1, 2),
                                 jnp.asarray(lens))[:, 0]
    np.testing.assert_allclose(_normalized(o, l), np.asarray(want), **TOL)


def test_zero_length_row_is_empty():
    q, k, v, lens = _case(3, 40, 4, 2, 16, [40, 0, 13], seed=2)
    o, m, l = tfd.flash_decode_partial(*_t(q, k, v, lens))
    assert bool((o[1] == 0).all()) and bool((l[1] == 0).all())
    assert bool((m[1] == -1e30).all())
    full = tfd.flash_decode_partial(*_t(q, k, v, np.asarray([40, 40, 13],
                                                            np.int32)))
    for a, b_ in zip((o, m, l), full):       # other rows untouched
        assert torch.equal(a[[0, 2]], b_[[0, 2]])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_model_layout_wrapper_matches_reference(dtype):
    """``ops.flash_decode`` on the models' (B, S, K, D) cache and (B, 1, H,
    D) query against the reference's ``ops.flash_decode``, which pads
    head_dim to 128 lanes and runs the Pallas kernel (bf16 at the
    reference kernel test's bf16 tolerance, tests/test_kernels.py:22)."""
    b, s, h, kv, d = 2, 256, 4, 2, 64
    q, k, v, lens = _case(b, s, h, kv, d, [100, 256], seed=4)
    q = q[:, None]
    k, v = k.swapaxes(1, 2).copy(), v.swapaxes(1, 2).copy()   # (B,S,K,D)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    want = rops.flash_decode(*[jnp.asarray(a).astype(jdt)
                               for a in (q, k, v)], jnp.asarray(lens))
    got = tops.flash_decode(*[t.to(tdt) for t in _t(q, k, v)],
                            torch.from_numpy(lens))
    assert got.shape == tuple(want.shape) and got.dtype == tdt
    tol = TOL if dtype == "f32" else dict(atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"), ("dtype_mix", "all be bf16 or all f32"),
    ("groups", "G must be"), ("head_dim", "head_dim"),
    ("lengths", "lengths must be int32"), ("strides", "contiguous along")])
def test_cuda_wrapper_refuses_bad_inputs(case, match):
    q = torch.zeros((2, 4, 16))
    k = torch.zeros((2, 2, 8, 16))
    v = torch.zeros((2, 2, 8, 16))
    lens = torch.zeros(2, dtype=torch.int32)
    if case == "dtype_mix":
        k, v = k.bfloat16(), v.bfloat16()
    elif case == "groups":
        q = torch.zeros((2, 18, 16))                  # G = 9 > 8
    elif case == "head_dim":
        q, k, v = (torch.zeros(t.shape[:-1] + (160,)) for t in (q, k, v))
    elif case == "lengths":
        lens = torch.zeros(2, dtype=torch.int64)
    elif case == "strides":
        k = torch.zeros((2, 2, 16, 8)).transpose(2, 3)
    before = tfd.LAUNCHES["dense_decode"]
    with pytest.raises(ValueError, match=match):
        tfd._dense_decode_cuda(q, k, v, lens)
    assert tfd.LAUNCHES["dense_decode"] == before


# (B, S, H, K, D, lengths, n_split): several split counts, splits past a
# row's length (a short row, a split count above the length) and a
# zero-length row
SPLIT_CASES = [(2, 256, 4, 4, 128, [128, 256], 2),
               (3, 512, 8, 2, 128, [256, 512, 128], 5),
               (2, 256, 4, 1, 64, [128, 256], 16),
               (3, 512, 8, 4, 64, [500, 0, 7], 12),
               (2, 256, 4, 2, 64, [3, 256], 64)]


@pytest.mark.parametrize("b,s,h,kv,d,lens,n_split", SPLIT_CASES)
def test_split_partials_match_pallas_kernel(b, s, h, kv, d, lens, n_split):
    """The kernel's split arithmetic (per-split partials over [i·c,
    min((i+1)·c, len)), c = ceil(len / n_split), rescaled to the common max
    and summed in split order) against the JAX package's
    ``flash_decode_partial`` at 2e-5; a zero-length row stays empty."""
    q, k, v, ln = _case(b, s, h, kv, d, lens, seed=n_split)
    oj, mj, lj = jfd.flash_decode_partial(
        *[jnp.asarray(a) for a in (q, k, v, ln)], interpret=True)
    ot, mt, lt = tfd._dense_decode_torch(*_t(q, k, v, ln), n_split=n_split)
    np.testing.assert_allclose(_normalized(ot, lt), _normalized(oj, lj),
                               **TOL)
    live = ln > 0
    np.testing.assert_allclose(mt.numpy()[live], np.asarray(mj)[live], **TOL)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    empty = ~live
    assert bool((ot[empty] == 0).all() and (lt[empty] == 0).all())
    assert bool((mt[empty] == -1e30).all())


def test_split_spans_cover_each_row_once():
    """Split i of a row covers [i·c, min((i+1)·c, len)): the spans tile
    [0, len) in order, and splits past the length are empty."""
    lens = torch.tensor([0, 1, 67, 1064, 5000], dtype=torch.int32)
    spans = tfd.split_spans(lens, 1068, 16)
    assert len(spans) == 16
    for r, n in enumerate([0, 1, 67, 1064, 1068]):
        edges = [(int(lo[r]), int(hi[r])) for lo, hi in spans]
        assert edges[0][0] == 0 and edges[-1][1] == n
        assert all(a[1] == b_[0] for a, b_ in zip(edges, edges[1:]))
        assert all(lo <= hi for lo, hi in edges)
    assert [int(hi[2] - lo[2]) for lo, hi in spans] == [5] * 13 + [2, 0, 0]


@pytest.mark.parametrize("b,n_kv,s,want", [
    (1, 16, 1068, 16), (8, 16, 4096, 3), (1, 16, 65, 1), (4, 4, 8192, 17),
    (1, 1, 100000, 64), (64, 16, 4096, 1)])
def test_split_count_fills_the_card(b, n_kv, s, want):
    """About two blocks per SM over the B·K pairs (132 SMs), at least 64
    positions of S a split, at most 64 splits."""
    assert tfd.dense_splits(b, n_kv, s, 132) == want
