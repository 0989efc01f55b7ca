"""Paged multi-query attention partials: the port's plain version against
both of the JAX package's implementations (the Pallas kernel in interpret
mode and the XLA column loop), the port's T=1 == decode contract and the
plain merge helpers. The CUDA kernel's own tests, which need a card and
no JAX, are in tests/test_torch_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as jfd
from repro.serving import cache as JC
from repro_torch.kernels import flash_decode as tfd

TOL = dict(rtol=2e-5, atol=2e-5)     # the repo's f32 kernel tolerance


def _paginate(k, v, table, bs, n_blocks):
    b, s, n_kv, d = k.shape
    k_pages = np.zeros((n_blocks, bs, n_kv, d), np.float32)
    v_pages = np.zeros((n_blocks, bs, n_kv, d), np.float32)
    for bi in range(b):
        for j in range(table.shape[1]):
            k_pages[table[bi, j]] = k[bi, j * bs:(j + 1) * bs]
            v_pages[table[bi, j]] = v[bi, j * bs:(j + 1) * bs]
    return k_pages, v_pages


def _case(t, h, kv, quant, seed=0):
    """The reference's contract shapes: a full row, a short row whose
    trailing bucket columns are dead, and a zero-length row."""
    rng = np.random.default_rng(seed)
    b, bs, mb, n_blocks, d = 3, 4, 4, 16, 16
    s = bs * mb
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    lengths = np.asarray([s, bs + 2, 0], np.int32)
    table = np.asarray([[5, 2, 9, 1], [3, 7, 0, 0], [0, 0, 0, 0]], np.int32)
    kp, vp = _paginate(k, v, table, bs, n_blocks)
    ks = vs = None
    if quant:
        kq, ksj = JC.quant_encode(jnp.asarray(kp), "int8")
        vq, vsj = JC.quant_encode(jnp.asarray(vp), "int8")
        kp, vp = np.asarray(kq), np.asarray(vq)
        ks, vs = np.asarray(ksj), np.asarray(vsj)
    return q, kp, vp, table, lengths, ks, vs


def _jax(args, impl):
    q, kp, vp, table, lengths, ks, vs = args
    opt = (lambda a: None if a is None else jnp.asarray(a))
    return jfd.paged_flash_prefix_partial(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lengths), k_scale=opt(ks), v_scale=opt(vs), impl=impl,
        interpret=True)


def _tensors(args):
    return tuple(None if a is None else torch.tensor(a) for a in args)


def _port(args):
    q, kp, vp, table, lengths, ks, vs = _tensors(args)
    return tfd.paged_flash_prefix_partial(q, kp, vp, table, lengths,
                                          k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("t", [1, 4, 8])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 1), (4, 4)])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_plain_matches_reference(t, quant, h, kv, impl):
    args = _case(t, h, kv, quant)
    want = _jax(args, impl)
    got = _port(args)
    for name, a, b in zip("oml", want, got):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)
    # the zero-length row is exactly empty: o = 0, l = 0, m = -1e30
    o, m, l = got
    assert torch.all(o[2] == 0) and torch.all(l[2] == 0)
    assert torch.all(m[2] == np.float32(-1e30))


@pytest.mark.parametrize("quant", [False, True])
def test_t1_prefix_read_is_decode_read_bitwise(quant):
    q, kp, vp, table, lengths, ks, vs = _case(1, 4, 2, quant, seed=1)
    opt = (lambda a: None if a is None else torch.tensor(a))
    pages = (torch.tensor(kp), torch.tensor(vp), torch.tensor(table),
             torch.tensor(lengths))
    one = tfd.paged_flash_decode_partial(torch.tensor(q[:, 0]), *pages,
                                         k_scale=opt(ks), v_scale=opt(vs))
    mq = tfd.paged_flash_prefix_partial(torch.tensor(q), *pages,
                                        k_scale=opt(ks), v_scale=opt(vs))
    for a, b in zip(one, mq):
        assert torch.equal(a, b[:, 0])


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("h,kv", [(4, 2), (4, 4)])
def test_causal_self_partial_and_merge(t, h, kv):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, t, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, kv, 16)).astype(np.float32)
    want = jfd.causal_self_partial(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), sm_scale=0.25)
    got = tfd.causal_self_partial(torch.tensor(q), torch.tensor(k),
                                  torch.tensor(v), sm_scale=0.25)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    # merge with a paged prefix partial (one zero-length row)
    args = _case(t, h, kv, False, seed=3)
    args = (args[0][:2],) + args[1:3] + (args[3][1:], args[4][1:]) + \
        args[5:]
    pre_j = _jax(args, "xla")
    pre_t = _port(args)
    np.testing.assert_allclose(
        tfd.merge_partials([pre_t, got]).numpy(),
        np.asarray(jfd.merge_partials([pre_j, want])), **TOL)


def test_wrapper_takes_plain_version_only_for_host_tensors():
    """CPU tensors run the plain version and launch nothing."""
    tfd.LAUNCHES.clear()
    _port(_case(2, 4, 2, False))
    assert tfd.LAUNCHES["paged_attention"] == 0


def _bad(case: str):
    q, kp, vp, table, lengths, ks, vs = _tensors(_case(2, 4, 2, True))
    q = q.bfloat16()
    if case == "q_f16":
        q = q.half()
    elif case == "q_f32":
        q = q.float()
    elif case == "pages_f32":
        kp, vp, ks, vs = kp.float(), vp.float(), None, None
    elif case == "page_dtypes_differ":
        vp = vp.float()
    elif case == "int8_without_scales":
        ks = vs = None
    elif case == "bf16_with_scales":
        kp, vp = kp.bfloat16(), vp.bfloat16()
    elif case == "scale_shape":
        ks = ks[:, :2].contiguous()
    elif case == "table_int64":
        table = table.long()
    elif case == "lengths_shape":
        lengths = lengths[:2]
    elif case == "head_dim_256":
        q = torch.zeros(*q.shape[:-1], 256, dtype=torch.bfloat16)
        kp = torch.zeros(*kp.shape[:-1], 256, dtype=torch.int8)
        vp = kp.clone()
    elif case == "q_not_contiguous":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    return q, kp, vp, table, lengths, ks, vs


@pytest.mark.parametrize("case", [
    "q_f16", "q_f32", "pages_f32", "page_dtypes_differ", "int8_without_scales",
    "bf16_with_scales", "scale_shape", "table_int64", "lengths_shape",
    "head_dim_256", "q_not_contiguous"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The CUDA wrapper validates before it loads or launches anything, so
    its checks run on host tensors too."""
    with pytest.raises(ValueError, match="paged_attention"):
        tfd._paged_mq_cuda(*_bad(case))
