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


# --------------------------------------------------------------------------
# the split kernel's arithmetic (n_split column spans, merged in order)
# --------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """torch's CPU ops on the calling thread: in some processes one
    worker of torch's thread pool evaluates f32 exp at ~1.5e-4 relative
    error (see tests/test_torch_ssd.py), above these tests' limits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(args, n_split):
    q, kp, vp, table, lengths, ks, vs = _tensors(args)
    return tfd._paged_prefix_torch(q, kp, vp, table, lengths, ks, vs,
                                   n_split=n_split)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("t", [1, 4, 64])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2)], ids=["G1", "G2"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_split_plain_matches_reference(one_thread, n_split, t, h, kv, quant,
                                       impl):
    """The plain version with the kernel's column spans and merge
    against the JAX package's paged read (the Pallas kernel in interpret
    mode, and the XLA column loop) at 2e-5, on the reference's contract
    case (a full row, a short row with dead bucket columns, an empty
    row); splits past a row's columns are empty, and the empty row stays
    o = 0, l = 0, m = -1e30."""
    args = _case(t, h, kv, quant, seed=n_split)
    want = _jax(args, impl)
    got = _plain(args, n_split)
    for name, a, b in zip("oml", want, got):
        assert tuple(b.shape) == a.shape, name
        np.testing.assert_allclose(b.numpy(), np.asarray(a), err_msg=name,
                                   **TOL)
    o, m, l = got
    assert torch.all(o[2] == 0) and torch.all(l[2] == 0)
    assert torch.all(m[2] == np.float32(-1e30))


def _column_loop(q, k_pages, v_pages, table, lengths, k_scale, v_scale):
    """The plain version as it stood before the split (one running state
    per row over every live column), kept to pin ``n_split=1`` to it."""
    b, tq, h, d = q.shape
    _, bs, n_kv, _ = k_pages.shape
    g = h // n_kv
    qg = q.reshape(b, tq, n_kv, g, d).float() * (1.0 / float(np.sqrt(d)))
    m = torch.full((b, tq, n_kv, g), -1e30, dtype=torch.float32)
    l = torch.zeros((b, tq, n_kv, g), dtype=torch.float32)
    acc = torch.zeros((b, tq, n_kv, g, d), dtype=torch.float32)
    neg = torch.full((), -1e30, dtype=torch.float32)
    n_cols = min(table.shape[1], (int(lengths.max()) + bs - 1) // bs)
    for j in range(n_cols):
        blk = table[:, j].long()
        k = k_pages[blk].float()
        v = v_pages[blk].float()
        if k_scale is not None:
            k = k * k_scale[blk]
            v = v * v_scale[blk]
        s = torch.einsum("btkgd,bskd->btkgs", qg, k)
        kpos = j * bs + torch.arange(bs)
        valid = (kpos[None, :] < lengths[:, None])[:, None, None, None, :]
        s = torch.where(valid, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(valid, torch.exp(s - m_new[..., None]),
                        torch.zeros(()))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("btkgs,bskd->btkgd", p, v)
        m = m_new
    return (acc.reshape(b, tq, h, d), m.reshape(b, tq, h, 1),
            l.reshape(b, tq, h, 1))


@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_one_split_is_the_column_loop_bitwise(t, quant):
    args = _tensors(_case(t, 4, 2, quant, seed=5))
    for a, b in zip(tfd._paged_prefix_torch(*args, n_split=1),
                    _column_loop(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_split", [1, 2, 3, 16, 64])
def test_page_spans_cover_each_live_column_once(n_split):
    """Split i of a row takes columns [i·c, min((i+1)·c, n)), n the row's
    live columns (its length, capped by the table, over the page size),
    c = ceil(n / s), s = max(1, min(n_split, ceil(n / 4))) the row's own
    split count: the spans tile [0, n) in order, at most s of them hold
    columns, and the splits past them are empty."""
    bs, mb = 16, 64
    lens = torch.tensor([0, 1, 16, 17, 936, 1024, 5000], dtype=torch.int32)
    spans = tfd.page_spans(lens, bs, mb, n_split)
    assert len(spans) == n_split
    for r, n in enumerate([0, 1, 1, 2, 59, 64, 64]):
        s = max(1, min(n_split, -(-n // 4)))
        edges = [(int(lo[r]), int(hi[r])) for lo, hi in spans]
        assert edges[0][0] == 0 and edges[-1][1] == n
        assert all(a[1] == b_[0] for a, b_ in zip(edges, edges[1:]))
        assert all(0 <= hi - lo <= -(-n // s) for lo, hi in edges)
        assert sum(hi > lo for lo, hi in edges) <= s
        assert all(lo == hi == n for lo, hi in edges[s:])


@pytest.mark.parametrize("b,kv", [(8, 16), (1, 16), (8, 32), (3, 2)])
def test_a_rows_spans_do_not_follow_the_table_width(b, kv):
    """With ``paged_splits``' count a row's spans are the same at every
    power-of-two table width that holds it: the engine sizes a decode
    step's table by the batch's longest row, so a row's read must not
    depend on which rows share its step (found by the chaos run of
    chip_smoke phase 22: a survivor decoded beside other rows than in the
    fault-free run split its pages otherwise)."""
    bs = 16
    lens = torch.tensor([0, 1, 17, 70, 128, 100], dtype=torch.int32)
    seen = []
    for mb in (8, 16, 32, 64, 128):
        n_split = tfd.paged_splits(b, kv, mb, 132)
        spans = tfd.page_spans(lens, bs, mb, n_split)
        seen.append([[(int(lo[r]), int(hi[r])) for lo, hi in spans
                      if hi[r] > lo[r]] for r in range(len(lens))])
    assert all(s == seen[0] for s in seen)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_plain_split_read_is_the_same_at_any_table_width(one_thread, quant):
    """The plain split read of a row, padded to wider tables (more dead
    columns, more empty splits at ``paged_splits``' count), is bit for
    bit the same: empty splits add exact zeros to the merge."""
    q, kp, vp, table, lengths, ks, vs = _tensors(_case(1, 4, 2, quant,
                                                       seed=7))
    outs = []
    for mb in (4, 8, 32, 64):
        wide = torch.zeros((table.shape[0], mb), dtype=table.dtype)
        wide[:, :table.shape[1]] = table
        outs.append(tfd._paged_prefix_torch(
            q, kp, vp, wide, lengths, ks, vs,
            n_split=tfd.paged_splits(q.shape[0], kp.shape[2], mb, 132)))
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert torch.equal(a, b)


def test_split_count_reads_shapes_only():
    """``paged_splits`` takes B, K, the table width and the SM count, and
    nothing of the window (T) or of ``lengths``: about six blocks per SM
    over the B·K pairs, at most one per 4 table columns and 64 in all. On
    132 SMs the decode shape (B=8, K=16, 128 columns) takes 7 splits and
    the chunk shape (B=1, K=16, 64 columns) 16."""
    import inspect
    assert list(inspect.signature(tfd.paged_splits).parameters) == [
        "b", "n_kv", "mb", "n_sm"]
    assert tfd.paged_splits(8, 16, 128, 132) == 7
    assert tfd.paged_splits(1, 16, 64, 132) == 16
    assert tfd.paged_splits(1, 1, 1024, 132) == 64
    assert tfd.paged_splits(1, 16, 4, 132) == 1
    assert tfd.paged_splits(64, 16, 128, 132) == 1
    assert tfd.paged_splits(3, 2, 8, 132) == 2


@pytest.mark.parametrize("n_split", [1, 3])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_rows_of_a_window_are_the_single_token_reads(one_thread, n_split,
                                                     quant):
    """Row t of a T-wide plain read is the T=1 read of q[:, t], at the
    same split count, within 2e-5 (the kernel's rows are bitwise the T=1
    reads, checked on the card; here torch's CPU einsum blocks its sums by
    T, so only the function is the same)."""
    q, kp, vp, table, lengths, ks, vs = _tensors(_case(8, 4, 2, quant,
                                                       seed=6))
    full = tfd._paged_prefix_torch(q, kp, vp, table, lengths, ks, vs,
                                   n_split=n_split)
    for t in range(q.shape[1]):
        one = tfd._paged_prefix_torch(q[:, t:t + 1], kp, vp, table, lengths,
                                      ks, vs, n_split=n_split)
        for a, b in zip(full, one):
            torch.testing.assert_close(a[:, t:t + 1], b, **TOL)
