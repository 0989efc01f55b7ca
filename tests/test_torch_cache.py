"""Paged KV storage: the port's int8 encode and its storage ops against
``repro.serving.cache``, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import cache as JC
from repro_torch.bridge import to_numpy
from repro_torch.serving import cache as TC


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8)


@pytest.mark.parametrize("shape", [(5, 16), (3, 4, 2, 64)])
def test_quant_encode_bitwise(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32)
    x[0, ...] = 0.0                        # all-zero vector: 1e-6 floor
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.tensor(x).bfloat16()
    qj, sj = JC.quant_encode(xj, "int8")
    qt, st = TC.quant_encode(xt, "int8")
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    np.testing.assert_array_equal(
        TC.quant_decode(qt, st, torch.float32).numpy(),
        np.asarray(JC.quant_decode(qj, sj, jnp.float32)))


def test_quant_encode_half_way_ties_round_to_even():
    """amax 127 gives a scale of exactly 1.0, so x.5 entries are exact
    ties: both packages round them half-to-even."""
    x = np.asarray([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]],
                   np.float32)
    qj, sj = JC.quant_encode(jnp.asarray(x), "int8")
    qt, st = TC.quant_encode(torch.tensor(x), "int8")
    assert float(st[0, 0]) == 1.0
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert qt[0].tolist() == [127, 2, -4, 0, 0, 2, 126, -126]


def test_quant_none_is_identity():
    x = torch.randn(3, 4)
    q, s = TC.quant_encode(x, "none")
    assert q is x and s is None


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_storage_sequence_matches_reference(quant):
    """write_prefill -> write_token_encoded (two live rows, two sentinel
    rows) -> truncate_slots leaves the port's pool byte-equal to the
    reference's, and no sentinel write touches a live block."""
    rng = np.random.default_rng(1)
    n_layers, kvh, hd, n_blocks, bs = 2, 2, 16, 8, 4
    jcfg = JC.PagedKVConfig(n_layers, kvh, hd, n_blocks, bs, quant)
    tcfg = TC.PagedKVConfig(n_layers, kvh, hd, n_blocks, bs, quant)
    js = JC.init_state(jcfg)
    tcache = TC.PagedKVCache(tcfg, device="cpu")
    seqs = {(3, 5): 6, (1, 6, 2): 9}
    for blocks, t in seqs.items():
        k = rng.standard_normal((n_layers, t, kvh, hd)).astype(np.float32)
        v = rng.standard_normal((n_layers, t, kvh, hd)).astype(np.float32)
        js = JC.write_prefill(js, quant, (jnp.asarray(k, jnp.bfloat16),
                                          jnp.asarray(v, jnp.bfloat16)),
                              list(blocks))
        tcache.write_prefill((torch.tensor(k).bfloat16(),
                              torch.tensor(v).bfloat16()), list(blocks))
    # decode append: rows 0/1 live (A at 6, B at 9), rows 2/3 inactive
    table = np.asarray([[3, 5, 0], [1, 6, 2], [0, 0, 0], [0, 0, 0]],
                       np.int32)
    pos = np.asarray([6, 9, 0, 5], np.int32)
    valid = np.asarray([True, True, False, False])
    k = rng.standard_normal((n_layers, 4, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((n_layers, 4, kvh, hd)).astype(np.float32)
    kq, ks = JC.quant_encode(jnp.asarray(k, jnp.bfloat16), quant)
    vq, vs = JC.quant_encode(jnp.asarray(v, jnp.bfloat16), quant)
    enc = {"k": kq, "v": vq}
    if ks is not None:
        enc.update(k_scale=ks, v_scale=vs)
    blk, off = JC.append_slots(jnp.asarray(table), jnp.asarray(pos), bs,
                               n_blocks, jnp.asarray(valid))
    js = JC.write_token_encoded(js, enc, blk, off)
    kq, ks = TC.quant_encode(torch.tensor(k).bfloat16(), quant)
    vq, vs = TC.quant_encode(torch.tensor(v).bfloat16(), quant)
    tenc = {"k": kq, "v": vq}
    if ks is not None:
        tenc.update(k_scale=ks, v_scale=vs)
    tblk, toff = TC.append_slots(torch.tensor(table), torch.tensor(pos),
                                 bs, n_blocks, torch.tensor(valid))
    assert tblk.tolist() == [5, 2, n_blocks, n_blocks]
    np.testing.assert_array_equal(tblk.numpy(), np.asarray(blk))
    np.testing.assert_array_equal(toff.numpy(), np.asarray(off))
    TC.write_token_encoded(tcache.state, tenc, tblk, toff)
    # rewind sequence A to 3 tokens (partial block 3, whole block 5)
    js = JC.truncate_slots(js, [3, 5], 3, bs)
    tcache.truncate_slots([3, 5], 3)
    pool = to_numpy(tcache.pool())
    assert pool.keys() == js.keys()
    for key in js:
        assert pool[key].shape == js[key].shape, key
        np.testing.assert_array_equal(_bits(pool[key]), _bits(js[key]),
                                      err_msg=key)
    # block 0 (and every unowned block) is untouched by the sentinels
    for key, arr in pool.items():
        fill = 1.0 if key.endswith("_scale") else 0.0
        for b in (0, 4, 7):
            assert np.all(np.asarray(arr[:, b], np.float32) == fill), key


def test_scrub_blocks_matches_reference():
    rng = np.random.default_rng(2)
    jcfg = JC.PagedKVConfig(1, 2, 8, 6, 4, "int8")
    tcfg = TC.PagedKVConfig(1, 2, 8, 6, 4, "int8")
    k = rng.standard_normal((1, 8, 2, 8)).astype(np.float32)
    js = JC.write_prefill(JC.init_state(jcfg), "int8",
                          (jnp.asarray(k, jnp.bfloat16),) * 2, [4, 1])
    js = JC.scrub_blocks(js, [1])
    tcache = TC.PagedKVCache(tcfg, device="cpu")
    tcache.write_prefill((torch.tensor(k).bfloat16(),) * 2, [4, 1])
    TC.scrub_blocks(tcache.state, [1])
    pool = to_numpy(tcache.pool())
    for key in js:
        np.testing.assert_array_equal(_bits(pool[key]), _bits(js[key]))


def test_allocator_contract():
    a = TC.BlockAllocator(4)
    got = a.alloc(3)
    assert len(set(got)) == 3 and a.n_free == 1
    with pytest.raises(TC.OutOfBlocks):
        a.alloc(2)
    a.release(got[:1])
    with pytest.raises(ValueError):
        a.release(got[:1])
    a.fail_next()
    with pytest.raises(TC.OutOfBlocks):
        a.alloc(1)
    assert a.n_free == 2 and a.utilization() == 0.5
