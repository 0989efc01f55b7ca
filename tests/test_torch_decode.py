"""Model-level dense-cache decode: ``LM.init_cache``, ``LM.prefill(max_len=)``
and ``LM.decode_step`` of the port against the JAX package's
(``attn_impl="naive"``) on the same bridged qwen1.5-0.5b smoke weights,
one step and several; the decode branch against the port's own
teacher-forced forward; ``naive_attention``'s ``q_offset``/``kv_len``
against the reference's; and the parts not ported raising.

Limits: logits within the bf16 bound of the reference kernel tests
(rtol = atol = 3e-2, tests/test_kernels.py:22): the two sides sum f32
products in different orders and round bf16 activations apart by an ulp,
and the reference's naive read rounds its probabilities to bf16 where the
port's dense decode read keeps them f32. Greedy tokens must agree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import layers as RL
from repro.models.lm import LM
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as PortLM

BF16 = dict(rtol=3e-2, atol=3e-2)
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def models():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    port = PortLM(port_config("qwen1.5-0.5b", reduced=True), device="cpu")
    return model, params, port, from_jax_numpy(jax.device_get(params))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def test_init_cache_matches_reference_layout(models):
    model, _, port, _ = models
    want = model.init_cache(3, 20)
    got = port.init_cache(3, 20)
    assert set(got) == set(want)
    for pos in want:
        for leaf in ("k", "v"):
            assert tuple(got[pos][leaf].shape) == want[pos][leaf].shape
            assert got[pos][leaf].dtype == torch.bfloat16
            assert not bool(got[pos][leaf].any())
        # two tensors: decode writes each in place
        assert got[pos]["k"].data_ptr() != got[pos]["v"].data_ptr()


def test_prefill_pads_the_cache_like_the_reference(models):
    model, params, port, tparams = models
    toks = np.random.default_rng(0).integers(
        1, 256, (2, 9)).astype(np.int32)
    lj, cj, nj = model.prefill(params, {"tokens": jnp.asarray(toks)},
                               max_len=14)
    lt, ct, nt = port.prefill(tparams, torch.from_numpy(toks), max_len=14)
    np.testing.assert_allclose(_f32(lt), _f32(lj), **BF16)
    assert nt.tolist() == np.asarray(nj).tolist() == [9, 9]
    for pos in cj:
        for leaf in ("k", "v"):
            a, b = _f32(ct[pos][leaf]), _f32(cj[pos][leaf])
            assert a.shape == b.shape == (2, 2, 14, 4, 16)
            assert not a[:, :, 9:].any()               # the zero padding
            np.testing.assert_allclose(a, b, **BF16)


@pytest.mark.parametrize("steps", [1, 5])
def test_decode_steps_match_reference(models, steps):
    """From a padded prefill, ``steps`` greedy decode steps on both sides
    (each fed its own argmax, which must agree): logits at the bf16 bound
    every step, the caches too."""
    model, params, port, tparams = models
    toks = np.random.default_rng(1).integers(
        1, 256, (2, 7)).astype(np.int32)
    _, cj, nj = model.prefill(params, {"tokens": jnp.asarray(toks)},
                              max_len=7 + steps)
    _, ct, nt = port.prefill(tparams, torch.from_numpy(toks),
                             max_len=7 + steps)
    nxt = np.asarray([[3], [11]], np.int32)
    for _ in range(steps):
        lj, cj = model.decode_step(params, cj, jnp.asarray(nxt), nj)
        lt, ct = port.decode_step(tparams, ct, torch.from_numpy(nxt), nt)
        nj, nt = nj + 1, nt + 1
        np.testing.assert_allclose(_f32(lt), _f32(lj), **BF16)
        assert (_f32(lt).argmax(-1) == _f32(lj).argmax(-1)).all()
        nxt = _f32(lj).argmax(-1).astype(np.int32)[:, None]
    for pos in cj:
        np.testing.assert_allclose(_f32(ct[pos]["k"]), _f32(cj[pos]["k"]),
                                   **BF16)


def test_decode_from_the_reference_cache(models):
    """The reference's own prefill cache, bridged (``from_jax_numpy``, bf16
    bit for bit), decoded one step on both sides from the same bits:
    logits at the bf16 bound, and the written k/v slot of every layer
    within it."""
    model, params, port, tparams = models
    toks = np.random.default_rng(4).integers(
        1, 256, (2, 6)).astype(np.int32)
    _, cj, nj = model.prefill(params, {"tokens": jnp.asarray(toks)},
                              max_len=8)
    ct = from_jax_numpy(jax.device_get(cj))
    for pos in cj:
        assert np.array_equal(_f32(ct[pos]["k"]), _f32(cj[pos]["k"]))
    nxt = np.asarray([[9], [17]], np.int32)
    lj, cj = model.decode_step(params, cj, jnp.asarray(nxt), nj)
    lt, ct = port.decode_step(tparams, ct, torch.from_numpy(nxt),
                              torch.from_numpy(np.asarray(nj)))
    np.testing.assert_allclose(_f32(lt), _f32(lj), **BF16)
    assert (_f32(lt).argmax(-1) == _f32(lj).argmax(-1)).all()
    for pos in cj:
        for leaf in ("k", "v"):
            np.testing.assert_allclose(_f32(ct[pos][leaf])[:, :, 6],
                                       _f32(cj[pos][leaf])[:, :, 6], **BF16)


def test_decode_step_equals_teacher_forced_forward(models):
    """The dense decode read against the port's own whole-sequence
    forward over the same tokens: each step's logits equal the forward's
    at that position within the bf16 bound (the forward's naive read
    rounds its probabilities to bf16)."""
    _, _, port, tparams = models
    seq = torch.from_numpy(np.random.default_rng(2).integers(
        1, 256, (1, 12)).astype(np.int32))
    full = port.forward(tparams, seq)[0]                       # (12, V)
    _, cache, n = port.prefill(tparams, seq[:, :8], max_len=12)
    for t in range(8, 12):
        logits, cache = port.decode_step(tparams, cache, seq[:, t:t + 1], n)
        n = n + 1
        np.testing.assert_allclose(_f32(logits[0]), _f32(full[t]), **BF16)


@pytest.mark.parametrize("causal,q_offset,kv_len", [
    (True, 0, None), (True, 5, None), (False, 0, [9, 3]),
    (True, 2, [11, 6])])
def test_naive_attention_offsets_match_reference(causal, q_offset, kv_len):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 11, 2, 16)).astype(np.float32)
    lens = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = RL.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=q_offset,
                              kv_len=None if lens is None
                              else jnp.asarray(lens))
    got = TL.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), mode="naive", causal=causal,
                       q_offset=q_offset,
                       kv_len=None if lens is None
                       else torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_mode_refuses_offsets():
    x = torch.zeros((1, 2, 4, 16))
    with pytest.raises(NotImplementedError):
        TL.attention(x, x, x, mode="flash", kv_len=torch.ones(1))


def test_unported_caches_raise(models):
    _, _, port, tparams = models
    with pytest.raises(NotImplementedError, match="int8"):
        port.init_cache(1, 8, dtype=torch.int8)
    ssm = PortLM(port_config("mamba2-130m", reduced=True), device="cpu")
    with pytest.raises(NotImplementedError, match="ssm"):
        ssm.init_cache(1, 8)
    with pytest.raises(NotImplementedError, match="ssm"):
        ssm.decode_step(ssm.init(0), {},
                        torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros(1, dtype=torch.int32))
    cache = port.init_cache(1, 8)
    cache["pos0"] = {leaf: a.to(torch.int8) for leaf, a in
                     cache["pos0"].items()}
    with pytest.raises(NotImplementedError, match="int8"):
        port.decode_step(tparams, cache, torch.ones((1, 1), dtype=torch.int32),
                         torch.zeros(1, dtype=torch.int32))
