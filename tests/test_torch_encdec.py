"""The encoder-decoder family (seamless-m4t-large-v2) in the port against
the JAX package at smoke size (2 encoder and 2 decoder layers, d_model
64, 8 frames) on bridged weights and numpy-seeded tokens and frame
embeddings: cross-attention (``cross_kv``, ``cross_attn_apply``), the
encoder (``LM._encode``), ``forward``, ``prefill`` plus greedy
``decode_step``s with the cross k/v in the cache, ``loss`` and its
gradients, each under both ``attn_impl`` values (on the CPU ``"flash"``
is the flash kernels' plain version, against the reference's
``"pallas"`` in interpret mode); and the engine's refusal of the family.
The checks shared with the vlm family (tests/test_torch_vlm.py) are the
``check_*`` functions here.

Tolerances. f32 blocks: 2e-5 (the reference's kernel-test limit). bf16
tensors of the model (the encoder output, caches): the bf16 bound 3e-2.
Logits: each within 4 bf16 ulps of its row's largest logit
(tests/test_torch_engine.py's rule: the frameworks round f32 sums to bf16
at the same points but sum in other orders; 3.4 ulps read on the CPU,
where 3e-2 is exceeded by 12 of 12,288 logits); each decode step's
greedy token the reference's or a 4-ulp near tie of its logits. The
loss (over 2 x 48 tokens) within 2e-3 and every gradient's cosine at least 0.999
(tests/test_torch_train.py's limits; the worst leaf read on the CPU:
cross-attention's ``wk`` at 0.99979). The reference has no model-level
Pallas decode (ROADMAP queue 3), so its decode steps run ``"naive"``
after either prefill.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import blocks as RB
from repro.models.lm import LM
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import blocks as TB
from repro_torch.models.lm import LM as PortLM
from repro_torch.models.params import tree_map, tree_paths
from repro_torch.serving.engine import Engine

ARCH = "seamless-m4t-large-v2"
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
NEAR_TIE_ULPS = 4
LOSS_ATOL = 2e-3
GRAD_COS = 0.999
# (the port's attn_impl, the reference's)
IMPLS = [("naive", "naive"), ("flash", "pallas")]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on the calling thread: the driver runs six test processes
    at once, and each one's default thread pool over every core slows
    all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def weights(arch):
    cfg = get_config(arch, reduced=True)
    params = LM(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, from_jax_numpy(jax.device_get(params))


def inputs(cfg, b=2, t=12, seed=0):
    """Seeded tokens (B, T) int32, labels with a masked prefix, and
    frontend embeddings (B, F, d) bf16, as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(1, cfg.vocab_size, (b, t)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32)
    lab[0, :3] = -1
    fe = np.asarray(jnp.asarray(rng.standard_normal(
        (b, cfg.frontend_len, cfg.d_model)), jnp.bfloat16))
    return tok, lab, fe


def models(arch, port_impl, jax_impl):
    cfg, params, tparams = weights(arch)
    return (LM(cfg, attn_impl=jax_impl), params,
            PortLM(port_config(arch, reduced=True), attn_impl=port_impl,
                   device="cpu"), tparams)


def f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def assert_logits_close(got, want):
    got, want = f32(got), f32(want)
    assert got.shape == want.shape
    top = np.abs(want).max(axis=-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.all(np.abs(got - want) <= NEAR_TIE_ULPS * ulp)


def assert_near_tie(tokens, want):
    """Each row's ``tokens`` is the reference's argmax or within
    ``NEAR_TIE_ULPS`` bf16 ulps of its top logit."""
    want = f32(want)
    top = want.max(axis=-1)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top))) - 7)
    got = np.take_along_axis(want, np.asarray(tokens)[:, None], -1)[:, 0]
    assert np.all(got >= top - NEAR_TIE_ULPS * ulp)


def cos(a, b):
    a, b = f32(a).ravel().astype(np.float64), f32(b).ravel().astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def check_forward(arch, port_impl, jax_impl):
    """Whole-sequence logits on both sides."""
    model, params, port, tparams = models(arch, port_impl, jax_impl)
    tok, _, fe = inputs(model.cfg)
    want = model.forward(params, {"tokens": jnp.asarray(tok),
                                  "frontend_embeds": jnp.asarray(fe)})
    got = port.forward(tparams, torch.from_numpy(tok),
                       frontend_embeds=from_jax_numpy(fe))
    assert_logits_close(got, want)


def check_prefill_and_decode(arch, port_impl, jax_impl, max_len, steps=4):
    """``prefill(max_len=)``, then ``steps`` greedy ``decode_step``s on
    both sides, each fed the reference's argmax (the port's must agree):
    logits every step, the returned lengths, and every cache leaf at the
    end (the bf16 bound). Returns both final caches."""
    model, params, port, tparams = models(arch, port_impl, jax_impl)
    decoder = LM(model.cfg)
    tok, _, fe = inputs(model.cfg, seed=1)
    lj, cj, nj = model.prefill(params, {"tokens": jnp.asarray(tok),
                                        "frontend_embeds": jnp.asarray(fe)},
                               max_len=max_len)
    lt, ct, nt = port.prefill(tparams, torch.from_numpy(tok),
                              max_len=max_len,
                              frontend_embeds=from_jax_numpy(fe))
    assert nt.tolist() == np.asarray(nj).tolist()
    for _ in range(steps):
        assert_logits_close(lt, lj)
        nxt = f32(lj).argmax(-1).astype(np.int32)[:, None]
        assert_near_tie(f32(lt).argmax(-1), lj)
        lj, cj = decoder.decode_step(params, cj, jnp.asarray(nxt), nj)
        lt, ct = port.decode_step(tparams, ct, torch.from_numpy(nxt), nt)
        nj, nt = nj + 1, nt + 1
    assert_logits_close(lt, lj)
    want, got = dict(tree_paths(jax.device_get(cj))), dict(tree_paths(ct))
    assert set(got) == set(want)
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        np.testing.assert_allclose(f32(got[path]), f32(a), **BF16)
    return cj, ct


def check_loss_and_grads(arch, port_impl, jax_impl):
    """The loss (and its CE) and every leaf's gradient."""
    model, params, port, _ = models(arch, port_impl, jax_impl)
    tok, lab, fe = inputs(model.cfg, t=48, seed=2)
    batch = {"tokens": tok, "labels": lab, "frontend_embeds": fe}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: model.loss(p, jax.tree_util.tree_map(jnp.asarray, batch)),
        has_aux=True))(params)
    tp = tree_map(lambda t: t.requires_grad_(True),
                  from_jax_numpy(jax.device_get(params)))
    tl, tmet = port.loss(tp, {k: from_jax_numpy(v) for k, v in
                              batch.items()})
    paths = tree_paths(tp)
    grads = torch.autograd.grad(tl, [t for _, t in paths])
    assert abs(float(tl.detach()) - float(jl)) < LOSS_ATOL
    assert abs(float(tmet["ce"]) - float(jmet["ce"])) < LOSS_ATOL
    want = dict(tree_paths(jax.device_get(jg)))
    assert set(want) == {p for p, _ in paths}
    for (path, _), g in zip(paths, grads):
        assert cos(g, want[path]) >= GRAD_COS, path


# ---------------------------------------------------------------------------


def test_config_and_parameters_match_reference():
    """The config, full and reduced, and the parameter tree (the decoder
    blocks' ``cross`` sub-tree, ``enc_blocks``, ``enc_final_ln``,
    ``frontend_proj``): paths, shapes and types, bridged with no special
    case."""
    for reduced in (False, True):
        assert (dataclasses.asdict(port_config(ARCH, reduced=reduced)) ==
                dataclasses.asdict(get_config(ARCH, reduced=reduced)))
    cfg, params, tparams = weights(ARCH)
    want = dict(tree_paths(jax.device_get(params)))
    specs = dict(tree_paths(PortLM(port_config(ARCH, reduced=True),
                                   device="cpu").param_specs()))
    assert set(specs) == set(want) == {p for p, _ in tree_paths(tparams)}
    for path in ("blocks/pos0/cross/wq", "enc_blocks/pos0/mix/wk",
                 "enc_blocks/pos0/ffn/w_down", "enc_final_ln",
                 "frontend_proj"):
        assert path in specs
    for path, ps in specs.items():
        assert ps.shape == want[path].shape, path
        assert str(ps.dtype).endswith(str(want[path].dtype)), path


def test_cross_attention_matches_reference():
    """f32 decoder stream and encoder output: ``cross_kv`` and
    ``cross_attn_apply`` of decoder layer 0 within 2e-5."""
    cfg, params, tparams = weights(ARCH)
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"]["pos0"]["cross"])
    tp = {k: v[0] for k, v in tparams["blocks"]["pos0"]["cross"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    pcfg = port_config(ARCH, reduced=True)
    kv_j = RB.cross_kv(jnp.asarray(enc), jp, cfg, None)
    kv_t = TB.cross_kv(torch.from_numpy(enc), tp, pcfg)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(kv_t[leaf].numpy(), np.asarray(kv_j[leaf]),
                                   **F32_TOL)
    yj = RB.cross_attn_apply(jnp.asarray(x), kv_j, jp, cfg, None)
    yt = TB.cross_attn_apply(torch.from_numpy(x), kv_t, tp, pcfg)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_encoder_matches_reference(port_impl, jax_impl):
    """``_encode``: non-causal self-attention through ``attn_impl`` (the
    flash forward with ``causal=False``) at the bf16 bound."""
    model, params, port, tparams = models(ARCH, port_impl, jax_impl)
    _, _, fe = inputs(model.cfg)
    want = model._encode(params, jnp.asarray(fe))
    got = port._encode(tparams, from_jax_numpy(fe))
    np.testing.assert_allclose(f32(got), f32(want), **BF16)


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_forward_matches_reference(port_impl, jax_impl):
    check_forward(ARCH, port_impl, jax_impl)


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_prefill_and_decode_match_reference(port_impl, jax_impl):
    """The prefill cache carries each layer's cross k/v ((n_periods, B,
    F, K, hd)), and decoding reads it."""
    cj, ct = check_prefill_and_decode(ARCH, port_impl, jax_impl,
                                      max_len=16)
    assert tuple(ct["pos0"]["cross"]["k"].shape) == (2, 2, 8, 4, 16)
    assert tuple(ct["pos0"]["self"]["k"].shape) == (2, 2, 16, 4, 16)


@pytest.mark.parametrize("port_impl,jax_impl", IMPLS)
def test_loss_and_grads_match_reference(port_impl, jax_impl):
    check_loss_and_grads(ARCH, port_impl, jax_impl)


def test_init_cache_matches_reference():
    """``init_cache(src_len=)``: zero self and cross k/v in the
    reference's layout, in the requested type."""
    cfg, _, _ = weights(ARCH)
    want = LM(cfg).init_cache(3, 20, src_len=8)
    got = PortLM(port_config(ARCH, reduced=True),
                 device="cpu").init_cache(3, 20, src_len=8)
    want, got = dict(tree_paths(want)), dict(tree_paths(got))
    assert set(got) == set(want)
    for path, a in want.items():
        assert tuple(got[path].shape) == a.shape, path
        assert got[path].dtype == torch.bfloat16 and not got[path].any()


def test_engine_refuses_encdec():
    """The engine's layer body applies no cross-attention (the
    reference's neither), so serving the family would drop the encoder:
    it raises, saying so."""
    _, _, tparams = weights(ARCH)
    with pytest.raises(NotImplementedError, match="cross-attention"):
        Engine(port_config(ARCH, reduced=True), tparams, device="cpu")
