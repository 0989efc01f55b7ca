"""Decoding the SSM families in the port: the per-token SSD scan
(``ssd_decode_scan``), the speculative-verify Mamba-2 block
(``ssm_apply_spec``) and model-level ``init_cache``/``decode_step`` of
mamba2 and jamba against the JAX package's on bridged smoke weights; and
speculation on both archs in the port's engine, held to its own spec-off
stream (the reference's mamba2 spec tests fail, ROADMAP queue 3).

Tolerances. f32 blocks against the reference: 2e-5 (the reference's
kernel-test limit; the frameworks sum f32 products in other orders).
Within the port, a verify window's per-token math is the decode
branch's at the decode branch's shapes, so it is held bit for bit: the
scan against T separate decode steps, ``ssm_apply_spec``'s outputs and
per-token states against T decode calls of ``ssm_apply``, and spec-on
streams and SSM pools against spec-off's. The whole model's logits: each
within 4 bf16 ulps of its row's largest logit (tests/test_torch_engine.py's
rule; the frameworks round their f32 sums to bf16 at the same points but
sum in other orders), greedy tokens equal. The reference is compiled with
``xla_allow_excess_precision`` off, which brings its jitted blocks to its
eager ones (tests/test_torch_train_families.py; ROADMAP queue 3). jamba's
smoke config runs cut to one period (8 of its 16 layers: attention, SSD
mixers and MoE FFNs all present), which keeps its reference compile short.
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
from repro.models import ssd as RS
from repro.models.lm import LM
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.data.pipeline import serving_requests
from repro_torch.models import blocks as TB
from repro_torch.models import ssd as TS
from repro_torch.models.lm import LM as PortLM
from repro_torch.serving.engine import Engine, Request
from repro_torch.serving.speculate import DraftModelProposer

F32_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on the calling thread: the driver runs six test processes
    at once, and each one's default thread pool over every core slows
    all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

NEAR_TIE_ULPS = 4
ARCHS = ["mamba2-130m", "jamba-v0.1-52b"]


def _cut(cfg):
    """jamba's smoke config cut to one period (see the module docstring)."""
    if cfg.attn_period:
        return dataclasses.replace(cfg, n_layers=cfg.attn_period)
    return cfg


def _port_config(arch):
    return _cut(port_config(arch, reduced=True))


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = _cut(get_config(arch, reduced=True))
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, from_jax_numpy(jax.device_get(params))


def _strict(fn, *args):
    """``fn`` compiled for ``args`` without XLA's excess precision."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      np.float32)


def _assert_logits_close(got, want):
    got, want = _f32(got), _f32(want)
    top = np.abs(want).max(axis=-1, keepdims=True)
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert np.all(np.abs(got - want) <= NEAR_TIE_ULPS * ulp)


# ---------------------------------------------------------------------------
# The per-token scan and the verify block
# ---------------------------------------------------------------------------


def _scan_inputs(b=2, t=5, h=4, p=8, g=2, n=8, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, t, h, p)).astype(f)
    bb = rng.standard_normal((b, t, g, n)).astype(f)
    cc = rng.standard_normal((b, t, g, n)).astype(f)
    dt = rng.uniform(0.01, 0.5, (b, t, h)).astype(f)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(f)
    d = rng.standard_normal((h,)).astype(f)
    s0 = rng.standard_normal((b, h, p, n)).astype(f)
    valid = np.ones((b, t), bool)
    valid[1, 3:] = False                          # a right-padded row
    return x, bb, cc, dt, a, d, s0, valid


def test_ssd_decode_scan_matches_reference_and_the_steps():
    """Outputs and the state after every token against the reference's
    scan (2e-5), and bit for bit against T separate ``ssd_decode_step``
    calls on contiguous per-token inputs (a padded position keeps the
    state)."""
    args = _scan_inputs()
    x, bb, cc, dt, a, d, s0, valid = args
    yj, sj = RS.ssd_decode_scan(*(jnp.asarray(v) for v in args[:7]),
                                valid=jnp.asarray(valid))
    tx = [torch.from_numpy(v) for v in args]
    yt, st = TS.ssd_decode_scan(*tx[:7], valid=tx[7])
    assert tuple(yt.shape) == x.shape and tuple(st.shape) == (5,) + s0.shape
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **F32_TOL)
    state = tx[6]
    for j in range(x.shape[1]):
        y, new = TS.ssd_decode_step(*(v[:, j].contiguous() for v in tx[:4]),
                                    tx[4], tx[5], state)
        state = torch.where(tx[7][:, j, None, None, None], new, state)
        assert torch.equal(st[j], state)
        assert torch.equal(yt[:, j], y)
    assert torch.equal(st[3:, 1], st[2:3, 1].expand(2, -1, -1, -1))


def _block(arch, dtype, seed=0, b=2, t=4):
    """Layer 0's SSM params of ``arch`` (both sides), a seeded residual
    x (B, T, d) in ``dtype``, a carried (conv, state) and a valid mask
    with one row right-padded."""
    cfg, _, params, tparams = _weights(arch)
    jp = jax.tree_util.tree_map(lambda a: a[0], params["blocks"]["pos0"]["mix"])
    tp = {k: v[0] for k, v in tparams["blocks"]["pos0"]["mix"].items()}
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    cache = TB.ssm_init_cache(cfg, b)
    conv = rng.standard_normal(tuple(cache["conv"].shape)).astype(np.float32)
    state = 0.1 * rng.standard_normal(
        tuple(cache["state"].shape)).astype(np.float32)
    valid = np.ones((b, t), bool)
    valid[0, 2:] = False
    xt = torch.from_numpy(x).to(dtype)
    return (cfg, jp, tp, xt, {"conv": torch.from_numpy(conv),
                              "state": torch.from_numpy(state)},
            torch.from_numpy(valid))


def test_ssm_apply_spec_matches_reference():
    """f32 residual: the verify block's output and its per-token (conv,
    state) against the reference's ``ssm_apply_spec`` within 2e-5."""
    cfg, jp, tp, x, cache, valid = _block("mamba2-130m", torch.float32)
    yj, cj = RB.ssm_apply_spec(
        jnp.asarray(x.numpy()), jp, cfg, None,
        cache={k: jnp.asarray(v.numpy()) for k, v in cache.items()},
        valid=jnp.asarray(valid.numpy()))
    yt, ct = TB.ssm_apply_spec(x, tp, port_config("mamba2-130m",
                                                  reduced=True),
                               cache=cache, valid=valid)
    live = valid.numpy()
    np.testing.assert_allclose(yt.numpy()[live], np.asarray(yj)[live],
                               **F32_TOL)
    for leaf in ("conv", "state"):
        assert tuple(ct[leaf].shape) == cj[leaf].shape
        np.testing.assert_allclose(ct[leaf].numpy(), np.asarray(cj[leaf]),
                                   **F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_apply_spec_is_decode_steps(arch):
    """The model's bf16 residual: each valid position's output and the
    (conv, state) after every token, bit for bit the T decode calls of
    ``ssm_apply`` that spec-off decoding makes (a padded position keeps
    the carried state)."""
    _, _, tp, x, cache, valid = _block(arch, torch.bfloat16, seed=1)
    pcfg = _port_config(arch)
    yt, ct = TB.ssm_apply_spec(x, tp, pcfg, cache=cache, valid=valid)
    st = dict(cache)
    for j in range(x.shape[1]):
        y, new = TB.ssm_apply(x[:, j:j + 1], tp, pcfg, cache=st)
        keep = valid[:, j]
        st = {leaf: torch.where(keep.reshape((-1,) + (1,) * (a.ndim - 1)),
                                a, st[leaf]) for leaf, a in new.items()}
        for leaf in st:
            assert torch.equal(ct[leaf][j], st[leaf]), (leaf, j)
        assert torch.equal(yt[keep, j], y[keep, 0])


# ---------------------------------------------------------------------------
# Model-level decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_and_decode_match_reference(arch):
    """``init_cache`` in the reference's layout (f32 conv and state
    stacked over the periods, zeros); then three decode steps from it and
    three greedy steps after a padded ``prefill``, on both sides: logits
    within 4 bf16 ulps of the row's top, tokens equal, the caches at the
    bf16 bound."""
    cfg, model, params, tparams = _weights(arch)
    port = PortLM(_port_config(arch), device="cpu")
    want, got = model.init_cache(2, 10), port.init_cache(2, 10)
    assert set(got) == set(want)
    for pos in want:
        for leaf, a in want[pos].items():
            assert tuple(got[pos][leaf].shape) == a.shape, (pos, leaf)
            assert str(got[pos][leaf].dtype).endswith(str(a.dtype))
            assert not bool(got[pos][leaf].any())
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (2, 7)).astype(np.int32)
    lens = np.zeros((2,), np.int32)
    args = (params, want, jnp.asarray(toks[:, :1]), jnp.asarray(lens))
    decode = _strict(model.decode_step, *args)
    cj = want
    for j in range(3):
        lj, cj = decode(params, cj, jnp.asarray(toks[:, j:j + 1]),
                        jnp.asarray(lens + j))
        lt, got = port.decode_step(tparams, got,
                                   torch.from_numpy(toks[:, j:j + 1]),
                                   torch.from_numpy(lens + j))
        _assert_logits_close(lt, lj)
    prefill = _strict(lambda p, t: model.prefill(p, {"tokens": t},
                                                 max_len=10),
                      params, jnp.asarray(toks))
    lj, cj, nj = prefill(params, jnp.asarray(toks))
    lt, ct, nt = port.prefill(tparams, torch.from_numpy(toks), max_len=10)
    for _ in range(3):
        _assert_logits_close(lt, lj)
        nxt = _f32(lj).argmax(-1).astype(np.int32)[:, None]
        assert (_f32(lt).argmax(-1)[:, None] == nxt).all()
        lj, cj = decode(params, cj, jnp.asarray(nxt), nj)
        lt, ct = port.decode_step(tparams, ct, torch.from_numpy(nxt), nt)
        nj, nt = nj + 1, nt + 1
    _assert_logits_close(lt, lj)
    for pos in cj:
        for leaf in cj[pos]:
            np.testing.assert_allclose(_f32(ct[pos][leaf]),
                                       _f32(cj[pos][leaf]),
                                       rtol=3e-2, atol=3e-2)


def test_decode_step_equals_teacher_forced_forward():
    """mamba2 prefill + decode steps against the port's own forward over
    the same tokens (the chunked scan against the single-token
    recurrence), within 4 bf16 ulps of the row's top."""
    _, _, _, tparams = _weights("mamba2-130m")
    port = PortLM(port_config("mamba2-130m", reduced=True), device="cpu")
    seq = torch.from_numpy(np.random.default_rng(3).integers(
        1, 256, (2, 12)).astype(np.int32))
    full = port.forward(tparams, seq)
    _, cache, n = port.prefill(tparams, seq[:, :8])
    for t in range(8, 12):
        logits, cache = port.decode_step(tparams, cache, seq[:, t:t + 1], n)
        n = n + 1
        _assert_logits_close(logits, full[:, t])


# ---------------------------------------------------------------------------
# Speculation in the engine
# ---------------------------------------------------------------------------


class ScriptedProposer:
    """Proposes the spec-off continuation for ``good`` tokens, then a
    garbage tail: rounds with partial acceptance."""

    def __init__(self, ref, good, garbage=7):
        self.ref, self.good, self.garbage = ref, good, garbage

    def propose(self, req, k):
        ref = self.ref[req.rid]
        i = len(req.output)
        props = ref[i: i + min(k, self.good)]
        return (props + [self.garbage] * (k - len(props)))[:k]


def _engine(arch, spec, **kw):
    _, _, _, tparams = _weights(arch)
    return Engine(_port_config(arch), tparams, max_batch=2,
                  n_blocks=64, block_size=8, ssd_impl="ref", speculate=spec,
                  spec_depth=3, device="cpu", **kw)


def _serve(eng, prompts, max_new=10, states=None):
    """Serve ``prompts`` step by step; with ``states``, record every
    running request's SSM slot after each step under (rid, tokens the
    slot has consumed)."""
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=list(p), max_new_tokens=max_new))
    while eng.waiting or any(r is not None for r in eng.running):
        eng.step()
        if states is None:
            continue
        for r in eng.running:
            if r is not None and r.output:
                states[(r.rid, r.length - 1)] = {
                    pos: {leaf: a[:, r.slot].clone() for leaf, a in st.items()}
                    for pos, st in eng._ssm_states.items()}
    assert len(eng.finished) == len(prompts)
    assert all(len(r.output) == max_new for r in eng.finished)
    assert eng.alloc.n_free == eng.alloc.n_blocks
    return {r.rid: list(r.output) for r in eng.finished}


def _prompts(arch, every_token):
    """Three prompts; ``every_token``: each a permutation of the whole
    vocabulary, so the n-gram proposer finds every generated token in
    the context and proposes in every round."""
    vocab = _port_config(arch).vocab_size
    if every_token:
        rng = np.random.default_rng(0)
        return [rng.permutation(vocab).tolist() for _ in range(3)]
    return serving_requests(3, vocab, prompt_lens=[12, 20], seed=1)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("spec", ["ngram", "draft"])
def test_spec_equals_spec_off(arch, spec):
    """n-gram (prompts holding every token) and an SSM draft (mamba2 with
    its own weights) against spec-off: tokens and the final SSM pools
    bitwise, speculative rounds run."""
    prompts = _prompts(arch, spec == "ngram")
    off = _engine(arch, "off")
    want = _serve(off, prompts)
    on = _engine(arch, "ngram" if spec == "ngram" else "draft:mamba2-130m")
    assert _serve(on, prompts) == want
    assert on.step_counts["verify"] > 0 and on.stats()["spec_rounds"] > 0
    for pos, st in off._ssm_states.items():
        for leaf, a in st.items():
            assert torch.equal(a, on._ssm_states[pos][leaf]), (pos, leaf)


def test_mamba2_self_draft_accepts_everything():
    """mamba2 drafting itself (the target's weights): every proposal is
    accepted on the CPU, the stream equals spec-off's."""
    prompts = _prompts("mamba2-130m", False)
    want = _serve(_engine("mamba2-130m", "off"), prompts)
    _, _, _, tparams = _weights("mamba2-130m")
    draft = DraftModelProposer(port_config("mamba2-130m", reduced=True),
                               params=tparams, device="cpu")
    on = _engine("mamba2-130m", draft)
    assert _serve(on, prompts) == want
    assert on.stats()["accept_rate"] == 1.0
    assert draft.n_prefills > 0 and draft.n_decode_steps > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_partial_acceptance_rolls_the_ssm_pool_back(arch):
    """A scripted proposer (one good token, then garbage): after every
    step each running slot's (conv, state) equals spec-off's at the same
    length, bit for bit; rounds accept some but not all proposals."""
    prompts = _prompts(arch, False)
    off_states, on_states = {}, {}
    want = _serve(_engine(arch, "off"), prompts, states=off_states)
    on = _engine(arch, ScriptedProposer(want, good=1))
    assert _serve(on, prompts, states=on_states) == want
    st = on.stats()
    assert 0.0 < st["accept_rate"] < 1.0
    assert on_states and set(on_states) <= set(off_states)
    for key, snap in on_states.items():
        for pos, leaves in snap.items():
            for leaf, a in leaves.items():
                assert torch.equal(a, off_states[key][pos][leaf]), key


def test_warmup_covers_the_ssm_verify_steps():
    """``warmup`` builds every verify bucket of an SSM arch's trace:
    serving it afterwards uses no new step key, and warmup leaves the
    SSM pool as it found it."""
    prompts = _prompts("mamba2-130m", True)
    eng = _engine("mamba2-130m", "ngram")
    before = {p: {k: a.clone() for k, a in st.items()}
              for p, st in eng._ssm_states.items()}
    eng.warmup(max(map(len, prompts)) + 10,
               prompt_lens=[len(p) for p in prompts])
    warm = dict(eng.trace_counts)
    assert any(k[0] == "verify" for k in warm)
    for pos, st in before.items():
        for leaf, a in st.items():
            assert torch.equal(a, eng._ssm_states[pos][leaf])
    _serve(eng, prompts)
    assert dict(eng.trace_counts) == warm
