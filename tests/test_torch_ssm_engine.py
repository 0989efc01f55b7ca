"""The port's SSM family (mamba2-130m) against the JAX package at smoke
size (2 layers, d_model 64, ssm_state 16, ssm_headdim 16, chunk 32,
d_ff 128) on bridged weights: the config, ``ssm_apply``'s three branches,
``LM.forward``/``prefill`` with both SSD impls, and the serving engine,
whole-prompt and chunked on a pool that preempts.

Tolerances. One block on the same bf16 input: the bf16 residual output
within one bf16 ulp, the f32 (conv, state) within 2e-5 (measured on the
whole-sequence branch: output bit-equal, caches within 5e-7; the two
frameworks sum f32 products in different orders). The whole model: logits within 3e-2, the qwen prefill test's
bound, because the reference's jitted layer scan rounds the residual one
bf16 ulp away from its own eager blocks (layer 1's conv state moves by
1.2e-2), while the port matches the eager blocks (the stack-vs-blocks
test below). Engine streams: equal, except at a bf16 near tie of the
reference's own logits (tests/test_torch_engine.py's rule).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import serving_requests
from repro.models import blocks as RB
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.kernels import ssd as tssdk
from repro_torch.models import blocks as TB
from repro_torch.models.lm import LM as PortLM
from repro_torch.serving.engine import Engine, Request

from test_torch_engine import _assert_streams_agree, _bf16_ulp

ARCH = "mamba2-130m"
F32_TOL = dict(rtol=2e-5, atol=2e-5)
TRACE = dict(n=6, lens=[5, 12, 9, 40], max_new=6)
PRESSURE = dict(n=5, lens=[24, 40, 32], max_new=8)
# (prefill_chunk, n_blocks, block_size, max_batch, trace)
SCHEDULES = {"whole": (None, 64, 4, 4, TRACE),
             "chunk8": (8, 64, 4, 4, TRACE),
             "pressure": (8, 12, 8, 4, PRESSURE)}


@pytest.fixture(scope="module")
def weights():
    cfg = get_config(ARCH, reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, from_jax_numpy(jax.device_get(params))


@pytest.fixture(scope="module")
def reference_runs(weights):
    """The reference engine's streams per schedule, run once each."""
    cfg, _, params, _ = weights
    return {name: _serve(JaxEngine, JaxRequest, cfg, params, *sched)
            for name, sched in SCHEDULES.items()}


def _serve(engine_cls, request_cls, cfg, params, prefill_chunk, n_blocks,
           block_size, max_batch, trace, **kw):
    eng = engine_cls(cfg, params, max_batch=max_batch, n_blocks=n_blocks,
                     block_size=block_size, prefill_chunk=prefill_chunk,
                     **kw)
    prompts = serving_requests(trace["n"], cfg.vocab_size,
                               prompt_lens=trace["lens"])
    for i, p in enumerate(prompts):
        eng.submit(request_cls(rid=i, tokens=p,
                               max_new_tokens=trace["max_new"]))
    done = eng.run(max_steps=2000)
    assert len(done) == trace["n"]
    assert all(len(r.output) == trace["max_new"] for r in done)
    return prompts, {r.rid: r.output for r in done}, eng


def _bf16_input(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, from_jax_numpy(np.asarray(xj))


def _assert_within_one_bf16_ulp(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    ulp = np.vectorize(_bf16_ulp)(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got - want) <= ulp).all()


def test_config_matches_reference():
    for reduced in (False, True):
        want = get_config(ARCH, reduced=reduced)
        got = port_config(ARCH, reduced=reduced)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.layer_kinds() == want.layer_kinds() == ("ssm",) * \
            got.n_layers
        assert got.ffn_kinds() == want.ffn_kinds()
        assert got.n_ssm_heads == want.n_ssm_heads
    full = port_config(ARCH)
    assert (full.n_ssm_heads, full.d_inner, full.d_ff) == (24, 1536, 0)
    assert full.ffn_kinds() == ("dense",) * 24      # zero-width FFNs
    assert port_config(ARCH, reduced=True).d_ff == 128


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_ssm_apply_whole_sequence(weights, impl):
    cfg, _, params, tparams = weights
    pj = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"]["pos0"]["mix"])
    pt = {k: v[0] for k, v in tparams["blocks"]["pos0"]["mix"].items()}
    xj, xt = _bf16_input((2, 45, cfg.d_model), 0)
    yj, cj = RB.ssm_apply(xj, pj, cfg, None, return_state=True)
    yt, ct = TB.ssm_apply(xt, pt, port_config(ARCH, reduced=True),
                          ssd_impl=impl, return_state=True)
    _assert_within_one_bf16_ulp(yt, yj)
    for leaf in ("conv", "state"):
        assert ct[leaf].dtype == torch.float32
        np.testing.assert_allclose(ct[leaf].numpy(), np.asarray(cj[leaf]),
                                   **F32_TOL)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("n_valid", [8, 5], ids=["full", "right-padded"])
def test_ssm_apply_chunk_continue(weights, impl, n_valid):
    """A chunk continuing from a carried (conv, state); with ``n_valid`` <
    T the tail is right-padding: dt is zeroed there and the conv tail
    comes from the last valid inputs."""
    cfg, _, params, tparams = weights
    pj = jax.tree_util.tree_map(lambda a: a[1],
                                params["blocks"]["pos0"]["mix"])
    pt = {k: v[1] for k, v in tparams["blocks"]["pos0"]["mix"].items()}
    rng = np.random.default_rng(1)
    cache = RB.ssm_init_cache(cfg, 1)
    conv0 = rng.standard_normal(cache["conv"].shape).astype(np.float32)
    state0 = rng.standard_normal(cache["state"].shape).astype(np.float32)
    xj, xt = _bf16_input((1, 8, cfg.d_model), 2)
    nv = None if n_valid == 8 else n_valid
    yj, cj = RB.ssm_apply(xj, pj, cfg, None,
                          cache={"conv": jnp.asarray(conv0),
                                 "state": jnp.asarray(state0)},
                          n_valid=None if nv is None else jnp.int32(nv))
    yt, ct = TB.ssm_apply(xt, pt, port_config(ARCH, reduced=True),
                          cache={"conv": torch.from_numpy(conv0),
                                 "state": torch.from_numpy(state0)},
                          ssd_impl=impl,
                          n_valid=None if nv is None else torch.tensor([nv]))
    _assert_within_one_bf16_ulp(yt[:, :n_valid], yj[:, :n_valid])
    for leaf in ("conv", "state"):
        np.testing.assert_allclose(ct[leaf].numpy(), np.asarray(cj[leaf]),
                                   **F32_TOL)


def test_ssm_apply_decode_step(weights):
    cfg, _, params, tparams = weights
    pj = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"]["pos0"]["mix"])
    pt = {k: v[0] for k, v in tparams["blocks"]["pos0"]["mix"].items()}
    rng = np.random.default_rng(3)
    cache = RB.ssm_init_cache(cfg, 3)
    conv0 = rng.standard_normal(cache["conv"].shape).astype(np.float32)
    state0 = rng.standard_normal(cache["state"].shape).astype(np.float32)
    xj, xt = _bf16_input((3, 1, cfg.d_model), 4)
    yj, cj = RB.ssm_apply(xj, pj, cfg, None,
                          cache={"conv": jnp.asarray(conv0),
                                 "state": jnp.asarray(state0)})
    yt, ct = TB.ssm_apply(xt, pt, port_config(ARCH, reduced=True),
                          cache={"conv": torch.from_numpy(conv0),
                                 "state": torch.from_numpy(state0)})
    _assert_within_one_bf16_ulp(yt, yj)
    for leaf in ("conv", "state"):
        np.testing.assert_allclose(ct[leaf].numpy(), np.asarray(cj[leaf]),
                                   **F32_TOL)


def test_ssm_init_cache_is_f32():
    cfg = port_config(ARCH, reduced=True)
    c = TB.ssm_init_cache(cfg, 3)
    assert c["conv"].dtype == c["state"].dtype == torch.float32
    assert tuple(c["conv"].shape) == (3, 3, 128 + 2 * 16)
    assert tuple(c["state"].shape) == (3, 8, 16, 16)
    assert not c["conv"].any() and not c["state"].any()


@pytest.mark.parametrize("impl,ref_impl", [("ref", "ref"),
                                           ("kernel", "pallas")])
def test_lm_forward_and_prefill_match_reference(weights, impl, ref_impl):
    cfg, _, params, tparams = weights
    model = LM(cfg, ssd_impl=ref_impl)
    toks = np.random.default_rng(5).integers(
        1, cfg.vocab_size, (2, 45)).astype(np.int32)
    port = PortLM(port_config(ARCH, reduced=True), ssd_impl=impl,
                  device="cpu")
    lj = model.forward(params, {"tokens": jnp.asarray(toks)})
    lt = port.forward(tparams, torch.tensor(toks))
    assert tuple(lt.shape) == lj.shape == (2, 45, 512)
    np.testing.assert_allclose(lt.float().numpy(), np.asarray(lj, np.float32),
                               rtol=3e-2, atol=3e-2)
    pj, cj, len_j = model.prefill(params, {"tokens": jnp.asarray(toks)})
    pt, ct, len_t = port.prefill(tparams, torch.tensor(toks))
    np.testing.assert_allclose(pt.float().numpy(), np.asarray(pj, np.float32),
                               rtol=3e-2, atol=3e-2)
    assert ct.keys() == cj.keys() == {"pos0"}
    for leaf in ("conv", "state"):
        assert tuple(ct["pos0"][leaf].shape) == cj["pos0"][leaf].shape
        np.testing.assert_allclose(ct["pos0"][leaf].numpy(),
                                   np.asarray(cj["pos0"][leaf]),
                                   rtol=3e-2, atol=3e-2)
    assert len_t.tolist() == np.asarray(len_j).tolist()


def test_lm_stack_matches_reference_blocks_applied_eagerly(weights):
    """The port's layer stack against the reference's own blocks called
    one by one (no jitted scan): the first block equal within one bf16
    ulp, the last layer's f32 state within 2e-5."""
    cfg, model, params, tparams = weights
    toks = np.random.default_rng(6).integers(
        1, cfg.vocab_size, (2, 40)).astype(np.int32)
    x = model._embed_in(params, jnp.asarray(toks))
    for i in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a: a[i], params["blocks"]["pos0"])
        x, cache_j = RB.ssm_apply(x, lp["mix"], cfg, None, return_state=True)
        x = RB.ffn_apply(x, lp["ffn"], cfg, None)
    port = PortLM(port_config(ARCH, reduced=True), device="cpu")
    _, ct, _ = port.prefill(tparams, torch.tensor(toks))
    np.testing.assert_allclose(ct["pos0"]["state"][-1].numpy(),
                               np.asarray(cache_j["state"]), **F32_TOL)
    np.testing.assert_allclose(ct["pos0"]["conv"][-1].numpy(),
                               np.asarray(cache_j["conv"]), **F32_TOL)


def test_zero_width_ffn_is_a_no_op(weights):
    """mamba2-130m's full config has d_ff = 0: every layer still builds an
    FFN, of width 0, whose rmsnorm and empty products leave the residual
    as it is, in both frameworks."""
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), d_ff=0)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(1))
    tparams = from_jax_numpy(jax.device_get(params))
    port = PortLM(dataclasses.replace(port_config(ARCH, reduced=True),
                                      d_ff=0), device="cpu")
    ffn = {k: v[0] for k, v in tparams["blocks"]["pos0"]["ffn"].items()}
    assert tuple(ffn["w_gate"].shape) == (64, 0)
    xj, xt = _bf16_input((2, 7, 64), 7)
    assert torch.equal(TB.ffn_apply(xt, ffn, port.cfg), xt)
    toks = np.random.default_rng(8).integers(1, 256, (1, 20)).astype(
        np.int32)
    np.testing.assert_allclose(
        port.forward(tparams, torch.tensor(toks)).float().numpy(),
        np.asarray(model.forward(params, {"tokens": jnp.asarray(toks)}),
                   np.float32), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_engine_tokens_match_reference(weights, reference_runs, schedule,
                                       impl):
    """Whole-prompt, chunked (8) and chunked on a pool of 12 x 8 blocks
    that preempts: the same greedy streams as the reference engine, and
    the same number of preemptions."""
    cfg, model, params, tparams = weights
    prompts, want, ref_eng = reference_runs[schedule]
    _, got, eng = _serve(Engine, Request, port_config(ARCH, reduced=True),
                         tparams, *SCHEDULES[schedule], device="cpu",
                         ssd_impl=impl)
    assert eng.model.ssd_impl == impl
    assert eng.sched.n_preemptions == ref_eng.sched.n_preemptions
    if schedule == "pressure":
        assert eng.sched.n_preemptions >= 1
    _assert_streams_agree(model, params, prompts, want, got)


def test_engine_counts_prefill_passes():
    """The counts chip_smoke holds the SSD kernel's launches to: one SSD
    call per layer per prefill group or chunk step, none per decode step
    (CPU: the plain version runs and nothing is launched)."""
    cfg = port_config(ARCH, reduced=True)
    params = PortLM(cfg, device="cpu").init(0)
    for chunk, groups, chunks in ((None, 2, 0), (8, 0, 1 + 2 + 1)):
        eng = Engine(cfg, params, max_batch=4, n_blocks=64, block_size=4,
                     prefill_chunk=chunk, device="cpu")
        for i, p in enumerate(serving_requests(3, cfg.vocab_size,
                                               prompt_lens=[5, 12])):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=3))
        before = tssdk.LAUNCHES["ssd"]
        eng.run()
        st = eng.stats()
        assert (st["prefill_groups"], st["chunk_steps"]) == (groups, chunks)
        assert st["decode_steps"] > 0 and st["finished"] == 3
        assert tssdk.LAUNCHES["ssd"] == before


def test_attention_free_engine_keeps_a_one_layer_dummy_pool():
    """No attention layer: the KV pool still exists (the scheduler accounts
    blocks per token) with one layer, and at least one KV head of width 1
    where the config has none, as the reference builds it."""
    cfg_j = get_config(ARCH, reduced=True)
    cfg_t = port_config(ARCH, reduced=True)
    for over in ({}, dict(n_heads=0, n_kv_heads=0, head_dim=0)):
        cj = dataclasses.replace(cfg_j, **over)
        ct = dataclasses.replace(cfg_t, **over)
        params_t = PortLM(ct, device="cpu").init(0)
        eng = Engine(ct, params_t, n_blocks=16, block_size=4, device="cpu")
        ref = JaxEngine(cj, LM(cj).init(jax.random.PRNGKey(0)),
                        n_blocks=16, block_size=4)
        assert dataclasses.asdict(eng.kv_cfg) == \
            dataclasses.asdict(ref.kv_cfg)
        assert eng.kv_cfg.n_layers == 1
        assert eng.kv.state["k"].shape[0] == 1
        assert eng._attn_pos == [] and eng._ssm_pos == [0]
    assert eng.kv_cfg.n_kv_heads == eng.kv_cfg.head_dim == 1


def test_engine_on_the_card_takes_only_the_kernel(monkeypatch):
    """The engine's SSD on a CUDA device is the kernel: asking for the
    plain reference there is refused before anything is allocated."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cfg = port_config(ARCH, reduced=True)
    with pytest.raises(ValueError, match="runs the kernel"):
        Engine(cfg, {}, ssd_impl="ref", device="cuda")


def test_decode_keeps_inactive_slots_state():
    """A slot mid-way through chunked prefill keeps its carried state
    while the running batch decodes (the active mask)."""
    cfg = port_config(ARCH, reduced=True)
    params = PortLM(cfg, device="cpu").init(0)
    eng = Engine(cfg, params, max_batch=2, n_blocks=64, block_size=4,
                 prefill_chunk=8, device="cpu")
    eng.submit(Request(rid=0, tokens=list(range(1, 6)), max_new_tokens=8))
    eng.step()                                   # rid 0 prefilled
    eng.submit(Request(rid=1, tokens=list(range(1, 21)), max_new_tokens=2))
    eng.step()                                   # rid 1: first chunk
    slot = next(r for r in eng.sched.running
                if r is not None and r.rid == 1).slot
    snap = {k: v[:, slot].clone() for k, v in eng._ssm_states["pos0"].items()}
    eng._decode_fused([r for r in eng.sched.running
                       if r is not None and r.rid == 0])
    for k, v in eng._ssm_states["pos0"].items():
        assert torch.equal(v[:, slot], snap[k])


def test_training_the_ssm_family_raises():
    cfg = port_config(ARCH, reduced=True)
    model = PortLM(cfg, device="cpu")
    params = model.init(0)
    toks = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ssm family"):
        model.loss(params, {"tokens": toks, "labels": toks})
    for over in (dict(family="hybrid", attn_period=2),
                 dict(n_experts=4, top_k=2)):
        with pytest.raises(NotImplementedError, match="not ported"):
            PortLM(dataclasses.replace(cfg, **over), device="cpu")
    with pytest.raises(ValueError, match="ssd_impl"):
        PortLM(cfg, ssd_impl="pallas", device="cpu")


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
          "--max-new", "3", "--mixed-lens", "5,11", "--prefill-chunk", "4"])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "finished: 3" in out
    assert "chunk_steps: " in out and "prefill_groups: 0" in out
