"""The port's MoE FFN, Qwen3's per-head q/k norms and the moe and hybrid
families of ``LM`` against the JAX package at smoke size, on the same
bridged weights and numpy-seeded inputs.

Function by function: ``qk_headnorm``, the router ``_route`` (weights,
experts, the auxiliary loss; ties broken to the lower expert as
``lax.top_k`` does), ``_expert_ffn``, ``_moe_local`` and ``moe_apply``
at the smoke capacity (nothing dropped) and at one small enough that
assignments drop to the pad row; f32 results at rtol = atol = 2e-5,
bf16 results in bf16 ulps. Then ``LM.forward``/``prefill`` of
qwen3-moe-30b-a3b, dbrx-132b and jamba-v0.1-52b within the 4-ulp row
bound of ``test_llama2_forward_and_prefill_match_reference``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import blocks as RB
from repro.models import layers as RL
from repro.models.lm import LM
from repro_torch.bridge import from_jax_numpy, to_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as PortLM
from repro_torch.models.params import tree_paths

from test_torch_engine import NEAR_TIE_ULPS

MOE_ARCHS = ["qwen3-moe-30b-a3b", "dbrx-132b", "jamba-v0.1-52b"]
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """Plain versions held at 2e-5 run torch on the calling thread (see
    tests/test_torch_ssd.py: one pool worker's f32 exp is inaccurate on
    this host in some processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = get_config(arch, reduced=True)
    model = LM(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    return cfg, model, params, from_jax_numpy(params)


def _moe_layer(arch="qwen3-moe-30b-a3b"):
    """The reference's and the port's params of the first MoE FFN."""
    cfg, model, params, tparams = _weights(arch)
    pos = model.fkinds.index("moe")
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"][f"pos{pos}"]["ffn"])
    tp = {k: v[0] for k, v in tparams["blocks"][f"pos{pos}"]["ffn"].items()}
    return cfg, port_config(arch, reduced=True), jp, tp


def _input(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _bf16(a):
    """An f32 numpy array rounded to bf16, as (jax, torch) twins."""
    t = torch.from_numpy(a).bfloat16()
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of each row's largest |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    top = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-30)
    return float((np.abs(got - want) / 2.0 ** (np.floor(np.log2(top)) - 7))
                 .max())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qk_headnorm_matches_reference(dtype):
    w = _input((16,), 1) * 0.1 + 1.0
    x = _input((2, 5, 4, 16), 0) * 3.0
    wj, wt = _bf16(w)
    if dtype == "f32":
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    else:
        xj, xt = _bf16(x)
    want = np.asarray(RL.qk_headnorm(xj, wj, 1e-6).astype(jnp.float32))
    got = TL.qk_headnorm(xt, wt, 1e-6)
    assert got.dtype == xt.dtype
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        assert _ulps(got.float().numpy(), want) <= 1


@pytest.mark.parametrize("h_dtype", ["f32", "bf16"])
def test_route_matches_reference(h_dtype):
    cfg, tcfg, jp, tp = _moe_layer()
    x = _input((22, cfg.d_model), 2)
    xj, xt = ((jnp.asarray(x), torch.from_numpy(x)) if h_dtype == "f32"
              else _bf16(x))
    wj, ej, aj = RB._route(xj, jp["router"], cfg)
    wt, et, at = TB._route(xt, tp["router"], tcfg)
    assert et.dtype == torch.int64 and tuple(et.shape) == (22, cfg.top_k)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
    np.testing.assert_allclose(float(at), float(aj), **TOL)


def test_route_breaks_ties_to_the_lower_expert():
    """Two identical router columns give equal gates: ``lax.top_k`` takes
    the lower expert first, and so must the port."""
    cfg, tcfg, jp, tp = _moe_layer("dbrx-132b")           # 4 experts, top-2
    router = np.asarray(jp["router"], np.float32).copy()
    router[:, 3] = router[:, 1]
    router[:, 2] = router[:, 0]
    rj, rt = _bf16(router)
    x = _input((16, cfg.d_model), 3)
    _, ej, _ = RB._route(jnp.asarray(x), rj, cfg)
    _, et, _ = TB._route(torch.from_numpy(x), rt, tcfg)
    ej = np.asarray(ej)
    # every row's top two are a tied pair (0, 2) or (1, 3), lower first
    assert np.all(ej[:, 1] - ej[:, 0] == 2)
    np.testing.assert_array_equal(et.numpy(), ej)


def test_expert_ffn_matches_reference():
    cfg, _, jp, tp = _moe_layer()
    xs = _input((cfg.n_experts, 6, cfg.d_model), 4)
    xj, xt = _bf16(xs)
    want = RB._expert_ffn(xj, jp["w_gate"], jp["w_up"], jp["w_down"])
    got = TB._expert_ffn(xt, tp["w_gate"], tp["w_up"], tp["w_down"])
    assert got.dtype == torch.bfloat16
    assert _ulps(got.float().numpy(), want.astype(jnp.float32)) <= 1


def _kept(top_e, n_experts, cap):
    """Whether each (token, choice) assignment keeps its row: fewer than
    ``cap`` earlier ones to its expert in (token, choice) order (the
    capacity step, in numpy)."""
    top_e = np.asarray(top_e)
    seen = np.zeros(n_experts, np.int64)
    kept = np.zeros(top_e.size, bool)
    for i, e in enumerate(top_e.reshape(-1)):
        kept[i] = seen[e] < cap
        seen[e] += 1
    return kept.reshape(top_e.shape)


def _drops(top_e, n_experts, cap):
    """Assignments past their expert's ``cap`` rows."""
    return int((~_kept(top_e, n_experts, cap)).sum())


def _dropped_tokens(top_e, n_experts, cap):
    """Tokens all of whose assignments dropped."""
    return ~_kept(top_e, n_experts, cap).any(-1)


@pytest.mark.parametrize("arch,mult", [
    ("qwen3-moe-30b-a3b", 4.0), ("qwen3-moe-30b-a3b", 0.1),
    ("dbrx-132b", 1.0), ("jamba-v0.1-52b", 0.05)],
    ids=["qwen3-serve", "qwen3-drops", "dbrx-train", "jamba-drops"])
def test_moe_local_matches_reference(arch, mult):
    """At the smoke capacity nothing drops; at the small multipliers
    assignments drop to the pad row, which holds the slot logic."""
    cfg, tcfg, jp, tp = _moe_layer(arch)
    h = _input((2, 11, cfg.d_model), 5)
    hj, ht = _bf16(h)
    want, aux_j = RB._moe_local(hj, jp, cfg, mult)
    got, aux_t = TB._moe_local(ht, tp, tcfg, mult)
    _, top_e, _ = RB._route(hj.reshape(-1, cfg.d_model), jp["router"], cfg)
    _, top_t, _ = TB._route(ht.reshape(-1, cfg.d_model), tp["router"], tcfg)
    # the port routes each token as the reference, so the reference's
    # drops are the port's
    np.testing.assert_array_equal(top_t.numpy(), np.asarray(top_e))
    cap = TB.capacity(22, tcfg, mult)
    dropped = _drops(top_e, cfg.n_experts, cap)
    assert (dropped > 0) == (mult < 1.0)
    # a token whose every assignment dropped adds nothing: its row is 0
    gone = _dropped_tokens(top_e, cfg.n_experts, cap).reshape(2, 11)
    assert (mult < 1.0) == bool(gone.any())
    assert not got.float().numpy()[gone].any()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == h.shape
    assert _ulps(got.float().numpy(), want.astype(jnp.float32)) <= 1
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)


def test_moe_apply_matches_reference():
    cfg, tcfg, jp, tp = _moe_layer()
    xj, xt = _bf16(_input((2, 7, cfg.d_model), 6))
    want, aux_j = RB.moe_apply(xj, jp, cfg, None, capacity_mult=4.0)
    got, aux_t = TB.moe_apply(xt, tp, tcfg, 4.0)
    assert _ulps(got.float().numpy(), want.astype(jnp.float32)) <= 1
    np.testing.assert_allclose(float(aux_t), float(aux_j), **TOL)


def test_capacity_matches_reference_formula():
    """``min(max(ceil(k n / E · factor · mult), 4), k n)``: the floor of
    4, the ceiling of k n, and qwen3-moe's full-width decode (8 rows)
    and 64-token chunk at the serving multiplier 4."""
    full = port_config("qwen3-moe-30b-a3b")
    assert TB.capacity(8, full, 4.0) == 4
    assert TB.capacity(64, full, 4.0) == 20
    assert TB.capacity(3000, full, 4.0) == 938
    smoke = port_config("qwen3-moe-30b-a3b", reduced=True)
    assert TB.capacity(1, smoke, 4.0) == 2                # k n = 2
    assert TB.capacity(22, smoke, 1.0) == 44              # nothing drops


def _eager_reference(model, fn, *args):
    """The reference on its eager path: its jitted layer scan rounds bf16
    at other points than its own blocks applied op by op (read on
    jamba's 16-layer smoke stack: up to 15 bf16 ulps between the two),
    which the port's eager blocks reproduce."""
    with jax.disable_jit():
        return fn(*args)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_and_prefill_match_reference(arch):
    """Smoke forward logits (train mode: capacity multiplier 1.0) within
    ``NEAR_TIE_ULPS`` bf16 ulps of each row's largest logit, prefill
    logits and caches (multiplier 4.0) likewise. jamba's 16 layers are
    held to the reference's eager path (``_eager_reference``)."""
    cfg, model, params, tparams = _weights(arch)
    port = PortLM(port_config(arch, reduced=True), device="cpu")
    toks = np.random.default_rng(1).integers(
        1, cfg.vocab_size, (2, 11)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks)}
    run = (functools.partial(_eager_reference, model)
           if cfg.family == "hybrid" else lambda fn, *a: fn(*a))
    lj = np.asarray(run(model.forward, params, batch), np.float32)
    lt = port.forward(tparams, torch.tensor(toks)).float().numpy()
    assert lt.shape == lj.shape == (2, 11, 512)
    assert _ulps(lt, lj) <= NEAR_TIE_ULPS
    pj, cj, nj = run(model.prefill, params, batch)
    pt, ct, nt = port.prefill(tparams, torch.tensor(toks))
    assert _ulps(pt.float().numpy(), np.asarray(pj, np.float32)) \
        <= NEAR_TIE_ULPS
    assert nt.tolist() == np.asarray(nj).tolist()
    want = dict(tree_paths(jax.device_get(cj)))
    got = dict(tree_paths(ct))
    assert got.keys() == want.keys()
    for path, a in want.items():
        b = got[path]
        assert tuple(b.shape) == a.shape, path
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), rtol=3e-2,
                                   atol=3e-2, err_msg=path)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_cross_bitwise_and_match_specs(arch):
    """The moe and hybrid trees (stacked experts, the router, q/k norms,
    jamba's period of 8) cross into the port and back bitwise and line up
    with the port's own specs."""
    _, model, params, tparams = _weights(arch)
    back = to_numpy(tparams)
    want, got = dict(tree_paths(params)), dict(tree_paths(back))
    assert got.keys() == want.keys()
    for path, a in want.items():
        np.testing.assert_array_equal(
            np.asarray(got[path]).view(np.uint8), np.asarray(a).view(np.uint8),
            err_msg=path)
    specs = dict(tree_paths(PortLM(port_config(arch, reduced=True),
                                   device="cpu").param_specs()))
    got = dict(tree_paths(tparams))
    assert got.keys() == specs.keys()
    for path, ps in specs.items():
        assert tuple(got[path].shape) == ps.shape, path
        assert got[path].dtype == ps.dtype, path


def test_port_init_draws_stacked_leaves_per_layer():
    """``materialize`` draws a stacked leaf one layer slice at a time: the
    init is seeded, each expert leaf is fan-in scaled by d_model (its
    stacked and expert axes excluded) and the q/k norms start at one."""
    model = PortLM(port_config("qwen3-moe-30b-a3b", reduced=True),
                   device="cpu")
    a, b = model.init(0), model.init(0)
    for (path, x), (_, y) in zip(tree_paths(a), tree_paths(b)):
        assert torch.equal(x, y), path
    ffn = a["blocks"]["pos0"]["ffn"]
    assert tuple(ffn["w_gate"].shape) == (2, 4, 64, 128)
    assert abs(ffn["w_gate"].float().std().item() - 1 / 8) < 0.01
    assert abs(ffn["w_down"].float().std().item() - 1 / np.sqrt(128)) < 0.01
    assert not torch.equal(ffn["w_gate"][0], ffn["w_gate"][1])
    mix = a["blocks"]["pos0"]["mix"]
    assert torch.all(mix["q_norm"] == 1) and torch.all(mix["k_norm"] == 1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_training_moe_or_hybrid_raises(arch):
    """Training the moe and hybrid families is ported: the loss is the CE
    plus 0.01 x the load-balancing loss over the layers, and every leaf
    gets a finite gradient (tests/test_torch_train_families.py holds them
    against the reference). Only the SSD kernel route still raises."""
    port = PortLM(port_config(arch, reduced=True), device="cpu")
    params = port.init(0)
    leaves = [t.requires_grad_(True) for _, t in tree_paths(params)]
    toks = torch.ones((1, 8), dtype=torch.int64)
    loss, met = port.loss(params, {"tokens": toks, "labels": toks})
    n = port.cfg.n_layers
    assert float(met["aux"]) > 0
    assert float(loss) == pytest.approx(
        float(met["ce"]) + 0.01 * float(met["aux"]) / n, rel=1e-6)
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)
    router = [g for (p, _), g in zip(tree_paths(params), grads)
              if p.endswith("router")]
    assert router and all(bool(g.abs().sum() > 0) for g in router)
    if "ssm" in port.kinds:
        kernel = PortLM(port_config(arch, reduced=True), ssd_impl="kernel",
                        device="cpu")
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            kernel.loss(params, {"tokens": toks, "labels": toks})


def test_moe_decode_step_matches_reference():
    """qwen3-moe's model-level decode (capacity multiplier 2.0, the dense
    cache, q/k norms) against the reference's, from the same prefill."""
    cfg, model, params, tparams = _weights("qwen3-moe-30b-a3b")
    port = PortLM(port_config("qwen3-moe-30b-a3b", reduced=True),
                  device="cpu")
    toks = np.random.default_rng(2).integers(
        1, cfg.vocab_size, (3, 9)).astype(np.int32)
    _, cj, nj = model.prefill(params, {"tokens": jnp.asarray(toks)},
                              max_len=12)
    _, ct, nt = port.prefill(tparams, torch.tensor(toks), max_len=12)
    nxt = np.random.default_rng(3).integers(
        1, cfg.vocab_size, (3, 1)).astype(np.int32)
    lj, _ = model.decode_step(params, cj, jnp.asarray(nxt), nj)
    lt, _ = port.decode_step(tparams, ct, torch.tensor(nxt), nt)
    assert _ulps(lt.float().numpy(), np.asarray(lj, np.float32)) \
        <= NEAR_TIE_ULPS
