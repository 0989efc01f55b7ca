"""The MoE dispatch over ranks, held directly with drops that bind: the
expert-parallel dispatch (the reference's ``_moe_ep``) over a model axis
of two gloo ranks, and the one-device dispatch over a data axis of the
same two processes, against the reference's ``_moe_local`` at a capacity
multiplier small enough that assignments drop.

* EP: each rank routes its slice of ``t`` at its own capacity, so
  ``moe_apply`` at TP = 2 is the reference's ``_moe_local`` on each token
  shard, concatenated (what ``_moe_ep`` computes), and the port's own
  ``_moe_local`` on each shard bit for bit (the reference pins EP and
  local as bitwise equal).
* DP: each rank holds half the rows, and the routing statistics, the
  assignment order and the capacity are the global batch's: the ranks'
  rows are the reference's ``_moe_local`` on the whole batch, drops
  included, and the port's one-device dispatch bit for bit; the loss is
  the global one on both ranks, and the gradients of the router and the
  experts summed over the ranks are the whole batch's (the loss's part
  scaled as ``LM.loss(aux_grad_scale=dp)`` scales it).

One spawn of two ranks (tests/torch_tp_worker.py, which imports no JAX)
runs both, one intra-op thread each.
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
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL

import torch_tp_worker as worker

ARCH = "qwen3-moe-30b-a3b"
MULT = 0.1                  # smoke capacity factor 8 x 0.1: drops bind
COEF = 0.5                  # the loss's weight in the held objective
EP_SHAPE, DP_SHAPE = (2, 12, 64), (4, 6, 64)
TOL = dict(rtol=2e-5, atol=2e-5)
# the ranks' sum against one device's, relative to its norm: each rank's
# gradient of a bf16 leaf is rounded to bf16 once, the one device's once
GRAD_REL = 2.0 ** -8
GRAD_COS = 0.999            # against the reference (test_torch_train's)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(shape, seed):
    """Seeded bf16 values as an f32 array."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).bfloat16().float().numpy()


@functools.lru_cache(maxsize=None)
def _setup():
    cfg = get_config(ARCH, reduced=True)
    model = LM(cfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(0)))
    pos = model.fkinds.index("moe")
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                params["blocks"][f"pos{pos}"]["ffn"])
    tparams = from_jax_numpy(params)
    tp = {k: v[0] for k, v in tparams["blocks"][f"pos{pos}"]["ffn"].items()}
    x_ep, x_dp = _bf16(EP_SHAPE, 11), _bf16(DP_SHAPE, 12)
    # small, so the loss's part of the router's gradient is not lost in
    # the output's
    cot = 1e-3 * np.random.default_rng(13).standard_normal(
        DP_SHAPE).astype(np.float32)
    ranks = spawn_ranks(worker.moe_dispatch, 2, backend="gloo",
                        device="cpu", threads=1,
                        args=(ARCH, tparams, x_ep, x_dp, cot, MULT, COEF))
    return cfg, jp, tp, x_ep, x_dp, cot, ranks


def _bits(a):
    return torch.from_numpy(a).view(torch.bfloat16)


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of each row's largest |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    top = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-30)
    return float((np.abs(got - want) / 2.0 ** (np.floor(np.log2(top)) - 7))
                 .max())


def _drops(h, jp, cfg, cap):
    """Assignments of the reference's routing of ``h`` past ``cap``."""
    _, top_e, _ = RB._route(h.reshape(-1, cfg.d_model), jp["router"], cfg)
    seen = np.zeros(cfg.n_experts, np.int64)
    dropped = 0
    for e in np.asarray(top_e).reshape(-1):
        dropped += int(seen[e] >= cap)
        seen[e] += 1
    return dropped


def test_ep_is_local_on_each_token_shard():
    """moe_apply at TP = 2 on a t-split input (t = 12): every rank holds
    the whole output, equal to the reference's ``_moe_local`` on each
    half of t at the same capacity multiplier, concatenated (within 1
    bf16 ulp: torch and XLA sum f32 products in other orders), and to
    the port's own ``_moe_local`` on each half bit for bit; each half's
    own capacity drops assignments."""
    cfg, jp, tp, x_ep, _, _, ranks = _setup()
    tcfg = port_config(ARCH, reduced=True)
    xj = jnp.asarray(x_ep).astype(jnp.bfloat16)
    hj = RL.rmsnorm(xj, jp["ln"], cfg.norm_eps)
    xt = torch.from_numpy(x_ep).bfloat16()
    ht = TL.rmsnorm(xt, tp["ln"], tcfg.norm_eps)
    half = EP_SHAPE[1] // 2
    shards = [slice(0, half), slice(half, 2 * half)]
    want = xj + jnp.concatenate([RB._moe_local(hj[:, s], jp, cfg, MULT)[0]
                                 for s in shards], axis=1)
    mine = xt + torch.cat([TB._moe_local(ht[:, s], tp, tcfg, MULT)[0]
                           for s in shards], dim=1)
    cap = TB.capacity(EP_SHAPE[0] * half, tcfg, MULT)
    assert cap < TB.capacity(EP_SHAPE[0] * EP_SHAPE[1], tcfg, MULT)
    assert all(_drops(hj[:, s], jp, cfg, cap) > 0 for s in shards)
    for rank in ranks:
        got = _bits(rank["ep"])
        assert _ulps(got.float().numpy(), want.astype(jnp.float32)) <= 1
        assert torch.equal(got.view(torch.int16), mine.view(torch.int16))
        assert rank["ep_bytes"] > 0
    # the loss: the shards' mean over the model axis, on every rank
    auxes = [float(RB._moe_local(hj[:, s], jp, cfg, MULT)[1])
             for s in shards]
    for rank in ranks:
        np.testing.assert_allclose(rank["ep_aux"], np.mean(auxes), **TOL)


def test_dp_routes_the_global_batch():
    """Over a data axis each rank holds two of four rows: the rows are
    the reference's ``_moe_local`` on the whole batch (the global
    capacity drops assignments; within 1 bf16 ulp) and the port's
    one-device dispatch bit for bit; the loss is the global batch's,
    equal on both ranks; the router's and the experts' gradients summed
    over the ranks are the whole batch's (one device: up to the ranks'
    bf16 roundings of their parts; the reference: cosine >= GRAD_COS a
    leaf)."""
    cfg, jp, tp, _, x_dp, cot, ranks = _setup()
    tcfg = port_config(ARCH, reduced=True)
    xj = jnp.asarray(x_dp).astype(jnp.bfloat16)
    hj = RL.rmsnorm(xj, jp["ln"], cfg.norm_eps)
    n = DP_SHAPE[0] * DP_SHAPE[1]
    assert _drops(hj, jp, cfg, TB.capacity(n, tcfg, MULT)) > 0
    # the halves alone would keep other assignments
    half = DP_SHAPE[0] // 2
    assert any(
        _drops(hj[s], jp, cfg, TB.capacity(n // 2, tcfg, MULT))
        != _drops(hj[s], jp, cfg, TB.capacity(n, tcfg, MULT))
        for s in (slice(0, half), slice(half, 2 * half)))
    want, aux_j = RB._moe_local(hj, jp, cfg, MULT)
    want = xj + want
    got = torch.cat([_bits(r["dp"]) for r in ranks])
    assert _ulps(got.float().numpy(), want.astype(jnp.float32)) <= 1
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x_dp).bfloat16()
    y1, aux1 = TB.moe_apply(xt, p, tcfg, MULT)
    assert torch.equal(got.view(torch.int16), y1.detach().view(torch.int16))
    assert ranks[0]["dp_aux"] == ranks[1]["dp_aux"]
    np.testing.assert_allclose(ranks[0]["dp_aux"], float(aux1.detach()),
                               rtol=1e-6)
    np.testing.assert_allclose(ranks[0]["dp_aux"], float(aux_j), **TOL)
    names = ("router", "w_gate", "w_up", "w_down")
    obj = (y1.float() * torch.from_numpy(cot)).sum() + COEF * aux1
    one = torch.autograd.grad(obj, [p[k] for k in names], retain_graph=True)
    # the loss's part of the router's gradient is large enough that the
    # ranks' sum without its scale (half of it missing) would fail
    g_aux = torch.autograd.grad(COEF * aux1, p["router"])[0].float()
    assert float(g_aux.norm()) / 2 > 10 * GRAD_REL * float(
        one[0].float().norm())

    def ref_obj(ws):
        q = dict(jp, **dict(zip(names, ws)))
        y, aux = RB._moe_local(hj, q, cfg, MULT)
        return (((xj + y).astype(jnp.float32) * jnp.asarray(cot)).sum()
                + COEF * aux)

    ref = jax.grad(ref_obj)([jp[k] for k in names])
    for k, g1, gj in zip(names, one, ref):
        g = ranks[0]["dp_grads"][k]
        np.testing.assert_array_equal(g, ranks[1]["dp_grads"][k])
        g1 = g1.float().numpy()
        assert np.linalg.norm(g - g1) <= GRAD_REL * np.linalg.norm(g1), k
        gj = np.asarray(gj, np.float32).ravel()
        cos = float(g.ravel() @ gj / (np.linalg.norm(g) * np.linalg.norm(gj)))
        assert cos >= GRAD_COS, (k, cos)

