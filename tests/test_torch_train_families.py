"""Training the ssm, moe and hybrid families: the port's loss and
gradients against the JAX package's on the same bridged weights and
numpy-seeded batch, at smoke size (tests/test_torch_family_trainer.py
trains them through ``Trainer``).

The reference is compiled with ``xla_allow_excess_precision`` off: XLA
otherwise keeps some bf16 values of a fusion in f32, which moves its
jitted loss from its own blocks applied eagerly (qwen3-moe smoke: 4.6e-3
in loss, router gradient cosine 0.986). The port rounds where the eager
blocks round, so without excess precision the two agree to roundoff
(measured, routing forced: |dloss| 0 to 6.8e-4, |daux| up to 6.9e-5,
worst leaf cosine 0.9963 on jamba's ``dt_bias``, at least 0.9992 on
jamba's other leaves and 0.99997 on the other archs').

Routing is recorded on both sides (the reference's through a debug
callback inside its compiled loss). Where a near tie flips a token's
expert set (jamba's 16-layer smoke: 4 tokens over its last three MoE
layers), the port is forced to the reference's experts, its gates and
load-balancing loss computed at them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.models import blocks as RB
from repro.models.lm import LM as JLM
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.core.config import technique_from_label
from repro_torch.launch.build import make_model
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM
from repro_torch.models.params import tree_map, tree_paths

B, T = 2, 64
ARCHS = ["mamba2-130m", "qwen3-moe-30b-a3b", "dbrx-132b", "jamba-v0.1-52b"]
LOSS_ATOL = 2e-3          # tests/test_torch_train.py's limit
AUX_ATOL = 2e-4           # the load-balancing loss (~8 on jamba): 6.9e-5
GRAD_COS = 0.995          # per leaf; jamba's dt_bias reads 0.9963


def _batch(cfg):
    rng = np.random.default_rng(0)
    tok = rng.integers(1, cfg.vocab_size, (B, T), dtype=np.int32)
    lab = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
    lab[0, :5] = -1
    return {"tokens": tok, "labels": lab}


def _reference(cfg, params, batch, monkeypatch):
    """The reference's (loss, metrics, grads) without excess precision,
    and the experts its router chose at each MoE call, in order."""
    routes = []
    orig = RB._route

    def recorded(h, w, c):
        out = orig(h, w, c)
        jax.debug.callback(lambda e: routes.append(np.asarray(e)), out[1],
                           ordered=True)
        return out

    monkeypatch.setattr(RB, "_route", recorded)
    model = JLM(cfg)
    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    fn = jax.jit(jax.value_and_grad(lambda p, b: model.loss(p, b),
                                    has_aux=True))
    compiled = fn.lower(params, jb).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (loss, metrics), grads = compiled(params, jb)
    jax.effects_barrier()
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        dict(tree_paths(jax.device_get(grads))), routes


def _forced_route(routes, flips, monkeypatch):
    """``blocks._route`` that takes the reference's experts of each call
    (in call order), with the gates and the load-balancing loss computed
    at them; counts the calls whose experts it changed in ``flips``."""
    orig = TB._route
    calls = iter(routes)

    def forced(h, w, cfg):
        top_w, top_e, aux = orig(h, w, cfg)
        want = torch.from_numpy(next(calls)).to(top_e.device).reshape(
            top_e.shape).long()
        if torch.equal(want, top_e):
            return top_w, top_e, aux
        flips.append(int((want != top_e).any(-1).sum()))
        gates = torch.softmax(TL.dense(h.float(), w).float(), dim=-1)
        tw = gates.gather(-1, want)
        tw = tw / torch.clamp_min(tw.sum(-1, keepdim=True), 1e-9)
        lead = tuple(range(gates.ndim - 1))
        experts = torch.arange(cfg.n_experts, device=want.device)
        ce = (want[..., :1] == experts).float().mean(dim=lead)
        return tw, want, cfg.n_experts * (gates.mean(dim=lead) * ce).sum()

    monkeypatch.setattr(TB, "_route", forced)


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    n = np.linalg.norm(a) * np.linalg.norm(b)
    if n == 0:
        return 1.0 if not a.any() and not b.any() else 0.0
    return float(a @ b / n)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_the_reference(arch, monkeypatch):
    """Smoke config, remat off, capacity multiplier 1.0 (train): the
    loss, its CE and load-balancing parts and every leaf's gradient."""
    cfg = get_config(arch, reduced=True)
    params = jax.device_get(JLM(cfg).init(jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    jl, jmet, jg, routes = _reference(cfg, params, batch, monkeypatch)
    flips: list = []
    if cfg.n_experts:
        _forced_route(routes, flips, monkeypatch)
    model = LM(port_config(arch, reduced=True), device="cpu")
    tp = tree_map(lambda t: t.requires_grad_(True), from_jax_numpy(params))
    tl, tmet = model.loss(tp, {k: torch.from_numpy(v.copy())
                               for k, v in batch.items()})
    paths = tree_paths(tp)
    grads = torch.autograd.grad(tl, [t for _, t in paths])
    moe_layers = sum(k == "moe" for k in cfg.ffn_kinds())
    assert len(routes) == moe_layers
    assert sum(flips) <= 0.01 * B * T * moe_layers, flips
    assert abs(float(tl.detach()) - jl) < LOSS_ATOL
    assert abs(float(tmet["ce"]) - jmet["ce"]) < LOSS_ATOL
    assert abs(float(tmet["aux"]) - jmet["aux"]) < AUX_ATOL
    assert (float(tmet["aux"]) > 0) == bool(moe_layers)
    assert len(paths) == len(jg)
    for (path, leaf), g in zip(paths, grads):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, path
        assert _cos(g.float().numpy(), np.asarray(jg[path], np.float32)) \
            >= GRAD_COS, path


def test_training_ssm_through_the_kernel_route_raises():
    """The SSD kernel has no backward: training an SSM layer through
    ``ssd_impl="kernel"`` raises instead of dropping its gradient."""
    cfg = port_config("mamba2-130m", reduced=True)
    model = LM(cfg, ssd_impl="kernel", device="cpu")
    toks = torch.ones((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        model.loss(model.init(0), {"tokens": toks, "labels": toks})
    assert make_model(cfg, technique_from_label("F+R"),
                      device="cpu").ssd_impl == "ref"
