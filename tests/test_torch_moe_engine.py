"""The port's serving engine on the MoE family (qwen3-moe-30b-a3b smoke:
every layer an MoE FFN of 4 experts, top-2, and Qwen3's per-head q/k
norms) against the JAX package's ``Engine(mode="fused")`` on the same
bridged weights and trace, whole-prompt bf16 and chunked int8 KV, plus
the port's own contracts there: n-gram speculation on equals off, and
the legacy per-layer oracle equals the fused steps.

Greedy streams may split from the reference's only at a bf16 near tie
of the reference's own logits (``test_torch_engine``). The smoke
capacity factor is 8, so no assignment drops in any step and a token's
output does not depend on its step's other rows.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import repetitive_requests
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.models import blocks as TB
from repro_torch.serving.engine import Engine, Request

from test_torch_engine import TRACE, _assert_streams_agree, _serve

ARCH = "qwen3-moe-30b-a3b"
CASES = [pytest.param(quant, chunk, id=f"{ARCH}-{quant}-{chunk}-4")
         for quant, chunk in (("none", None), ("int8", 8))]


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = get_config(ARCH, reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, from_jax_numpy(jax.device_get(params))


def _record_moe_calls(monkeypatch):
    """Wrap the MoE dispatch: each call's (rows, length) and the count of
    its assignments past their expert's capacity, from the routing the
    call took."""
    calls, route, local = [], TB._route, TB._moe_local

    def routed(x, w, cfg):
        out = route(x, w, cfg)
        calls.append([None, out[1]])
        return out

    def dispatched(h, p, cfg, capacity_mult):
        out = local(h, p, cfg, capacity_mult)
        top_e = calls[-1][1].reshape(-1)
        cap = TB.capacity(top_e.numel() // cfg.top_k, cfg, capacity_mult)
        per = torch.zeros(cfg.n_experts, dtype=torch.int64)
        dropped = 0
        for e in top_e.tolist():
            dropped += int(per[e] >= cap)
            per[e] += 1
        calls[-1] = [tuple(h.shape[:-1]), dropped]
        return out

    monkeypatch.setattr(TB, "_route", routed)
    monkeypatch.setattr(TB, "_moe_local", dispatched)
    return calls


@pytest.mark.parametrize("kv_quant,prefill_chunk", CASES)
def test_greedy_tokens_match_reference(kv_quant, prefill_chunk, monkeypatch):
    cfg, model, params, tparams = _weights()
    kw = dict(max_batch=4, n_blocks=64, block_size=4, kv_quant=kv_quant,
              prefill_chunk=prefill_chunk)
    prompts, want, _ = _serve(JaxEngine, JaxRequest, cfg, params, TRACE,
                              **kw)
    calls = _record_moe_calls(monkeypatch)
    _, got, _ = _serve(Engine, Request, port_config(ARCH, reduced=True),
                       tparams, TRACE, device="cpu", **kw)
    assert calls and sum(d for _, d in calls) == 0
    # every step kind routed through the MoE FFN: decode (4 rows of 1),
    # and the chunk step (1 x 8) or the prefill groups (rows x length)
    shapes = {s for s, _ in calls}
    assert (4, 1) in shapes and ((1, 8) in shapes or prefill_chunk is None)
    _assert_streams_agree(model, params, prompts, want, got)


def _port_run(tparams, prompts, max_new, **kw):
    cfg = port_config(ARCH, reduced=True)
    eng = Engine(cfg, tparams, max_batch=4, n_blocks=64, block_size=4,
                 device="cpu", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
    done = eng.run(max_steps=2000)
    return {r.rid: r.output for r in done}, eng.stats()


def test_ngram_speculation_equals_spec_off():
    """The verify step runs the MoE FFN over every row's window (B x T
    rows at the serving capacity): on the repetitive trace the n-gram
    proposer fires, and the greedy tokens equal spec-off's."""
    _, _, _, tparams = _weights()
    prompts = repetitive_requests(4, 256, prompt_len=24)
    off, _ = _port_run(tparams, prompts, 10, prefill_chunk=8)
    on, st = _port_run(tparams, prompts, 10, prefill_chunk=8,
                       speculate="ngram", spec_depth=4)
    assert st["spec_rounds"] > 0 and st["spec_proposed_tokens"] > 0
    assert on == off


def test_legacy_matches_fused_tokens():
    """The legacy per-layer oracle dispatches the MoE FFN layer by layer
    at the same capacity and emits the fused steps' tokens."""
    _, _, _, tparams = _weights()
    prompts = [list(np.random.default_rng(i).integers(1, 256, 12))
               for i in range(5)]
    outs = [_port_run(tparams, prompts, 5, mode=mode)[0]
            for mode in ("legacy", "fused")]
    assert outs[0] == outs[1]
