"""The port's serving engine on the hybrid family (jamba-v0.1-52b smoke:
two periods of 8 layers, attention at offset 4, SSD mixers elsewhere, an
MoE FFN at the odd offsets) against the JAX package's ``Engine(mode=
"fused")`` on the same bridged weights and trace, whole-prompt bf16 and
chunked int8 KV; the hybrid layout of the engine's pools; and the
prefix cache on it, whose hits restore SSM snapshots: cache-on equals
cache-off.

Greedy streams may split from the reference's only at a bf16 near tie
of the reference's own logits (``test_torch_engine``), read on its eager
path: on 16 layers its jitted scan rounds bf16 at other points than its
blocks applied op by op (up to 15 ulps apart on this trace, where the
eager reference and the port put every split within 1 ulp).
"""
import functools

import jax
import pytest

from repro.configs import get_config
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.data.pipeline import shared_prefix_requests
from repro_torch.serving.engine import Engine, Request

from test_torch_engine import TRACE, _assert_streams_agree, _serve

ARCH = "jamba-v0.1-52b"
CASES = [pytest.param(quant, chunk, id=f"{ARCH}-{quant}-{chunk}-4")
         for quant, chunk in (("none", None), ("int8", 8))]


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = get_config(ARCH, reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, from_jax_numpy(jax.device_get(params))


class _Eager:
    """The reference model with its ``forward`` on the eager path."""

    def __init__(self, model):
        self.model = model

    def forward(self, params, batch):
        with jax.disable_jit():
            return self.model.forward(params, batch)


@pytest.mark.parametrize("kv_quant,prefill_chunk", CASES)
def test_greedy_tokens_match_reference(kv_quant, prefill_chunk):
    cfg, model, params, tparams = _weights()
    kw = dict(max_batch=4, n_blocks=64, block_size=4, kv_quant=kv_quant,
              prefill_chunk=prefill_chunk)
    prompts, want, _ = _serve(JaxEngine, JaxRequest, cfg, params, TRACE,
                              **kw)
    _, got, _ = _serve(Engine, Request, port_config(ARCH, reduced=True),
                       tparams, TRACE, device="cpu", ssd_impl="ref", **kw)
    _assert_streams_agree(_Eager(model), params, prompts, want, got)


def test_hybrid_layout_of_the_pools():
    """One period of 8: attention at offset 4 pages its KV (one paged
    layer a period), the seven SSD positions keep (conv, state) per slot,
    and the MoE FFNs sit at the odd offsets."""
    cfg = port_config(ARCH, reduced=True)
    eng = Engine(cfg, _weights()[3], max_batch=3, n_blocks=16,
                 block_size=4, ssd_impl="ref", device="cpu")
    assert eng.model.period == 8 and eng.model.n_periods == 2
    assert eng._attn_pos == [4]
    assert eng._ssm_pos == [0, 1, 2, 3, 5, 6, 7]
    assert [i for i, k in enumerate(eng.model.fkinds) if k == "moe"] == \
        [1, 3, 5, 7]
    assert eng.kv_cfg.n_layers == 2
    assert sorted(eng._ssm_states) == [f"pos{i}" for i in eng._ssm_pos]
    state = eng._ssm_states["pos0"]["state"]
    assert tuple(state.shape) == (2, 3, cfg.n_ssm_heads, cfg.ssm_headdim,
                                  cfg.ssm_state)


def _run(tparams, prompts, *, prefix_cache):
    eng = Engine(port_config(ARCH, reduced=True), tparams, max_batch=2,
                 n_blocks=64, block_size=8, prefill_chunk=32,
                 prefix_cache=prefix_cache, ssd_impl="ref", device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=list(p), max_new_tokens=6))
        eng.step()
    done = eng.run(max_steps=1500)
    assert len(done) == len(prompts)
    return eng, {r.rid: list(r.output) for r in done}


def test_cache_on_equals_cache_off():
    """A hit on jamba shares the attention layers' KV blocks and restores
    every SSD layer's snapshot at the chunk-aligned depth, so the resumed
    chunks scan as a cold prefill's: the tokens equal cache-off's."""
    tparams = _weights()[3]
    prompts = shared_prefix_requests(3, 256, prefix_len=64, suffix_len=8,
                                     seed=4)
    off_eng, off = _run(tparams, prompts, prefix_cache=False)
    eng, on = _run(tparams, prompts, prefix_cache=True)
    assert on == off
    assert eng.prefix_hits == 2
    assert eng.stats()["prefill_tokens"] < off_eng.stats()["prefill_tokens"]
    snaps = [n.ssm for n in eng._prefix.by_block.values()
             if n.ssm is not None]
    assert snaps and all(sorted(s) == sorted(eng._ssm_states)
                         for s in snaps)
    assert eng.alloc.n_available == eng.alloc.n_blocks
