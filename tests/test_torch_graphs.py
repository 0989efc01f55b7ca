"""The engine's step dispatch on the CPU, held against the JAX package at
smoke size: ``trace_counts`` (on the card the CUDA-graph captures, here
the first use of each ``(kind, T, table bucket)`` key) equals the
reference's executable count on its three bounded-compile traces
(tests/test_serving.py's decode buckets and mixed-length chunk buckets,
tests/test_speculative.py's verify widths); ``warmup`` leaves every pool
byte and every ``stats()`` counter as it found them; and the chunk step,
which takes its slot as a device index so one graph serves every slot,
gives the tokens and SSM rows that slot's own batch-of-one pool gives.

The capture and replay themselves need a card: tests/test_torch_gpu.py
holds replay against the eager engine bitwise there."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import repetitive_requests as jax_repetitive
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.data.pipeline import repetitive_requests, serving_requests
from repro_torch.models.lm import LM as PortLM
from repro_torch.serving.engine import Engine, Request

QWEN = "qwen1.5-0.5b"
MAMBA2 = "mamba2-130m"


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config(QWEN, reduced=True)
    params = LM(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, from_jax_numpy(jax.device_get(params))


def _decode_buckets(make, req):
    """tests/test_serving.py:158-190: a table bucket is built once; a
    larger footprint builds exactly one more; ``warmup`` builds the
    bucket of its length and a same-footprint burst reuses it."""
    eng = make(max_batch=2, n_blocks=64, block_size=4)
    seen = []
    eng.submit(req(rid=0, tokens=list(range(1, 5)), max_new_tokens=4))
    eng.run(max_steps=50)
    seen.append(dict(eng.trace_counts))
    eng.submit(req(rid=1, tokens=list(range(1, 5)), max_new_tokens=4))
    eng.submit(req(rid=2, tokens=list(range(2, 6)), max_new_tokens=4))
    eng.run(max_steps=50)
    seen.append(dict(eng.trace_counts))
    eng.submit(req(rid=3, tokens=list(range(1, 17)), max_new_tokens=8))
    eng.run(max_steps=80)
    seen.append(dict(eng.trace_counts))
    assert len(eng.finished) == 4
    eng2 = make(max_batch=2, n_blocks=64, block_size=4)
    eng2.warmup(8)
    seen.append(dict(eng2.trace_counts))
    eng2.submit(req(rid=0, tokens=list(range(1, 5)), max_new_tokens=4))
    eng2.run(max_steps=50)
    seen.append(dict(eng2.trace_counts))
    return seen


def _chunk_buckets(make, req):
    """tests/test_serving.py:302-324: ``warmup(prompt_lens=)`` before a
    mixed-length chunked burst."""
    lens, max_new = [6, 16, 40], 4
    eng = make(max_batch=3, n_blocks=64, block_size=4, prefill_chunk=4)
    eng.warmup(max(lens) + max_new, prompt_lens=lens)
    warm = dict(eng.trace_counts)
    rng = np.random.default_rng(0)
    for rid, t in enumerate(lens):
        eng.submit(req(rid=rid, tokens=rng.integers(
            1, 256, size=t).tolist(), max_new_tokens=max_new))
    eng.run(max_steps=500)
    assert len(eng.finished) == 3
    return [warm, dict(eng.trace_counts)]


def _verify_widths(make, req, prompts):
    """tests/test_speculative.py:395-400: n-gram speculation at depth 4
    builds each verify width once."""
    eng = make(max_batch=2, n_blocks=64, block_size=4, speculate="ngram",
               spec_depth=4)
    eng.warmup(16)
    warm = dict(eng.trace_counts)
    for rid in range(4):
        eng.submit(req(rid=rid, tokens=prompts(rid), max_new_tokens=8))
    eng.run(max_steps=200)
    assert len(eng.finished) == 4
    return [warm, dict(eng.trace_counts)]


@pytest.mark.parametrize("trace", ["decode_buckets", "chunk_buckets",
                                   "verify_widths"])
def test_trace_counts_match_reference(qwen, trace):
    """The port's keys and counts equal the reference's after every
    phase of each trace, except that the port's ``warmup(prompt_lens=)``
    also builds the decode buckets below the largest, which the
    reference compiles while serving: the port's counts after warmup
    then hold the reference's, and serving adds nothing to them."""
    cfg, params, tparams = qwen
    pcfg = port_config(QWEN, reduced=True)

    def ref(**kw):
        kw.setdefault("mode", "fused")
        return JaxEngine(cfg, params, **kw)

    def port(**kw):
        return Engine(pcfg, tparams, device="cpu", **kw)

    if trace == "decode_buckets":
        want = _decode_buckets(ref, JaxRequest)
        got = _decode_buckets(port, Request)
        assert got == want
        assert want[-1] == {("decode", 1, 2): 1}
    elif trace == "chunk_buckets":
        want = _chunk_buckets(ref, JaxRequest)
        got = _chunk_buckets(port, Request)
        assert got[1] == want[1]
        assert got[0] == got[1]                  # nothing built serving
        assert want[0].items() <= got[0].items()
        assert want[0] != want[1]                # the reference's did
    else:
        def prompts(mk):
            return lambda rid: mk(1, cfg.vocab_size, prompt_len=8,
                                  pattern_len=6, seed=rid)[0]
        want = _verify_widths(ref, JaxRequest, prompts(jax_repetitive))
        got = _verify_widths(port, Request, prompts(repetitive_requests))
        assert got == want
        assert {t for _, t, _ in got[1]} == {1, 2, 4, 5}


def _pool_bytes(eng):
    kv = {k: v.clone() for k, v in eng.kv.state.items()}
    ssm = {(pos, leaf): a.clone() for pos, st in eng._ssm_states.items()
           for leaf, a in st.items()}
    return kv, ssm


def _counters(eng):
    """``stats()`` without its times (every key ending in ``_s``)."""
    return {k: v for k, v in eng.stats().items() if not k.endswith("_s")}


WARMUP_CASES = {
    "qwen whole-prompt bf16": (QWEN, dict()),
    "qwen chunk=4 int8": (QWEN, dict(prefill_chunk=4, kv_quant="int8")),
    "mamba2 chunk=8": (MAMBA2, dict(prefill_chunk=8)),
    "qwen ngram": (QWEN, dict(speculate="ngram", spec_depth=3)),
}


@pytest.mark.parametrize("case", list(WARMUP_CASES))
def test_warmup_changes_no_pool_byte_and_no_counter(case):
    """Mid-burst, with live requests in both pools: ``warmup`` (every
    bucket of the trace) leaves the KV storage (the null block included)
    and the SSM pool bitwise and every ``stats()`` counter unchanged, and
    the burst then ends with the tokens an engine that never warmed up
    gives."""
    arch, kw = WARMUP_CASES[case]
    cfg = port_config(arch, reduced=True)
    params = PortLM(cfg, device="cpu").init(0)
    lens, max_new = [5, 12, 9], 6
    outs = []
    for warm in (False, True):
        eng = Engine(cfg, params, max_batch=2, n_blocks=64, block_size=4,
                     device="cpu", **kw)
        for i, p in enumerate(serving_requests(4, cfg.vocab_size,
                                               prompt_lens=lens)):
            eng.submit(Request(rid=i, tokens=p, max_new_tokens=max_new))
        for _ in range(4):
            eng.step()
        if warm:
            kv, ssm = _pool_bytes(eng)
            counters = _counters(eng)
            eng.warmup(max(lens) + max_new, prompt_lens=lens)
            assert eng.trace_counts
            kv2, ssm2 = _pool_bytes(eng)
            for k in kv:
                assert torch.equal(kv2[k], kv[k]), k
            for k in ssm:
                assert torch.equal(ssm2[k], ssm[k]), k
            assert _counters(eng) == counters
        eng.run(max_steps=500)
        outs.append({r.rid: r.output for r in eng.finished})
    assert outs[0] == outs[1] and len(outs[0]) == 4


@pytest.mark.parametrize("slot", [0, 1, 3])
def test_chunk_step_slot_index_reads_and_writes_its_row(slot):
    """The chunk step on a 4-slot pool at device index ``slot`` against
    the same step on a 1-slot pool holding that row (seeded random
    states, a right-padded chunk continuing a context of 8): the same
    token and flag, the slot's (conv, state) rows bitwise the 1-slot
    pool's, every other row untouched."""
    cfg = port_config(MAMBA2, reduced=True)
    params = PortLM(cfg, device="cpu").init(0)
    engines = [Engine(cfg, params, max_batch=b, n_blocks=16, block_size=4,
                      prefill_chunk=8, ssd_impl="ref", device="cpu")
               for b in (4, 1)]
    many, one = engines
    gen = torch.Generator().manual_seed(slot)
    for pos, st in many._ssm_states.items():
        for leaf, a in st.items():
            a.copy_(torch.randn(a.shape, generator=gen) * 0.5)
            one._ssm_states[pos][leaf].copy_(a[:, slot:slot + 1])
    before = _pool_bytes(many)[1]
    rng = np.random.default_rng(slot)
    tokens = rng.integers(1, cfg.vocab_size, (1, 8)).astype(np.int32)
    table = np.asarray([[3, 5, 0, 0]], np.int32)
    outs = []
    for eng, s in ((many, slot), (one, 0)):
        inputs = eng._chunk_inputs(tokens, 8, 5, table, s)
        with torch.no_grad():
            outs.append([o.clone() for o in eng._chunk_step_impl(
                eng.params, eng.kv.state, eng._ssm_states,
                **{k: eng._dev(a) for k, a in inputs.items()})])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    for pos, st in many._ssm_states.items():
        for leaf, a in st.items():
            assert torch.equal(a[:, slot],
                               one._ssm_states[pos][leaf][:, 0])
            assert not torch.equal(a[:, slot], before[(pos, leaf)][:, slot])
            others = [i for i in range(4) if i != slot]
            assert torch.equal(a[:, others], before[(pos, leaf)][:, others])
