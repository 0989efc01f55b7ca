"""Speculative decoding in the port: the proposers and the depth back-off
against the JAX package's (tests/test_speculative.py:57-69 and 494-535 as
models), the repetitive trace bit for bit, spec-on == spec-off greedy
parity of the port's engine (n-gram, scripted and draft proposers; int8
KV, chunked prefill, preemption), exact rollback of the paged pool, the
port's spec tokens and accept counts against the reference engine's on
the repetitive trace, and the parts not ported raising.

Within the port, spec-on and spec-off must give equal tokens: both run
the same kernels in the same order on the CPU (the verify window's rows
are independent). Against the reference engine, a stream may split only
at a bf16 near tie (4 bf16 ulps) of the reference's own logits, the rule
of tests/test_torch_engine.py: the two frameworks sum f32 products in
different orders.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import repetitive_requests as ref_repetitive
from repro.models.lm import LM
from repro.serving import speculate as RS
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.data.pipeline import repetitive_requests
from repro_torch.serving import speculate as TS
from repro_torch.serving.engine import Engine, Request

NEAR_TIE_ULPS = 4


@pytest.fixture(scope="module")
def weights():
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return (cfg, model, params, port_config("qwen1.5-0.5b", reduced=True),
            from_jax_numpy(jax.device_get(params)))


def _prompts(vocab, lens, seed=0):
    return [repetitive_requests(1, vocab, prompt_len=t, pattern_len=6,
                                seed=seed)[0] for t in lens]


def _req(tokens, output):
    return types.SimpleNamespace(tokens=list(tokens), output=list(output))


class ScriptedProposer:
    """Proposes the reference continuation for ``good`` tokens, then a
    garbage tail: a deterministic partial-acceptance pattern."""

    def __init__(self, ref, good, garbage=7):
        self.ref, self.good, self.garbage = ref, good, garbage

    def propose(self, req, k):
        i = len(req.output)
        ref = self.ref[req.rid] if isinstance(self.ref, dict) else self.ref
        if i >= len(ref):
            return []
        props = ref[i: i + min(k, self.good)]
        if len(props) < k:
            props = props + [self.garbage] * (k - len(props))
        return props[:k]


def _serve(cfg, params, prompts, *, max_new, cls=Engine, req_cls=Request,
           **kw):
    if cls is Engine:
        kw.setdefault("device", "cpu")
    eng = cls(cfg, params, **kw)
    for rid, p in enumerate(prompts):
        eng.submit(req_cls(rid=rid, tokens=list(p), max_new_tokens=max_new))
    done = eng.run(max_steps=500)
    assert len(done) == len(prompts)
    assert all(len(r.output) == max_new for r in done)
    assert eng.alloc.n_free == eng.alloc.n_blocks
    return eng, {r.rid: r.output for r in done}


# ---------------------------------------------------------------------------
# Proposers, back-off, trace
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tokens,output,k", [
    ([10, 11, 12, 13, 20, 30, 11], [12], 2),
    ([1, 2, 5, 1, 2, 9], [1, 2], 1),
    ([4, 4, 4], [4], 8),
    ([1, 2, 3, 4, 5], [], 4),
    ([9, 1, 2, 8, 0, 9, 1, 2], [], 1),
])
def test_ngram_proposer_matches_reference(tokens, output, k):
    want = RS.NGramProposer(max_ngram=3).propose(_req(tokens, output), k)
    got = TS.NGramProposer(max_ngram=3).propose(_req(tokens, output), k)
    assert got == want


def test_ngram_proposer_on_random_contexts():
    rng = np.random.default_rng(0)
    for _ in range(50):
        ctx = rng.integers(0, 5, rng.integers(1, 30)).tolist()
        k = int(rng.integers(1, 6))
        n = int(rng.integers(1, 4))
        assert (TS.NGramProposer(max_ngram=n).propose(_req(ctx, []), k)
                == RS.NGramProposer(max_ngram=n).propose(_req(ctx, []), k))


def test_adaptive_depth_backoff_matches_reference():
    """tests/test_speculative.py:494-513 on both speculators side by side:
    the same record() sequence gives the same depths and stats."""
    specs = (TS.Speculator(TS.NGramProposer(), depth=8),
             RS.Speculator(RS.NGramProposer(), depth=8))
    reqs = (_req([1], [2]), _req([1], [2]))
    for r in reqs:
        r.spec_depth = 0
    assert [s.depth_for(r, budget=100) for s, r in zip(specs, reqs)] == [8, 8]
    for expect in (4, 2, 1, 1):
        for s, r in zip(specs, reqs):
            s.record(r, proposed=r.spec_depth, accepted=0)
            assert r.spec_depth == expect
    for expect in (2, 3, 4, 5, 6, 7, 8, 8):
        for s, r in zip(specs, reqs):
            s.record(r, proposed=r.spec_depth, accepted=r.spec_depth)
            assert r.spec_depth == expect
    for s, r in zip(specs, reqs):
        s.record(r, proposed=8, accepted=3)
        assert r.spec_depth == 4
        assert s.depth_for(r, budget=2) == 2
    assert specs[0].stats() == specs[1].stats()
    specs[0].reset()
    assert specs[0].stats()["spec_rounds"] == 0
    assert specs[0].stats()["spec_depth_hist"] == {}


def test_build_speculator_validation():
    cfg = port_config("qwen1.5-0.5b", reduced=True)
    assert TS.build_speculator(None, cfg) is None
    assert TS.build_speculator("off", cfg) is None
    assert TS.build_speculator("ngram", cfg).proposer.name == "ngram"
    draft = TS.build_speculator("draft:qwen1.5-0.5b", cfg, device="cpu")
    assert draft.proposer.name == "draft"
    assert draft.proposer.cfg.name == "qwen1.5-0.5b-smoke"
    obj = ScriptedProposer([1, 2], good=1)
    assert TS.build_speculator(obj, cfg, depth=3).proposer is obj
    with pytest.raises(ValueError):
        TS.build_speculator("bogus", cfg)
    with pytest.raises(ValueError):        # vocab 151936 vs 50280
        TS.build_speculator("draft:mamba2-130m",
                            port_config("qwen1.5-0.5b"), device="cpu")
    with pytest.raises(ValueError):
        TS.Speculator(TS.NGramProposer(), depth=0)


@pytest.mark.parametrize("n,vocab,prompt_len,pattern_len,seed", [
    (16, 151936, 256, 8, 0), (3, 256, 24, 6, 1), (2, 50280, 7, 9, 5)])
def test_repetitive_requests_bit_equal(n, vocab, prompt_len, pattern_len,
                                       seed):
    assert (repetitive_requests(n, vocab, prompt_len, pattern_len, seed)
            == ref_repetitive(n, vocab, prompt_len, pattern_len, seed))


def test_draft_proposer_matches_reference(weights):
    """Both draft proposers on the same bridged weights propose the same
    greedy tokens (prefill, then dense-cache decode steps)."""
    cfg, _, params, pcfg, tparams = weights
    ref = RS.DraftModelProposer(cfg, params)
    port = TS.DraftModelProposer(pcfg, tparams, device="cpu")
    rng = np.random.default_rng(5)
    for t, k in ((5, 4), (12, 3), (9, 1)):
        req = _req(rng.integers(1, cfg.vocab_size, t).tolist(), [3])
        assert port.propose(req, k) == ref.propose(req, k)
    assert (port.n_prefills, port.n_decode_steps) == (3, 3 + 2 + 0)


# ---------------------------------------------------------------------------
# The port's engine: spec-on == spec-off
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_spec_ngram_equals_spec_off(weights, kv_quant):
    _, _, _, pcfg, tparams = weights
    prompts = _prompts(pcfg.vocab_size, (12, 9, 14, 20))
    kw = dict(max_batch=3, n_blocks=64, block_size=8, kv_quant=kv_quant)
    _, ref = _serve(pcfg, tparams, prompts, max_new=10, **kw)
    eng, out = _serve(pcfg, tparams, prompts, max_new=10, speculate="ngram",
                      spec_depth=4, **kw)
    st = eng.stats()
    assert out == ref
    assert st["spec_rounds"] > 0 and st["verify_steps"] > 0
    assert st["decode_steps"] == 0          # every decode step verifies
    assert sum(st["spec_depth_hist"].values()) == st["spec_rounds"]
    assert st["spec_proposed_tokens"] >= st["spec_accepted_tokens"]


def test_spec_with_chunked_prefill_equals_spec_off(weights):
    """A request mid-chunked-prefill holds an inactive verify row while
    the running batch speculates; the scripted proposer forces partial
    acceptance while the long prompt is still paging out."""
    _, _, _, pcfg, tparams = weights
    prompts = _prompts(pcfg.vocab_size, (8, 64))

    def run(spec):
        eng = Engine(pcfg, tparams, max_batch=2, n_blocks=64, block_size=8,
                     prefill_chunk=8, speculate=spec, spec_depth=4,
                     device="cpu")
        eng.submit(Request(rid=0, tokens=list(prompts[0]),
                           max_new_tokens=16))
        eng.step()                  # rid 0 starts decoding first
        eng.submit(Request(rid=1, tokens=list(prompts[1]),
                           max_new_tokens=6))
        done = eng.run(max_steps=400)
        assert len(done) == 2
        assert eng.alloc.n_free == eng.alloc.n_blocks
        return eng, {r.rid: r.output for r in done}

    _, ref = run(None)
    eng, out = run(ScriptedProposer(ref, good=2))
    assert eng.stats()["spec_rounds"] > 0
    assert out == ref


def test_spec_preemption_no_leak_token_exact(weights):
    _, _, _, pcfg, tparams = weights
    prompts = _prompts(pcfg.vocab_size, (8, 8, 8, 8), seed=1)
    kw = dict(max_batch=3, block_size=4)
    _, ref = _serve(pcfg, tparams, prompts, max_new=6, n_blocks=64, **kw)
    eng, out = _serve(pcfg, tparams, prompts, max_new=6, n_blocks=6,
                      speculate="ngram", spec_depth=4, **kw)
    assert out == ref
    assert eng.sched.n_preemptions > 0
    assert all(r is None for r in eng.sched.running)


def test_spec_draft_equals_spec_off(weights):
    """A draft with other (random) weights proposes mostly wrong tokens;
    acceptance still leaves the target's greedy stream untouched."""
    _, _, _, pcfg, tparams = weights
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, pcfg.vocab_size, size=t).tolist()
               for t in (10, 15)]
    kw = dict(max_batch=2, n_blocks=64, block_size=8)
    _, ref = _serve(pcfg, tparams, prompts, max_new=8, **kw)
    draft = TS.DraftModelProposer(pcfg, seed=1, device="cpu")
    eng, out = _serve(pcfg, tparams, prompts, max_new=8, speculate=draft,
                      spec_depth=3, **kw)
    assert out == ref
    assert eng.stats()["spec_rounds"] > 0
    assert draft.n_decode_steps > 0


def test_spec_self_draft_accepts_everything(weights):
    """Drafting with the target's own weights: every proposal matches the
    verify argmax, so 11 tokens arrive in ~11/(depth+1) rounds."""
    _, _, _, pcfg, tparams = weights
    draft = TS.DraftModelProposer(pcfg, tparams, device="cpu")
    eng, out = _serve(pcfg, tparams, [list(range(1, 11))], max_new=11,
                      max_batch=1, n_blocks=32, block_size=8,
                      speculate=draft, spec_depth=4)
    st = eng.stats()
    assert st["accept_rate"] == 1.0
    assert st["spec_rounds"] <= 3
    _, ref = _serve(pcfg, tparams, [list(range(1, 11))], max_new=11,
                    max_batch=1, n_blocks=32, block_size=8)
    assert out == ref


def test_spec_respects_max_new_budget(weights):
    _, _, _, pcfg, tparams = weights
    kw = dict(max_batch=1, n_blocks=32, block_size=8)
    _, ref = _serve(pcfg, tparams, [list(range(1, 9))], max_new=5, **kw)
    _, out = _serve(pcfg, tparams, [list(range(1, 9))], max_new=5,
                    speculate=ScriptedProposer(ref[0], good=8),
                    spec_depth=8, **kw)
    assert out == ref


def test_partial_acceptance_rolls_the_pool_back_exactly(weights):
    """Two good tokens then garbage each round: every verify round
    rejects a tail, whose KV went to the null block, so the pool proper
    is byte-equal to the spec-off replay's."""
    _, _, _, pcfg, tparams = weights
    prompt = np.random.default_rng(1).integers(
        1, pcfg.vocab_size, size=13).tolist()
    kw = dict(max_batch=2, n_blocks=32, block_size=8)
    eng_off, ref = _serve(pcfg, tparams, [prompt], max_new=10, **kw)
    eng_on, out = _serve(pcfg, tparams, [prompt], max_new=10,
                         speculate=ScriptedProposer(ref[0], good=2),
                         spec_depth=4, **kw)
    st = eng_on.stats()
    assert out == ref
    assert 0.0 < st["accept_rate"] < 1.0
    for key, a in eng_off.kv.pool().items():
        assert torch.equal(a, eng_on.kv.pool()[key]), key


def test_stats_fields_and_reset(weights):
    _, _, _, pcfg, tparams = weights
    eng, _ = _serve(pcfg, tparams, _prompts(pcfg.vocab_size, (12, 16), 3),
                    max_new=8, max_batch=2, n_blocks=64, block_size=8,
                    speculate="ngram", spec_depth=4)
    st = eng.stats()
    for k in ("spec_rounds", "spec_proposed_tokens", "spec_accepted_tokens",
              "spec_abandoned", "accept_rate", "spec_depth_hist",
              "verify_steps"):
        assert k in st
    assert st["spec_rounds"] > 0
    assert all(int(k) <= 4 for k in st["spec_depth_hist"])
    eng.reset_stats()
    st = eng.stats()
    assert st["spec_rounds"] == st["spec_proposed_tokens"] == 0
    assert st["spec_depth_hist"] == {} and st["verify_steps"] == 0
    plain = Engine(pcfg, tparams, device="cpu").stats()
    assert "spec_rounds" not in plain and plain["verify_steps"] == 0


@pytest.mark.parametrize("spec,chunk", [("self-draft", None),
                                        ("ngram", 8)])
def test_read_and_norm_calls_follow_the_steps(weights, monkeypatch, spec,
                                              chunk):
    """The counts chip_smoke.py derives from a run's stats, held on the
    CPU by counting the wrappers' calls: the paged read once a layer per
    decode, chunk or verify step; the dense decode read once a layer per
    draft decode step; RMSNorm 2 x layers + 1 per forward (prefill
    groups, engine steps, draft prefills and draft decode steps)."""
    from collections import Counter

    from repro_torch.kernels import flash_decode as tfd
    from repro_torch.kernels import ops as tops
    _, _, _, pcfg, tparams = weights
    calls = Counter()

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tops, "rmsnorm", counted("rmsnorm", tops.rmsnorm))
    monkeypatch.setattr(tfd, "flash_decode_partial", counted(
        "dense", tfd.flash_decode_partial))
    monkeypatch.setattr(tfd, "paged_flash_prefix_partial", counted(
        "paged", tfd.paged_flash_prefix_partial))
    draft = (TS.DraftModelProposer(pcfg, tparams, device="cpu")
             if spec == "self-draft" else None)
    eng, _ = _serve(pcfg, tparams, _prompts(pcfg.vocab_size, (12, 20, 9)),
                    max_new=9, max_batch=2, n_blocks=64, block_size=8,
                    prefill_chunk=chunk, speculate=draft or spec,
                    spec_depth=4)
    st = eng.stats()
    n_l = pcfg.n_layers
    steps = st["decode_steps"] + st["chunk_steps"] + st["verify_steps"]
    drafted = (draft.n_prefills, draft.n_decode_steps) if draft else (0, 0)
    assert st["verify_steps"] > 0 and (chunk is None or st["chunk_steps"])
    assert calls["paged"] == n_l * steps
    assert calls["dense"] == n_l * drafted[1]
    assert calls["rmsnorm"] == (2 * n_l + 1) * (
        steps + st["prefill_groups"] + sum(drafted))


# ---------------------------------------------------------------------------
# Against the reference engine
# ---------------------------------------------------------------------------


def _bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def test_spec_tokens_and_accepts_match_reference(weights):
    """The repetitive trace through both engines with the n-gram
    proposer: every stream agrees up to a bf16 near tie of the
    reference's logits; where no stream splits, the verify rounds,
    proposed and accepted counts are equal."""
    cfg, model, params, pcfg, tparams = weights
    prompts = _prompts(cfg.vocab_size, (12, 9, 14, 20))
    kw = dict(max_batch=3, n_blocks=64, block_size=8, speculate="ngram",
              spec_depth=4)
    jeng, want = _serve(cfg, params, prompts, max_new=10, cls=JaxEngine,
                        req_cls=JaxRequest, **kw)
    teng, got = _serve(pcfg, tparams, prompts, max_new=10, **kw)
    splits = 0
    for rid, ref in want.items():
        out = got[rid]
        j = next((i for i, (a, b) in enumerate(zip(ref, out)) if a != b),
                 None)
        if j is None:
            continue
        splits += 1
        seq = jnp.asarray([prompts[rid] + ref[:j]], jnp.int32)
        row = np.asarray(model.forward(params, {"tokens": seq})[0, -1],
                         np.float32)
        top = float(row.max())
        assert row[out[j]] >= top - NEAR_TIE_ULPS * _bf16_ulp(top), (
            f"rid {rid} splits at token {j}, not a bf16 near tie")
    js, ts = jeng.stats(), teng.stats()
    assert js["spec_rounds"] > 0
    if not splits:
        for k in ("spec_rounds", "spec_proposed_tokens",
                  "spec_accepted_tokens", "spec_depth_hist"):
            assert ts[k] == js[k], k


# ---------------------------------------------------------------------------
# Not ported, and the CLI
# ---------------------------------------------------------------------------


def test_ssm_arch_speculation_raises():
    from repro_torch.models.lm import LM as PortLM
    ssm = port_config("mamba2-130m", reduced=True)
    params = PortLM(ssm, device="cpu").init(0)
    with pytest.raises(NotImplementedError, match="SSM"):
        Engine(ssm, params, speculate="ngram", device="cpu")
    Engine(ssm, params, speculate="off", device="cpu")


def test_serve_cli_speculates(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "3", "--max-new", "8",
                "--speculate", "ngram", "--spec-depth", "3",
                "--repetitive"])
    out = capsys.readouterr().out
    stats = dict(line.split(": ", 1) for line in
                 (ln.strip() for ln in out.splitlines()) if ": " in line)
    assert stats["finished"] == "3"
    assert int(stats["spec_rounds"]) > 0
    assert int(stats["verify_steps"]) > 0 and stats["decode_steps"] == "0"
    assert "spec_depth_hist" in stats


def test_serve_cli_draft_flag(capsys):
    from repro_torch.launch import serve
    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "4",
                "--speculate", "draft:qwen1.5-0.5b", "--spec-depth", "2"])
    out = capsys.readouterr().out
    assert "accept_rate" in out and "finished: 2" in out
