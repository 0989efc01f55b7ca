"""The port's serving telemetry (serving/telemetry.py) on smoke
qwen1.5-0.5b and mamba2-130m weights bridged from the JAX package.

  * the metrics registry, the disabled collector's null phases, the
    bounded step ring and event cap;
  * invisible to the device: telemetry-on (plain and fenced) and -off
    engines give bitwise-equal tokens, ``trace_counts`` and pools;
  * against the reference on one trace (chunked prefill, the prefix
    cache, a pool that preempts; with and without n-gram speculation):
    ``snapshot()``'s nested key set equals the reference's but for the
    port's step counts under ``engine`` and is a superset of
    tests/test_telemetry.py's ``DOCUMENTED_SCHEMA``; without speculation
    (whose proposals follow the tokens, which may split at near ties)
    the schedule is the same, so the registry counters, the request,
    pool and prefix-cache sections and the step kinds are equal;
  * ``stats()`` as a flat view of ``snapshot_base()``, ``reset_stats``;
  * the Chrome export: every request's lifecycle, the chaos track, the
    port's metadata.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.data.pipeline import shared_prefix_requests as jax_shared_prefix
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.data.pipeline import shared_prefix_requests
from repro_torch.serving import telemetry as T
from repro_torch.serving.engine import Engine, Rejected, Request
from repro_torch.serving.faults import FaultInjector, StepFaults

from test_telemetry import DOCUMENTED_SCHEMA
from test_torch_engine import _assert_streams_agree

QWEN = "qwen1.5-0.5b"
MAMBA2 = "mamba2-130m"
# the port's step counts by kind, kept in the engine section
PORT_ENGINE_KEYS = {"decode_steps", "verify_steps", "chunk_steps",
                    "prefill_groups"}
# the mixed trace: chunked prefill, shared prefixes (cache hits), n-gram
# speculation and a pool small enough to preempt
MIXED = dict(max_batch=4, n_blocks=14, block_size=8, prefill_chunk=8,
             speculate="ngram", spec_depth=3, prefix_cache=True)


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config(QWEN, reduced=True)
    params = LM(cfg).init(jax.random.PRNGKey(0))
    return cfg, params, from_jax_numpy(jax.device_get(params))


@pytest.fixture(scope="module")
def cfg():
    return port_config(QWEN, reduced=True)


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=t).tolist() for t in lens]


def _drain(eng, request_cls, prompts, max_new=6, max_steps=1500):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, tokens=list(p),
                               max_new_tokens=max_new))
    done = eng.run(max_steps=max_steps)
    assert len(done) == len(prompts)
    return {r.rid: r.output for r in done}


def _keys(tree, depth=2):
    """Nested key set of a snapshot down to ``depth`` levels."""
    out = set()
    for k, v in tree.items():
        out.add((k,))
        if depth > 1 and isinstance(v, dict) and k not in (
                "counters", "gauges", "histograms", "rejected_reasons",
                "spec_depth_hist", "phase_totals_s", "step_kinds"):
            out |= {(k,) + sub for sub in _keys(v, depth - 1)}
    return out


# ---------------------------------------------------------------------------
# Registry, null phases, bounded collection
# ---------------------------------------------------------------------------


def test_metrics_registry_snapshot():
    reg = T.MetricsRegistry(hist_cap=8)
    reg.count("a")
    reg.count("a", 4)
    reg.gauge("g", 2.5)
    for v in range(20):
        reg.observe("h", float(v))
    snap = reg.snapshot()
    assert snap["counters"]["a"] == 5
    assert snap["gauges"]["g"] == 2.5
    h = snap["histograms"]["h"]
    assert h["count"] == 20 and h["sum"] == sum(range(20))
    assert h["mean"] == pytest.approx(9.5)
    assert 12.0 <= h["p50"] <= 19.0     # the reservoir keeps the last 8
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}


def test_disabled_telemetry_collects_nothing(cfg, qwen):
    tel = T.Telemetry(enabled=False)
    assert tel.phase("schedule") is T._NULL_PHASE
    eng = Engine(cfg, qwen[2], max_batch=2, n_blocks=16, block_size=8,
                 device="cpu")
    _drain(eng, Request, _prompts(cfg.vocab_size, (8,)), max_new=3)
    tel = eng.telemetry
    assert not tel.enabled
    assert tel.events == [] and len(tel.timeline) == 0
    assert tel.timer.records == {}
    assert tel.registry.snapshot()["counters"] == {}


def test_step_timeline_ring_is_bounded(cfg, qwen):
    tel = T.Telemetry(timeline_cap=4)
    eng = Engine(cfg, qwen[2], max_batch=2, n_blocks=32, block_size=8,
                 telemetry=tel, device="cpu")
    _drain(eng, Request, _prompts(cfg.vocab_size, (8, 8)), max_new=8)
    assert eng.steps > 4 and len(tel.timeline) == 4
    s = tel.timeline_summary()
    assert s["recorded"] == 4 and s["dropped"] == eng.steps - 4
    assert [r["step"] for r in tel.timeline] == \
        list(range(eng.steps - 4, eng.steps))


def test_event_cap_drops_and_counts(monkeypatch):
    monkeypatch.setattr(T, "_EVENTS_CAP", 3)
    tel = T.Telemetry()
    for i in range(5):
        tel._instant(0, f"e{i}")
    assert tel.events_dropped == 2
    trace = tel.export_chrome()
    assert trace["otherData"]["events_dropped"] == 2
    assert sum(1 for e in trace["traceEvents"] if e["ph"] == "i") == 3


# ---------------------------------------------------------------------------
# Invisible to the device
# ---------------------------------------------------------------------------


def _pools(eng):
    kv = {k: v.clone() for k, v in eng.kv.pool().items()}
    ssm = {(pos, leaf): a.clone() for pos, st in eng._ssm_states.items()
           for leaf, a in st.items()}
    return kv, ssm


@pytest.mark.parametrize("arch", [QWEN, MAMBA2])
def test_telemetry_on_off_bitwise(qwen, arch):
    """Off, on and fenced: the same tokens, ``trace_counts`` and pool
    bytes (qwen: the mixed trace; mamba2: chunked with the prefix cache,
    its SSM snapshots restored on hits)."""
    if arch == QWEN:
        params, kw = qwen[2], MIXED
    else:
        rcfg = get_config(MAMBA2, reduced=True)
        params = from_jax_numpy(jax.device_get(
            LM(rcfg).init(jax.random.PRNGKey(0))))
        kw = dict(max_batch=2, n_blocks=64, block_size=8, prefill_chunk=32,
                  prefix_cache=True, ssd_impl="ref")
    cfg = port_config(arch, reduced=True)
    prompts = shared_prefix_requests(5, cfg.vocab_size, prefix_len=24 if
                                     arch == QWEN else 64, suffix_len=8,
                                     seed=7)
    runs = []
    for tel in (False, True, T.Telemetry(fenced=True)):
        eng = Engine(cfg, params, telemetry=tel, device="cpu", **kw)
        toks = _drain(eng, Request, prompts)
        runs.append((toks, dict(eng.trace_counts), _pools(eng),
                     eng.stats()["prefix_cache_hit_rate"]))
    for toks, traces, (kv, ssm), hit in runs[1:]:
        assert toks == runs[0][0]
        assert traces == runs[0][1]
        assert all(torch.equal(kv[k], runs[0][2][0][k]) for k in kv)
        assert all(torch.equal(ssm[k], runs[0][2][1][k]) for k in ssm)
        assert hit == runs[0][3] > 0.0
    assert eng.telemetry.timeline_summary()["phase_totals_s"]["sync"] >= 0


# ---------------------------------------------------------------------------
# The snapshot against the reference's
# ---------------------------------------------------------------------------


def _no_spec(kw):
    return {k: v for k, v in kw.items() if k not in ("speculate",
                                                     "spec_depth")}


@pytest.fixture(scope="module")
def mixed_runs(qwen):
    """The mixed trace, with and without speculation, on both engines."""
    rcfg, rparams, tparams = qwen
    prompts = jax_shared_prefix(6, rcfg.vocab_size, prefix_len=24,
                                suffix_len=8, seed=7)
    out = {"prompts": prompts}
    for name, kw in (("spec", MIXED), ("plain", _no_spec(MIXED))):
        ref = JaxEngine(rcfg, rparams, telemetry=True, **kw)
        ref_toks = _drain(ref, JaxRequest, prompts, max_new=8)
        eng = Engine(port_config(QWEN, reduced=True), tparams,
                     telemetry=True, device="cpu", **kw)
        toks = _drain(eng, Request, prompts, max_new=8)
        out[name] = (ref, ref_toks, eng, toks)
    return out


@pytest.mark.parametrize("run", ["spec", "plain"])
def test_snapshot_keys_and_counters_match_reference(qwen, mixed_runs, run):
    ref, ref_toks, eng, toks = mixed_runs[run]
    model = LM(get_config(QWEN, reduced=True))
    _assert_streams_agree(model, qwen[1], mixed_runs["prompts"], ref_toks,
                          toks)
    snap, want = eng.snapshot(), ref.snapshot()
    json.dumps(snap)
    assert snap["schema_version"] == want["schema_version"] == \
        T.SCHEMA_VERSION
    extra = {("engine", k) for k in PORT_ENGINE_KEYS}
    assert _keys(snap, 3) == _keys(want, 3) | extra
    for section, keys in DOCUMENTED_SCHEMA.items():
        assert keys <= set(snap[section]), section
    assert set(snap["histograms"]) == set(want["histograms"])
    assert snap["counters"]["preemptions"] > 0
    assert snap["counters"]["prefix_hits"] > 0
    if run == "spec":
        assert snap["counters"]["spec_proposed"] > 0
        return
    # one schedule, accounted on the host the same way by both
    assert snap["counters"] == want["counters"]
    for sec in ("requests", "prefix_cache", "scheduler", "pool"):
        assert snap[sec] == want[sec], sec
    for k in ("steps", "mode", "prefill_chunk", "model_parallel"):
        assert snap["engine"][k] == want["engine"][k]
    assert snap["timeline"]["step_kinds"] == want["timeline"]["step_kinds"]
    assert snap["timeline"]["recorded"] == want["timeline"]["recorded"]


def test_stats_is_a_flat_view_of_the_snapshot(mixed_runs):
    _, _, eng, _ = mixed_runs["spec"]
    st, s = eng.stats(), eng.snapshot_base()
    assert st["requests"] == s["requests"]["completed"]
    assert st["finished"] == s["requests"]["finished"]
    assert st["rejected_reasons"] == s["requests"]["rejected_reasons"]
    assert st["throughput_tok_s"] == s["throughput"]["tok_s"]
    assert st["decode_tok_s"] == s["throughput"]["decode_tok_s"]
    assert st["p50_ttft_s"] == s["latency"]["ttft"]["p50"]
    assert st["p99_tpot_s"] == s["latency"]["tpot"]["p99"]
    assert st["mean_queue_s"] == s["latency"]["queue"]["mean"]
    assert st["kv_blocks_free"] == s["pool"]["free"]
    assert st["prefix_cache_hit_rate"] == s["prefix_cache"]["hit_rate"]
    assert st["cached_tokens_reused"] == s["prefix_cache"]["tokens_reused"]
    assert st["preemptions"] == s["scheduler"]["preemptions"]
    assert st["model_parallel"] == s["engine"]["model_parallel"] == 1
    for k in PORT_ENGINE_KEYS:
        assert st[k] == s["engine"][k]
    assert st["verify_steps"] > 0 and st["chunk_steps"] > 0
    assert s["engine"]["mode"] == "fused"


def test_chrome_export_covers_every_request(mixed_runs, tmp_path):
    _, _, eng, _ = mixed_runs["spec"]
    out = tmp_path / "trace.json"
    trace = eng.telemetry.export_chrome(str(out), metadata={"seed": 7})
    loaded = json.loads(out.read_text())
    assert loaded == json.loads(json.dumps(trace))
    other = loaded["otherData"]
    assert other["schema_version"] == T.SCHEMA_VERSION
    assert other["torch_version"] == torch.__version__
    assert other["device"] == "cpu" and other["seed"] == 7
    by_rid = {}
    for ev in loaded["traceEvents"]:
        if ev.get("pid") == 1 and ev["ph"] != "M":
            by_rid.setdefault(ev["tid"], []).append(ev)
    assert sorted(by_rid) == list(range(6))
    for rid, evs in by_rid.items():
        names = [e["name"] for e in evs]
        assert {"submit", "queued", "prefill", "decode", "first_token",
                "terminal"} <= set(names), rid
        term = [e for e in evs if e["name"] == "terminal"]
        assert len(term) == 1
        assert term[0]["args"]["state"] == "finished"
    names = {e["name"] for evs in by_rid.values() for e in evs}
    assert {"preempted", "prefix_hit", "prefill_chunk"} <= names
    steps = [e for e in loaded["traceEvents"]
             if e.get("cat") == "step" and e["ph"] == "X"]
    assert len(steps) == eng.steps
    for ev in loaded["traceEvents"]:
        if ev["ph"] in ("X", "i", "C"):
            assert ev["ts"] >= 0.0
        if ev["ph"] == "X":
            assert ev["dur"] >= 0.0


def test_rejections_and_chaos_land_on_the_timeline(cfg, qwen):
    eng = Engine(cfg, qwen[2], max_batch=2, n_blocks=64, block_size=8,
                 queue_cap=1, telemetry=True, device="cpu")
    shed = 0
    for rid, p in enumerate(_prompts(cfg.vocab_size, (8, 8, 8, 8))):
        try:
            eng.submit(Request(rid=rid, tokens=p, max_new_tokens=2))
        except Rejected:
            shed += 1
    assert shed == 3
    assert eng.telemetry.registry.counters["terminal_rejected"] == 3
    trace = eng.telemetry.export_chrome()
    rejects = [e for e in trace["traceEvents"] if e["name"] == "rejected"]
    assert [e["args"]["reason"] for e in rejects] == ["queue_full"] * 3
    eng.run(max_steps=100)

    faults = FaultInjector({1: StepFaults(squeeze_blocks=2),
                            3: StepFaults(release_squeezed=True,
                                          cancel_rids=(1,))})
    eng = Engine(cfg, qwen[2], max_batch=2, n_blocks=16, block_size=8,
                 faults=faults, telemetry=True, device="cpu")
    _drain(eng, Request, _prompts(cfg.vocab_size, (8, 8)), max_new=8,
           max_steps=400)
    tel = eng.telemetry
    assert tel.chaos_actions == faults.log
    chaos = [e for e in tel.events if e.get("cat") == "chaos"]
    assert [e["name"] for e in chaos] == [a for _, a, _ in faults.log]
    counters = tel.registry.snapshot()["counters"]
    assert counters["chaos_squeeze"] == 1
    assert counters["terminal_cancelled"] == 1


def test_reset_stats_clears_counters_and_telemetry(cfg, qwen):
    """Counters and telemetry clear; the prefix cache's contents stay."""
    eng = Engine(cfg, qwen[2], max_batch=2, n_blocks=32, block_size=8,
                 prefill_chunk=8, prefix_cache=True, telemetry=True,
                 device="cpu")
    st = eng.stats()
    assert st["prefix_cache_hit_rate"] == 0.0 and st["kv_blocks_free"] == 32
    prompts = shared_prefix_requests(3, cfg.vocab_size, prefix_len=16,
                                     suffix_len=8, seed=13)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, tokens=list(p), max_new_tokens=4))
        eng.step()
    eng.run(max_steps=400)
    assert eng.stats()["prefix_cache_hit_rate"] > 0.0
    assert eng.telemetry.snapshot()["telemetry"]["events"] > 0
    eng.reset_stats()
    st = eng.stats()
    assert st["prefix_cache_hit_rate"] == 0.0
    assert st["cached_tokens_reused"] == 0 and st["chunk_steps"] == 0
    assert st["cached_blocks"] > 0 and st["kv_blocks_cached_reclaimable"] > 0
    tel = eng.telemetry
    assert tel.snapshot()["telemetry"]["events"] == 0
    assert len(tel.timeline) == 0 and tel.chaos_actions == []
    assert tel.registry.snapshot()["counters"] == {}
    eng.submit(Request(rid=9, tokens=list(prompts[0]), max_new_tokens=4))
    eng.run(max_steps=100)
    assert eng.stats()["prefix_cache_hit_rate"] == 1.0
    assert tel.snapshot()["telemetry"]["events"] > 0
