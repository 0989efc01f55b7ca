"""The port's request lifecycle and fault injection (serving/faults.py),
on smoke qwen1.5-0.5b weights bridged from the JAX package.

On the port itself: ``submit``'s rejection reasons; ``cancel`` of waiting
and running requests; deadlines under an injected clock and a deadline
storm; NaN quarantine in the decode, chunk and verify steps, whose
batchmates keep the tokens of an unarmed run bit for bit and whose mask
built nothing new (one use of each step key); the ``StallError``
watchdog. Against the reference: for a few seeds, the
``FaultInjector.from_seed`` schedule, its action log and the terminal
causes of the same trace are equal, and the survivors' tokens follow the
near-tie rule of tests/test_torch_engine.py (scheduling is host policy,
identical in both packages, and a smoke run emits no EOS, so the
schedules cannot diverge).
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config
from repro.models.lm import LM
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import Request as JaxRequest
from repro.serving.faults import FaultInjector as JaxInjector
from repro_torch.bridge import from_jax_numpy
from repro_torch.configs import get_config as port_config
from repro_torch.serving.engine import Engine, Rejected, Request, StallError
from repro_torch.serving.faults import (POLLUTE_RID_BASE, FaultInjector,
                                        StepFaults)

from test_torch_engine import _assert_streams_agree

ARCH = "qwen1.5-0.5b"
CAUSES = ("finished", "timed_out", "cancelled", "failed", "rejected")


@pytest.fixture(scope="module")
def weights():
    cfg = get_config(ARCH, reduced=True)
    model = LM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return cfg, model, params, from_jax_numpy(jax.device_get(params))


@pytest.fixture(scope="module")
def cfg():
    return port_config(ARCH, reduced=True)


@pytest.fixture(scope="module")
def params(weights):
    return weights[3]


def _engine(cfg, params, **kw):
    return Engine(cfg, params, device="cpu", **kw)


def _prompts(vocab, n, plen=12, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=plen).tolist() for _ in range(n)]


def _submit_all(eng, request_cls, prompts, max_new=5):
    for rid, p in enumerate(prompts):
        eng.submit(request_cls(rid=rid, tokens=list(p),
                               max_new_tokens=max_new))


def _assert_clean(eng):
    """Pool fully returned, free list dup-free, every request that
    entered the schedule in exactly one terminal state."""
    assert eng.alloc.n_available == eng.alloc.n_blocks
    free = list(eng.alloc.free)
    assert len(free) == len(set(free))
    assert not eng.sched.has_work
    for r in eng.finished:
        assert r.finish_time is not None
        assert not r.blocks and r.slot == -1


def _baseline(cfg, params, prompts, max_new=5, **kw):
    kw = {**dict(max_batch=3, n_blocks=32, block_size=8), **kw}
    eng = _engine(cfg, params, **kw)
    _submit_all(eng, Request, prompts, max_new=max_new)
    done = eng.run(max_steps=400)
    assert all(r.state == "finished" for r in done)
    return {r.rid: list(r.output) for r in done}


# ---------------------------------------------------------------------------
# submit() validation: one case per reason
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reason", ["empty_prompt", "bad_max_new",
                                    "unschedulable", "queue_full"])
def test_submit_rejects_with_reason(cfg, params, reason):
    eng = _engine(cfg, params, max_batch=2, n_blocks=4, block_size=4,
                  queue_cap=1)
    if reason == "queue_full":
        eng.submit(Request(rid=0, tokens=[1, 2], max_new_tokens=2))
    req = {"empty_prompt": Request(rid=1, tokens=[], max_new_tokens=4),
           "bad_max_new": Request(rid=1, tokens=[1, 2], max_new_tokens=0),
           "unschedulable": Request(rid=1, tokens=list(range(1, 17)),
                                    max_new_tokens=8),
           "queue_full": Request(rid=1, tokens=[3, 4], max_new_tokens=2),
           }[reason]
    with pytest.raises(Rejected) as ei:
        eng.submit(req)
    assert ei.value.reason == reason
    assert req.finish_time is not None
    st = eng.stats()
    assert st["rejected"] == 1 and st["rejected_reasons"] == {reason: 1}
    eng.run(max_steps=100)
    assert eng.stats()["finished"] == (reason == "queue_full")
    _assert_clean(eng)


# ---------------------------------------------------------------------------
# Cancellation and deadlines
# ---------------------------------------------------------------------------


def test_cancel_waiting_and_running(cfg, params):
    prompts = _prompts(cfg.vocab_size, 6)
    base = _baseline(cfg, params, prompts)
    # rid 1 is decoding at step 2; rid 5 is still queued (3 slots)
    inj = FaultInjector({2: StepFaults(cancel_rids=(1, 5))})
    eng = _engine(cfg, params, max_batch=3, n_blocks=32, block_size=8,
                  faults=inj)
    _submit_all(eng, Request, prompts)
    done = eng.run(max_steps=400)
    st = eng.stats()
    assert st["cancelled"] == 2 and st["finished"] == 4
    assert [a for _, a, _ in inj.log] == ["cancel", "cancel"]
    for r in done:
        if r.state == "finished":
            assert r.output == base[r.rid]
        else:
            assert r.rid in (1, 5)
    _assert_clean(eng)
    assert eng.cancel(1) is False and eng.cancel(999) is False


class _Tick:
    """A fake clock: one unit a call."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_deadlines_time_out_queued_and_running(cfg, params):
    """Under an injected clock, a deadline evicts a request whether it is
    decoding or still queued, and the others keep their tokens."""
    prompts = _prompts(cfg.vocab_size, 4)
    base = _baseline(cfg, params, prompts, max_new=6, max_batch=2)
    eng = _engine(cfg, params, max_batch=2, n_blocks=32, block_size=8,
                  clock=_Tick())
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, tokens=list(p), max_new_tokens=6,
                           deadline_s=(20.0 if rid in (1, 3) else None)))
    done = eng.run(max_steps=400)
    st = eng.stats()
    assert st["timed_out"] == 2 and st["finished"] == 2
    by = {r.rid: r for r in done}
    assert by[1].state == by[3].state == "timed_out"
    assert by[3].admitted_time is None              # timed out queued
    assert 0 < len(by[1].output) < 6                # timed out decoding
    assert by[0].output == base[0] and by[2].output == base[2]
    _assert_clean(eng)


def test_deadline_storm_and_default_deadline(cfg, params):
    prompts = _prompts(cfg.vocab_size, 5)
    inj = FaultInjector({3: StepFaults(deadline_s=0.0)})
    eng = _engine(cfg, params, max_batch=2, n_blocks=32, block_size=8,
                  faults=inj)
    _submit_all(eng, Request, prompts)
    eng.run(max_steps=400)
    st = eng.stats()
    assert st["timed_out"] + st["finished"] == 5 and st["timed_out"] >= 3
    assert ("deadline_storm" in [a for _, a, _ in inj.log])
    _assert_clean(eng)
    eng = _engine(cfg, params, max_batch=2, n_blocks=32, block_size=8,
                  clock=_Tick(), default_deadline_s=1e9)
    _submit_all(eng, Request, prompts)
    assert all(r.deadline_s == 1e9 for r in eng.live_requests())
    eng.run(max_steps=400)
    assert eng.stats()["finished"] == 5


# ---------------------------------------------------------------------------
# NaN quarantine: the mask rides the steps, the batch is undisturbed
# ---------------------------------------------------------------------------

# (engine options, fault step, (rid, period), max_new)
NAN_CASES = {
    "decode": (dict(max_batch=3), 3, (2, 0), 5),
    "chunk": (dict(max_batch=2, prefill_chunk=4), 1, (0, 1), 4),
    "verify": (dict(max_batch=2, speculate="ngram", spec_depth=3), 4,
               (1, 0), 8),
}


@pytest.mark.parametrize("case", list(NAN_CASES))
def test_nan_quarantine(cfg, params, case):
    kw, step, nan, max_new = NAN_CASES[case]
    kw = {**dict(n_blocks=32, block_size=8), **kw}
    prompts = _prompts(cfg.vocab_size, 4)
    base = _baseline(cfg, params, prompts, max_new=max_new, **kw)
    inj = FaultInjector({step: StepFaults(nan=nan)})
    eng = _engine(cfg, params, faults=inj, **kw)
    _submit_all(eng, Request, prompts, max_new=max_new)
    done = eng.run(max_steps=400)
    st = eng.stats()
    assert st["failed"] == 1 and st["finished"] == 3
    assert inj.log == [(step, "nan", nan)]
    for r in done:
        if r.rid == nan[0]:
            assert r.state == "failed"
            if case == "chunk":         # poisoned while paging its prompt
                assert r.output == []
        else:
            assert r.state == "finished" and r.output == base[r.rid]
    if case == "verify":
        assert st["spec_abandoned"] == 1
    # the mask is a step input: every step key was built exactly once
    assert all(v == 1 for v in eng.trace_counts.values()), eng.trace_counts
    _assert_clean(eng)


def test_arm_nan_validates_period(cfg, params):
    eng = _engine(cfg, params, max_batch=2, n_blocks=8, block_size=8)
    with pytest.raises(ValueError, match="period"):
        eng.arm_nan(0, cfg.n_layers)


# ---------------------------------------------------------------------------
# Watchdog, validation
# ---------------------------------------------------------------------------


def test_watchdog_raises_stall_error(cfg, params):
    # the whole pool squeezed at step 0 and never returned: nothing admits
    inj = FaultInjector({0: StepFaults(squeeze_blocks=8)})
    eng = _engine(cfg, params, max_batch=2, n_blocks=8, block_size=8,
                  faults=inj, stall_limit=5)
    eng.submit(Request(rid=42, tokens=[1, 2, 3], max_new_tokens=3))
    with pytest.raises(StallError) as ei:
        eng.run(max_steps=100)
    assert ei.value.rids == [42]
    assert "rid=42" in str(ei.value) and "waiting" in str(ei.value)
    inj.release_all(eng)
    done = eng.run(max_steps=100)
    assert [r.rid for r in done] == [42] and done[0].state == "finished"
    _assert_clean(eng)


def test_engine_validates_lifecycle_options(cfg, params):
    with pytest.raises(ValueError, match="stall_limit"):
        _engine(cfg, params, stall_limit=0)
    with pytest.raises(ValueError, match="fused"):
        _engine(cfg, params, mode="legacy", faults=FaultInjector())
    with pytest.raises(ValueError, match="mode"):
        _engine(cfg, params, mode="eager")


# ---------------------------------------------------------------------------
# Seeded chaos against the reference
# ---------------------------------------------------------------------------

CHAOS = dict(rids=range(6), horizon=40, squeezes=2, cancels=2,
             alloc_failures=2, nan_period=1, pollute=2)


def _chaos_run(engine_cls, request_cls, injector_cls, cfg, params, seed,
               **kw):
    inj = injector_cls.from_seed(seed, **CHAOS)
    eng = engine_cls(cfg, params, max_batch=3, n_blocks=32, block_size=8,
                     prefill_chunk=8, prefix_cache=True, faults=inj, **kw)
    prompts = _prompts(cfg.vocab_size, 6, plen=24)
    _submit_all(eng, request_cls, prompts, max_new=6)
    done = eng.run(max_steps=600)
    inj.release_all(eng)
    assert inj.quiescent
    st = eng.stats()
    return (prompts, inj, {r.rid: (r.state, list(r.output)) for r in done},
            {k: st[k] for k in CAUSES}, eng)


@pytest.fixture(scope="module")
def reference_chaos(weights):
    cfg, _, params, _ = weights
    return {seed: _chaos_run(JaxEngine, JaxRequest, JaxInjector, cfg, params,
                             seed)[:4] for seed in (0, 7)}


@pytest.mark.parametrize("seed", [0, 7])
def test_seeded_chaos_matches_reference(weights, reference_chaos, seed):
    rcfg, model, rparams, params = weights
    prompts, rinj, rdone, rcauses = reference_chaos[seed]
    _, inj, done, causes, eng = _chaos_run(
        Engine, Request, FaultInjector, port_config(ARCH, reduced=True),
        params, seed, device="cpu")
    assert ({k: dataclasses.asdict(f) for k, f in inj.schedule.items()} ==
            {k: dataclasses.asdict(f) for k, f in rinj.schedule.items()})
    assert inj.log == rinj.log
    assert eng.telemetry.chaos_actions == inj.log
    assert causes == rcauses
    assert {r: s for r, (s, _) in done.items()} == \
        {r: s for r, (s, _) in rdone.items()}
    assert sum(causes.values()) - causes["rejected"] == len(done)
    acts = {a for _, a, _ in inj.log}
    assert "alloc_fail" in acts and len(inj.log) >= 3
    base = [r for r, (s, _) in rdone.items()
            if s == "finished" and r < POLLUTE_RID_BASE]
    _assert_streams_agree(model, rparams, prompts,
                          {r: rdone[r][1] for r in base},
                          {r: done[r][1] for r in base})
    # leak-free with cached blocks parked: every block is free or one
    # reclaim away, and the free list and the parked set are disjoint
    alloc = eng.alloc
    assert alloc.n_available == alloc.n_blocks
    assert not set(alloc.free) & set(eng._prefix.unref)
    assert all(rc == 0 for rc in alloc.refcount)


def test_chaos_survivors_equal_a_fault_free_run(weights):
    """On the port itself: every finished base request of a seeded chaos
    run (the prefix cache on) emits the tokens of a cache-off,
    fault-free run, bit for bit."""
    params = weights[3]
    cfg = port_config(ARCH, reduced=True)
    prompts, inj, done, causes, _ = _chaos_run(
        Engine, Request, FaultInjector, cfg, params, 3, device="cpu")
    base = _baseline(cfg, params, prompts, max_new=6, prefill_chunk=8)
    survivors = [r for r, (s, _) in done.items()
                 if s == "finished" and r < POLLUTE_RID_BASE]
    assert survivors and causes["failed"] + causes["cancelled"] > 0
    for r in survivors:
        assert done[r][1] == base[r], (r, inj.log)
