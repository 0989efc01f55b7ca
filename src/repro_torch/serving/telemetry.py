"""Serving telemetry: request-lifecycle tracing, a per-step phase
timeline, and an exportable metrics registry (the port of
``repro.serving.telemetry``; host-only, it never touches a tensor).

The paper's contribution is *dissecting* runtime — module-wise and
phase-wise breakdowns that explain where wall-clock goes (§III-B,
Tables V-XI) — and this module is the serving-side apparatus for the
same question. Three pillars, all host-side:

  * **Request-lifecycle spans.** Every request owns a span tree on the
    trace timeline: ``queued`` (submit → admission), ``prefill`` (per
    admission episode, with each paged chunk as a nested complete
    event), ``decode`` (RUNNING segments), ``preempted`` (eviction →
    re-admission), and a terminal instant carrying the terminal state
    and eviction path (``finished`` / ``active_scrub`` /
    ``queue_drop``). :meth:`Telemetry.export_chrome` writes the whole
    timeline as Chrome-trace JSON — load it in ``chrome://tracing`` or
    https://ui.perfetto.dev — with one track per request plus an engine
    track of step spans and pool/queue counter series.

  * **Per-step phase timeline.** A bounded ring buffer of per-step
    records: the host-side phase split (``sweep`` — faults + deadline
    sweep, ``schedule`` — admission + block growth, ``dispatch`` —
    building step inputs, the step (a CUDA-graph replay on the card)
    and host materialization of its outputs, ``sync`` — the explicit
    fence of fenced mode), the
    traced-step kinds the step dispatched (``decode``/``chunk``/
    ``verify``/``prefill``), batch occupancy, the block-pool occupancy
    split (owned / cached_reclaimable / free), waiting-queue depth and
    speculative proposed/accepted counts. Phase durations accumulate in
    a :class:`repro_torch.core.perfscope.Timer`, so
    ``telemetry.timer.summary()`` gives the same per-region breakdown
    trainings' perfscope does — train and serve share one timing idiom.
    ``fenced=True`` adds a ``torch.cuda.synchronize`` of the engine's
    device inside the ``sync`` phase (the paper's torch.profiler-style
    attribution mode: it charges each step with the device work it
    queued; on the CPU it does nothing).

  * **Metrics registry.** Counters, gauges and histograms with a stable
    machine-readable snapshot: :meth:`Telemetry.snapshot` returns the
    structured schema documented in docs/observability.md (pinned by a
    schema-stability test), which subsumes the engine's legacy flat
    ``stats()`` dict — ``Engine.stats()`` is now a thin compatibility
    view over this snapshot.

**The hard contract** (pinned by tests/test_telemetry.py and
tests/test_torch_telemetry.py): telemetry is invisible to the device.
Every hook is host-side; enabling telemetry adds **no launch and no
step argument**, the engine's ``trace_counts`` is identical
telemetry-on vs -off, and greedy output and the pools are
bitwise-identical. A disabled :class:`Telemetry` (the engine
default) reduces every hook to one predicate check. Fault injection
(serving/faults.py) logs its actions through :meth:`chaos_action`, so a
chaos run's squeezes/cancels/NaN-quarantines land on the same timeline
as the victims' spans — visually alignable in the trace viewer.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import Counter, deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.perfscope import Timer
# shared with Engine.stats(): both report percentiles through ONE
# definition (core/stats.py) so histogram snapshots and SLO stats can
# never drift on empty/singleton edge cases
from repro_torch.core.stats import percentile as _pctl

__all__ = ["Telemetry", "MetricsRegistry", "SCHEMA_VERSION"]

#: Version stamp of the :meth:`Telemetry.snapshot` schema and the Chrome
#: trace ``otherData`` header. Bump when a documented key is renamed or
#: removed (additions are compatible — the schema-stability test asserts
#: superset, not equality).
SCHEMA_VERSION = 1

#: Engine-step phase names, in execution order (see module docstring).
PHASES = ("sweep", "schedule", "dispatch", "sync")

#: Hard cap on retained Chrome-trace events: tracing a very long run
#: degrades to dropping the newest events (counted in ``events_dropped``)
#: instead of growing without bound.
_EVENTS_CAP = 500_000

#: Shared no-op context for the disabled-telemetry ``phase()`` path: no
#: generator frame, no clock reads — one predicate check per phase.
_NULL_PHASE = contextlib.nullcontext()

#: Zeroed per-phase accumulator template; ``.copy()``-ed per step record
#: (cheaper than re-running ``dict.fromkeys`` in the step_begin hook).
_PHASE_ZEROS = dict.fromkeys(PHASES, 0.0)


class _PhaseCtx:
    """Hand-rolled context manager for one phase name, cached per
    Telemetry instance: the contextlib generator machinery costs several
    microseconds per use, which at ~5 phase regions per engine step is
    the difference between telemetry overhead in the noise and telemetry
    overhead in the step budget. Not re-entrant per name — engine phases
    never nest the same name (they accumulate across separate entries)."""

    __slots__ = ("tel", "name", "t0", "rec")

    def __init__(self, tel: "Telemetry", name: str):
        self.tel = tel
        self.name = name
        self.t0 = 0.0
        # bind the perfscope record list once; Telemetry.reset() swaps
        # the Timer out and clears the ctx cache, so this never dangles
        self.rec = tel.timer.records[name]

    def __enter__(self):
        self.t0 = self.tel.clock()
        return self

    def __exit__(self, *exc):
        tel = self.tel
        dt = tel.clock() - self.t0
        cur = tel._cur
        if cur is not None:
            cur["phases"][self.name] += dt
        self.rec.append(dt)
        return False


class MetricsRegistry:
    """Counters, gauges and histograms with a machine-readable snapshot.

    All host-side and schema-stable: ``snapshot()`` returns
    ``{"counters": {name: num}, "gauges": {name: num},
    "histograms": {name: {count, sum, mean, p50, p95, p99}}}``.
    Histograms keep a bounded sample reservoir (newest-dropped beyond
    ``hist_cap``) so a long run cannot grow one without bound.
    """

    def __init__(self, hist_cap: int = 4096):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self._hists: Dict[str, deque] = {}
        self._hist_n: Dict[str, int] = {}
        self._hist_sum: Dict[str, float] = {}
        self.hist_cap = hist_cap

    def count(self, name: str, v: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + v

    def gauge(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def observe(self, name: str, v: float) -> None:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = deque(maxlen=self.hist_cap)
            self._hist_n[name] = 0
            self._hist_sum[name] = 0.0
        h.append(float(v))
        self._hist_n[name] += 1
        self._hist_sum[name] += float(v)

    def snapshot(self) -> Dict[str, Any]:
        hists = {}
        for name, h in self._hists.items():
            s = sorted(h)
            hists[name] = {
                "count": self._hist_n[name],
                "sum": self._hist_sum[name],
                "mean": (self._hist_sum[name] / self._hist_n[name]
                         if self._hist_n[name] else 0.0),
                "p50": _pctl(s, 50), "p95": _pctl(s, 95),
                "p99": _pctl(s, 99),
            }
        return {"counters": dict(self.counters),
                "gauges": dict(self.gauges),
                "histograms": hists}

    def reset(self) -> None:
        self.counters.clear()
        self.gauges.clear()
        self._hists.clear()
        self._hist_n.clear()
        self._hist_sum.clear()


class Telemetry:
    """Observability hub for one serving :class:`~repro_torch.serving.
    engine.Engine` (bound via :meth:`bind`; the engine does this in its
    constructor). ``enabled=False`` (the engine default) turns every
    hook into a single predicate check; chaos actions are the one
    exception — they are recorded regardless, because the post-run
    action log must exist even when tracing is off.

    ``clock`` defaults to ``time.perf_counter`` and is deliberately
    independent of the engine's scheduling clock: tests drive engines
    with fake tick clocks, and trace timestamps must stay monotonic
    wall time either way.
    """

    def __init__(self, *, enabled: bool = True, fenced: bool = False,
                 timeline_cap: int = 4096, clock=time.perf_counter):
        if timeline_cap < 1:
            raise ValueError("timeline_cap must be >= 1")
        self.enabled = enabled
        self.fenced = fenced
        self.clock = clock
        self.registry = MetricsRegistry()
        self.timer = Timer()            # perfscope idiom: phase regions
        self.timeline: deque = deque(maxlen=timeline_cap)
        self.events: List[dict] = []    # eagerly-built events (chaos track)
        self.events_dropped = 0
        self.chaos_actions: List[Tuple[int, str, object]] = []
        self._steps_recorded = 0
        self._engine = None
        self._epoch = clock()
        self._cur: Optional[dict] = None        # current step record
        self._phase_ctxs: Dict[str, _PhaseCtx] = {}
        self._step_names: Dict[Tuple[str, ...], str] = {}
        self._kind_keys: Dict[str, str] = {}
        self._term_keys: Dict[str, str] = {}
        self._step_recs: List[dict] = []    # timeline recs kept for export
        self._chunk_recs: List[tuple] = []  # (rid, t0, t1, start, n)
        self._req_recs: List[tuple] = []    # (ph, rid, name, t0, t1, args, more)
        self._open: Dict[Tuple[int, str], Tuple[float, dict]] = {}
        self._named_tids: set = set()
        self._meta_events: List[dict] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 0, "tid": 0, "name": "thread_name",
             "args": {"name": "steps"}},
            {"ph": "M", "pid": 0, "tid": 1, "name": "thread_name",
             "args": {"name": "chaos"}},
            {"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
             "args": {"name": "requests"}},
        ]

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def bind(self, engine) -> None:
        """Attach the engine whose aggregates :meth:`snapshot` reports."""
        self._engine = engine

    def _ts(self, t: Optional[float] = None) -> float:
        """Microseconds since the trace epoch (Chrome-trace time unit)."""
        return ((t if t is not None else self.clock()) - self._epoch) * 1e6

    def _emit(self, ev: dict) -> None:
        if len(self.events) >= _EVENTS_CAP:
            self.events_dropped += 1
            return
        self.events.append(ev)

    def _req_tid(self, rid: int) -> int:
        if rid not in self._named_tids:
            self._named_tids.add(rid)
            self._meta_events.append(
                {"ph": "M", "pid": 1, "tid": rid, "name": "thread_name",
                 "args": {"name": f"rid {rid}"}})
        return rid

    # ------------------------------------------------------------------
    # request-lifecycle spans (pid 1, one tid per request)
    # ------------------------------------------------------------------

    # Request events are recorded as compact tuples and synthesized into
    # Chrome event dicts at export time (the same deferral step_end and
    # req_chunk use): these helpers sit on the per-step hot path through
    # admission/terminal hooks, and dict construction there is most of
    # the telemetry-on overhead budget.

    def _span_begin(self, rid: int, name: str, **args) -> None:
        self._open[(rid, name)] = (self.clock(), args)

    def _span_end(self, rid: int, name: str, **more) -> None:
        t0_args = self._open.pop((rid, name), None)
        if t0_args is None:
            return                      # span opened before enablement
        t0, args = t0_args
        if len(self._req_recs) < _EVENTS_CAP:
            self._req_recs.append(
                ("X", rid, name, t0, self.clock(), args, more))
        else:
            self.events_dropped += 1

    def _instant(self, rid: int, name: str, **args) -> None:
        if len(self._req_recs) < _EVENTS_CAP:
            self._req_recs.append(
                ("i", rid, name, self.clock(), None, args, None))
        else:
            self.events_dropped += 1

    def req_submit(self, req) -> None:
        if not self.enabled:
            return
        self.registry.count("requests_submitted")
        self._instant(req.rid, "submit", prompt_tokens=len(req.tokens),
                      max_new=req.max_new_tokens)
        self._span_begin(req.rid, "queued")

    def req_reject(self, req, reason: str) -> None:
        """Submit-side rejection: the request never entered the schedule,
        so its whole trace is one instant carrying the shed reason."""
        if not self.enabled:
            return
        self.registry.count("terminal_rejected")
        self.registry.count(f"rejected_{reason}")
        self._span_end(req.rid, "queued")   # no-op for fresh rejections
        self._instant(req.rid, "rejected", reason=reason)

    def req_admit(self, req) -> None:
        """Admission (or re-admission of a preemption victim): the
        queued/preempted wait ends and a prefill episode begins."""
        if not self.enabled:
            return
        self.registry.count("requests_admitted")
        self._span_end(req.rid, "queued")
        self._span_end(req.rid, "preempted")
        self._span_begin(req.rid, "prefill",
                         cached_tokens=req.cached_tokens,
                         resumed_tokens=len(req.output))
        if req.cached_tokens:
            self.registry.count("prefix_hits")
            self._instant(req.rid, "prefix_hit",
                          cached_tokens=req.cached_tokens)

    def req_chunk(self, req, t0: float, start: int, n: int) -> None:
        """One paged prefill chunk, as a complete event inside the
        request's prefill span (``t0`` from :attr:`clock`)."""
        if not self.enabled:
            return
        # hot during prefill: store a compact tuple, synthesize the
        # Chrome event at export time (same deferral as step_end)
        if len(self._chunk_recs) < _EVENTS_CAP // 3:
            self._chunk_recs.append(
                (req.rid, t0, self.clock(), start, n))
        else:
            self.events_dropped += 1

    def req_running(self, req) -> None:
        """Prefill complete: the request enters its decode segment."""
        if not self.enabled:
            return
        self._span_end(req.rid, "prefill")
        self._span_begin(req.rid, "decode")

    def req_first_token(self, req) -> None:
        if not self.enabled:
            return
        self._instant(req.rid, "first_token")

    def req_preempt(self, req) -> None:
        if not self.enabled:
            return
        self.registry.count("preemptions")
        out = len(req.output)
        self._span_end(req.rid, "prefill", preempted=True)
        self._span_end(req.rid, "decode", preempted=True, n_output=out)
        self._span_begin(req.rid, "preempted")
        self._instant(req.rid, "preempt", n_output=out)

    def req_terminal(self, req, state: str, path: str) -> None:
        """Terminal transition: close every open span and stamp the
        terminal reason plus the eviction path (``finished`` — budget
        met via Scheduler.finish; ``active_scrub`` — evicted from a
        batch slot through the scrub→release path; ``queue_drop`` —
        removed while waiting; ``rejected`` — never entered)."""
        if not self.enabled:
            return
        key = self._term_keys.get(state)
        if key is None:
            key = self._term_keys[state] = "terminal_" + state
        self.registry.count(key)
        for name in ("queued", "prefill", "decode", "preempted"):
            self._span_end(req.rid, name, terminal=state)
        self._instant(req.rid, "terminal", state=state, path=path,
                      n_output=len(req.output),
                      n_preemptions=req.n_preemptions)

    # ------------------------------------------------------------------
    # per-step phase timeline (pid 0 tid 0 + counter tracks)
    # ------------------------------------------------------------------

    def step_begin(self, step: int) -> None:
        if not self.enabled:
            return
        self._cur = {"step": step, "t0": self.clock(),
                     "kinds": [], "phases": _PHASE_ZEROS.copy(),
                     "spec_proposed": 0, "spec_accepted": 0}

    def phase(self, name: str):
        """Time one host-side phase of the current engine step; phases
        may be entered more than once per step (durations accumulate)
        and always also land in :attr:`timer` (perfscope regions).
        Disabled telemetry returns a shared null context; enabled
        telemetry a cached per-name :class:`_PhaseCtx`."""
        if not self.enabled:
            return _NULL_PHASE
        ctx = self._phase_ctxs.get(name)
        if ctx is None:
            ctx = self._phase_ctxs[name] = _PhaseCtx(self, name)
        return ctx

    def mark_kind(self, kind: str) -> None:
        """Record a step dispatch kind for the current step
        (``decode`` / ``chunk`` / ``verify`` / ``prefill``)."""
        if not self.enabled or self._cur is None:
            return
        self._cur["kinds"].append(kind)

    def spec_round(self, proposed: int, accepted: int) -> None:
        """One request's verify-round outcome (called per row by the
        engine's speculative path through Speculator.record)."""
        if not self.enabled:
            return
        self.registry.count("spec_proposed", proposed)
        self.registry.count("spec_accepted", accepted)
        if self._cur is not None:
            self._cur["spec_proposed"] += proposed
            self._cur["spec_accepted"] += accepted

    def step_end(self, engine) -> None:
        # the per-step hot hook — runs every engine step, so it stays
        # lean: one timeline record, counter bumps through cached key
        # strings, no event-dict construction
        if not self.enabled or self._cur is None:
            return
        rec, self._cur = self._cur, None
        now = self.clock()
        t0 = rec.pop("t0")
        occ = engine.alloc.occupancy()
        kinds = tuple(rec["kinds"])
        counters = self.registry.counters
        kind_keys = self._kind_keys
        for k in kinds:
            key = kind_keys.get(k)
            if key is None:
                key = kind_keys[k] = "steps_" + k
            counters[key] = counters.get(key, 0) + 1
        running = engine.sched.running
        rec["ts_us"] = (t0 - self._epoch) * 1e6
        rec["dur_s"] = now - t0
        rec["kinds"] = kinds
        rec["batch"] = len(running) - running.count(None)
        rec["queue_depth"] = len(engine.sched.waiting)
        rec["pool"] = occ
        self.timeline.append(rec)
        self._steps_recorded += 1
        self.registry.observe("step_ms", (now - t0) * 1e3)
        # Chrome events for the step are NOT built here: the record
        # above already carries everything, so the engine track (one "X"
        # span + one "C" pool/queue/batch sample per step) is synthesized
        # from these refs at export time — dict construction off the
        # per-step hot path is most of the telemetry-on overhead budget
        if len(self._step_recs) < _EVENTS_CAP // 3:
            self._step_recs.append(rec)
        else:
            self.events_dropped += 1

    # ------------------------------------------------------------------
    # chaos actions (always recorded — the post-run action log must
    # exist even when tracing is off; trace events only when enabled)
    # ------------------------------------------------------------------

    def chaos_action(self, step: int, action: str, detail) -> None:
        self.chaos_actions.append((step, action, detail))
        if not self.enabled:
            return
        self.registry.count(f"chaos_{action}")
        self._emit({"ph": "i", "pid": 0, "tid": 1, "name": action,
                    "cat": "chaos", "ts": self._ts(), "s": "p",
                    "args": {"step": step, "detail": repr(detail)}})

    # ------------------------------------------------------------------
    # snapshot + export
    # ------------------------------------------------------------------

    def timeline_summary(self) -> Dict[str, Any]:
        phase_totals = {name: float(sum(self.timer.records.get(name, ())))
                        for name in PHASES}
        kinds: Counter = Counter()
        for rec in self.timeline:
            for k in rec["kinds"]:
                kinds[k] += 1
        return {"recorded": len(self.timeline),
                "dropped": self._steps_recorded - len(self.timeline),
                "phase_totals_s": phase_totals,
                "step_kinds": dict(kinds)}

    def snapshot(self) -> Dict[str, Any]:
        """The stable machine-readable metrics snapshot (schema v1, see
        docs/observability.md). Engine aggregates (requests, latency,
        throughput, pool, prefix cache, speculation) come from the bound
        engine; registry and timeline sections from this object. Works
        with telemetry disabled — the engine sections are always live,
        and registry/timeline are simply empty."""
        snap: Dict[str, Any] = {"schema_version": SCHEMA_VERSION}
        if self._engine is not None:
            snap.update(self._engine.snapshot_base())
        snap["telemetry"] = {
            "enabled": self.enabled,
            "fenced": self.fenced,
            "events": (len(self.events) + 2 * len(self._step_recs)
                       + len(self._chunk_recs) + len(self._req_recs)),
            "events_dropped": self.events_dropped,
            "chaos_actions": len(self.chaos_actions),
        }
        snap.update(self.registry.snapshot())
        snap["timeline"] = self.timeline_summary()
        return snap

    def export_chrome(self, path: Optional[str] = None, *,
                      metadata: Optional[dict] = None) -> dict:
        """Build (and optionally write) the Chrome-trace JSON object:
        ``{"traceEvents": [...], "displayTimeUnit": "ms", "otherData":
        {schema_version, torch/CUDA versions and the device, caller
        metadata — e.g. the chaos replay seed}}``. Loadable in
        chrome://tracing and Perfetto."""
        import torch
        # synthesize the engine track (one "X" step span + one "C"
        # pool/queue/batch counter sample per step) from the retained
        # timeline records — deferred out of step_end, see there
        step_events: List[dict] = []
        epoch = self._epoch
        for ph, rid, name, t0, t1, args, more in self._req_recs:
            if ph == "X":
                step_events.append(
                    {"ph": "X", "pid": 1, "tid": self._req_tid(rid),
                     "name": name, "cat": "request",
                     "ts": (t0 - epoch) * 1e6, "dur": (t1 - t0) * 1e6,
                     "args": {**args, **more}})
            else:
                step_events.append(
                    {"ph": "i", "pid": 1, "tid": self._req_tid(rid),
                     "name": name, "cat": "request",
                     "ts": (t0 - epoch) * 1e6, "s": "t", "args": args})
        for rid, t0, t1, start, n in self._chunk_recs:
            step_events.append(
                {"ph": "X", "pid": 1, "tid": self._req_tid(rid),
                 "name": "prefill_chunk", "cat": "request",
                 "ts": (t0 - epoch) * 1e6, "dur": (t1 - t0) * 1e6,
                 "args": {"start": start, "n_tokens": n}})
        names = self._step_names
        for rec in self._step_recs:
            kinds = rec["kinds"]
            name = names.get(kinds)
            if name is None:
                name = names[kinds] = (
                    "step[%s]" % "+".join(kinds) if kinds else "step[idle]")
            ts0 = rec["ts_us"]
            dur_us = rec["dur_s"] * 1e6
            occ = rec["pool"]
            step_events.append(
                {"ph": "X", "pid": 0, "tid": 0, "name": name,
                 "cat": "step", "ts": ts0, "dur": dur_us,
                 "args": {k: v for k, v in rec.items() if k != "dur_s"}})
            step_events.append(
                {"ph": "C", "pid": 0, "tid": 0, "name": "kv_pool",
                 "ts": ts0 + dur_us,
                 "args": {"owned": occ["owned"],
                          "cached_reclaimable": occ["cached_reclaimable"],
                          "free": occ["free"],
                          "waiting": rec["queue_depth"],
                          "batch": rec["batch"]}})
        trace = {
            "traceEvents": (list(self._meta_events) + step_events
                            + list(self.events)),
            "displayTimeUnit": "ms",
            "otherData": {
                "schema_version": SCHEMA_VERSION,
                "torch_version": torch.__version__,
                "cuda_version": torch.version.cuda,
                "device": self._device_name(),
                "events_dropped": self.events_dropped,
                **(metadata or {}),
            },
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(trace, f)
        return trace

    def _device_name(self) -> str:
        """The bound engine's device: the card's name, or ``cpu``."""
        import torch
        dev = getattr(self._engine, "device", None)
        if dev is not None and dev.type == "cuda":
            return torch.cuda.get_device_name(dev)
        return "cpu"

    def reset(self) -> None:
        """Clear collected events/timeline/metrics (the trace epoch is
        kept, so timestamps stay monotonic across a reset). Called by
        ``Engine.reset_stats`` so a benchmark's measured pass starts
        with empty telemetry the same way it starts with empty stats."""
        self.registry.reset()
        self.timer = Timer()
        self._phase_ctxs.clear()    # ctxs bind the replaced Timer's lists
        self.timeline.clear()
        self.events = []
        self._step_recs = []
        self._chunk_recs = []
        self._req_recs = []
        self.events_dropped = 0
        self.chaos_actions = []
        self._steps_recorded = 0
        self._cur = None
        self._open.clear()
