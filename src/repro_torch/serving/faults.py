"""Deterministic fault injection for the serving engine (chaos harness;
the port's copy of ``repro.serving.faults``, host-only Python).

Benchmark suites only report numbers from runs that *complete*; a
production engine must also survive the runs that don't. This module makes
"completion under fault" a tested contract: a :class:`FaultInjector`
carries a schedule of injection points keyed by engine step index and is
wired into ``Engine(faults=...)`` behind a no-op default — an engine
without an injector executes exactly the code it always did, and an engine
with one runs the *same captured steps* (the NaN-injection mask is an
input of every step, one more static buffer of its CUDA graph, so faulted
and fault-free engines share graphs and their surviving rows stay
bitwise-identical).

Injection points (all host-side, all deterministic and replayable):

  * **Block squeeze** — grab N free blocks from the allocator at step k
    and hold them for a while: the pool "runs dry" on schedule, driving
    admission backpressure and recompute preemption exactly where the
    schedule says.
  * **Allocator failure** — arm ``BlockAllocator.fail_next`` so the next
    alloc *call* raises ``OutOfBlocks`` even though the free list looks
    healthy (a lying allocator / racing co-user). The scheduler treats it
    as backpressure; nothing crashes.
  * **Delayed cancellation** — ``Engine.cancel(rid)`` at step k: the
    request is evicted mid-flight (possibly mid-speculative-window)
    through the scrub→release path.
  * **NaN poisoning** — arm the engine's in-step injection mask so one
    request's hidden state turns non-finite at a chosen layer period
    during that step's forward; the step's non-finite-logit flag then
    quarantines the request (``FAILED``) without disturbing the batch.
  * **Deadline storm** — stamp a burst of waiting/running requests with a
    deadline that has effectively already passed, so the next sweep times
    them out together.

The chaos suites (tests/test_faults.py, tests/test_torch_faults.py)
assert the core invariant after
*any* schedule: surviving requests' greedy tokens are identical to a
fault-free run, the allocator ends with a dup-free fully-returned free
list, and ``Engine.stats()`` accounts every terminal cause.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["StepFaults", "FaultInjector", "POLLUTE_RID_BASE"]

#: rid offset for injected cache-pollution twins: far above any test's
#: base cohort, so "survivors" can be filtered by rid alone.
POLLUTE_RID_BASE = 90_000


@dataclasses.dataclass
class StepFaults:
    """Faults to apply at the start of one engine step."""

    squeeze_blocks: int = 0         # grab up to N free blocks, hold them
    release_squeezed: bool = False  # return every held block first
    alloc_failures: int = 0         # arm N injected OutOfBlocks raises
    cancel_rids: Tuple[int, ...] = ()   # Engine.cancel(rid) for each
    # (rid, layer period): poison rid's hidden state entering that layer
    # period with NaN during this step's forward (fused/chunk/verify)
    nan: Optional[Tuple[int, int]] = None
    # stamp every non-terminal request with this deadline_s (relative to
    # its own arrival; pick a value the clock has already passed to storm)
    deadline_s: Optional[float] = None
    # cache pollution: submit N divergent-suffix twins of live requests —
    # each twin shares the first half of a victim's prompt and diverges
    # after, so with the prefix cache on it hits the shared prefix and
    # then forces the radix trie to branch mid-burst. Twin rids start at
    # POLLUTE_RID_BASE so tests can separate them from the base cohort.
    pollute_twins: int = 0

    def merged(self, other: "StepFaults") -> "StepFaults":
        return StepFaults(
            squeeze_blocks=self.squeeze_blocks + other.squeeze_blocks,
            release_squeezed=self.release_squeezed or other.release_squeezed,
            alloc_failures=self.alloc_failures + other.alloc_failures,
            cancel_rids=self.cancel_rids + other.cancel_rids,
            nan=self.nan if self.nan is not None else other.nan,
            deadline_s=(self.deadline_s if self.deadline_s is not None
                        else other.deadline_s),
            pollute_twins=self.pollute_twins + other.pollute_twins)


class FaultInjector:
    """Seeded, deterministic fault schedule over engine steps.

    ``schedule`` maps engine step index -> :class:`StepFaults`. The engine
    calls :meth:`on_step_begin` once per step (before admission/prefill/
    decode), which applies that step's faults and logs every action taken,
    so a chaos test can replay and account for exactly what happened.
    Blocks squeezed from the pool are owned by the injector until a
    ``release_squeezed`` event or :meth:`release_all` — tests call the
    latter before asserting the fully-returned free list.
    """

    def __init__(self, schedule: Optional[Dict[int, StepFaults]] = None):
        self.schedule: Dict[int, StepFaults] = dict(schedule or {})
        self.held: List[int] = []
        self.log: List[Tuple[int, str, object]] = []
        self._twin_seq = 0      # deterministic pollution-twin counter

    # ------------------------------------------------------------------
    @classmethod
    def from_seed(cls, seed: int, *, rids: Sequence[int] = (),
                  horizon: int = 48, squeezes: int = 2, cancels: int = 2,
                  alloc_failures: int = 2, nan_period: Optional[int] = None,
                  pollute: int = 0) -> "FaultInjector":
        """Generate a random-but-replayable schedule from ``seed``.

        Squeeze events hold blocks for at most ``horizon // 4`` steps (and
        every squeeze schedules its release inside the horizon), so a
        healthy engine always regains its pool and the run can't stall
        past the watchdog by construction. Cancellations target ``rids``;
        an rid that already reached a terminal state by its scheduled step
        is a logged no-op. ``nan_period`` (when given) adds one NaN
        poisoning of a random rid at a random step. ``pollute`` schedules
        that many single-twin cache-pollution events at random steps
        (mid-burst divergent-suffix submissions — see
        :attr:`StepFaults.pollute_twins`).
        """
        rng = np.random.default_rng(seed)
        sched: Dict[int, StepFaults] = {}

        def add(step: int, f: StepFaults):
            sched[step] = f.merged(sched[step]) if step in sched else f

        for _ in range(squeezes):
            k = int(rng.integers(0, max(horizon - 8, 1)))
            hold = int(rng.integers(1, max(horizon // 4, 2)))
            n = int(rng.integers(1, 5))
            add(k, StepFaults(squeeze_blocks=n))
            add(k + hold, StepFaults(release_squeezed=True))
        for _ in range(alloc_failures):
            add(int(rng.integers(0, horizon)), StepFaults(alloc_failures=1))
        for _ in range(pollute):
            add(int(rng.integers(1, horizon)),
                StepFaults(pollute_twins=1))
        if rids:
            pool = list(rids)
            for _ in range(min(cancels, len(pool))):
                rid = pool.pop(int(rng.integers(0, len(pool))))
                add(int(rng.integers(1, horizon)),
                    StepFaults(cancel_rids=(rid,)))
            if nan_period is not None:
                rid = pool[int(rng.integers(0, len(pool)))] if pool \
                    else list(rids)[0]
                add(int(rng.integers(1, horizon)),
                    StepFaults(nan=(rid, nan_period)))
        return cls(sched)

    # ------------------------------------------------------------------
    def _note(self, eng, step: int, action: str, detail) -> None:
        """Record one applied action: always in :attr:`log` (the replay
        record chaos tests assert against) and, when the engine carries
        one, on its telemetry timeline — so a trace viewer shows each
        squeeze/cancel/NaN aligned with the victims' request spans."""
        self.log.append((step, action, detail))
        tel = getattr(eng, "telemetry", None)
        if tel is not None:
            tel.chaos_action(step, action, detail)

    def on_step_begin(self, eng) -> None:
        """Apply this step's faults to ``eng`` (called by Engine.step)."""
        f = self.schedule.get(eng.steps)
        if f is None:
            return
        step = eng.steps
        if f.release_squeezed and self.held:
            eng.alloc.release(self.held)
            self._note(eng, step, "release", len(self.held))
            self.held = []
        if f.squeeze_blocks:
            n = min(f.squeeze_blocks, eng.alloc.n_free)
            if n:
                self.held.extend(eng.alloc.alloc(n))
                self._note(eng, step, "squeeze", n)
        if f.alloc_failures:
            eng.alloc.fail_next(f.alloc_failures)
            self._note(eng, step, "alloc_fail", f.alloc_failures)
        if f.deadline_s is not None:
            for r in eng.live_requests():
                r.deadline_s = f.deadline_s
            eng.arm_deadlines()
            self._note(eng, step, "deadline_storm", f.deadline_s)
        if f.pollute_twins:
            self._pollute(eng, step, f.pollute_twins)
        for rid in f.cancel_rids:
            done = eng.cancel(rid)
            self._note(eng, step, "cancel" if done else "cancel_miss", rid)
        if f.nan is not None:
            rid, period = f.nan
            live = {r.rid for r in eng.live_requests()}
            if rid in live:
                eng.arm_nan(rid, period)
                self._note(eng, step, "nan", (rid, period))
            else:
                self._note(eng, step, "nan_miss", (rid, period))

    def _pollute(self, eng, step: int, n: int) -> None:
        """Submit ``n`` divergent-suffix twins of live base requests:
        prompt = victim.tokens[:half] + reversed(victim.tokens[half:]),
        which shares every full prefix block with the victim and then
        diverges — the radix trie must branch, and with the cache off the
        twin is just extra load. Deterministic: victims are picked round-
        robin over the rid-sorted live base cohort. A full queue
        (load shedding) is a logged no-op, not a failure."""
        from repro_torch.serving.scheduler import Rejected, Request
        for _ in range(n):
            live = sorted((r for r in eng.live_requests()
                           if r.rid < POLLUTE_RID_BASE),
                          key=lambda r: r.rid)
            if not live:
                self._note(eng, step, "pollute_miss", None)
                self._twin_seq += 1
                continue
            src = live[self._twin_seq % len(live)]
            half = max(1, len(src.tokens) // 2)
            twin_tokens = (list(src.tokens[:half])
                           + list(reversed(src.tokens[half:])))
            rid = POLLUTE_RID_BASE + self._twin_seq
            self._twin_seq += 1
            try:
                eng.submit(Request(rid=rid, tokens=twin_tokens,
                                   max_new_tokens=2))
                self._note(eng, step, "pollute", (rid, src.rid))
            except Rejected as e:
                self._note(eng, step, "pollute_shed", (rid, e.reason))

    def release_all(self, eng) -> None:
        """Return every squeezed block to the pool (end-of-run cleanup)."""
        if self.held:
            eng.alloc.release(self.held)
            self._note(eng, eng.steps, "release", len(self.held))
            self.held = []

    @property
    def quiescent(self) -> bool:
        """True when the injector holds no pool resources."""
        return not self.held
