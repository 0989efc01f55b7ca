"""Continuous-batching scheduler v2: chunked prefill, lazy block
allocation, and preemption under block pressure.

The scheduler owns every *policy* decision of the serving engine; the
engine (serving/engine.py) owns model execution. Compared to the v1
FIFO-with-full-reservation admission loop, three things change:

  * **Lazy block allocation.** A request is admitted with only the blocks
    its first prefill unit needs (one chunk, or the whole prompt when
    chunked prefill is off) and grows its block table on demand — one
    block at a time during decode, one chunk's worth during prefill. KV
    budget is a live resource, not a worst-case reservation, so a burst of
    long-``max_new`` requests no longer serializes behind pessimistic
    admission control.

  * **Chunked prefill** (``prefill_chunk=N``). Prompts are paged out N
    tokens at a time, one chunk per engine step, interleaved with the
    fused decode step over the running batch — a 4k-token prompt no longer
    stalls every decoding request for a whole-prompt forward (the
    Sarathi/vLLM chunked-prefill schedule). ``next_prefill_chunk`` always
    picks the *oldest* prefilling request, so prefill is FCFS.

  * **Preemption under block pressure.** When a request must grow and the
    free list is short, :meth:`ensure_blocks` evicts the lowest-priority
    (youngest-arrival) *other* request: its blocks are freed, its slot is
    released, and it is re-queued at the front of the waiting queue with
    its generated prefix intact (recompute-style preemption — on
    re-admission its prompt *plus generated tokens* are prefilled again
    and decode continues from where it stopped). Victims are always
    strictly younger than the grower — a request that would have to evict
    an elder waits instead (``ensure_blocks`` returns False) — so FCFS
    priority is never inverted, the oldest active request always
    progresses, and the schedule cannot deadlock; :meth:`submit` rejects
    requests whose full footprint could never fit the pool, which
    guarantees the oldest can always grow by evicting its juniors.

Latency accounting lives on the :class:`Request`: arrival, first
admission (queue time), first token (TTFT), finish (TPOT = decode seconds
per generated token after the first, re-prefill delays included — the
honest SLO view of preemption), and a preemption counter.

This module is a copy of the reference's scheduler, unchanged but for
its import of the allocator: policy is host-only Python, so both
packages' engines schedule an identical trace identically.

**Request lifecycle.** Every request ends in exactly one terminal
state: ``FINISHED`` (generation budget met), ``TIMED_OUT`` (its
``deadline_s`` elapsed before completion), ``CANCELLED`` (caller revoked
it via ``Engine.cancel``), ``REJECTED`` (``submit`` refused it — invalid,
unschedulable, or load-shed by the bounded queue) or ``FAILED`` (the
engine quarantined it, e.g. non-finite logits). :meth:`submit` validates
at the boundary — empty prompts, non-positive generation budgets and
never-schedulable footprints raise :class:`Rejected` with a machine-
readable ``reason`` instead of poisoning the queue — and ``queue_cap``
bounds the waiting queue so overload sheds load (``reason="queue_full"``)
instead of queueing unboundedly. :meth:`evict_terminal` removes a live or
waiting request through the same scrub→release path preemption uses, so
a cancellation or timeout can never leak blocks or leave stale KV bytes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Tuple

from repro_torch.serving.cache import BlockAllocator, OutOfBlocks

WAITING = "waiting"
PREFILL = "prefill"
RUNNING = "running"
FINISHED = "finished"
TIMED_OUT = "timed_out"
CANCELLED = "cancelled"
REJECTED = "rejected"
FAILED = "failed"

#: States a request can never leave. ``finish_time`` is set on entry to
#: any of them, so "all requests reached a terminal state" is checkable.
TERMINAL_STATES = frozenset(
    {FINISHED, TIMED_OUT, CANCELLED, REJECTED, FAILED})


class Rejected(RuntimeError):
    """:meth:`Scheduler.submit` refused a request.

    ``reason`` is machine-readable backpressure/validation taxonomy:

      * ``"empty_prompt"`` — no prompt tokens;
      * ``"bad_max_new"`` — non-positive generation budget;
      * ``"unschedulable"`` — the full footprint (prompt + max_new) can
        never fit the block pool, so queueing it would deadlock FCFS;
      * ``"queue_full"`` — the bounded waiting queue is at ``queue_cap``
        (load shedding: the caller should retry later or downsize).

    The request's state is set to :data:`REJECTED` before raising, so the
    caller holds a request object already in its terminal state.
    """

    def __init__(self, reason: str, msg: str):
        super().__init__(msg)
        self.reason = reason


@dataclasses.dataclass
class Request:
    rid: int
    tokens: List[int]
    max_new_tokens: int = 32
    arrival: float = 0.0
    # wall-clock deadline relative to arrival: the engine's per-step sweep
    # evicts the request as TIMED_OUT once clock() - arrival >= deadline_s,
    # whether it is still queued, prefilling or decoding. None = no SLO.
    deadline_s: Optional[float] = None
    # lifecycle
    state: str = WAITING
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    admitted_time: Optional[float] = None
    output: List[int] = dataclasses.field(default_factory=list)
    blocks: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    prefilled: int = 0          # context tokens already paged out
    n_preemptions: int = 0
    # adaptive speculation depth (serving/speculate.py): 0 = not yet
    # initialized; the Speculator seeds it with the configured depth on
    # first use and backs it off as acceptance drops. Survives preemption
    # — an evicted request resumes with its learned depth.
    spec_depth: int = 0
    # prefix-cache bookkeeping, reset at each (re-)admission: how many
    # context tokens were satisfied from cached blocks this admission, and
    # the deepest trie node on this request's registered/shared chain (the
    # engine resumes registration below it and restores its SSM snapshot).
    cached_tokens: int = 0
    cache_node: object = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def length(self) -> int:
        return len(self.tokens) + len(self.output)

    def context_tokens(self) -> List[int]:
        """Tokens whose KV must be paged before decode can proceed: the
        prompt plus every generated token except the last (the last one is
        the next decode input; its KV is appended by the decode step)."""
        if self.output:
            return list(self.tokens) + self.output[:-1]
        return list(self.tokens)

    def context_len(self) -> int:
        return len(self.tokens) + max(len(self.output) - 1, 0)

    # latency views (valid once the corresponding timestamps exist)
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    def tpot(self) -> Optional[float]:
        if (self.finish_time is None or self.first_token_time is None
                or len(self.output) < 2):
            return None
        return ((self.finish_time - self.first_token_time)
                / (len(self.output) - 1))

    def queue_time(self) -> Optional[float]:
        if self.admitted_time is None:
            return None
        return self.admitted_time - self.arrival


def _priority(req: Request) -> Tuple[float, int]:
    """FCFS priority: earlier arrival wins; rid breaks ties."""
    return (req.arrival, req.rid)


class Scheduler:
    """Slot/queue/block bookkeeping for the continuous-batching engine."""

    def __init__(self, *, max_batch: int, n_blocks: int, block_size: int,
                 prefill_chunk: Optional[int] = None,
                 queue_cap: Optional[int] = None,
                 prefix_cache=None):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")
        if queue_cap is not None and queue_cap < 1:
            raise ValueError("queue_cap must be >= 1 (or None)")
        self.max_batch = max_batch
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.queue_cap = queue_cap
        self.prefix_cache = prefix_cache
        self.alloc = BlockAllocator(n_blocks)
        if prefix_cache is not None:
            self.alloc.attach_cache(prefix_cache)
        self.waiting: deque = deque()
        self.running: List[Optional[Request]] = [None] * max_batch
        self.n_preemptions = 0
        # optional hook invoked with the victim BEFORE its blocks are
        # released (the engine scrubs the victim's pages through it)
        self.on_preempt = None
        # optional Telemetry (serving/telemetry.py), wired by the engine:
        # lifecycle transitions made HERE (admission, preemption, terminal
        # states) emit their spans here so policy and trace can't drift
        self.tel = None

    # ------------------------------------------------------------------
    def _blocks_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.block_size)

    def submit(self, req: Request) -> None:
        """Validate and enqueue, or raise :class:`Rejected` with a reason.

        Every rejection is decided HERE, at the admission boundary, and
        marks the request terminally ``REJECTED`` — an invalid or
        unschedulable request must never enter the queue (it would either
        deadlock FCFS or fail many layers deeper with a cryptic shape
        error), and a full queue sheds load instead of growing without
        bound. Preemption re-queues (``appendleft``) bypass the cap: an
        admitted request's claim on service is never revoked by arrivals
        behind it.
        """
        def reject(reason: str, msg: str):
            # repro: allow[LIFE-01] rejection happens at the admission boundary: no slot, no blocks, nothing to scrub or release
            req.state = REJECTED
            raise Rejected(reason, f"request {req.rid}: {msg}")

        if not req.tokens:
            reject("empty_prompt", "empty prompt (no tokens to prefill)")
        if req.max_new_tokens < 1:
            reject("bad_max_new",
                   f"max_new_tokens={req.max_new_tokens} must be >= 1")
        total = len(req.tokens) + req.max_new_tokens
        if self._blocks_for(total) > self.alloc.n_blocks:
            reject("unschedulable",
                   f"needs {self._blocks_for(total)} blocks at its full "
                   f"footprint but the pool holds only "
                   f"{self.alloc.n_blocks}; it could never be scheduled")
        if (self.queue_cap is not None
                and len(self.waiting) >= self.queue_cap):
            reject("queue_full",
                   f"waiting queue is at its cap ({self.queue_cap}); "
                   f"shedding load instead of queueing unboundedly")
        req.state = WAITING
        self.waiting.append(req)

    # ------------------------------------------------------------------
    # Admission: FIFO, with only the first prefill unit's blocks. The
    # headroom term keeps one free block per already-active request (each
    # may need to grow within a step or two), which damps admit→preempt
    # thrash without reverting to full-footprint reservation.
    # ------------------------------------------------------------------

    def admit(self, now: float) -> List[Request]:
        admitted: List[Request] = []
        while self.waiting:
            req = self.waiting[0]
            free_slots = [i for i, r in enumerate(self.running) if r is None]
            if not free_slots:
                break
            target = req.context_len()
            # Longest cached prefix (full blocks only, always < target):
            # those blocks enter the table at refcount+1 and prefill skips
            # straight to the novel suffix.
            cached_node, cached_blocks = (
                self.prefix_cache.match(req.context_tokens())
                if self.prefix_cache is not None else (None, []))
            n_cached = len(cached_blocks) * self.block_size
            suffix = target - n_cached
            first = (suffix if self.prefill_chunk is None
                     else min(suffix, self.prefill_chunk))
            need = self._blocks_for(n_cached + first) - len(cached_blocks)
            headroom = sum(1 for r in self.running if r is not None)
            if self.alloc.n_available < need + headroom:
                break               # no KV budget yet: keep FIFO order
            self.waiting.popleft()
            # Pin the cached chain FIRST: share() revives refcount-zero
            # blocks out of the second-chance pool, so the alloc() below
            # cannot reclaim them out from under this request.
            if cached_blocks:
                self.alloc.share(cached_blocks)
            try:
                fresh = self.alloc.alloc(need)
            except OutOfBlocks:
                # a lying/faulted allocator (fault injection, or a racing
                # co-user) is backpressure, not a crash: requeue at the
                # front and retry next step — FIFO order is preserved
                if cached_blocks:
                    self.alloc.release(cached_blocks)
                self.waiting.appendleft(req)
                break
            req.blocks = list(cached_blocks) + fresh
            req.slot = free_slots[0]
            req.state = PREFILL
            req.prefilled = n_cached
            req.cached_tokens = n_cached
            req.cache_node = cached_node
            if req.admitted_time is None:
                req.admitted_time = now
            self.running[req.slot] = req
            admitted.append(req)
            if self.tel is not None:
                self.tel.req_admit(req)
        return admitted

    # ------------------------------------------------------------------
    # Growth + preemption
    # ------------------------------------------------------------------

    def ensure_blocks(self, req: Request, n_tokens: int) -> bool:
        """Grow ``req``'s block table to cover ``n_tokens`` context tokens,
        preempting the youngest active request(s) *younger than req* if the
        free list is short. Returns False when ``req`` must wait instead
        (only older requests hold the blocks — evicting them would invert
        FCFS priority). The oldest active request can always grow: every
        other active request is younger and submit() bounds each footprint
        by the pool size, so it makes progress and the schedule cannot
        deadlock; a waiting grower is unblocked when its elders finish."""
        need = self._blocks_for(n_tokens) - len(req.blocks)
        if need <= 0:
            return True
        while self.alloc.n_available < need:
            victim = self._pick_victim(than=req)
            if victim is None:
                return False        # req yields to its elders this step
            self.preempt(victim)
        try:
            req.blocks.extend(self.alloc.alloc(need))
        except OutOfBlocks:
            return False    # injected/raced allocator failure: wait a step
        return True

    def _pick_victim(self, than: Request) -> Optional[Request]:
        """Youngest active request strictly lower-priority than ``than``."""
        cands = [r for r in self.running
                 if r is not None and r is not than
                 and _priority(r) > _priority(than)]
        if not cands:
            return None
        return max(cands, key=_priority)    # youngest arrival goes first

    def preempt(self, victim: Request) -> None:
        """Evict an active request: free its blocks and slot, re-queue it at
        the front of the waiting queue with its generated prefix intact."""
        if self.on_preempt is not None:
            self.on_preempt(victim)
        self.alloc.release(victim.blocks)
        victim.blocks = []
        self.running[victim.slot] = None
        victim.slot = -1
        victim.prefilled = 0
        victim.cached_tokens = 0
        victim.cache_node = None
        victim.state = WAITING
        victim.n_preemptions += 1
        self.n_preemptions += 1
        # victims are preempted youngest-first and appendleft'ed, so the
        # waiting queue stays globally FCFS-ordered
        self.waiting.appendleft(victim)
        if self.tel is not None:
            self.tel.req_preempt(victim)

    def finish(self, req: Request, now: float) -> None:
        req.finish_time = now
        # repro: allow[LIFE-01] finish IS the sanctioned success exit (evict_terminal refuses FINISHED); it releases blocks below
        req.state = FINISHED
        self.alloc.release(req.blocks)
        req.blocks = []
        self.running[req.slot] = None
        req.slot = -1
        if self.tel is not None:
            self.tel.req_terminal(req, FINISHED, "finished")

    def evict_terminal(self, req: Request, state: str, now: float) -> None:
        """Remove a request from the schedule into a terminal ``state``
        (TIMED_OUT / CANCELLED / FAILED) — the cancellation, deadline and
        quarantine exit used by the engine.

        An *active* request leaves through the same path preemption uses:
        the ``on_preempt`` hook fires first (the engine scrubs the
        request's pages through it, so partially-written KV can never
        leak stale bytes to a later owner), then its blocks return to the
        allocator and its slot frees. A *waiting* request simply leaves
        the queue. Unlike :meth:`preempt` nothing is re-queued — the
        state is terminal — and unlike :meth:`finish` the request may be
        mid-prefill or never admitted at all.
        """
        if state not in TERMINAL_STATES or state == FINISHED:
            raise ValueError(f"evict_terminal: {state!r} is not an "
                             f"eviction terminal state")
        # eviction path for the terminal trace event: through the active
        # scrub→release path, or a plain dequeue of a waiting request
        path = "active_scrub" if req.slot >= 0 else "queue_drop"
        if req.slot >= 0:
            if self.on_preempt is not None:
                self.on_preempt(req)
            self.alloc.release(req.blocks)
            req.blocks = []
            self.running[req.slot] = None
            req.slot = -1
        else:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass                # already out of the schedule
        req.state = state
        req.finish_time = now
        if self.tel is not None:
            self.tel.req_terminal(req, state, path)

    # ------------------------------------------------------------------
    # Step planning views
    # ------------------------------------------------------------------

    def next_prefill_chunk(self) -> Optional[Tuple[Request, int, int]]:
        """(request, start, n_tokens) for the oldest request still paging
        its context out, or None. Only meaningful with chunked prefill."""
        cands = [r for r in self.running
                 if r is not None and r.state == PREFILL]
        if not cands:
            return None
        req = min(cands, key=_priority)
        n = min(self.prefill_chunk, req.context_len() - req.prefilled)
        return req, req.prefilled, n

    def decode_candidates(self) -> List[Request]:
        """Running (decoding) requests, oldest first."""
        return sorted((r for r in self.running
                       if r is not None and r.state == RUNNING),
                      key=_priority)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or any(r is not None for r in self.running)
