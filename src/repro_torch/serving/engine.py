"""Continuous-batching serving engine: fused paged decode, chunked
prefill and speculative decoding over a paged KV cache (the port of
``repro.serving.engine``, ``mode="fused"``, dense and ssm families;
speculation on the dense family).

The engine owns a paged KV cache (serving/cache.py) and a
:class:`~repro_torch.serving.scheduler.Scheduler` that makes every policy
decision: FIFO admission with lazy block allocation, chunked-prefill
planning, and preemption of the youngest request under block pressure.

**Fused decode.** ``_fused_step_impl`` advances every running sequence by
one token: embed, the layer stack with attention read from the *paged*
cache through the block table (kernels/flash_decode
``paged_flash_decode_partial``; the hand-written CUDA kernel on the card),
the fresh token's own contribution LSE-merged analytically
(``causal_self_partial`` + ``merge_partials``), the head and greedy pick,
and ONE all-layer scatter of the new KV after the stack. The batch is
always ``max_batch`` rows; inactive rows have length 0, an all-zero table
row and route their append to the null block.

**Prefill** comes in two schedules: whole-prompt (``prefill_chunk=None``:
admitted requests grouped by context length, one dense forward per group,
one paged write per sequence) and chunked (``prefill_chunk=N``: one chunk
step pages N context tokens of one sequence per engine step, reading its
already-paged prefix through the same multi-query kernel, T=N, while the
running batch keeps decoding in the same engine step).

**SSM layers** keep a dense per-slot pool of (conv, state), both f32,
one row per engine slot. Whole-prompt prefill writes each request's
final states into its slot; a chunk step slices its request's slot,
carries (conv, state) through the chunk with ``n_valid`` marking the
valid prefix of a right-padded tail, and writes it back; the fused decode
step advances every slot's state by one token and keeps inactive slots'
state with the ``active`` mask (a slot mid-way through chunked prefill
must not be advanced by the running batch's decode). Under chunked
prefill a slot starts from zero at admission. The SSD scan of both
prefill kinds runs in the model's ``ssd_impl``: the engine builds its
model with ``"kernel"`` (the hand-written CUDA kernel on the card, where
no other impl is accepted); ``"ref"`` is for the CPU tests. An
attention-free arch keeps a one-layer dummy KV pool, as the reference
does, and skips all attention work.

**Speculative decoding** (``speculate="ngram" | "draft:<config>"`` or
any proposer object; serving/speculate.py). A proposer guesses up to
``spec_depth`` tokens per running request, and ONE verify step
(``_verify_step_impl``) scores every request's window: the fused step's
layer body with the paged read at T = 1 + proposals (the multi-query
kernel's T > 1 path), the fresh window's causal partial and the LSE
merge. Proposals are accepted while they equal the forward's own argmax
(the leading run of matches), so greedy output equals spec-off decode,
and every row emits its accepted tokens plus the model's own token at
the first disagreement. Rejected positions' KV appends route to the
null-write sentinel, so rollback is exact. The window width is the
largest row's, rounded up to a power of two and capped at depth + 1,
as in the reference, so the products run at the reference's shapes. The
reference's prefix-cache copy-on-write (``_cow_tail``) and fault
injection (``_inj_mask``) are not ported; speculation on an SSM arch
(its per-token verify scan) is a later slice and raises.

**State updates in place.** Where the reference donates its state
buffers to each jitted step and rebinds the result, the port writes both
pools in place: the step functions take the paged KV storage and the SSM
slot pool as arguments, mutate them and return only the per-step
outputs. The step bodies hold no host syncs, so a step is a stream of
launches the host does not wait on until it reads the tokens.

**CUDA graphs** (serving/graphs.py). On the card each step kind runs as
one CUDA graph per static shape, the reference's one executable per
``(kind, T, table bucket)``: ``("decode", 1, mbb)``, ``("chunk", cn,
mbb)`` and ``("verify", t, mbb)``. A graph is captured once over the
live pools (all graphs in one memory pool) and replayed by ``step()``;
its first use runs the step eagerly, then captures it, and
:meth:`Engine.warmup` captures the shapes a trace will need before
traffic arrives. ``trace_counts`` counts the captures by key (on the
CPU, which captures nothing, the first use of each key), as the
reference counts its traces. A replay gives the eager step's bits: the
same kernels in the same order. ``cuda_graphs=False`` runs every step
eagerly on the card too, for that comparison; a capture or replay that
fails raises. Whole-prompt prefill, the draft model's decode and the
preemption scrubs stay eager.

**Failure semantics.** A row whose logits are not all finite is
quarantined: it is evicted as ``FAILED`` through the scheduler's
scrub -> release path without emitting its token. ``run`` raises
:class:`StallError` after ``STALL_LIMIT`` steps without progress.
"""
from __future__ import annotations

import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.config import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.stats import percentile as _pct
from repro_torch.kernels import flash_decode as fd
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.lm import LM
from repro_torch.models.params import tree_map
from repro_torch.serving import cache as C
from repro_torch.serving.cache import PagedKVCache, PagedKVConfig
from repro_torch.serving.graphs import StepGraph
from repro_torch.serving.scheduler import (FAILED, FINISHED, RUNNING,
                                           Rejected, Request, Scheduler)
from repro_torch.serving.speculate import build_speculator

__all__ = ["Engine", "Request", "Rejected", "StallError"]

#: consecutive steps without progress before ``run`` gives up
STALL_LIMIT = 200


class StallError(RuntimeError):
    """``Engine.run`` made no progress for ``STALL_LIMIT`` consecutive
    steps while work remained; names every stuck request."""

    def __init__(self, idle_steps: int, stuck: List[Request]):
        self.rids = [r.rid for r in stuck]
        names = ", ".join(
            f"rid={r.rid}({r.state}, prefilled={r.prefilled}, "
            f"out={len(r.output)})" for r in stuck)
        super().__init__(
            f"engine stalled: {idle_steps} consecutive steps without "
            f"progress; stuck requests: {names or '<none>'}")


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Engine:
    """Serve ``cfg`` with ``params`` on ``device`` (the card unless the
    caller passes ``"cpu"``; params are moved there if needed). On the
    card the steps replay CUDA graphs unless ``cuda_graphs=False``."""

    def __init__(self, cfg: ArchConfig, params, *, max_batch: int = 8,
                 n_blocks: int = 64, block_size: int = 16,
                 kv_quant: str = "none",
                 prefill_chunk: Optional[int] = None,
                 ssd_impl: str = "kernel", speculate=None,
                 spec_depth: int = 4,
                 device: Optional[Union[str, torch.device]] = None,
                 cuda_graphs: bool = True):
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got "
                             f"{kv_quant!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and ssd_impl != "kernel":
            raise ValueError(
                f"ssd_impl={ssd_impl!r}: on the card the engine's SSD scan "
                f"runs the kernel; the plain paths are for the CPU")
        self.cfg = cfg
        self.model = LM(cfg, ssd_impl=ssd_impl, device=self.device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        # per-layer views into the stacked block tree, built once
        self._layers = [self.model.layer_params(self.params, i)
                        for i in range(cfg.n_layers)]
        self.max_batch = max_batch
        self.block_size = block_size
        self.prefill_chunk = prefill_chunk
        self.clock = time.monotonic
        self._attn_pos = [i for i in range(self.model.period)
                          if self.model.kinds[i] == "attn"]
        self._ssm_pos = [i for i in range(self.model.period)
                         if self.model.kinds[i] == "ssm"]
        if self._ssm_pos and speculate not in (None, "off"):
            raise NotImplementedError(
                "speculative decoding on an SSM arch is not ported (the "
                "verify step's per-token scan, ssm_apply_spec, is a later "
                "slice)")
        self.spec = build_speculator(speculate, cfg, depth=spec_depth,
                                     device=self.device)
        # an attention-free arch keeps a one-layer dummy pool (the
        # scheduler still accounts blocks per token), as the reference does
        n_attn = len(self._attn_pos) * self.model.n_periods
        self.kv_cfg = PagedKVConfig(
            n_layers=max(n_attn, 1), n_kv_heads=max(cfg.n_kv_heads, 1),
            head_dim=max(cfg.head_dim, 1), n_blocks=n_blocks,
            block_size=block_size, kv_quant=kv_quant)
        self.kv = PagedKVCache(self.kv_cfg, device=self.device)
        self._ssm_states = self._init_ssm_states()
        self.sched = Scheduler(max_batch=max_batch, n_blocks=n_blocks,
                               block_size=block_size,
                               prefill_chunk=prefill_chunk)
        # recompute-style preemption scrubs the victim's pages before the
        # allocator reuses them
        self.sched.on_preempt = self._scrub_preempted
        self.finished: List[Request] = []
        self.n_rejected = 0
        self.steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.decode_time = 0.0
        self.prefill_time = 0.0
        # engine steps of each kind (host-side accounting: every decode or
        # chunk step reads the paged cache once per attention layer)
        self.step_counts: Counter = Counter()
        # one graph per (kind, T, table bucket), all in one memory pool;
        # trace_counts counts their captures (first uses on the CPU)
        self.capture = cuda_graphs and self.device.type == "cuda"
        self._graph_pool = (torch.cuda.graph_pool_handle() if self.capture
                            else None)
        self._graphs: Dict[tuple, StepGraph] = {}
        self.trace_counts: Counter = Counter()

    @property
    def alloc(self):
        return self.sched.alloc

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    # Step dispatch: one CUDA graph per (kind, T, table bucket) on the
    # card, the eager step on the CPU (serving/graphs.py)
    # ------------------------------------------------------------------

    def _run_step(self, key: tuple, impl: Callable,
                  inputs: Dict[str, np.ndarray]) -> Tuple[np.ndarray, ...]:
        """One step of ``key`` on the host ``inputs`` over the live pools:
        the key's graph replayed, else the step run eagerly (then, at the
        key's first use on the card, captured). Returns the step's
        outputs as numpy."""
        graph = self._graphs.get(key)
        if graph is not None:
            return graph.replay(inputs)
        dev_in = {k: self._dev(a) for k, a in inputs.items()}
        out = tuple(o.cpu().numpy() for o in impl(
            self.params, self.kv.state, self._ssm_states, **dev_in))
        self._trace(key, impl, dev_in)
        return out

    def _trace(self, key: tuple, impl: Callable,
               dev_in: Dict[str, torch.Tensor]) -> None:
        """Count ``key``'s first use and, when capturing, capture its
        graph over the live pools. The step has just run eagerly at this
        shape, so every kernel's lazily built state exists."""
        if key in self.trace_counts:
            return
        self.trace_counts[key] += 1
        if self.capture:
            self._graphs[key] = StepGraph(
                lambda **kw: impl(self.params, self.kv.state,
                                  self._ssm_states, **kw),
                dev_in, self._graph_pool)

    def _chunk_inputs(self, tokens: np.ndarray, start: int, n: int,
                      table: np.ndarray, slot: int) -> Dict[str, np.ndarray]:
        return dict(tokens=tokens, ctx=np.asarray([start], np.int32),
                    n_valid=np.asarray([n], np.int32), table=table,
                    slot=np.asarray([slot], np.int64))

    @torch.no_grad()
    def warmup(self, max_seq_len: int,
               prompt_lens: Optional[List[int]] = None) -> None:
        """Build the steps for the shapes a trace needs before it
        arrives, as a deployment compiles before taking traffic (the
        reference's ``warmup``): on the card each shape's graph is
        captured, on the CPU its key is counted. No pool byte and no
        ``stats()`` counter changes: each shape first runs eagerly on
        throwaway copies of both pools.

        ``max_seq_len`` (prompt + generation budget) sets the largest
        table bucket. With ``prompt_lens`` every power-of-two bucket from
        the smallest prompt's up to it is built: for chunk steps, as in
        the reference, since a preemption victim re-prefills its prompt
        plus generated prefix into buckets no fresh prompt uses; and for
        decode and verify steps, whose bucket follows the live batch's
        largest footprint through the same buckets (the reference builds
        those at the largest bucket only and compiles the others while
        serving). Verify steps are built at every window width
        ``min(next_pow2(k), depth + 1)``."""
        top = _next_pow2(-(-max_seq_len // self.block_size))
        buckets = [top]
        if prompt_lens:
            b = min(_next_pow2(self.sched._blocks_for(t))
                    for t in prompt_lens)
            buckets = []
            while b < top:
                buckets.append(b)
                b *= 2
            buckets.append(top)
        pools = ({k: v.clone() for k, v in self.kv.state.items()},
                 {pos: {leaf: a.clone() for leaf, a in st.items()}
                  for pos, st in self._ssm_states.items()})
        bsz = self.max_batch
        zeros = np.zeros((bsz,), np.int32)
        if self.spec is None:
            for mbb in buckets:
                self._warm(("decode", 1, mbb), self._fused_step_impl, pools,
                           dict(tokens=zeros, lengths=zeros,
                                table=np.zeros((bsz, mbb), np.int32),
                                active=np.zeros((bsz,), bool)))
        if self.prefill_chunk is not None:
            cn = self.prefill_chunk
            for mbb in buckets:
                self._warm(("chunk", cn, mbb), self._chunk_step_impl, pools,
                           self._chunk_inputs(
                               np.zeros((1, cn), np.int32), 0, cn,
                               np.zeros((1, mbb), np.int32), 0))
        if self.spec is not None:
            depth = self.spec.depth
            for t in sorted({min(_next_pow2(k), depth + 1)
                             for k in range(1, depth + 2)}):
                for mbb in buckets:
                    self._warm(("verify", t, mbb), self._verify_step_impl,
                               pools,
                               dict(tokens=np.zeros((bsz, t), np.int32),
                                    ctx=zeros, n_valid=zeros,
                                    table=np.zeros((bsz, mbb), np.int32),
                                    active=np.zeros((bsz,), bool)))

    def _warm(self, key: tuple, impl: Callable, pools,
              inputs: Dict[str, np.ndarray]) -> None:
        if key in self.trace_counts:
            return
        dev_in = {k: self._dev(a) for k, a in inputs.items()}
        impl(self.params, *pools, **dev_in)
        self._trace(key, impl, dev_in)

    # ------------------------------------------------------------------
    # SSM slot pool: per SSM period position, (conv, state) stacked as
    # (n_periods, max_batch, ...), f32
    # ------------------------------------------------------------------

    def _init_ssm_states(self) -> Dict[str, Dict[str, torch.Tensor]]:
        base = B.ssm_init_cache(self.cfg, self.max_batch, self.device)
        return {f"pos{pos}": {leaf: torch.zeros(
                    (self.model.n_periods,) + tuple(a.shape), dtype=a.dtype,
                    device=self.device) for leaf, a in base.items()}
                for pos in self._ssm_pos}

    def _zero_ssm_slot(self, slot: int) -> None:
        """Reset one slot's SSM state (chunked prefill starts from zeros;
        whole-prompt prefill overwrites the slot with its final states)."""
        for st in self._ssm_states.values():
            for a in st.values():
                a[:, slot].zero_()

    def _ssm_xs(self, ssm_state):
        """Per-period views of every slot of the SSM pool ``ssm_state``."""
        return [{pos: {leaf: a[per] for leaf, a in st.items()}
                 for pos, st in ssm_state.items()}
                for per in range(self.model.n_periods)]

    def _ssm_slot_xs(self, ssm_state, slot: torch.Tensor):
        """Per-period copies of one slot's rows, a batch of one: ``slot``
        is a (1,) int64 device index, so one graph serves every slot."""
        return [{pos: {leaf: a[per].index_select(0, slot)
                       for leaf, a in st.items()}
                 for pos, st in ssm_state.items()}
                for per in range(self.model.n_periods)]

    def _write_ssm(self, ssm_state, ssm_ys) -> None:
        """Store each period's new (conv, state) of every slot into the
        pool, in place."""
        for per, new in enumerate(ssm_ys):
            for pos, leaves in new.items():
                for leaf, a in leaves.items():
                    ssm_state[pos][leaf][per].copy_(a)

    def _write_ssm_slot(self, ssm_state, ssm_ys, slot: torch.Tensor
                        ) -> None:
        """Store each period's new (conv, state) of one slot (a (1,)
        int64 device index) into the pool, in place."""
        for per, new in enumerate(ssm_ys):
            for pos, leaves in new.items():
                for leaf, a in leaves.items():
                    ssm_state[pos][leaf][per].index_copy_(0, slot, a)

    # ------------------------------------------------------------------
    # Scheduling entry points (policy lives in serving/scheduler.py)
    # ------------------------------------------------------------------

    def submit(self, req: Request) -> None:
        """Enqueue a request, or raise :class:`Rejected` (counted in
        ``stats()["rejected"]``)."""
        req.arrival = req.arrival or self.clock()
        try:
            self.sched.submit(req)
        except Rejected as e:
            self.n_rejected += 1
            req.finish_time = req.finish_time or self.clock()
            raise

    def live_requests(self) -> List[Request]:
        return list(self.sched.waiting) + [r for r in self.sched.running
                                           if r is not None]

    def _evict_terminal(self, req: Request, state: str) -> None:
        """Move ``req`` to a terminal state through the preempt -> scrub
        -> release path and account it with the finished cohort."""
        if self.spec is not None and req.state == RUNNING:
            self.spec.abandon(req)
        self.sched.evict_terminal(req, state, self.clock())
        self.finished.append(req)

    # ------------------------------------------------------------------
    # Whole-prompt prefill: one forward per group of equal-length
    # contexts, paged out with one write per sequence. Resume-aware: a
    # preempted request re-prefills its prompt plus generated prefix.
    # ------------------------------------------------------------------

    def _prefill(self, reqs: List[Request]) -> None:
        by_len: Dict[int, List[Request]] = {}
        for r in reqs:
            by_len.setdefault(r.context_len(), []).append(r)
        for t in sorted(by_len):
            self._prefill_group(by_len[t], t)

    def _prefill_group(self, group: List[Request], t: int) -> None:
        toks = self._dev(np.asarray([r.context_tokens() for r in group],
                                    np.int32))
        logits, cache, _ = self.model.prefill(self.params, toks)
        self.step_counts["prefill"] += 1
        if self._attn_pos:
            n_l = self.kv_cfg.n_layers
            lkv = (len(group), t, self.kv_cfg.n_kv_heads,
                   self.kv_cfg.head_dim)
            k_all = torch.stack([cache[f"pos{p}"]["k"]
                                 for p in self._attn_pos],
                                dim=1).reshape(n_l, *lkv)
            v_all = torch.stack([cache[f"pos{p}"]["v"]
                                 for p in self._attn_pos],
                                dim=1).reshape(n_l, *lkv)
        for g, r in enumerate(group):
            if self._attn_pos:
                self.kv.write_prefill((k_all[:, g], v_all[:, g]), r.blocks)
            for pos in self._ssm_pos:
                for leaf, a in self._ssm_states[f"pos{pos}"].items():
                    a[:, r.slot].copy_(cache[f"pos{pos}"][leaf][:, g])
        next_tok = logits.argmax(dim=-1).cpu().numpy()
        row_ok = torch.isfinite(logits.float()).all(dim=-1).cpu().numpy()
        now = self.clock()
        for g, r in enumerate(group):
            if not row_ok[g]:       # poisoned prompt forward: quarantine
                self._evict_terminal(r, FAILED)
                continue
            if not r.output:        # fresh request: this IS the first token
                r.output.append(int(next_tok[g]))
                r.first_token_time = now
            r.prefilled = t
            r.state = RUNNING
            self.prefill_tokens += t

    # ------------------------------------------------------------------
    # Shared layer body. Fused decode and chunked prefill run the SAME
    # body over the layer stack and differ only in the attention read
    # (``attn_read``: paged multi-query prefix partial + fresh-window
    # causal partial + LSE merge, decode being the T=1 window) and the
    # SSM cache plumbing (``ssm_step``: T=1 decode with the active-slot
    # mask, or T>1 chunk continue). The body attends to the fresh tokens
    # exactly as the cache will store them (int8 round trip under
    # kv_quant) and returns the encoded form for the single post-stack
    # scatter, and each SSM position's new (conv, state).
    # ------------------------------------------------------------------

    def _make_stack_body(self, *, positions, attn_read, ssm_step):
        cfg = self.cfg
        quant = self.kv_cfg.kv_quant
        period = self.model.period
        kinds = self.model.kinds

        def body(x, per, kv_slice, ssm_slice):
            new_kv: Dict[str, list] = {}
            new_ssm: Dict[str, Dict[str, torch.Tensor]] = {}
            r = 0
            for pos in range(period):
                pp = self._layers[per * period + pos]
                if kinds[pos] == "ssm":
                    x, new_ssm[f"pos{pos}"] = ssm_step(
                        x, pp["mix"], ssm_slice[f"pos{pos}"])
                else:
                    h = L.rmsnorm(x, pp["mix"]["ln"], cfg.norm_eps)
                    q, k, v = B._qkv(h, pp["mix"], cfg, positions)
                    kq, ks = C.quant_encode(k, quant)
                    vq, vs = C.quant_encode(v, quant)
                    out = attn_read(q, (kq, ks, vq, vs), kv_slice, r)
                    x = x + L.dense(out, pp["mix"]["wo"], n_in=2)
                    new_kv.setdefault("k", []).append(kq)
                    new_kv.setdefault("v", []).append(vq)
                    if ks is not None:
                        new_kv.setdefault("k_scale", []).append(ks)
                        new_kv.setdefault("v_scale", []).append(vs)
                    r += 1
                x = B.ffn_apply(x, pp["ffn"], cfg)
            return (x, {kk: torch.stack(vv) for kk, vv in new_kv.items()},
                    new_ssm)

        return body

    def _kv_xs(self, kv_state) -> List[Dict[str, torch.Tensor]]:
        """(L, ...) storage -> per-period views (attn-per-period, ...);
        empty for an attention-free arch."""
        n = len(self._attn_pos)
        return [{kk: vv[per * n:(per + 1) * n] for kk, vv in kv_state.items()}
                if n else {} for per in range(self.model.n_periods)]

    def _run_stack(self, body, x, kv_state, ssm_xs):
        kv_ys, ssm_ys = [], []
        for per, kv_slice in enumerate(self._kv_xs(kv_state)):
            x, kv_y, ssm_y = body(x, per, kv_slice, ssm_xs[per])
            kv_ys.append(kv_y)
            ssm_ys.append(ssm_y)
        return x, kv_ys, ssm_ys

    def _collect_enc(self, kv_ys) -> Dict[str, torch.Tensor]:
        """Per-period ys (R, B, T, ...) -> storage-ready (L, B*T, ...) for
        one all-layer write_token_encoded scatter."""
        n_l = self.kv_cfg.n_layers
        return {kk: torch.stack([y[kk] for y in kv_ys]).reshape(
                    n_l, -1, *kv_ys[0][kk].shape[3:])
                for kk in kv_ys[0]}

    def _sm_scale(self) -> float:
        return 1.0 / float(np.sqrt(max(self.cfg.head_dim, 1)))

    def _enc_read(self, q, enc):
        """The fresh window's causal partial, read as stored."""
        kq, ks, vq, vs = enc
        ka = C.quant_decode(kq, ks, torch.float32)
        va = C.quant_decode(vq, vs, torch.float32)
        return fd.causal_self_partial(q, ka, va, sm_scale=self._sm_scale())

    def _page_kwargs(self, kv_slice, r) -> Dict:
        if self.kv_cfg.kv_quant != "int8":
            return {}
        return {"k_scale": kv_slice["k_scale"][r],
                "v_scale": kv_slice["v_scale"][r]}

    # ------------------------------------------------------------------
    # Chunked prefill: one step pages ``prefill_chunk`` context tokens of
    # ONE sequence through its block table. The paged prefix [0, ctx) is
    # read with the multi-query kernel (T = chunk); the chunk attends
    # itself causally and the partials LSE-merge. A ragged tail is right-
    # padded to the chunk size: padded KV routes to the null block and
    # padded rows compute values nothing reads (the next token comes from
    # row n_valid - 1).
    # ------------------------------------------------------------------

    def _chunk_step_impl(self, params, kv_state, ssm_state, tokens, ctx,
                         n_valid, table, slot):
        cn = tokens.shape[1]
        mbb = table.shape[1]
        dev = tokens.device
        model = self.model
        sm_scale = self._sm_scale()

        x = model._embed_in(params, tokens)                  # (1, C, d)
        steps = torch.arange(cn, device=dev)
        positions = ctx[:, None] + steps[None, :]

        def attn_read(q, enc, kv_slice, r):
            o_c, m_c, l_c = fd.paged_flash_prefix_partial(
                q, kv_slice["k"][r], kv_slice["v"][r], table, ctx,
                sm_scale=sm_scale, **self._page_kwargs(kv_slice, r))
            out = fd.merge_partials([(o_c, m_c, l_c),
                                     self._enc_read(q, enc)])
            return out.to(q.dtype)

        def ssm_step(x, pp_mix, st):
            return B.ssm_apply(x, pp_mix, self.cfg, cache=st,
                               ssd_impl=model.ssd_impl, n_valid=n_valid)

        body = self._make_stack_body(positions=positions,
                                     attn_read=attn_read, ssm_step=ssm_step)
        x, kv_ys, ssm_ys = self._run_stack(
            body, x, kv_state, self._ssm_slot_xs(ssm_state, slot))

        last = x.index_select(1, (n_valid - 1).long())       # (1, 1, d)
        logits = model._head(params, last)[:, 0]
        next_token = logits.argmax(dim=-1)[0]
        # non-finite-logit quarantine flag, read by the host after the step
        ok = torch.isfinite(logits.float()).all()

        if self._attn_pos:
            enc = self._collect_enc(kv_ys)
            valid = steps < n_valid
            blk, off = C.append_slots(table.expand(cn, mbb), ctx + steps,
                                      self.block_size, self.kv_cfg.n_blocks,
                                      valid)
            C.write_token_encoded(kv_state, enc, blk, off)
        self._write_ssm_slot(ssm_state, ssm_ys, slot)
        return next_token, ok

    def _prefill_chunk_tick(self) -> None:
        plan = self.sched.next_prefill_chunk()
        if plan is None:
            return
        req, start, n = plan
        if not self.sched.ensure_blocks(req, start + n):
            return      # only elders hold blocks: wait for them to finish
        seq = req.context_tokens()
        cn = self.prefill_chunk
        chunk = seq[start:start + n] + [0] * (cn - n)
        # fixed table width per request footprint
        mbb = _next_pow2(self.sched._blocks_for(len(seq)))
        table = np.zeros((1, mbb), np.int32)
        table[0, : len(req.blocks)] = req.blocks
        next_tok, ok = self._run_step(
            ("chunk", cn, mbb), self._chunk_step_impl, self._chunk_inputs(
                np.asarray([chunk], np.int32), start, n, table, req.slot))
        self.step_counts["chunk"] += 1
        if not bool(ok):
            # poisoned mid-prefill: quarantine (pages scrubbed on eviction)
            self._evict_terminal(req, FAILED)
            return
        req.prefilled = start + n
        self.prefill_tokens += n
        if req.prefilled >= len(seq):
            if not req.output:      # fresh request: this IS the first token
                req.output.append(int(next_tok))
                req.first_token_time = self.clock()
            req.state = RUNNING

    # ------------------------------------------------------------------
    # Fused decode: embed, layer stack with the paged read, head, greedy
    # pick and one batched KV append. Host work per step is O(max_batch).
    # ------------------------------------------------------------------

    def _fused_step_impl(self, params, kv_state, ssm_state, tokens, lengths,
                         table, active):
        model = self.model
        sm_scale = self._sm_scale()

        x = model._embed_in(params, tokens[:, None])
        positions = lengths[:, None]

        def attn_read(q, enc, kv_slice, r):
            o_c, m_c, l_c = fd.paged_flash_decode_partial(
                q[:, 0], kv_slice["k"][r], kv_slice["v"][r], table, lengths,
                sm_scale=sm_scale, **self._page_kwargs(kv_slice, r))
            # the fresh token attends to itself as the cache will store
            # it; its KV lands in the pages after the stack
            out = fd.merge_partials(
                [(o_c[:, None], m_c[:, None], l_c[:, None]),
                 self._enc_read(q, enc)])
            return out.to(q.dtype)

        def ssm_step(x, pp_mix, st):
            x, nc = B.ssm_apply(x, pp_mix, self.cfg, cache=st)
            # inactive slots keep their state: a slot mid-way through
            # chunked prefill must not be advanced by the running batch's
            # decode (the SSM analogue of the null block for KV appends)
            return x, {leaf: torch.where(active.reshape(
                (-1,) + (1,) * (new.ndim - 1)), new, st[leaf])
                for leaf, new in nc.items()}

        body = self._make_stack_body(positions=positions,
                                     attn_read=attn_read, ssm_step=ssm_step)
        x, kv_ys, ssm_ys = self._run_stack(body, x, kv_state,
                                           self._ssm_xs(ssm_state))

        logits = model._head(params, x)[:, 0]
        next_tokens = logits.argmax(dim=-1)
        # per-row non-finite-logit flags; the host consults live rows only
        row_ok = torch.isfinite(logits.float()).all(dim=-1)

        if self._attn_pos:
            enc = self._collect_enc(kv_ys)
            # inactive slots -> the null block
            blk, off = C.append_slots(table, lengths, self.block_size,
                                      self.kv_cfg.n_blocks, active)
            C.write_token_encoded(kv_state, enc, blk, off)
        self._write_ssm(ssm_state, ssm_ys)
        new_lengths = torch.where(active, lengths + 1, lengths)
        return next_tokens, new_lengths, row_ok

    def _decode_fused(self, live: List[Request]) -> None:
        if not live:
            return
        bsz = self.max_batch
        tokens = np.zeros((bsz,), np.int32)
        lengths = np.zeros((bsz,), np.int32)
        active = np.zeros((bsz,), bool)
        mbb = _next_pow2(max(len(r.blocks) for r in live))
        table = np.zeros((bsz, mbb), np.int32)
        for r in live:
            tokens[r.slot] = r.output[-1]
            lengths[r.slot] = r.length - 1          # current KV length
            active[r.slot] = True
            table[r.slot, : len(r.blocks)] = r.blocks
        next_tokens, _, row_ok = self._run_step(
            ("decode", 1, mbb), self._fused_step_impl,
            dict(tokens=tokens, lengths=lengths, table=table, active=active))
        self.step_counts["decode"] += 1
        self._finish_step(live, next_tokens, row_ok=row_ok)

    # ------------------------------------------------------------------
    # Speculative decoding: ONE verify forward scores every running
    # request's window [last token, proposals...] through the shared
    # layer body (paged prefix read at T = window + fresh-window causal
    # partial, LSE-merged). A row with no proposals runs at depth 0, a
    # plain decode row. Accepted: the leading run of proposals equal to
    # the forward's own argmax; the argmax after it is the bonus token.
    # KV appends of rejected positions and inactive rows go to the null
    # block, so nothing needs rolling back.
    # ------------------------------------------------------------------

    def _verify_step_impl(self, params, kv_state, ssm_state, tokens, ctx,
                          n_valid, table, active):
        cn = tokens.shape[1]             # 1 + spec depth (bucketed)
        model = self.model
        sm_scale = self._sm_scale()
        dev = tokens.device

        x = model._embed_in(params, tokens)                  # (B, T, d)
        steps = torch.arange(cn, device=dev)
        positions = ctx[:, None] + steps[None, :]
        # per-row validity: [last token, proposals...] then padding; an
        # inactive slot has n_valid == 0 (the whole row inert)
        valid_rows = steps[None, :] < n_valid[:, None]

        def attn_read(q, enc, kv_slice, r):
            o_c, m_c, l_c = fd.paged_flash_prefix_partial(
                q, kv_slice["k"][r], kv_slice["v"][r], table, ctx,
                sm_scale=sm_scale, **self._page_kwargs(kv_slice, r))
            out = fd.merge_partials([(o_c, m_c, l_c),
                                     self._enc_read(q, enc)])
            return out.to(q.dtype)

        # no SSM layers: the engine refuses speculation on an SSM arch
        body = self._make_stack_body(positions=positions,
                                     attn_read=attn_read, ssm_step=None)
        x, kv_ys, _ = self._run_stack(body, x, kv_state,
                                      self._ssm_xs(ssm_state))

        logits = model._head(params, x)                      # (B, T, V)
        greedy = logits.argmax(dim=-1).int()
        # quarantine flags over the VALID window positions only (padded
        # positions compute values nothing reads)
        fin = torch.isfinite(logits.float()) | ~valid_rows[:, :, None]
        row_ok = fin.flatten(1).all(dim=1)
        # the proposals are the input tokens shifted left: count the
        # leading run where proposal == the model's own argmax
        match = ((tokens[:, 1:] == greedy[:, :-1])
                 & (steps[None, :-1] < (n_valid - 1)[:, None]))
        n_acc = torch.cumprod(match.int(), dim=1).sum(dim=1)   # (B,)

        if self._attn_pos:
            enc = self._collect_enc(kv_ys)          # rows: (B, T) C-order
            accepted = (steps[None, :] <= n_acc[:, None]) & active[:, None]
            blk, off = C.append_slots(
                table.repeat_interleave(cn, dim=0), positions.reshape(-1),
                self.block_size, self.kv_cfg.n_blocks, accepted.reshape(-1))
            C.write_token_encoded(kv_state, enc, blk, off)
        return greedy, n_acc, row_ok

    def _decode_spec(self, live: List[Request]) -> None:
        """One batched verify round over every live request: gather the
        proposals (oldest first), grow block tables for the speculative
        appends, run the verify step, emit accepted + bonus tokens. A
        request the proposer is silent on (or whose growth would need an
        elder's blocks) rides along at depth 0."""
        if not live:
            return
        bsz = self.max_batch
        width = self.spec.depth + 1
        tokens = np.zeros((bsz, width), np.int32)
        ctx = np.zeros((bsz,), np.int32)
        n_valid = np.zeros((bsz,), np.int32)
        active = np.zeros((bsz,), bool)
        n_props: Dict[int, int] = {}
        rows: List[Request] = []
        for r in sorted(live, key=lambda r: (r.arrival, r.rid)):
            if r.state != RUNNING:      # preempted by an elder's growth
                continue
            budget = r.max_new_tokens - len(r.output) - 1
            k = self.spec.depth_for(r, budget) if budget >= 1 else 0
            props = self.spec.propose(r, k) if k >= 1 else []
            # the window appends up to len(props)+1 tokens of KV; growth
            # can only preempt rows not yet gathered (strictly younger)
            if props and not self.sched.ensure_blocks(
                    r, r.length + len(props)):
                props = []
            tokens[r.slot, 0] = r.output[-1]
            tokens[r.slot, 1: 1 + len(props)] = props
            ctx[r.slot] = r.length - 1          # current KV length
            n_valid[r.slot] = 1 + len(props)
            active[r.slot] = True
            n_props[r.rid] = len(props)
            rows.append(r)
        if not rows:
            return
        mbb = _next_pow2(max(len(r.blocks) for r in rows))
        table = np.zeros((bsz, mbb), np.int32)
        for r in rows:
            table[r.slot, : len(r.blocks)] = r.blocks
        # window width bucketed to powers of two, capped at depth + 1
        t = min(_next_pow2(int(n_valid.max())), width)
        greedy, n_acc, row_ok = self._run_step(
            ("verify", t, mbb), self._verify_step_impl,
            dict(tokens=tokens[:, :t], ctx=ctx, n_valid=n_valid,
                 table=table, active=active))
        self.step_counts["verify"] += 1
        now = self.clock()
        for r in rows:
            if not row_ok[r.slot]:
                # quarantine: nothing the poisoned forward produced is
                # emitted or recorded; eviction scrubs its pages
                self._evict_terminal(r, FAILED)
                continue
            j = int(n_acc[r.slot])
            emitted = [int(tok) for tok in greedy[r.slot, : j + 1]]
            r.output.extend(emitted)
            self.decode_tokens += len(emitted)
            if n_props[r.rid]:
                self.spec.record(r, proposed=n_props[r.rid], accepted=j)
            if len(r.output) >= r.max_new_tokens:
                self.sched.finish(r, now)
                self.finished.append(r)

    def _scrub_preempted(self, victim: Request) -> None:
        """Zero a preemption victim's pages before the allocator reuses
        them, so a preempted-then-resumed schedule leaves the storage
        bit-identical to an uncontended one."""
        if victim.blocks:
            self.kv.truncate_slots(victim.blocks, 0)

    def _finish_step(self, live: List[Request], next_tokens,
                     row_ok=None) -> None:
        now = self.clock()
        for r in live:
            if row_ok is not None and not row_ok[r.slot]:
                # non-finite logits: quarantine the row without emitting
                self._evict_terminal(r, FAILED)
                continue
            r.output.append(int(next_tokens[r.slot]))
            self.decode_tokens += 1
            if len(r.output) >= r.max_new_tokens:
                self.sched.finish(r, now)
                self.finished.append(r)

    @torch.no_grad()
    def step(self) -> None:
        admitted = self.sched.admit(self.clock())
        if self.prefill_chunk is not None:
            for r in admitted:      # chunked prefill starts from zero state
                self._zero_ssm_slot(r.slot)
        t0 = self.clock()
        if self.prefill_chunk is None:
            if admitted:
                self._prefill(admitted)
        else:
            self._prefill_chunk_tick()
        self.prefill_time += self.clock() - t0
        # grow each decoding request's block table for this step's append;
        # under pressure this preempts strictly-younger request(s), so
        # states are re-checked after the loop, and a request that could
        # only grow by evicting an elder sits this step out
        deferred = set()
        for r in self.sched.decode_candidates():
            if r.state == RUNNING and \
                    not self.sched.ensure_blocks(r, r.length):
                deferred.add(r.rid)
        live = [r for r in self.sched.running
                if r is not None and r.state == RUNNING
                and r.rid not in deferred]
        t0 = self.clock()
        if self.spec is not None:
            self._decode_spec(live)
        else:
            self._decode_fused(live)
        self.decode_time += self.clock() - t0
        self.steps += 1

    def _progress_key(self):
        return (len(self.finished), self.sched.n_preemptions,
                len(self.sched.waiting), self.alloc.n_free,
                tuple((r.rid, r.state, r.prefilled, len(r.output))
                      for r in self.sched.running if r is not None))

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive steps until the schedule drains (or ``max_steps``)."""
        idle = 0
        key = self._progress_key()
        while self.sched.has_work and self.steps < max_steps:
            self.step()
            new_key = self._progress_key()
            if new_key == key:
                idle += 1
                if idle >= STALL_LIMIT:
                    raise StallError(idle, self.live_requests())
            else:
                idle, key = 0, new_key
        return self.finished

    def reset_stats(self) -> None:
        """Clear request history and counters, keeping the cache storage.
        Requires a quiescent engine."""
        if self.sched.has_work:
            raise RuntimeError("reset_stats() on an engine with live work")
        self.finished = []
        self.steps = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.decode_time = 0.0
        self.prefill_time = 0.0
        self.sched.n_preemptions = 0
        self.n_rejected = 0
        self.step_counts = Counter()
        if self.spec is not None:
            self.spec.reset()

    def stats(self) -> Dict[str, float]:
        """Flat stats with the reference's key names for the parts of the
        engine that are ported."""
        done = self.finished
        lat = [r.finish_time - r.arrival for r in done if r.finish_time]
        ttft = [t for t in (r.ttft() for r in done) if t is not None]
        tpot = [t for t in (r.tpot() for r in done) if t is not None]
        wall = (max((r.finish_time or 0.0) for r in done)
                - min(r.arrival for r in done)) if done else 0.0
        toks = sum(len(r.output) for r in done)
        causes = Counter(r.state for r in done)
        return {
            **(self.spec.stats() if self.spec is not None else {}),
            "requests": len(done),
            "finished": causes.get(FINISHED, 0),
            "failed": causes.get(FAILED, 0),
            "rejected": self.n_rejected,
            "throughput_tok_s": toks / wall if wall > 0 else 0.0,
            "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
            "p50_latency_s": _pct(lat, 50),
            "p99_latency_s": _pct(lat, 99),
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "p50_ttft_s": _pct(ttft, 50),
            "p95_ttft_s": _pct(ttft, 95),
            "p99_ttft_s": _pct(ttft, 99),
            "mean_tpot_s": float(np.mean(tpot)) if tpot else 0.0,
            "p50_tpot_s": _pct(tpot, 50),
            "p99_tpot_s": _pct(tpot, 99),
            "preemptions": self.sched.n_preemptions,
            "kv_utilization": self.alloc.utilization(),
            "decode_tokens": self.decode_tokens,
            "prefill_tokens": self.prefill_tokens,
            "decode_time_s": self.decode_time,
            "prefill_time_s": self.prefill_time,
            "decode_tok_s": (self.decode_tokens / self.decode_time
                             if self.decode_time > 0 else 0.0),
            "decode_steps": self.step_counts["decode"],
            "verify_steps": self.step_counts["verify"],
            "chunk_steps": self.step_counts["chunk"],
            "prefill_groups": self.step_counts["prefill"],
        }
