"""Speculative decoding: proposers and the acceptance/depth policy (the
port of ``repro.serving.speculate``).

A proposer guesses up to K continuation tokens of a running request; the
engine scores every request's window in ONE multi-token verify forward
(``Engine._verify_step_impl``) and keeps the proposals that equal the
forward's own argmax, plus the model's own (bonus) token at the first
disagreement, so greedy output equals non-speculative decode and every
round emits between 1 and K+1 tokens.

  * :class:`NGramProposer` — prompt lookup: the continuation of the most
    recent earlier occurrence of the context's tail n-gram.
  * :class:`DraftModelProposer` — a draft model decoded greedily for K
    tokens: each round prefills the whole context into a decode cache
    (``LM.prefill(max_len=)``) and takes K-1 ``LM.decode_step`` steps,
    whose attention read is the dense decode kernel on the card and
    whose SSM layers step their (conv, state) (an SSM draft's prefill
    scans through the SSD kernel). Stateless between rounds, so
    preemption needs no draft bookkeeping.

Under tensor parallelism (``Engine(mesh=)``) every rank runs the same
proposer: the n-gram proposer reads the host-global request, and a draft
model runs whole on every rank (an ``LM`` without a sharding context, as
the reference builds its ``LM(cfg)``), so a self-draft takes the full
tree, not a rank's shard.

Anything with ``.propose(request, k) -> list[int]`` plugs in. The
:class:`Speculator` owns the per-request adaptive depth (a fully accepted
round grows it toward the cap, a fully rejected one halves it, a partial
one settles at accepted + 1) and the counters ``Engine.stats()`` reports.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch


class NGramProposer:
    """Prompt-lookup proposer: continuation of the most recent earlier
    occurrence of the context's tail n-gram (longest n first)."""

    name = "ngram"

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, req, k: int) -> List[int]:
        ctx = np.asarray(req.tokens + req.output, np.int64)
        t = len(ctx)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if t <= n:
                continue
            tail = ctx[-n:]
            # candidate windows end strictly before the tail itself, so a
            # match always has at least one continuation token
            win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.nonzero((win == tail).all(axis=1))[0]
            if hits.size == 0:
                continue
            start = int(hits[-1]) + n          # most recent match
            return ctx[start: start + k].astype(np.int64).tolist()
        return []


class DraftModelProposer:
    """Greedy K-token continuation from a draft model.

    ``cfg`` is any config of the port's registry whose vocabulary matches
    the target's and whose decode read fits the dense decode kernel (at
    most 8 query heads a KV head: not chatglm3-6b's 16); ``params`` defaults to a fresh init from ``seed`` (the
    port's own generator, so not the reference's weights), and passing the
    target's params self-drafts. ``device`` is the card unless the caller
    passes ``"cpu"``. ``n_prefills`` and ``n_decode_steps`` count the
    draft's forwards (each ``decode_step`` reads the dense cache once per
    attention layer)."""

    name = "draft"

    def __init__(self, cfg, params=None, *, seed: int = 1, device=None):
        from repro_torch.kernels.flash_decode import _DENSE_MAX_G
        from repro_torch.models.lm import LM
        from repro_torch.models.params import tree_map

        if cfg.n_heads // max(cfg.n_kv_heads, 1) > _DENSE_MAX_G:
            # chatglm3-6b (32 heads over 2 KV heads) is such a config
            raise ValueError(
                f"draft config {cfg.name!r}: {cfg.n_heads} heads over "
                f"{cfg.n_kv_heads} KV heads; the draft's dense decode "
                f"kernel takes at most {_DENSE_MAX_G} query heads a KV head")
        self.cfg = cfg
        self.model = LM(cfg, ssd_impl="kernel", device=device)
        self.params = (tree_map(lambda t: t.to(self.model.device), params)
                       if params is not None else self.model.init(seed))
        self.n_prefills = 0
        self.n_decode_steps = 0

    def _tokens(self, toks) -> torch.Tensor:
        return torch.tensor(toks, dtype=torch.int32,
                            device=self.model.device)

    def propose(self, req, k: int) -> List[int]:
        ctx = req.tokens + req.output
        logits, cache, lengths = self.model.prefill(
            self.params, self._tokens([ctx]), max_len=len(ctx) + k)
        self.n_prefills += 1
        out = [int(logits[0].argmax())]
        for _ in range(k - 1):
            logits, cache = self.model.decode_step(
                self.params, cache, self._tokens([[out[-1]]]), lengths)
            self.n_decode_steps += 1
            lengths = lengths + 1
            out.append(int(logits[0].argmax()))
        return out


class Speculator:
    """Proposer wrapper + adaptive per-request depth + counters."""

    def __init__(self, proposer, *, depth: int = 4):
        if depth < 1:
            raise ValueError("spec_depth must be >= 1")
        self.proposer = proposer
        self.depth = depth
        # optional Telemetry (serving/telemetry.py), wired by the engine:
        # per-round proposed/accepted counts feed the step timeline
        self.tel = None
        self.reset()

    def reset(self) -> None:
        self.n_rounds = 0
        self.proposed_tokens = 0
        self.accepted_tokens = 0
        self.n_abandoned = 0
        self.depth_hist: Counter = Counter()

    def depth_for(self, req, budget: int) -> int:
        """Proposal width for this round: the request's adaptive depth,
        clipped so a fully-accepted round (+1 bonus token) cannot exceed
        its remaining generation budget."""
        if req.spec_depth <= 0:
            req.spec_depth = self.depth
        return min(req.spec_depth, budget)

    def propose(self, req, k: int) -> List[int]:
        return list(self.proposer.propose(req, k))[:k]

    def record(self, req, *, proposed: int, accepted: int) -> None:
        self.n_rounds += 1
        self.proposed_tokens += proposed
        self.accepted_tokens += accepted
        self.depth_hist[proposed] += 1
        if self.tel is not None:
            self.tel.spec_round(proposed, accepted)
        # back-off: full acceptance creeps back toward the cap, full
        # rejection halves, partial settles just past the accepted run
        if accepted >= proposed:
            req.spec_depth = min(self.depth, req.spec_depth + 1)
        elif accepted == 0:
            req.spec_depth = max(1, req.spec_depth // 2)
        else:
            req.spec_depth = max(1, min(self.depth, accepted + 1))

    def abandon(self, req) -> None:
        """A running request left the schedule mid-flight (cancelled,
        timed out, quarantined). Its window rolls back with its pages
        (rejected appends were null-writes, accepted ones are scrubbed on
        eviction), so only the abandonment is counted."""
        self.n_abandoned += 1
        if self.tel is not None and self.tel.enabled:
            self.tel.registry.count("spec_abandoned")

    def stats(self) -> Dict:
        return {
            "spec_rounds": self.n_rounds,
            "spec_proposed_tokens": self.proposed_tokens,
            "spec_accepted_tokens": self.accepted_tokens,
            "spec_abandoned": self.n_abandoned,
            "accept_rate": (self.accepted_tokens
                            / max(self.proposed_tokens, 1)),
            "spec_depth_hist": {str(k): v for k, v
                                in sorted(self.depth_hist.items())},
        }


def build_speculator(spec, target_cfg, *, depth: int = 4, device=None
                     ) -> Optional[Speculator]:
    """Resolve an Engine ``speculate=`` argument.

    ``None``/``"off"`` -> no speculation; ``"ngram"`` -> prompt lookup;
    ``"draft:<config>"`` -> a draft model from the port's registry
    (reduced when the target is a ``-smoke`` config), on ``device``; any
    object with ``.propose`` is wrapped as-is."""
    if spec is None or spec == "off":
        return None
    if hasattr(spec, "propose"):
        return Speculator(spec, depth=depth)
    if spec == "ngram":
        return Speculator(NGramProposer(), depth=depth)
    if isinstance(spec, str) and spec.startswith("draft:"):
        from repro_torch.configs import get_config

        name = spec.split(":", 1)[1]
        dcfg = get_config(name.removesuffix("-smoke"),
                          reduced=target_cfg.name.endswith("-smoke"))
        if dcfg.vocab_size != target_cfg.vocab_size:
            raise ValueError(
                f"draft config {dcfg.name!r} has vocab {dcfg.vocab_size}, "
                f"target {target_cfg.name!r} has {target_cfg.vocab_size}: "
                "speculation requires a shared tokenizer")
        return Speculator(DraftModelProposer(dcfg, device=device),
                          depth=depth)
    raise ValueError(
        f"unknown speculate spec {spec!r}; expected 'off', 'ngram', "
        "'draft:<config>' or a proposer object")
