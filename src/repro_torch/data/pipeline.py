"""Synthetic data (numpy only; the port's copy of the numpy part of
``repro.data.pipeline``): the serving prompts (random and repeated-
pattern) and the packed training batches. Same generators and draws as
the reference, so the two packages see identical tokens for one seed."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

ALPACA_MEAN_LEN = 350
SERVING_PROMPT_LEN = 512


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    mean_doc_len: int = ALPACA_MEAN_LEN
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    pack: bool = True
    pad_id: int = 0


class SyntheticLM:
    """Random-token documents at alpaca statistics, packed into training
    batches. Deterministic in (seed, host, step) — resumable."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {cfg.n_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _doc(self, rng: np.random.Generator) -> np.ndarray:
        n = max(8, int(rng.normal(self.cfg.mean_doc_len,
                                  self.cfg.mean_doc_len / 4)))
        return rng.integers(1, self.cfg.vocab_size,
                            size=n, dtype=np.int32)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"} int32 (local_batch, seq_len); labels are
        the tokens shifted by one, with padding masked as -1."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + cfg.host_id)
        rows = np.full((self.local_batch, cfg.seq_len + 1), cfg.pad_id,
                       np.int32)
        for i in range(self.local_batch):
            pos = 0
            while pos < cfg.seq_len + 1:
                doc = self._doc(rng)
                take = min(len(doc), cfg.seq_len + 1 - pos)
                rows[i, pos: pos + take] = doc[:take]
                pos += take
                if not cfg.pack:
                    break
        tokens = rows[:, :-1]
        labels = rows[:, 1:].copy()
        labels[labels == cfg.pad_id] = -1          # masked in the loss
        return {"tokens": tokens, "labels": labels}


def serving_requests(n: int, vocab: int, prompt_len: int = SERVING_PROMPT_LEN,
                     seed: int = 0, prompt_lens=None):
    """n synthetic prompts of ``prompt_len`` tokens, dispatched in a burst.
    ``prompt_lens`` (a sequence of lengths, cycled over requests) gives
    mixed-length traces."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = prompt_lens[i % len(prompt_lens)] if prompt_lens else prompt_len
        out.append(rng.integers(1, vocab, size=t, dtype=np.int32).tolist())
    return out


def repetitive_requests(n: int, vocab: int,
                        prompt_len: int = SERVING_PROMPT_LEN,
                        pattern_len: int = 8, seed: int = 0):
    """Repeated-pattern prompts: one random ``pattern_len``-token pattern
    tiled to ``prompt_len``, shared by all ``n`` requests (the trace on
    which the n-gram proposer fires)."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(1, vocab, size=pattern_len, dtype=np.int32).tolist()
    reps = -(-prompt_len // pattern_len)
    return [(pat * reps)[:prompt_len] for _ in range(n)]
