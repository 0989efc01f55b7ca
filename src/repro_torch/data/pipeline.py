"""Synthetic serving workload (numpy only; the port's copy of
``repro.data.pipeline.serving_requests``)."""
from __future__ import annotations

import numpy as np

SERVING_PROMPT_LEN = 512


def serving_requests(n: int, vocab: int, prompt_len: int = SERVING_PROMPT_LEN,
                     seed: int = 0, prompt_lens=None):
    """n synthetic prompts of ``prompt_len`` tokens, dispatched in a burst.
    ``prompt_lens`` (a sequence of lengths, cycled over requests) gives
    mixed-length traces. Same generator and draws as the reference, so
    the two packages serve identical prompts for one seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = prompt_lens[i % len(prompt_lens)] if prompt_lens else prompt_len
        out.append(rng.integers(1, vocab, size=t, dtype=np.int32).tolist())
    return out
