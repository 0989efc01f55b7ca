"""Synthetic data (the port of ``repro.data.pipeline``): the serving
prompts (random, repeated-pattern and shared-prefix), Poisson arrival
offsets and the packed training batches, all numpy, with the same
generators and draws as the reference, so the two packages see identical
tokens for one seed; and the :class:`Prefetcher`, which overlaps batch
synthesis and the host-to-device copy with the device's work."""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering of an iterator of batches
    (dicts of numpy arrays or tensors): a daemon thread fills a queue of
    ``depth`` batches. With a ``device`` the worker also copies each
    batch there, as the reference's ``device_put`` does: a CUDA copy goes
    through pinned host memory, ``non_blocking`` on the worker's own
    stream, and the consumer's stream waits on the copy's event before
    the batch is handed over; a CPU device gets tensors."""

    def __init__(self, it: Iterator, device: Optional[Union[
            str, torch.device]] = None, depth: int = 2):
        self.it = it
        self.device = None if device is None else torch.device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None
                        and self.device.type == "cuda" else None)
        self.t = threading.Thread(target=self._worker, daemon=True)
        self.t.start()

    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            if self._stream is not None:
                t = t.pin_memory()
                with torch.cuda.stream(self._stream):
                    out[k] = t.to(self.device, non_blocking=True)
            else:
                out[k] = t.to(self.device)
        if self._stream is None:
            return out, None
        event = torch.cuda.Event()
        event.record(self._stream)
        return out, event

    def _worker(self):
        for batch in self.it:
            if self._stop.is_set():
                return
            item = (self._to_device(batch) if self.device is not None
                    else (batch, None))
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            else:
                return

    def __iter__(self):
        return self

    def __next__(self):
        batch, event = self.q.get()
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
            for t in batch.values():     # the copy's memory is the worker's
                t.record_stream(torch.cuda.current_stream(self.device))
        return batch

    def stop(self):
        """Stop the worker at its next batch and let it exit."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.t.join(timeout=5.0)


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


def shared_prefix_requests(n: int, vocab: int, prefix_len: int = 48,
                           suffix_len: int = 8, seed: int = 0):
    """Shared-system-prompt trace: every request opens with the SAME
    ``prefix_len``-token prefix and appends its own random
    ``suffix_len``-token tail (the prefix cache's workload)."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(1, vocab, size=prefix_len, dtype=np.int32).tolist()
    return [prefix + rng.integers(1, vocab, size=suffix_len,
                                  dtype=np.int32).tolist()
            for _ in range(n)]


def poisson_arrivals(n: int, rate_rps: float, seed: int = 0) -> np.ndarray:
    """Cumulative arrival offsets (seconds from t0) of a Poisson process
    at ``rate_rps`` requests/second."""
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))
