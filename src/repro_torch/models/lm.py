"""Decoder-only language model: embed -> layer stack -> tied head.

The dense-family subset of ``repro.models.lm.LM``. Parameters are the
reference's tree as a nested dict of tensors, with every block leaf
stacked on a leading ``n_periods`` axis; layer ``i`` reads the views
``leaf[i]``. Whole-sequence attention is the plain ``naive_attention``
(the reference computes it with XLA einsums too, outside any kernel).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import materialize, spec, tree_map

VOCAB_PAD = 512


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def _period(cfg: ArchConfig) -> int:
    kinds = list(zip(cfg.layer_kinds(), cfg.ffn_kinds()))
    n = len(kinds)
    for p in range(1, n + 1):
        if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)):
            return p
    return n


class LM:
    """``device`` is the card unless the caller passes ``"cpu"``."""

    def __init__(self, cfg: ArchConfig, *,
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; the port "
                f"serves the dense family")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.period = _period(cfg)
        self.n_periods = cfg.n_layers // self.period
        self.kinds = cfg.layer_kinds()[: self.period]
        self.fkinds = cfg.ffn_kinds()[: self.period]
        self.vocab = padded_vocab(cfg.vocab_size)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def param_specs(self) -> Dict:
        cfg = self.cfg
        d, v = cfg.d_model, self.vocab
        blocks = {f"pos{i}": {"mix": B.attn_specs(cfg, self.n_periods),
                              "ffn": B.ffn_specs(cfg, self.n_periods)}
                  for i in range(self.period)}
        p = {
            "embed": spec((v, d), ("vocab", "embed")),
            "final_ln": spec((d,), ("embed",), "ones"),
            "blocks": blocks,
        }
        if not cfg.tie_embeddings:
            p["head"] = spec((d, v), ("embed", "vocab"))
        return p

    def init(self, seed: int = 0) -> Dict:
        """Seeded random init on ``self.device`` (fan-in-scaled normal)."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        return materialize(self.param_specs(), g, self.device)

    def layer_params(self, params, i: int) -> Dict:
        """Views of layer ``i``'s parameters in the stacked block tree."""
        per, pos = divmod(i, self.period)
        return tree_map(lambda a: a[per], params["blocks"][f"pos{pos}"])

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------

    def _embed_in(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocabulary (tied: x @ embed.T)."""
        x = L.rmsnorm(x, params["final_ln"], self.cfg.norm_eps)
        w = params["embed"].T if self.cfg.tie_embeddings else params["head"]
        return L.dense(x, w)

    # ------------------------------------------------------------------
    # Whole-sequence entry points
    # ------------------------------------------------------------------

    def _stack(self, params, x, *, return_kv: bool):
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = self.layer_params(params, i)
            x, kv = B.attn_apply(x, lp["mix"], cfg, positions=positions,
                                 return_kv=return_kv)
            if return_kv:
                ks.append(kv["k"])
                vs.append(kv["v"])
            x = B.ffn_apply(x, lp["ffn"], cfg)
        return x, ks, vs

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits (B, T, padded_vocab) for tokens (B, T)."""
        x = self._embed_in(params, tokens)
        x, _, _ = self._stack(params, x, return_kv=False)
        return self._head(params, x)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Run the prompt; returns (last_logits (B, V), cache, lengths).
        ``cache["pos0"]`` holds k/v stacked as (n_periods, B, T, K, hd),
        the layout of the reference's prefill cache."""
        b, t = tokens.shape
        x = self._embed_in(params, tokens)
        x, ks, vs = self._stack(params, x, return_kv=True)
        cache = {"pos0": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        logits = self._head(params, x[:, -1:, :])[:, 0]
        lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        return logits, cache, lengths
