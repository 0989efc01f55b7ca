"""Decoder-only language model: embed -> layer stack -> tied head.

The dense-family subset of ``repro.models.lm.LM``. Parameters are the
reference's tree as a nested dict of tensors, with every block leaf
stacked on a leading ``n_periods`` axis; layer ``i`` reads the views
``leaf[i]``. Whole-sequence attention is ``layers.attention`` in the
model's ``attn_impl`` mode: ``"naive"`` (the serving engine's) or
``"flash"`` (the flash kernels, for training).

``forward``/``prefill`` serve and run without autograd; ``backbone`` and
``loss`` are the training objective and build the autograd graph, with
each layer under ``train.remat.wrap_remat(..., remat)``. To train, make
the stacked leaves ``requires_grad`` (``train.step.init_train_state``):
each layer then reads them through one ``unbind``, so every layer's
gradient lands in its slice of the stacked gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import materialize, spec, tree_map
from repro_torch.train.remat import REMAT_MODES, wrap_remat

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


ATTN_IMPLS = ("naive", "flash")


class LM:
    """``device`` is the card unless the caller passes ``"cpu"``;
    ``attn_impl`` is a ``layers.attention`` mode and ``remat`` a
    ``train.remat`` policy (training only)."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str = "naive",
                 remat: str = "none",
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet; the port "
                f"runs the dense family")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not one of "
                             f"{ATTN_IMPLS}")
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.remat = remat
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
                                 attn_impl=self.attn_impl,
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

    # ------------------------------------------------------------------
    # Training objective
    # ------------------------------------------------------------------

    def _unstacked_layers(self, params) -> List[Dict]:
        """Per-layer parameter trees from ONE ``unbind`` of each stacked
        leaf: the backward then stacks all layers' gradients once
        instead of adding one full-size zero-padded slice per layer."""
        per_pos = [tree_map(lambda a: a.unbind(0),
                            params["blocks"][f"pos{p}"])
                   for p in range(self.period)]
        out = []
        for i in range(self.cfg.n_layers):
            per, pos = divmod(i, self.period)
            out.append(tree_map(lambda t: t[per], per_pos[pos]))
        return out

    def _layer(self, x, lp, positions):
        x, _ = B.attn_apply(x, lp["mix"], self.cfg, positions=positions,
                            attn_impl=self.attn_impl)
        return B.ffn_apply(x, lp["ffn"], self.cfg)

    def backbone(self, params, batch) -> torch.Tensor:
        """Everything before the LM head; returns final hidden states
        (B, T, d_model). Each layer runs under ``wrap_remat(remat)``."""
        x = self._embed_in(params, batch["tokens"])
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        body = wrap_remat(self._layer, self.remat)
        for lp in self._unstacked_layers(params):
            x = body(x, lp, positions)
        return x

    def _block_ce(self, params, xb, lb):
        """(sum of masked CE, token count) of one block: logits in f32
        over the whole padded vocabulary, labels < 0 masked."""
        logits = self._head(params, xb).float()
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(
            -1, lb.long().clamp_min(0)[..., None])[..., 0]
        mask = (lb >= 0).float()
        return ((lse - label_logit) * mask).sum(), mask.sum()

    def loss(self, params, batch, chunk_t: int = 512
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Causal-LM CE, computed block-wise over the sequence so the full
        (B, T, V) logits tensor is never materialized: each block applies
        the head + CE under checkpoint (recomputed in the backward).
        Returns ``(loss, {"ce", "aux"})``; the dense family has no MoE
        auxiliary loss, so ``aux`` is 0 and ``loss == ce``."""
        x = self.backbone(params, batch)
        labels = batch["labels"]
        _, t, _ = x.shape
        tc = min(chunk_t, t)
        while t % tc:
            tc //= 2
        ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_tok = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, t, tc):
            s, n = checkpoint(self._block_ce, params, x[:, c0:c0 + tc],
                              labels[:, c0:c0 + tc], use_reentrant=False,
                              preserve_rng_state=False)
            ce_sum = ce_sum + s
            n_tok = n_tok + n
        ce = ce_sum / torch.clamp_min(n_tok, 1.0)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return ce + aux, {"ce": ce, "aux": aux}
