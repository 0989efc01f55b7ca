"""Decoder-only language model: embed -> layer stack -> tied head.

The dense- and ssm-family subset of ``repro.models.lm.LM``. Parameters
are the reference's tree as a nested dict of tensors, with every block
leaf stacked on a leading ``n_periods`` axis; layer ``i`` reads the views
``leaf[i]``. Each period position mixes with attention or with a Mamba-2
(SSD) block, as ``cfg.layer_kinds()`` says, and every layer has a dense
FFN (zero-width for mamba2-130m's ``d_ff=0``, a no-op on the residual, as
in the reference). Whole-sequence attention is ``layers.attention`` in
the model's ``attn_impl`` mode: ``"naive"`` (the serving engine's) or
``"flash"`` (the flash kernels, for training). The SSD scan of an SSM
layer is ``models.ssd.ssd_chunked`` in the model's ``ssd_impl``:
``"ref"`` (the plain chunked reference) or ``"kernel"`` (the SSD kernel,
the counterpart of the reference's ``"pallas"``). An int8 (``QTensor``)
projection runs in the model's ``qmm_impl``: ``"kernel"`` (the int8
kernel) or ``"ref"`` (dequantize to the activation's type, the
reference's ``dense``); see ``layers.dense``.

``forward``/``prefill`` serve and run without autograd; ``init_cache``,
``prefill(max_len=)`` and ``decode_step`` decode the dense family against
a dense (B, max_len, K, hd) cache, whose read is the dense decode kernel
on the card (``blocks.attn_apply``'s decode branch). ``backbone`` and
``loss`` are the training objective of the dense family and build the
autograd graph, with each layer under ``train.remat.wrap_remat(...,
remat)``. To train, make the stacked leaves ``requires_grad``
(``train.step.init_train_state``): each layer then reads them through one
``unbind``, so every layer's gradient lands in its slice of the stacked
gradient.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ArchConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.params import (materialize, spec, tree_map,
                                       tree_unstack)
from repro_torch.models.ssd import SSD_IMPLS
from repro_torch.quant.qtensor import QTensor
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
FAMILIES = ("dense", "ssm")


class LM:
    """``device`` is the card unless the caller passes ``"cpu"``;
    ``attn_impl`` is a ``layers.attention`` mode, ``ssd_impl`` a
    ``models.ssd.ssd_chunked`` impl, ``qmm_impl`` a ``layers.dense`` route
    for int8 weights and ``remat`` a ``train.remat`` policy (training
    only)."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str = "naive",
                 ssd_impl: str = "ref", qmm_impl: str = "kernel",
                 remat: str = "none",
                 device: Optional[Union[str, torch.device]] = None):
        if cfg.family not in FAMILIES or cfg.is_moe:
            raise NotImplementedError(
                f"family {cfg.family!r}{' (MoE)' if cfg.is_moe else ''} "
                f"is not ported yet; the port runs the {'/'.join(FAMILIES)} "
                f"families without MoE")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not one of "
                             f"{ATTN_IMPLS}")
        if ssd_impl not in SSD_IMPLS:
            raise ValueError(f"ssd_impl {ssd_impl!r} not one of "
                             f"{SSD_IMPLS}")
        if qmm_impl not in L.QMM_IMPLS:
            raise ValueError(f"qmm_impl {qmm_impl!r} not one of "
                             f"{L.QMM_IMPLS}")
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.qmm_impl = qmm_impl
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
        mix = {"attn": B.attn_specs, "ssm": B.ssm_specs}
        blocks = {f"pos{i}": {"mix": mix[self.kinds[i]](cfg, self.n_periods),
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
        """Views of layer ``i``'s parameters in the stacked block tree
        (``QTensor``/``LoRATensor`` fields sliced, static fields kept)."""
        per, pos = divmod(i, self.period)
        return tree_map(lambda a: a[per], params["blocks"][f"pos{pos}"])

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------

    def _embed_in(self, params, tokens: torch.Tensor) -> torch.Tensor:
        table = params["embed"]
        if isinstance(table, QTensor):
            table = table.dequantize(torch.bfloat16)
        return table[tokens.long()]

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocabulary (tied: x @ embed.T). A
        quantized tied table is dequantized first, as in the reference:
        its scales lie along the head's output axis, not the int8
        kernel's K rows."""
        x = L.rmsnorm(x, params["final_ln"], self.cfg.norm_eps)
        if not self.cfg.tie_embeddings:
            return L.dense(x, params["head"], qmm_impl=self.qmm_impl)
        w = params["embed"]
        if isinstance(w, QTensor):
            w = w.dequantize(x.dtype)
        return L.dense(x, w.T)

    # ------------------------------------------------------------------
    # Whole-sequence entry points
    # ------------------------------------------------------------------

    def _stack(self, params, x, *, return_cache: bool):
        """The layer stack over a whole sequence; with ``return_cache``
        also each layer's fresh k/v (attention) or resume state (SSM),
        as per-position lists over the periods."""
        cfg = self.cfg
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        caches: Dict[int, list] = {pos: [] for pos in range(self.period)}
        for i in range(cfg.n_layers):
            lp = self.layer_params(params, i)
            pos = i % self.period
            if self.kinds[pos] == "attn":
                x, c = B.attn_apply(x, lp["mix"], cfg, positions=positions,
                                    attn_impl=self.attn_impl,
                                    return_kv=return_cache,
                                    qmm_impl=self.qmm_impl)
            else:
                x, c = B.ssm_apply(x, lp["mix"], cfg,
                                   ssd_impl=self.ssd_impl,
                                   return_state=return_cache)
            caches[pos].append(c)
            x = B.ffn_apply(x, lp["ffn"], cfg, qmm_impl=self.qmm_impl)
        return x, caches

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence logits (B, T, padded_vocab) for tokens (B, T)."""
        x = self._embed_in(params, tokens)
        x, _ = self._stack(params, x, return_cache=False)
        return self._head(params, x)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Run the prompt; returns (last_logits (B, V), cache, lengths).
        ``cache[f"pos{i}"]`` holds, stacked over the periods, k/v as
        (n_periods, B, max_len, K, hd) for an attention position (the T
        prompt positions, then zeros up to ``max_len``, default T: the
        reference's ``_prefill_to_cache``) and ``{"conv": (n_periods, B,
        W-1, C), "state": (n_periods, B, H, P, N)}`` for an SSM one: the
        layout of the reference's prefill cache."""
        b, t = tokens.shape
        x = self._embed_in(params, tokens)
        x, caches = self._stack(params, x, return_cache=True)
        pad = max(0, (max_len or t) - t)
        cache = {}
        for pos, cs in caches.items():
            stacked = {leaf: torch.stack([c[leaf] for c in cs])
                       for leaf in cs[0]}
            if self.kinds[pos] == "attn" and pad:      # (.., T, K, hd)
                stacked = {leaf: torch.nn.functional.pad(
                    a, (0, 0, 0, 0, 0, pad)) for leaf, a in stacked.items()}
            cache[f"pos{pos}"] = stacked
        logits = self._head(params, x[:, -1:, :])[:, 0]
        lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        return logits, cache, lengths

    def _require_dense(self, what: str) -> None:
        if "ssm" in self.kinds:
            raise NotImplementedError(
                f"{what} of the ssm family is not ported (the reference's "
                f"per-token ssd_decode_scan is a later slice)")

    def init_cache(self, batch: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16) -> Dict:
        """Zero dense decode cache: per attention position, k and v as
        (n_periods, batch, max_len, K, hd) (two tensors: decode writes
        them in place). Only float caches: the reference's ``int8`` cache
        casts k/v with no scale, which the port does not copy."""
        self._require_dense("init_cache")
        if not dtype.is_floating_point:
            raise NotImplementedError(
                f"a {dtype} dense cache is not ported (the reference casts "
                f"k/v to it with no scale)")
        cfg = self.cfg
        shape = (self.n_periods, batch, max_len, cfg.n_kv_heads,
                 cfg.head_dim)
        return {f"pos{i}": {leaf: torch.zeros(shape, dtype=dtype,
                                              device=self.device)
                            for leaf in ("k", "v")}
                for i in range(self.period)}

    @torch.no_grad()
    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens (B, 1), lengths (B,) int32 current KV
        lengths. Each layer writes its new k/v at ``lengths`` in ``cache``
        (in place) and attends ``lengths + 1`` positions through the dense
        decode read. Returns (logits (B, V), cache)."""
        self._require_dense("decode_step")
        cfg = self.cfg
        x = self._embed_in(params, tokens)
        positions = lengths[:, None]
        for i in range(cfg.n_layers):
            lp = self.layer_params(params, i)
            per, pos = divmod(i, self.period)
            c = cache[f"pos{pos}"]
            x, _ = B.attn_apply(x, lp["mix"], cfg, positions=positions,
                                attn_impl=self.attn_impl,
                                qmm_impl=self.qmm_impl,
                                cache={"k": c["k"][per], "v": c["v"][per]},
                                lengths=lengths)
            x = B.ffn_apply(x, lp["ffn"], cfg, qmm_impl=self.qmm_impl)
        return self._head(params, x)[:, 0], cache

    # ------------------------------------------------------------------
    # Training objective
    # ------------------------------------------------------------------

    def _unstacked_layers(self, params) -> List[Dict]:
        """Per-layer parameter trees from ONE ``unbind`` of each stacked
        leaf (``params.tree_unstack``)."""
        per_pos = [tree_unstack(params["blocks"][f"pos{p}"], self.n_periods)
                   for p in range(self.period)]
        return [per_pos[i % self.period][i // self.period]
                for i in range(self.cfg.n_layers)]

    def _layer(self, x, lp, positions):
        x, _ = B.attn_apply(x, lp["mix"], self.cfg, positions=positions,
                            attn_impl=self.attn_impl, qmm_impl=self.qmm_impl)
        return B.ffn_apply(x, lp["ffn"], self.cfg, qmm_impl=self.qmm_impl)

    def backbone(self, params, batch) -> torch.Tensor:
        """Everything before the LM head; returns final hidden states
        (B, T, d_model). Each layer runs under ``wrap_remat(remat)``.
        Dense family only: the reference's SSD kernel has no backward, and
        training the SSM family is not ported."""
        if "ssm" in self.kinds:
            raise NotImplementedError(
                "training the ssm family is not ported (the SSD kernel has "
                "no backward)")
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
