"""Language model: embed -> layer stack -> head, for every family.

The port of ``repro.models.lm.LM``: the dense, moe, ssm, hybrid,
encoder-decoder (encdec) and vision-language (vlm) families. Parameters
are the reference's tree as a nested dict of tensors, with every block
leaf stacked on a leading ``n_periods`` axis; layer ``i`` reads the views
``leaf[i]``. Each period position mixes with attention or with a Mamba-2
(SSD) block, as ``cfg.layer_kinds()`` says, and has a dense FFN
(zero-width for mamba2-130m's ``d_ff=0``, a no-op on the residual, as in
the reference) or an MoE FFN, as ``cfg.ffn_kinds()`` says (jamba's period
of 8: attention at offset 4, MoE at the odd offsets). An MoE FFN's expert
capacity scales with the reference's ``capacity_mult`` of each entry
point: 1.0 in ``forward`` (its train mode), 4.0 in ``prefill``, 2.0 in
``decode_step``. Whole-sequence attention is ``layers.attention`` in the
model's ``attn_impl`` mode: ``"naive"`` (the serving engine's) or
``"flash"`` (the flash kernels, for training). The SSD scan of an SSM
layer is ``models.ssd.ssd_chunked`` in the model's ``ssd_impl``:
``"ref"`` (the plain chunked reference) or ``"kernel"`` (the SSD kernel,
the counterpart of the reference's ``"pallas"``). An int8 (``QTensor``)
projection runs in the model's ``qmm_impl``: ``"kernel"`` (the int8
kernel) or ``"ref"`` (dequantize to the activation's type, the
reference's ``dense``); see ``layers.dense``.

**Frontends.** Both frontends are stubs, as in the reference: callers
pass precomputed embeddings ``frontend_embeds`` (B, F, d_model), which
``frontend_proj`` projects. The vlm family prepends them to the token
embeddings (its positions run over patches and tokens; its loss counts
the token span only). The encdec family runs them through the encoder
(``enc_blocks``: non-causal self-attention in ``attn_impl``, RoPE at the
frame positions, and an FFN, then ``enc_final_ln``); every decoder layer
then adds cross-attention on the encoder output
(``blocks.cross_attn_apply``), whose k/v the prefill cache carries.

``forward``/``prefill`` serve and run without autograd; ``init_cache``,
``prefill(max_len=)`` and ``decode_step`` decode every family against a
dense (B, max_len, K, hd) attention cache, whose read is the dense decode
kernel on the card (``blocks.attn_apply``'s decode branch), and a
per-layer (conv, state) SSM cache advanced by the single-token
recurrence; both are updated in place. ``backbone`` and ``loss`` are the
training objective of every family (the causal-LM CE plus
``moe_aux_coef`` times the MoE load-balancing loss averaged over the
layers, the reference's) and build the autograd graph, with each decoder
layer under ``train.remat.wrap_remat(..., remat)`` (the encoder runs
without it, as the reference's encoder scan does). An SSM layer trains
through ``ssd_impl="ref"``, the reference's training route (the SSD
kernel, like the TPU kernel, has no backward). To train, make the stacked
leaves ``requires_grad`` (``train.step.init_train_state``): each layer
then reads them through one ``unbind``, so every layer's gradient lands in
its slice of the stacked gradient.

**Tensor parallelism.** ``LM(cfg, ctx=)`` (a ``parallel.sharding.
ShardCtx``) serves this rank's part of a model sharded over the model
axis: ``params`` is its slice of the tree (``sharding.shard_params``),
``forward``, ``prefill`` and ``decode_step`` run the blocks on its heads
and MLP width with the row-parallel seams summed over the axis (an MoE
FFN on its experts, expert-parallel: ``blocks.moe_apply``), the
embedding is whole on every rank, and the head's vocab-sharded logits
are gathered, so every rank returns the whole logits. ``init_cache`` and
``prefill``'s cache hold the KV heads and SSM heads the rank stores.
Over a data axis (``ctx`` with ``dp_size > 1``) an MoE layer routes with
the global batch's statistics, order and capacity.

**Training over a model axis** (Megatron-style, the reference's GSPMD
program; every family but the encoder-decoder one): ``loss`` and
``backbone`` run each layer on the rank's heads and MLP columns, entered
through Megatron's f (``layers.dense_column``: the products' input
cotangent summed over the axis in f32, rounded once) and left through g
(``ShardCtx.exit_block``). Under sequence parallelism (``Technique.sp``)
the residual stream holds this rank's rows of T (``ShardCtx.own_rows``):
the norms run on them, each block gathers T on entry and reduce-scatters
its row-parallel partials on exit. Without it the stream is whole on
every rank, and only the rank's rows of the embedded sequence (a vlm's
patches included) carry its gradient, so the ranks' embedding and
``frontend_proj`` gradients add up to the whole
(:meth:`LM.model_summed`). An MoE layer whose experts the axis divides
runs expert parallelism under autograd (``blocks._moe_ep``: the rank's
t-slice routed at its own capacity, the exchange's backward the reverse
exchange); a Mamba-2 layer runs its SSD heads, its gated norm's row
statistics summed over the axis under autograd
(``kernels.ops.rmsnorm_split``). The loss is a
vocab-parallel cross-entropy (:func:`vocab_parallel_ce`): each rank's
logits block holds its ``V/tp`` columns of the padded vocabulary (the
untied ``head`` is cut so; the tied ``embed`` stays whole and is sliced
at use, as the reference constrains ``w.T`` to ``"head"``), and the max,
the sum of exponentials and the label's logit are summed over the axis
in f32. In sequence mode (``ShardCtx.attn_mode == "seq"``) the
attention blocks run on the rank's rows of T with the whole attention
leaves (``blocks._attn_seq``), which :meth:`LM.model_summed` then lists.
The encoder-decoder family raises under a model axis (ROADMAP queue 1
item 7.10).

**ZeRO-3.** Training over a data axis (``train.step``) passes ``loss``
and ``backbone`` a tree whose leaves may be ``parallel.zero.Shard``s,
this rank's pieces of the parameters. Each decoder or encoder layer
gathers its leaves (one exact collective, ``zero.gather_used``) inside
the body its remat policy wraps, so the forward frees them and the
recomputation gathers them again; the embedding, final norm, head and
frontend/encoder norms are gathered once a micro-batch
(``zero.gather_top``). With plain tensors both are no-ops.
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
from repro_torch.models.ssd import SSD_IMPLS
from repro_torch.parallel import zero as Z
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
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# the reference's MoE capacity multiplier of each mode (its lm.py)
CAPACITY_MULT = {"train": 1.0, "prefill": 4.0, "decode": 2.0}


class LM:
    """``device`` is the card unless the caller passes ``"cpu"``;
    ``attn_impl`` is a ``layers.attention`` mode, ``ssd_impl`` a
    ``models.ssd.ssd_chunked`` impl, ``qmm_impl`` a ``layers.dense`` route
    for int8 weights, ``remat`` a ``train.remat`` policy (training
    only) and ``moe_aux_coef`` the weight of the MoE load-balancing loss
    in :meth:`loss`."""

    def __init__(self, cfg: ArchConfig, *, attn_impl: str = "naive",
                 ssd_impl: str = "ref", qmm_impl: str = "kernel",
                 remat: str = "none", moe_aux_coef: float = 0.01,
                 device: Optional[Union[str, torch.device]] = None,
                 ctx=None):
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} not one of {FAMILIES}")
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
        self.moe_aux_coef = moe_aux_coef
        self.ctx = ctx
        self.device = resolve_device(device)
        self.period = _period(cfg)
        self.n_periods = cfg.n_layers // self.period
        self.kinds = cfg.layer_kinds()[: self.period]
        self.fkinds = cfg.ffn_kinds()[: self.period]
        self.vocab = padded_vocab(cfg.vocab_size)

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------

    def _block_specs(self, cross: bool) -> Dict:
        cfg, n_stack = self.cfg, self.n_periods
        mix = {"attn": B.attn_specs, "ssm": B.ssm_specs}
        ffn = {"dense": B.ffn_specs, "moe": B.moe_specs}
        out = {}
        for i in range(self.period):
            pos = {"mix": mix[self.kinds[i]](cfg, n_stack)}
            if cross:
                pos["cross"] = B.cross_attn_specs(cfg, n_stack)
            pos["ffn"] = ffn[self.fkinds[i]](cfg, n_stack)
            out[f"pos{i}"] = pos
        return out

    def param_specs(self) -> Dict:
        cfg = self.cfg
        d, v = cfg.d_model, self.vocab
        p = {
            "embed": spec((v, d), ("vocab", "embed")),
            "final_ln": spec((d,), ("embed",), "ones"),
            "blocks": self._block_specs(cross=bool(cfg.n_enc_layers)),
        }
        if not cfg.tie_embeddings:
            p["head"] = spec((d, v), ("embed", "vocab"))
        if cfg.n_enc_layers:
            p["enc_blocks"] = {"pos0": {
                "mix": B.attn_specs(cfg, cfg.n_enc_layers),
                "ffn": B.ffn_specs(cfg, cfg.n_enc_layers)}}
            p["enc_final_ln"] = spec((d,), ("embed",), "ones")
        if cfg.frontend != "none":
            p["frontend_proj"] = spec((d, d), ("embed", "null"))
        return p

    def init(self, seed: int = 0, pieces: bool = False) -> Dict:
        """Seeded random init on ``self.device`` (fan-in-scaled normal).
        With ``pieces`` under a model axis of more than one rank, this
        rank's pieces of that tree (``sharding.param_piece``), drawn a
        layer slice at a time: the whole tree is never held."""
        g = torch.Generator(device=self.device).manual_seed(seed)
        piece = None
        if pieces and self.ctx is not None and self.ctx.size > 1:
            from repro_torch.parallel.sharding import (logical_by_path_of,
                                                       param_piece)
            table = logical_by_path_of(self.param_specs())

            def piece(path, t):
                return param_piece(self.ctx, path, t, table[path])
        return materialize(self.param_specs(), g, self.device, piece)

    def layer_params(self, params, i: int) -> Dict:
        """Views of layer ``i``'s parameters in the stacked block tree
        (``QTensor``/``LoRATensor`` fields sliced, static fields kept)."""
        per, pos = divmod(i, self.period)
        return tree_map(lambda a: a[per], params["blocks"][f"pos{pos}"])

    # ------------------------------------------------------------------
    # Embedding / head
    # ------------------------------------------------------------------

    def _embed_in(self, params, tokens: torch.Tensor,
                  frontend_embeds: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
        """Token embeddings; the vlm family prepends ``frontend_proj`` of
        ``frontend_embeds``, cast to the embeddings' type."""
        table = params["embed"]
        if isinstance(table, QTensor):
            table = table.dequantize(torch.bfloat16)
        x = table[tokens.long()]
        if frontend_embeds is not None and self.cfg.family == "vlm":
            fe = L.dense(frontend_embeds, params["frontend_proj"],
                         qmm_impl=self.qmm_impl)
            x = torch.cat([fe.to(x.dtype), x], dim=1)
        return x

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Logits over the padded vocabulary (tied: x @ embed.T). A
        quantized tied table is dequantized first, as in the reference:
        its scales lie along the head's output axis, not the int8
        kernel's K rows."""
        x = L.rmsnorm(x, params["final_ln"], self.cfg.norm_eps)
        if not self.cfg.tie_embeddings:
            logits = L.dense(x, params["head"], qmm_impl=self.qmm_impl)
            if self.ctx is None:
                return logits
            return self.ctx.gather_last(logits, self.vocab)
        w = params["embed"]
        if isinstance(w, QTensor):
            w = w.dequantize(x.dtype)
        return L.dense(x, w.T)

    # ------------------------------------------------------------------
    # Encoder (encdec)
    # ------------------------------------------------------------------

    def _encoder_in(self, params, frontend_embeds) -> Optional[torch.Tensor]:
        """The encoder output for an encdec model, else None."""
        if not self.cfg.n_enc_layers:
            return None
        if frontend_embeds is None:
            raise ValueError(f"{self.cfg.name}: the encoder-decoder family "
                             f"needs frontend_embeds")
        return self._encode(params, frontend_embeds)

    def _encode(self, params, frontend_embeds) -> torch.Tensor:
        """``frontend_proj``, then ``n_enc_layers`` of non-causal
        self-attention (``attn_impl``; RoPE at positions ``arange(F)``) and
        the FFN, then ``enc_final_ln``. Each layer reads its slice of the
        stacked ``enc_blocks`` through one ``unbind`` (differentiable)."""
        cfg = self.cfg
        x = L.dense(frontend_embeds, params["frontend_proj"],
                    qmm_impl=self.qmm_impl)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        for lp in Z.unstack(params["enc_blocks"]["pos0"], cfg.n_enc_layers):
            lp = Z.gather_used(lp)
            x, _ = B.attn_apply(x, lp["mix"], cfg, positions=positions,
                                attn_impl=self.attn_impl, causal=False,
                                qmm_impl=self.qmm_impl)
            x = B.ffn_apply(x, lp["ffn"], cfg, qmm_impl=self.qmm_impl)
        return L.rmsnorm(x, params["enc_final_ln"], cfg.norm_eps)

    # ------------------------------------------------------------------
    # Whole-sequence entry points
    # ------------------------------------------------------------------

    def _stack(self, params, x, *, return_cache: bool, mode: str,
               enc_out: Optional[torch.Tensor] = None):
        """The layer stack over a whole sequence; with ``return_cache``
        also each layer's fresh k/v (attention) or resume state (SSM),
        and for encdec its cross k/v, as per-position lists over the
        periods (``{"self": ..., "cross": ...}`` with cross-attention).
        ``mode`` sets the MoE capacity (``CAPACITY_MULT``)."""
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
                                    qmm_impl=self.qmm_impl, ctx=self.ctx)
            else:
                x, c = B.ssm_apply(x, lp["mix"], cfg,
                                   ssd_impl=self.ssd_impl,
                                   return_state=return_cache, ctx=self.ctx)
            if "cross" in lp:
                ckv = B.cross_kv(enc_out, lp["cross"], cfg,
                                 qmm_impl=self.qmm_impl)
                x = B.cross_attn_apply(x, ckv, lp["cross"], cfg,
                                       qmm_impl=self.qmm_impl)
                c = {"self": c, "cross": ckv}
            caches[pos].append(c)
            x = B.ffn_or_moe(x, lp["ffn"], cfg, self.fkinds[pos],
                             CAPACITY_MULT[mode], qmm_impl=self.qmm_impl,
                             ctx=self.ctx)
        return x, caches

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """Full-sequence logits (B, T', padded_vocab) for tokens (B, T)
        and, for the encdec and vlm families, ``frontend_embeds`` (B, F,
        d_model); T' = F + T for vlm, T otherwise."""
        enc_out = self._encoder_in(params, frontend_embeds)
        x = self._embed_in(params, tokens, frontend_embeds)
        x, _ = self._stack(params, x, return_cache=False, mode="train",
                           enc_out=enc_out)
        return self._head(params, x)

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor,
                max_len: Optional[int] = None,
                frontend_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict, torch.Tensor]:
        """Run the prompt; returns (last_logits (B, V), cache, lengths).
        ``cache[f"pos{i}"]`` holds, stacked over the periods, k/v as
        (n_periods, B, S, K, hd) for an attention position and ``{"conv":
        (n_periods, B, W-1, C), "state": (n_periods, B, H, P, N)}`` for an
        SSM one: the layout of the reference's prefill cache. S is the
        prompt's T' positions (F + T for vlm), then zeros up to
        ``max_len`` (default T, the reference's: a vlm prompt then fills
        its cache, and the decode writes that follow are clipped to the
        last slot, as there). For encdec each position's entry is
        ``{"self": ..., "cross": {"k", "v"}}``, the cross k/v (n_periods,
        B, F, K, hd) from the encoder output. ``lengths`` (B,) is T'."""
        b, t = tokens.shape
        enc_out = self._encoder_in(params, frontend_embeds)
        x = self._embed_in(params, tokens, frontend_embeds)
        x, caches = self._stack(params, x, return_cache=True,
                                mode="prefill", enc_out=enc_out)
        pad = max(0, (max_len or t) - x.shape[1])

        def stack(cs, attn: bool):
            out = {leaf: torch.stack([c[leaf] for c in cs])
                   for leaf in cs[0]}
            if attn and pad:                             # (.., T', K, hd)
                out = {leaf: torch.nn.functional.pad(
                    a, (0, 0, 0, 0, 0, pad)) for leaf, a in out.items()}
            return out

        cache = {}
        for pos, cs in caches.items():
            attn = self.kinds[pos] == "attn"
            if self.cfg.n_enc_layers:
                cache[f"pos{pos}"] = {
                    "self": stack([c["self"] for c in cs], attn),
                    "cross": stack([c["cross"] for c in cs], False)}
            else:
                cache[f"pos{pos}"] = stack(cs, attn)
        logits = self._head(params, x[:, -1:, :])[:, 0]
        lengths = torch.full((b,), x.shape[1], dtype=torch.int32,
                             device=x.device)
        return logits, cache, lengths

    def init_cache(self, batch: int, max_len: int, src_len: int = 0,
                   dtype: torch.dtype = torch.bfloat16) -> Dict:
        """Zero decode cache in the layout of :meth:`prefill`'s: per
        attention position k and v as (n_periods, batch, max_len, K, hd)
        in ``dtype`` (two tensors: decode writes them in place; an
        integer type is the reference's unscaled cast,
        ``blocks.cache_cast``), per SSM position f32 conv and state
        stacked over the periods, and for encdec zero cross k/v of
        ``src_len`` source positions."""
        cfg = self.cfg
        kv_shape = (self.n_periods, batch, max_len, self.kv_heads_held(),
                    cfg.head_dim)
        ssm = (B.ssm_init_cache(cfg, batch, ctx=self.ctx)
               if "ssm" in self.kinds else {})

        def zeros(shape, dt):
            return torch.zeros(shape, dtype=dt, device=self.device)

        cache: Dict = {}
        for i in range(self.period):
            if self.kinds[i] == "attn":
                c = {leaf: zeros(kv_shape, dtype) for leaf in ("k", "v")}
            else:
                c = {leaf: zeros((self.n_periods,) + tuple(a.shape), a.dtype)
                     for leaf, a in ssm.items()}
            if cfg.n_enc_layers:
                src = kv_shape[:2] + (src_len,) + kv_shape[3:]
                c = {"self": c, "cross": {leaf: zeros(src, dtype)
                                          for leaf in ("k", "v")}}
            cache[f"pos{i}"] = c
        return cache

    def kv_heads_held(self) -> int:
        """KV heads of this rank's attention caches: K/tp where the model
        axis divides them, else all K."""
        k = self.cfg.n_kv_heads
        if self.ctx is None:
            return k
        lo, hi = self.ctx.part(k)
        return hi - lo

    @torch.no_grad()
    def decode_step(self, params, cache: Dict, tokens: torch.Tensor,
                    lengths: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One decode step: tokens (B, 1), lengths (B,) int32 current KV
        lengths. Each attention layer writes its new k/v at ``lengths``
        in ``cache`` (in place) and attends ``lengths + 1`` positions
        through the dense decode read; each SSM layer advances its (conv,
        state) by the token, in place; an encdec layer reads its cross
        k/v. Returns (logits (B, V), cache)."""
        cfg = self.cfg
        x = self._embed_in(params, tokens)
        positions = lengths[:, None]
        for i in range(cfg.n_layers):
            lp = self.layer_params(params, i)
            per, pos = divmod(i, self.period)
            ci = cache[f"pos{pos}"]
            c = ci["self"] if "cross" in lp else ci
            if self.kinds[pos] == "attn":
                x, _ = B.attn_apply(x, lp["mix"], cfg, positions=positions,
                                    attn_impl=self.attn_impl,
                                    qmm_impl=self.qmm_impl,
                                    cache={"k": c["k"][per],
                                           "v": c["v"][per]},
                                    lengths=lengths, ctx=self.ctx)
            else:
                st = {leaf: a[per] for leaf, a in c.items()}
                x, new = B.ssm_apply(x, lp["mix"], cfg, cache=st,
                                     ctx=self.ctx)
                for leaf, a in new.items():
                    st[leaf].copy_(a)
            if "cross" in lp:
                x = B.cross_attn_apply(
                    x, {leaf: a[per] for leaf, a in ci["cross"].items()},
                    lp["cross"], cfg, qmm_impl=self.qmm_impl)
            x = B.ffn_or_moe(x, lp["ffn"], cfg, self.fkinds[pos],
                             CAPACITY_MULT["decode"], qmm_impl=self.qmm_impl,
                             ctx=self.ctx)
        return self._head(params, x)[:, 0], cache

    # ------------------------------------------------------------------
    # Training objective
    # ------------------------------------------------------------------

    def _unstacked_layers(self, params) -> List[Dict]:
        """Per-layer parameter trees from ONE ``unbind`` of each stacked
        leaf (``params.tree_unstack``)."""
        per_pos = [Z.unstack(params["blocks"][f"pos{p}"], self.n_periods)
                   for p in range(self.period)]
        return [per_pos[i % self.period][i // self.period]
                for i in range(self.cfg.n_layers)]

    def _tp(self) -> bool:
        """Whether this model trains over a model axis of more than one
        rank."""
        return self.ctx is not None and self.ctx.size > 1

    def model_summed(self, t: int) -> List[str]:
        """Key paths (``tree_paths``' spelling) of the leaves each rank
        holds whole but whose gradient it computes only in part under a
        model axis on sequences of ``t`` positions, so the step sums them
        over the axis: the embedding and a vlm's ``frontend_proj`` (the
        rank's rows of the embedded sequence, and for a tied table the
        rank's vocab slice of the head), the block norms under sequence
        parallelism (the rank's rows), in head mode wk/wv and their
        biases where the degree does not divide the KV heads (the heads
        its q heads read) and Qwen3's per-head q/k norms (applied to the
        rank's heads), and in sequence mode every attention leaf
        where the axis splits T (the rank's rows; where it does not,
        every rank attends the whole sequence); an MoE FFN's ``router``
        under expert parallelism (the rank's t-slice); a Mamba-2 block's
        ``a_log``, ``d_skip`` and ``dt_bias`` (replicated, read at the
        rank's heads) and the B and C runs of ``in_proj``, ``conv_w`` and
        ``conv_b`` (whole on every rank, read by its heads; the step sums
        those runs only). Empty without a model axis."""
        if not self._tp():
            return []
        ctx, cfg = self.ctx, self.cfg
        seq = ctx.attn_mode == "seq"
        out = ["embed"]
        if cfg.frontend != "none":
            out.append("frontend_proj")
        blocks = self.param_specs()["blocks"]
        for pos in range(self.period):
            blk = f"blocks/pos{pos}"
            mix = blocks[f"pos{pos}"]["mix"]
            if self.kinds[pos] == "ssm":
                out += [f"{blk}/mix/{w}" for w in (
                    "in_proj", "conv_w", "conv_b", "a_log", "d_skip",
                    "dt_bias")]
                if ctx.sp:
                    out.append(f"{blk}/mix/ln")
            elif seq and ctx.seq_splits(t):
                out += [f"{blk}/mix/{w}" for w in mix]
            else:
                if ctx.sp:
                    out.append(f"{blk}/mix/ln")
                if not seq:
                    out += [f"{blk}/mix/{w}" for w in ("q_norm", "k_norm")
                            if w in mix]
                if not seq and not ctx.splits(cfg.n_kv_heads):
                    out += [f"{blk}/mix/{w}" for w in ("wk", "wv", "bk",
                                                       "bv") if w in mix]
            if ctx.sp:
                out.append(f"{blk}/ffn/ln")
            if self.fkinds[pos] == "moe" and B.uses_ep(cfg, ctx):
                out.append(f"{blk}/ffn/router")
        return out

    def _split_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The embedding output as the layers take it over a model axis:
        under sequence parallelism this rank's rows of T; else the whole
        sequence, of which only this rank's rows pass their gradient back
        (the same values; each rank's lookup gradient covers its rows)."""
        if not self._tp():
            return x
        if self.ctx.sp:
            lo, hi = self.ctx.own_rows(x.shape[1])
            return x[:, lo:hi]
        t, n, r = x.shape[1], self.ctx.size, self.ctx.rank
        lo, hi = r * t // n, (r + 1) * t // n
        return torch.cat([x[:, :lo].detach(), x[:, lo:hi],
                          x[:, hi:].detach()], dim=1)

    def _layer(self, x, lp, positions, pos: int, enc_out=None):
        """One layer of the training stack at period position ``pos``
        (with cross-attention on ``enc_out`` for encdec): returns (x, the
        MoE load-balancing loss or None). Under ZeRO-3 ``lp`` holds
        Shards, gathered here, inside the remat body. Over a model axis
        the blocks run on this rank's heads and MLP columns."""
        cfg = self.cfg
        lp = Z.gather_used(lp)
        tp = self.ctx if self._tp() else None
        if self.kinds[pos] == "attn":
            x, _ = B.attn_apply(x, lp["mix"], cfg, positions=positions,
                                attn_impl=self.attn_impl,
                                qmm_impl=self.qmm_impl, ctx=tp)
        else:
            x, _ = B.ssm_apply(x, lp["mix"], cfg, ssd_impl=self.ssd_impl,
                               ctx=tp)
        if "cross" in lp:
            ckv = B.cross_kv(enc_out, lp["cross"], cfg,
                             qmm_impl=self.qmm_impl)
            x = B.cross_attn_apply(x, ckv, lp["cross"], cfg,
                                   qmm_impl=self.qmm_impl)
        if self.fkinds[pos] == "moe":
            return B.moe_apply(x, lp["ffn"], cfg, CAPACITY_MULT["train"],
                               self.ctx)
        return B.ffn_apply(x, lp["ffn"], cfg, qmm_impl=self.qmm_impl,
                           ctx=tp), None

    def _backbone(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(final hidden states, the MoE load-balancing loss summed over
        the layers in f32, 0 without MoE layers). ``params``' top-level
        leaves are whole (``zero.gather_top``). Over a model axis under
        sequence parallelism the hidden states are this rank's rows."""
        if self._tp() and self.cfg.n_enc_layers:
            raise NotImplementedError(
                f"{self.cfg.name}: training the {self.cfg.family} family "
                f"over a model axis (its cross-attention's seams) is not "
                f"ported: ROADMAP queue 1 item 7.10")
        if "ssm" in self.kinds and self.ssd_impl != "ref":
            raise NotImplementedError(
                f"training through ssd_impl={self.ssd_impl!r}: the SSD "
                f"kernel has no backward (ROADMAP.md queue 1 item 5); "
                f"train with ssd_impl='ref', as the reference does")
        fe = batch.get("frontend_embeds")
        enc_out = self._encoder_in(params, fe)
        x = self._embed_in(params, batch["tokens"], fe)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = self._split_rows(x)
        body = wrap_remat(self._layer, self.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, lp in enumerate(self._unstacked_layers(params)):
            x, a = body(x, lp, positions, i % self.period, enc_out)
            if a is not None:
                aux = aux + a
        return x, aux

    def backbone(self, params, batch) -> torch.Tensor:
        """Everything before the LM head; returns final hidden states
        (B, T', d_model) (T' = F + T for vlm; over a model axis under
        sequence parallelism this rank's T/tp rows). ``batch`` holds
        ``tokens`` and, for encdec and vlm, ``frontend_embeds``. Each
        decoder layer runs under ``wrap_remat(remat)``."""
        return self._backbone(Z.gather_top(params), batch)[0]

    def _block_ce(self, params, xb, lb):
        """(sum of masked CE, token count) of one block: logits in f32
        over the whole padded vocabulary, labels < 0 masked. Over a model
        axis the logits block is this rank's vocab slice
        (:func:`vocab_parallel_ce`)."""
        if self._tp():
            ctx = self.ctx
            x = L.rmsnorm(xb, params["final_ln"], self.cfg.norm_eps)
            lo, hi = ctx.part(self.vocab)
            w = (params["embed"][lo:hi].T if self.cfg.tie_embeddings
                 else params["head"])
            logits, = L.dense_column(x, [w], ctx, gather=False)
            return vocab_parallel_ce(logits.float(), lb, lo, ctx)
        logits = self._head(params, xb).float()
        lse = torch.logsumexp(logits, dim=-1)
        label_logit = logits.gather(
            -1, lb.long().clamp_min(0)[..., None])[..., 0]
        mask = (lb >= 0).float()
        return ((lse - label_logit) * mask).sum(), mask.sum()

    def loss(self, params, batch, chunk_t: int = 512,
             n_tok: Optional[torch.Tensor] = None, aux_grad_scale: int = 1
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Causal-LM CE, computed block-wise over the sequence so the full
        (B, T, V) logits tensor is never materialized: each block applies
        the head + CE under checkpoint (recomputed in the backward).
        Returns ``(ce + moe_aux_coef · aux / n_layers, {"ce", "aux"})``
        with ``aux`` the MoE load-balancing loss summed over the layers
        (0 without MoE layers, where the loss is the CE). For vlm the
        labels cover the token span, after the F patches. ``n_tok``, where
        given, replaces the batch's own label count as the CE's divisor
        (a data-parallel rank's share of the global count).
        ``aux_grad_scale`` multiplies the load-balancing term's gradient,
        not its value: over ``dp`` data-parallel ranks ``aux`` is the
        global batch's on every rank but carries only this rank's part of
        its gradient, and the step divides the ranks' summed gradients by
        ``dp``, so the step passes ``dp``."""
        params = Z.gather_top(params)
        x, aux = self._backbone(params, batch)
        if self._tp():
            x = self.ctx.gather_rows(x)
        labels = batch["labels"]
        n_front = x.shape[1] - labels.shape[1]
        if n_front > 0:                     # vlm: the token span only
            x = x[:, n_front:]
        _, t, _ = x.shape
        tc = min(chunk_t, t)
        while t % tc:
            tc //= 2
        ce_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        n_count = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, t, tc):
            s, n = checkpoint(self._block_ce, params, x[:, c0:c0 + tc],
                              labels[:, c0:c0 + tc], use_reentrant=False,
                              preserve_rng_state=False)
            ce_sum = ce_sum + s
            n_count = n_count + n
        ce = ce_sum / (torch.clamp_min(n_count, 1.0) if n_tok is None
                       else n_tok)
        weighted = aux if aux_grad_scale == 1 else _GradScale.apply(
            aux, float(aux_grad_scale))
        total = ce + self.moe_aux_coef * weighted / max(self.cfg.n_layers, 1)
        return total, {"ce": ce, "aux": aux}


def vocab_parallel_ce(logits: torch.Tensor, labels: torch.Tensor, lo: int,
                      ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked CE, token count) from this rank's f32 logits block
    (B, tc, V/tp), its columns ``[lo, lo + V/tp)`` of the padded
    vocabulary, labels < 0 masked: the row max over the model axis (no
    gradient, as logsumexp's max), then one f32 all-reduce of each row's
    sum of exponentials and its label's logit (g: the rank whose columns
    hold the label gives it, the others 0). No rank holds the whole
    vocabulary's logits."""
    m = ctx.model_max(logits.detach().amax(-1))
    s = torch.exp(logits - m[..., None]).sum(-1)
    idx = labels.long() - lo
    own = (idx >= 0) & (idx < logits.shape[-1])
    lab = logits.gather(-1, idx.clamp(0, logits.shape[-1] - 1)[..., None])
    lab = torch.where(own, lab[..., 0], torch.zeros((), device=lab.device))
    s, lab = ctx.reduce_from_model(torch.stack([s, lab]))
    mask = (labels >= 0).float()
    return ((m + torch.log(s) - lab) * mask).sum(), mask.sum()


class _GradScale(torch.autograd.Function):
    """The identity, whose backward multiplies the gradient by ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None
