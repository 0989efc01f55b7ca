"""Transformer, MoE and Mamba-2 blocks: param specs and apply functions.

The one-device part of ``repro.models.blocks``: the attention block
(QKV bias, Qwen3's per-head q/k norms; whole-sequence and dense-cache
decode branches), cross-attention for the encoder-decoder family, the
SwiGLU FFN, the MoE FFN (top-k routing and the one-device capacity
dispatch, ``_moe_local``) and the Mamba-2 (SSD) block with its three
branches (whole sequence, chunk continue, T=1 decode) and its
speculative-verify form (``ssm_apply_spec``).

**Tensor parallelism.** The attention, FFN and Mamba-2 blocks take a
``ctx`` (a ``parallel.sharding.ShardCtx``, ``None`` on one device: the
path as it was, bit for bit) and this rank's slice of their weights
(``sharding.shard_params``). Attention runs on the rank's q heads and KV
heads (where the model axis does not divide the KV heads, every rank
holds all of them and reads those its q heads map to, h // G:
:func:`kv_heads_read`), the FFN on its part of the MLP width, the
Mamba-2 block on its SSD heads (z, x, dt and the conv on their
channels, B and C whole); ``wo``, the MLP down projection and
``out_proj`` are row-parallel (``layers.dense_row``: f32 partials summed
over the model axis, one rounding), and the gated RMSNorm over the whole
``d_inner`` sums its squares over the model axis before the rsqrt.
The MoE FFN takes ``ctx`` too (:func:`moe_apply`): expert parallelism
(the reference's ``_moe_ep``: tokens exchanged with the experts' ranks
by ``ShardCtx.all_to_all``) where the degree divides the experts, else
the one-device dispatch with the experts cut on their MLP width; over a
data axis (training) the one-device dispatch routes with the global
batch's statistics, order and capacity, and expert parallelism each
(data, model) shard's own rows at its own capacity. In training every
block runs under autograd over a model axis: the exchange, the t-slice
and its gather carry their cotangents back bit for bit, the experts'
seams are f and g where they are cut on their MLP width, and the Mamba-2
block's ``in_proj`` enters through f, its gated norm sums its row
statistics under autograd and ``out_proj`` leaves through g. A training
``ctx`` in the reference's sequence mode (``attn_mode="seq"``) runs the
attention block on the rank's rows of T with the whole attention leaves
instead (:func:`_attn_seq`).

Cache conventions (decode): attention ``{"k", "v"}`` as (B, S, K, hd)
(bf16, or the reference's unscaled int8) with the global ``lengths``
(B,); SSM (also chunked prefill) ``{"conv": (B, W-1, C) f32, "state":
(B, H, P, N) f32}``; cross-attention ``{"k", "v"}`` as (B, S_src, K, hd),
computed once from the encoder output.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.config import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.params import spec
from repro_torch.quant.qtensor import QTensor
from repro_torch.models.ssd import (ssd_chunked, ssd_decode_scan,
                                    ssd_decode_step)


def attn_specs(cfg: ArchConfig, n_stack: int) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = (n_stack,)
    ly = ("layers",)
    p = {
        "ln": spec(s + (d,), ly + ("embed",), "ones"),
        "wq": spec(s + (d, h, hd), ly + ("embed", "q_heads", "head_dim")),
        "wk": spec(s + (d, kv, hd), ly + ("embed", "kv_heads", "head_dim")),
        "wv": spec(s + (d, kv, hd), ly + ("embed", "kv_heads", "head_dim")),
        "wo": spec(s + (h, hd, d), ly + ("q_heads", "head_dim", "embed"),
                   fan_in_axes=(0, 1)),
    }
    if cfg.qkv_bias:
        p["bq"] = spec(s + (h, hd), ly + ("q_heads", "head_dim"), "zeros")
        p["bk"] = spec(s + (kv, hd), ly + ("kv_heads", "head_dim"), "zeros")
        p["bv"] = spec(s + (kv, hd), ly + ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = spec(s + (hd,), ly + ("head_dim",), "ones")
        p["k_norm"] = spec(s + (hd,), ly + ("head_dim",), "ones")
    return p


def _qkv(x, p, cfg: ArchConfig, positions, rope: bool = True,
         qmm_impl: str = "kernel", ctx=None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projection -> per-head q/k norms (``qk_norm``) -> RoPE as real f32
    tensors, ONE rounding at the end: q/k/v feed the int8 KV encode in the
    serving engine, where a one-ulp input flip moves a whole vector's
    scale. Under ``ctx`` the projections are column-parallel
    (``layers.dense_column``); each bias is added after its product, in
    f32, as :func:`layers.dense` adds it."""
    f32 = torch.float32
    q, k, v = (y if p.get(b) is None else y + p[b] for y, b in zip(
        L.dense_column(x, [p["wq"], p["wk"], p["wv"]], ctx, out_dtype=f32,
                       qmm_impl=qmm_impl), ("bq", "bk", "bv")))
    if cfg.qk_norm:
        q = L.qk_headnorm(q, p["q_norm"], cfg.norm_eps)
        k = L.qk_headnorm(k, p["k_norm"], cfg.norm_eps)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def tp_seam(ctx, n: int):
    """``ctx`` where its model axis cuts an axis of ``n`` entries (the
    contraction of a row-parallel seam is split), else ``None``."""
    return ctx if ctx is not None and ctx.splits(n) else None


def kv_heads_read(k, v, cfg: ArchConfig, ctx):
    """k/v (..., K held, hd) narrowed to the KV heads this rank's q heads
    read: a view of every head held unless the model axis splits the q
    heads and not the KV heads; then the rank holds all K and reads
    ``ShardCtx.kv_part``."""
    if (ctx is None or not ctx.splits(cfg.n_heads)
            or ctx.splits(cfg.n_kv_heads)):
        return k, v
    lo, hi = ctx.kv_part(cfg)
    return k[..., lo:hi, :], v[..., lo:hi, :]


def attn_apply(x, p, cfg: ArchConfig, *, positions, attn_impl: str = "naive",
               causal: bool = True, return_kv: bool = False,
               qmm_impl: str = "kernel", cache: Optional[Dict] = None,
               lengths: Optional[torch.Tensor] = None, ctx=None
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention residual block.

    Whole sequence (``cache=None``, train/prefill): :func:`layers.attention`
    in mode ``attn_impl``; optionally returns the fresh (k, v). Decode
    (``cache`` holds (B, S, K, hd) k/v, x is one token per row): the new
    k/v are written at ``clip(lengths, 0, S-1)`` — in place, into the
    cache tensors the caller passed — and the token attends the whole
    cache with ``kv_len = lengths + 1`` through ``kernels.ops.
    flash_decode`` (the dense decode kernel on the card, its plain version
    on the CPU) whatever ``attn_impl`` is: the counterpart of the
    reference's intended ``"pallas_decode"``. An integer cache stores k/v
    as the reference's unscaled cast (:func:`cache_cast`) and is read
    back in q's type. ``causal=False`` (the encoder) attends every
    position. ``qmm_impl`` is a :func:`layers.dense` route for int8
    weights. Under ``ctx`` the rank's heads attend (the cache and the
    returned k/v hold the KV heads it stores) and ``wo`` is
    row-parallel. In training (a training ``ctx`` under autograd) the
    normed input enters the q/k/v projections through Megatron's f, or
    under sequence parallelism through the all-gather of T (x is then
    this rank's rows and so is the result; ``layers.dense_column``), and
    ``wo``'s seam is g or the reduce-scatter (``ShardCtx.exit_block``).
    A training ``ctx`` in sequence mode takes :func:`_attn_seq`."""
    if ctx is not None and ctx.attn_mode == "seq":
        if cache is not None or return_kv:
            raise NotImplementedError(
                "sequence (context-parallel) attention serves no cache: "
                "model-level prefill and decode under attn_mode='seq' (the "
                "reference's kv_cache split of T) are ROADMAP queue 1 item "
                "7.13")
        return _attn_seq(x, p, cfg, positions=positions,
                         attn_impl=attn_impl, qmm_impl=qmm_impl,
                         ctx=ctx), None
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, positions, qmm_impl=qmm_impl, ctx=ctx)
    new_cache = None
    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        slot = torch.clamp(lengths.long(), 0, kc.shape[1] - 1)
        rows = torch.arange(kc.shape[0], device=kc.device)
        kc[rows, slot] = cache_cast(k[:, 0], kc.dtype)
        vc[rows, slot] = cache_cast(v[:, 0], vc.dtype)
        new_cache = {"k": kc, "v": vc}
        kr, vr = kv_heads_read(kc, vc, cfg, ctx)
        out = kops.flash_decode(q, kr.to(q.dtype), vr.to(q.dtype),
                                (lengths + 1).int())
    else:
        out = L.attention(q, *kv_heads_read(k, v, cfg, ctx), mode=attn_impl,
                          causal=causal)
        if return_kv:
            new_cache = {"k": k, "v": v}
    y = L.dense_row(out, p["wo"], tp_seam(ctx, cfg.n_heads), n_in=2,
                    qmm_impl=qmm_impl)
    return x + y, new_cache


def _attn_seq(x, p, cfg: ArchConfig, *, positions, attn_impl: str,
              qmm_impl: str, ctx) -> torch.Tensor:
    """The causal self-attention block in the reference's sequence mode
    (``attn_mode="seq"``: its ``act_q``/``act_kv`` split T over the model
    axis, and every rank holds the whole attention leaves). Rank r of tp
    takes its rows ``[lo, hi) = [r·T/tp, (r+1)·T/tp)``: under ``sp`` x is
    those rows already, else it enters them (``ShardCtx.enter_rows``: the
    cotangent gathered back whole); the norm, q/k/v with their biases,
    norms and RoPE at positions ``lo + i``, and ``wo`` run on them with
    the whole weights; attention reads the keys ``[0, hi)`` gathered from
    every rank with ``q_offset = lo`` (``ShardCtx.seq_attention``: their
    dK/dV summed over the ranks in f32, rounded once). Without ``sp`` the
    output rows are gathered back to the whole sequence
    (``ShardCtx.leave_rows``); with it they stay the rank's. Each rank
    computes these leaves' gradients on its rows alone, so the step sums
    them over the model axis (``LM.model_summed``). Where the axis does
    not divide T (the reference's ``_mdl`` gives ``None``) every rank
    attends the whole sequence, as one device does, and nothing is
    summed."""
    t = x.shape[1] * (ctx.size if ctx.sp else 1)
    if not ctx.seq_splits(t):
        return attn_apply(x, p, cfg, positions=positions,
                          attn_impl=attn_impl, qmm_impl=qmm_impl)[0]
    lo, hi = ctx.own_rows(t)
    xr = x if ctx.sp else ctx.enter_rows(x)
    h = L.rmsnorm(xr, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, positions[..., lo:hi], qmm_impl=qmm_impl)
    out = ctx.seq_attention(q, k, v, attn_impl)
    y = L.dense(out, p["wo"], n_in=2, qmm_impl=qmm_impl)
    return x + (y if ctx.sp else ctx.leave_rows(y))


def cache_cast(a: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``a`` stored into a cache of ``dtype`` as the reference's
    ``astype`` does: a float type rounds; an integer type (the
    reference's int8 dense cache, no scale) saturates to the type's range
    and truncates toward zero. torch's cast wraps out-of-range values, so
    they are clamped first."""
    if dtype.is_floating_point:
        return a.to(dtype)
    info = torch.iinfo(dtype)
    return torch.clamp(a, info.min, info.max).to(dtype)


def cross_attn_specs(cfg: ArchConfig, n_stack: int) -> Dict:
    p = attn_specs(cfg, n_stack)
    p.pop("q_norm", None), p.pop("k_norm", None)
    return p


def cross_attn_apply(x, enc_kv, p, cfg: ArchConfig,
                     qmm_impl: str = "kernel") -> torch.Tensor:
    """Cross-attention residual block: q from the decoder stream (one
    ``dense`` in x's type, no RoPE), k/v precomputed from the encoder
    output (:func:`cross_kv`), read by naive attention over every source
    position (no causal or length mask), as the reference reads it."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q = L.dense(h, p["wq"], bias=p.get("bq"), qmm_impl=qmm_impl)
    out = L.attention(q, enc_kv["k"], enc_kv["v"], mode="naive",
                      causal=False)
    return x + L.dense(out, p["wo"], n_in=2, qmm_impl=qmm_impl)


def cross_kv(enc_out, p, cfg: ArchConfig,
             qmm_impl: str = "kernel") -> Dict[str, torch.Tensor]:
    """The encoder output's k/v for one decoder layer, in its type."""
    return {"k": L.dense(enc_out, p["wk"], bias=p.get("bk"),
                         qmm_impl=qmm_impl),
            "v": L.dense(enc_out, p["wv"], bias=p.get("bv"),
                         qmm_impl=qmm_impl)}


def ffn_specs(cfg: ArchConfig, n_stack: int) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    s, ly = (n_stack,), ("layers",)
    return {
        "ln": spec(s + (d,), ly + ("embed",), "ones"),
        "w_gate": spec(s + (d, f), ly + ("embed", "mlp")),
        "w_up": spec(s + (d, f), ly + ("embed", "mlp")),
        "w_down": spec(s + (f, d), ly + ("mlp", "embed")),
    }


def ffn_apply(x, p, cfg: ArchConfig, qmm_impl: str = "kernel", ctx=None
              ) -> torch.Tensor:
    """The SwiGLU residual block; under ``ctx`` on this rank's part of
    the MLP width, entered and left as :func:`attn_apply` is."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"],
                        qmm_impl=qmm_impl, ctx=tp_seam(ctx, cfg.d_ff))


# ==========================================================================
# MoE FFN: top-k routing, token-choice dispatch with capacity
# ==========================================================================

def moe_specs(cfg: ArchConfig, n_stack: int) -> Dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    s, ly = (n_stack,), ("layers",)
    return {
        "ln": spec(s + (d,), ly + ("embed",), "ones"),
        "router": spec(s + (d, e), ly + ("embed", "null")),
        "w_gate": spec(s + (e, d, f), ly + ("experts", "embed", "mlp"),
                       fan_in_axes=(1,)),
        "w_up": spec(s + (e, d, f), ly + ("experts", "embed", "mlp"),
                     fan_in_axes=(1,)),
        "w_down": spec(s + (e, f, d), ly + ("experts", "mlp", "embed"),
                       fan_in_axes=(1,)),
    }


def _route(h, router_w, cfg: ArchConfig, ctx=None):
    """Router: f32 logits of h, softmax gates, the top-k experts (the
    lower index first on ties, as ``lax.top_k``: a stable descending
    sort) with their gates renormalised, and the Switch-style load
    balancing loss. Returns (top_w (..., k) f32, top_e (..., k) int64,
    aux).

    Over a data axis (``ctx`` with ``dp_size > 1``: ``h`` is this rank's
    rows of the global batch) both statistics of the loss are the global
    batch's, as the reference's GSPMD program computes them: one
    all-reduce of the gates' sums, the first choices' counts and the
    token count. Their value is the global one on every rank; their
    gradient flows into this rank's own gates only, so the ranks'
    gradients sum to the global loss's."""
    logits = L.dense(h.float(), router_w).float()
    gates = torch.softmax(logits, dim=-1)                       # (..., E)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_w, top_e = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    lead = tuple(range(gates.ndim - 1))
    # one_hot of the first choice, by comparison: F.one_hot checks its
    # input's range on the host, a device sync
    e = cfg.n_experts
    first = (top_e[..., :1] == torch.arange(e, device=top_e.device)).float()
    if ctx is None or ctx.dp_size == 1:
        me, ce = gates.mean(dim=lead), first.mean(dim=lead)
    else:
        n = gates.new_full((1,), gates.numel() // e)
        local = torch.cat([gates.sum(dim=lead), first.sum(dim=lead), n])
        total = ctx.dp_all_reduce(local.detach().clone())
        total = total + (local - local.detach())    # global value, local grad
        me, ce = total[:e] / total[-1], total[e:2 * e] / total[-1]
    aux = e * (me * ce).sum()
    return top_w, top_e, aux


def _expert_weights(p, dtype):
    return tuple(p[w].dequantize(dtype) if isinstance(p[w], QTensor)
                 else p[w] for w in ("w_gate", "w_up", "w_down"))


def _expert_ffn(xs, wg, wu, wd, ctx=None):
    """xs (E, C, D); weights (E, D, F) / (E, F, D): every expert's SwiGLU
    over its C rows, each product batched over the experts
    (``layers.dense_batched``). The gate chain is real f32 into the down
    projection, rounded once at the end, as ``layers.swiglu``. Under
    ``ctx`` the weights are this rank's part of the MLP width: the
    dispatch buffer enters through Megatron's f (``ShardCtx.
    copy_to_model``: in training its cotangent is summed over the model
    axis) and the down projection is a row-parallel seam (its f32
    partials summed over the model axis, then rounded once, as
    ``layers.dense_row``; ``ShardCtx.exit_block``, g in training)."""
    if ctx is not None:
        xs = ctx.copy_to_model(xs)
    g = L.dense_batched(xs, wg, out_dtype=torch.float32)
    u = L.dense_batched(xs, wu, out_dtype=torch.float32)
    if ctx is None:
        return L.dense_batched(L.silu(g) * u, wd).to(xs.dtype)
    y = L.dense_batched(L.silu(g) * u, wd, out_dtype=torch.float32)
    return ctx.exit_block(y, rows=False).to(xs.dtype)


def capacity(n: int, cfg: ArchConfig, capacity_mult: float) -> int:
    """Rows each expert takes from a call of ``n`` tokens: read from
    shapes only (at capture, as the reference at trace time)."""
    k, e = cfg.top_k, cfg.n_experts
    cap = int(np.ceil(k * n / e * cfg.capacity_factor * capacity_mult))
    return min(max(cap, 4), k * n)


def _slots(top_e, e: int, cap: int, ctx=None):
    """Each (token, choice) assignment's row in the (E·cap + 1) dispatch
    buffer: the next of its expert's ``cap`` rows in (token, choice)
    order (a stable sort by expert; the counts an integer
    ``scatter_add_``, no host sync); past ``cap`` the pad row ``E·cap``
    (written, never read). Returns (slot, keep) over the flattened
    assignments.

    Over a data axis (``ctx`` with ``dp_size > 1``) the order is the
    global batch's, whose rows lie rank after rank: an assignment's
    position is its position here plus its expert's assignments on every
    lower rank (an exclusive prefix over the ranks of the per-expert
    counts, from one all-reduce of a (dp, E) int32 table), and ``cap``
    is the global batch's. Its row here stays its local position, below
    ``cap`` wherever it is kept."""
    flat_e = top_e.reshape(-1)                                  # (n*k,)
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(e, dtype=torch.int64, device=dev).scatter_add_(
        0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(flat_e.numel(), device=dev) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    if ctx is None or ctx.dp_size == 1:
        keep = pos < cap
    else:
        table = torch.zeros((ctx.dp_size, e), dtype=torch.int32, device=dev)
        table[ctx.dp_rank] = counts.to(torch.int32)
        ctx.dp_all_reduce(table)
        below = table[:ctx.dp_rank].sum(0)
        keep = pos + below[flat_e] < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, e * cap))
    return slot, keep


def _dispatch(x, slot, k: int, rows: int):
    """The (rows, D) dispatch buffer: each (token, choice) assignment's
    token row of ``x`` (n, D) at its ``slot`` (a dropped one at the pad
    row ``rows``, cut off), zeros elsewhere."""
    flat_t = torch.arange(slot.numel(), device=x.device) // k   # its token
    buf = torch.zeros((rows + 1, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf.index_copy_(0, slot, x[flat_t])
    return buf[:-1]


def _combine(ys, slot, keep, top_w, n: int, k: int, dtype):
    """Each token's k gate-weighted expert outputs added in f32 in choice
    order from zeros (as the reference's scatter-add; no order-dependent
    float atomics), a dropped assignment adding nothing, rounded once.
    ``ys`` (E·cap, D) the expert rows; returns (n, D) in ``dtype``."""
    d, dev = ys.shape[-1], ys.device
    ys = torch.cat([ys, torch.zeros((1, d), dtype=ys.dtype, device=dev)])
    gathered = ys[slot].float() * top_w.reshape(-1)[:, None]    # (n*k, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros((), device=dev)).reshape(n, k, d)
    out = torch.zeros((n, d), dtype=torch.float32, device=dev)
    for j in range(k):
        out = out + gathered[:, j]
    return out.to(dtype)


def _moe_local(h, p, cfg: ArchConfig, capacity_mult: float, ctx=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice dispatch with capacity, sort-based, over the whole
    of ``h`` (:func:`_slots`): each expert runs its SwiGLU over all its
    ``cap`` rows, filled or not, and :func:`_combine` adds a token's
    outputs.

    ``ctx`` where given: under a model axis that cuts the experts' MLP
    width (the degree does not divide the experts), the experts' down
    projection is row-parallel (:func:`_expert_ffn`); over a data axis,
    the routing statistics, the assignment order and the capacity are the
    global batch's (:func:`_route`, :func:`_slots`), so the drops are the
    reference's on its global batch, token for token."""
    wg, wu, wd = _expert_weights(p, h.dtype)
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    x = h.reshape(-1, d)
    n = x.shape[0]
    dp = ctx if ctx is not None and ctx.dp_size > 1 else None
    # without a data axis the calls keep the reference's arguments (the
    # routing probes wrap them)
    top_w, top_e, aux = (_route(x, p["router"], cfg) if dp is None else
                         _route(x, p["router"], cfg, dp))
    cap = capacity(n * (dp.dp_size if dp is not None else 1), cfg,
                   capacity_mult)
    slot, keep = _slots(top_e, e, cap, dp)
    buf = _dispatch(x, slot, k, e * cap).reshape(e, cap, d)
    ys = _expert_ffn(buf, wg, wu, wd, tp_seam(ctx, cfg.d_ff))
    out = _combine(ys.reshape(e * cap, d), slot, keep, top_w, n, k, h.dtype)
    return out.reshape(h.shape), aux


def _moe_ep(h, p, cfg: ArchConfig, ctx, capacity_mult: float,
            with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel dispatch (the reference's ``_moe_ep``): this
    rank's ``p`` holds its E/size experts. Where ``t`` splits (``t %
    size == 0`` and ``t > 1``) each rank routes its slice of ``t``, else
    every rank routes every token (a decode step: each expert's rank then
    receives ``size`` copies of its rows, as in the reference). The
    capacity is the shard's own (``cap`` from its ``n``). Each rank
    routes and sorts its tokens as :func:`_moe_local`, sends each
    expert's ``cap`` rows to the expert's rank (``ShardCtx.all_to_all``),
    runs its experts' SwiGLU over ``(E/size, size·cap, D)``, sends the
    rows back and combines in f32, rounded once, as the tail of
    :func:`_moe_local`; the ``t`` slices are gathered
    (``ShardCtx.gather_t``), so every rank holds the whole output. The
    loss is averaged over the model axis and the data axes (the
    reference's ``pmean``, ``ShardCtx.mesh_mean``), unless ``with_aux``
    is false (serving drops it).

    In training every step of it is differentiable: the exchange's
    backward is the reverse exchange, the t-slice's (``ShardCtx.
    slice_t``) the gather of every rank's slice of the cotangent and
    ``gather_t``'s the rank's rows of it, all bit for bit. Under sequence
    parallelism ``h`` is already this rank's rows of T, the reference's
    ``P(dp, model, None)`` slice: they are routed as they are and the
    rows returned. A (data, model) shard routes its own rows at its own
    capacity, as the reference's ``shard_map`` does. Training needs the
    axis to divide T (the reference's replicated input would count each
    token ``size`` times in the experts' gradients)."""
    wg, wu, wd = _expert_weights(p, h.dtype)
    d, e, k = cfg.d_model, cfg.n_experts, cfg.top_k
    m = ctx.size
    e_loc = e // m
    rows = ctx.sp                     # h is this rank's rows of T already
    t = h.shape[1] * (m if rows else 1)
    split_t = t % m == 0 and t > 1
    # repro: allow[JIT-04] autograd's mode and requires_grad are host metadata of the tensor, not device values
    if not split_t and torch.is_grad_enabled() and h.requires_grad:
        raise NotImplementedError(
            f"expert-parallel training over a model axis of {m} with T={t}, "
            f"which it does not divide")
    hh = ctx.slice_t(h) if split_t and not rows else h
    x = hh.reshape(-1, d)
    n = x.shape[0]
    top_w, top_e, aux = _route(x, p["router"], cfg)
    cap = capacity(n, cfg, capacity_mult)
    slot, keep = _slots(top_e, e, cap)
    recv = ctx.all_to_all(_dispatch(x, slot, k, e * cap).reshape(
        m, e_loc * cap, d))
    xs = recv.reshape(m, e_loc, cap, d).transpose(0, 1).reshape(
        e_loc, m * cap, d)
    ys = _expert_ffn(xs, wg, wu, wd)
    ys = ys.reshape(e_loc, m, cap, d).transpose(0, 1).reshape(
        m, e_loc * cap, d)
    back = ctx.all_to_all(ys)
    out = _combine(back.reshape(e * cap, d), slot, keep, top_w, n, k,
                   h.dtype).reshape(hh.shape)
    if split_t and not rows:
        out = ctx.gather_t(out, t)
    if with_aux:
        aux = ctx.mesh_mean(aux)
    return out, aux


def uses_ep(cfg: ArchConfig, ctx) -> bool:
    """Whether the MoE FFN runs the expert-parallel dispatch under
    ``ctx``: a model axis of more than one rank that TP uses and that
    divides the experts (the reference's choice in ``moe_apply``)."""
    return ctx is not None and ctx.splits(cfg.n_experts)


def moe_apply(x, p, cfg: ArchConfig, capacity_mult: float = 1.0, ctx=None,
              with_aux: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE residual block: RMSNorm, then the dispatch the reference's
    ``moe_apply`` chooses: :func:`_moe_ep` where the model axis of
    ``ctx`` divides the experts, else :func:`_moe_local` (on one device;
    under a model axis with the experts cut on their MLP width where the
    degree divides it, or whole; over a data axis on the global batch).
    Returns (x + y, the load-balancing loss).

    Under sequence parallelism (training) ``x`` is this rank's rows of
    T and so is the result: the expert-parallel dispatch routes the rows
    as they are; the one-device dispatch with the experts cut on their
    MLP width routes the whole sequence, gathered from the ranks' normed
    rows (``ShardCtx.leave_rows``), and returns this rank's rows
    (``ShardCtx.enter_rows``), so the rows' cotangents are gathered
    whole."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    if uses_ep(cfg, ctx):
        y, aux = _moe_ep(h, p, cfg, ctx, capacity_mult, with_aux)
    elif ctx is None:
        y, aux = _moe_local(h, p, cfg, capacity_mult)
    elif ctx.sp:
        y, aux = _moe_local(ctx.leave_rows(h), p, cfg, capacity_mult, ctx)
        y = ctx.enter_rows(y)
    else:
        y, aux = _moe_local(h, p, cfg, capacity_mult, ctx)
    return x + y, aux


def ffn_or_moe(x, p, cfg: ArchConfig, kind: str, capacity_mult: float,
               qmm_impl: str = "kernel", ctx=None) -> torch.Tensor:
    """The FFN of a layer of ``kind`` (``cfg.ffn_kinds()``): the dense
    SwiGLU, or the MoE FFN at ``capacity_mult`` (its loss dropped: the
    serving and inference paths), each under ``ctx``."""
    if kind == "moe":
        return moe_apply(x, p, cfg, capacity_mult, ctx, with_aux=False)[0]
    return ffn_apply(x, p, cfg, qmm_impl=qmm_impl, ctx=ctx)


# ==========================================================================
# Mamba2 (SSD) block
# ==========================================================================


def ssm_specs(cfg: ArchConfig, n_stack: int) -> Dict:
    d, di = cfg.d_model, cfg.d_inner
    g, n_ssm, ns = cfg.ssm_ngroups, cfg.n_ssm_heads, cfg.ssm_state
    conv_ch = di + 2 * g * ns
    proj_out = 2 * di + 2 * g * ns + n_ssm
    s, ly = (n_stack,), ("layers",)
    return {
        "ln": spec(s + (d,), ly + ("embed",), "ones"),
        "in_proj": spec(s + (d, proj_out), ly + ("embed", "ssm_inner")),
        "conv_w": spec(s + (cfg.ssm_conv, conv_ch), ly + ("conv", "ssm_inner"),
                       fan_in_axes=(0,)),
        "conv_b": spec(s + (conv_ch,), ly + ("ssm_inner",), "zeros"),
        "a_log": spec(s + (n_ssm,), ly + ("ssm_heads",), "ssm_a",
                      torch.float32),
        "d_skip": spec(s + (n_ssm,), ly + ("ssm_heads",), "ones",
                       torch.float32),
        "dt_bias": spec(s + (n_ssm,), ly + ("ssm_heads",), "dt_bias",
                        torch.float32),
        "norm": spec(s + (di,), ly + ("ssm_inner",), "ones"),
        "out_proj": spec(s + (di, d), ly + ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv, width W. x: (B,T,C), w: (W,C)."""
    wdt, t = w.shape[0], x.shape[1]
    y = 0
    for i in range(wdt):
        shifted = torch.nn.functional.pad(x, (0, 0, wdt - 1 - i, 0))[:, :t]
        y = y + shifted * w[i][None, None, :]
    return y + b[None, None, :]


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as max(x, 0) + log1p(e^-|x|)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _conv_step(conv_state, xbc, p):
    """One token through the carried conv window: ``conv_state`` (B, W-1,
    C) f32 and the token's conv input ``xbc`` (B, 1, C) f32 -> (the conv
    output (B, 1, C), the window after the token (B, W-1, C))."""
    buf = torch.cat([conv_state, xbc], dim=1)                  # (B, W, C)
    y = (torch.einsum("bwc,wc->bc", buf, p["conv_w"].float())[:, None, :]
         + p["conv_b"][None, None])
    return y, buf[:, 1:]


def ssm_heads(cfg: ArchConfig, ctx=None) -> Tuple[int, int]:
    """``[lo, hi)`` of the SSD heads this rank computes: its H/tp where
    the model axis divides the heads, else all of them. Their channels
    (``(hi - lo) · headdim``) are its part of ``d_inner``."""
    if ctx is None:
        return 0, cfg.n_ssm_heads
    return ctx.part(cfg.n_ssm_heads)


def _head_vecs(p, cfg: ArchConfig, ctx):
    """``a_log``, ``d_skip`` and ``dt_bias`` at this rank's heads (they
    are replicated, as the reference places ``ssm_heads`` vectors)."""
    if ctx is None:
        return p["a_log"], p["d_skip"], p["dt_bias"]
    lo, hi = ssm_heads(cfg, ctx)
    return p["a_log"][lo:hi], p["d_skip"][lo:hi], p["dt_bias"][lo:hi]


def _ssm_split(xbc, dt, dt_bias, cfg: ArchConfig, nh: int):
    """The conv output ``xbc`` (B, T, C) and the raw ``dt`` (B, T, H),
    both f32 -> silu'd heads x (B, T, H, P), B and C (B, T, G, N), and dt
    through softplus with its bias (B, T, H); ``nh`` heads (this rank's
    H/tp under TP)."""
    di, g, ns = nh * cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    b, t = xbc.shape[0], xbc.shape[1]
    xbc = L.silu(xbc)
    xs = xbc[..., :di].reshape(b, t, nh, cfg.ssm_headdim)
    Bs = xbc[..., di: di + g * ns].reshape(b, t, g, ns)
    Cs = xbc[..., di + g * ns:].reshape(b, t, g, ns)
    return xs, Bs, Cs, _softplus(dt.float() + dt_bias[None, None, :])


def _gated_norm(y, z, w, cfg: ArchConfig, ctx):
    """The gated RMSNorm ``rmsnorm(y · silu(z))`` over the whole
    ``d_inner``. Where the model axis splits the heads, each rank holds
    its channels: their f32 sum of squares is summed over the model axis
    before the rsqrt (``kernels.ops.rmsnorm_split``: the kernel's two
    passes on the card, their plain versions on the CPU; under autograd
    its backward sums each row's ``Σ dy·w·x`` over the axis the same
    way)."""
    g = y * L.silu(z)
    seam = tp_seam(ctx, cfg.n_ssm_heads)
    if seam is None:
        return L.rmsnorm(g, w, cfg.norm_eps)
    return kops.rmsnorm_split(g, w, cfg.d_inner, seam, cfg.norm_eps)


def _ssm_pre(h, p, cfg: ArchConfig, conv_state=None, capture_tail=False,
             n_valid=None, ctx=None):
    """in_proj + causal conv + splits. Returns z, x, B, C, dt and the new
    conv state (decode, chunk continue) or the conv-input tail (whole
    sequence with ``capture_tail``).

    ``n_valid`` (a (1,) or 0-dim integer tensor, chunked prefill only)
    marks the valid prefix of a right-padded chunk: dt is zeroed past it
    (a state-neutral no-op for the SSD recurrence) and the carried conv
    tail is read from the last valid inputs (a gather, no host sync).

    The whole pre-pipeline (in_proj output, conv, silu, splits) runs in
    real f32 with no rounding between ops, and the conv history is f32,
    as in the reference. Under ``ctx`` it runs on this rank's heads (its
    ``in_proj`` columns are z | x | B | C | dt of them, B and C whole),
    the product column-parallel (``layers.dense_column``: in training
    Megatron's f, or under sequence parallelism the all-gather of T)."""
    lo, hi = ssm_heads(cfg, ctx)
    nh = hi - lo
    di, g, ns = nh * cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    zxbcdt, = L.dense_column(h, [p["in_proj"]], tp_seam(
        ctx, cfg.n_ssm_heads), out_dtype=torch.float32)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * g * ns]
    dt = zxbcdt[..., di + di + 2 * g * ns:]
    t = zxbcdt.shape[1]
    new_conv_state = None
    if conv_state is not None and t == 1:            # decode: T == 1
        xbc, new_conv_state = _conv_step(conv_state, xbc, p)
    elif conv_state is not None:                     # chunk continue
        w1 = conv_state.shape[1]                               # W - 1
        buf = torch.cat([conv_state, xbc], dim=1)              # (B, W-1+T, C)
        if n_valid is None:
            new_conv_state = buf[:, -w1:]
        else:   # last W-1 *valid* inputs: rows [n_valid, n_valid + w1)
            rows = n_valid.reshape(()).long() + torch.arange(
                w1, device=buf.device)
            new_conv_state = buf.index_select(1, rows)
        xbc = _causal_conv(buf, p["conv_w"], p["conv_b"])[:, w1:]
    else:
        if capture_tail:  # conv state to resume decoding after prefill
            w1 = cfg.ssm_conv - 1
            tail = xbc[:, -w1:]
            pad = w1 - tail.shape[1]
            if pad > 0:
                tail = torch.nn.functional.pad(tail, (0, 0, pad, 0))
            new_conv_state = tail
        xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, Bs, Cs, dt = _ssm_split(xbc, dt, _head_vecs(p, cfg, ctx)[2], cfg, nh)
    if n_valid is not None:
        # padded positions: dt=0 => decay exp(0)=1 and update x*dt=0, so
        # the SSD state is untouched past the valid prefix
        keep = torch.arange(t, device=dt.device) < n_valid.reshape(())
        dt = torch.where(keep[None, :, None], dt,
                         torch.zeros((), device=dt.device))
    return z, xs, Bs, Cs, dt, new_conv_state


def ssm_apply(x, p, cfg: ArchConfig, *, cache: Optional[Dict] = None,
              ssd_impl: str = "ref", return_state: bool = False,
              n_valid=None, ctx=None) -> Tuple[torch.Tensor, Any]:
    """Mamba-2 residual block. ``cache=None``: a whole sequence (prefill;
    ``return_state`` also returns ``{"conv", "state"}`` to resume from).
    A cache and T == 1: one decode step. A cache and T > 1: a chunk of
    chunked prefill continuing from the carried (conv, state), with
    ``n_valid`` marking the valid prefix of a right-padded chunk.
    ``ssd_impl`` is ``models.ssd.ssd_chunked``'s ``impl``. Under ``ctx``
    the rank's heads (and its part of the cache) only; ``out_proj`` is
    row-parallel. In training under a model axis ``in_proj`` enters
    through Megatron's f (``layers.dense_column``), the gated norm sums
    its row statistics over the axis under autograd, and ``out_proj``
    leaves through g (``ShardCtx.exit_block``); under sequence
    parallelism ``x`` and the result are this rank's rows of T, entered
    by the all-gather and left by the reduce-scatter, and the scan runs
    on the whole sequence."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    a_log, d_skip, _ = _head_vecs(p, cfg, ctx)
    a = -torch.exp(a_log.float())                              # (H,)
    if cache is not None and x.shape[1] == 1:
        z, xs, Bs, Cs, dt, conv_state = _ssm_pre(h, p, cfg, cache["conv"],
                                                 ctx=ctx)
        y, new_state = ssd_decode_step(
            xs[:, 0], Bs[:, 0], Cs[:, 0], dt[:, 0], a, d_skip,
            cache["state"])
        y = y[:, None]
        new_cache = {"conv": conv_state, "state": new_state}
    elif cache is not None:
        z, xs, Bs, Cs, dt, conv_state = _ssm_pre(h, p, cfg, cache["conv"],
                                                 n_valid=n_valid, ctx=ctx)
        y, final_state = ssd_chunked(xs, Bs, Cs, dt, a, d_skip,
                                     chunk=cfg.ssm_chunk, impl=ssd_impl,
                                     init_state=cache["state"])
        new_cache = {"conv": conv_state, "state": final_state}
    else:
        z, xs, Bs, Cs, dt, conv_tail = _ssm_pre(
            h, p, cfg, capture_tail=return_state, ctx=ctx)
        y, final_state = ssd_chunked(xs, Bs, Cs, dt, a, d_skip,
                                     chunk=cfg.ssm_chunk, impl=ssd_impl)
        new_cache = ({"conv": conv_tail, "state": final_state}
                     if return_state else None)
    b, t = z.shape[0], z.shape[1]
    y = _gated_norm(y.reshape(b, t, z.shape[-1]), z, p["norm"], cfg, ctx)
    # f32 all the way through out_proj, ONE rounding into the residual type
    out = L.dense_row(y, p["out_proj"],
                      tp_seam(ctx, cfg.n_ssm_heads)).to(x.dtype)
    return x + out, new_cache


def ssm_apply_spec(x, p, cfg: ArchConfig, *, cache: Dict,
                   valid: torch.Tensor, ctx=None
                   ) -> Tuple[torch.Tensor, Dict]:
    """Speculative-verify Mamba-2 block: T tokens through the decode
    branch's math, with the (conv, state) after every token.

    It is T decode calls of :func:`ssm_apply`, bit for bit: each token's
    conv window step, silu, splits and softplus run on that token alone
    at the decode branch's shapes (:func:`_conv_step`,
    :func:`_ssm_split`), and the recurrence is
    :func:`~repro_torch.models.ssd.ssd_decode_scan` (not the grouped
    ``ssd_chunked``). The projections that do not depend on position
    (``in_proj``, ``out_proj``) and the norms run once over the window.
    ``valid`` (B, T) bool masks each row's right padding (and rows not
    speculating): an invalid position keeps the prior (conv, state) and
    its output is not to be read. Returns ``(x_out, {"conv": (T, B, W-1,
    C), "state": (T, B, H, P, N)})``: the caller rolls each row back to
    its accepted prefix by indexing the leading axis. Under ``ctx`` the
    rank's heads, as :func:`ssm_apply`."""
    lo, hi = ssm_heads(cfg, ctx)
    nh = hi - lo
    di, g, ns = nh * cfg.ssm_headdim, cfg.ssm_ngroups, cfg.ssm_state
    b, t = x.shape[0], x.shape[1]
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    a_log, d_skip, dt_bias = _head_vecs(p, cfg, ctx)
    a = -torch.exp(a_log.float())
    zxbcdt = L.dense(h, p["in_proj"], out_dtype=torch.float32)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * g * ns]
    dt = zxbcdt[..., di + di + 2 * g * ns:]
    conv = cache["conv"]
    convs, parts = [], []
    for j in range(t):
        y, new = _conv_step(conv, xbc[:, j:j + 1], p)
        conv = torch.where(valid[:, j, None, None], new, conv)
        convs.append(conv)
        parts.append(_ssm_split(y, dt[:, j:j + 1], dt_bias, cfg, nh))
    xs, Bs, Cs, dts = (torch.cat(c, dim=1) for c in zip(*parts))
    y, states = ssd_decode_scan(xs, Bs, Cs, dts, a, d_skip,
                                cache["state"], valid=valid)
    y = _gated_norm(y.reshape(b, t, di), z, p["norm"], cfg, ctx)
    out = L.dense_row(y, p["out_proj"],
                      tp_seam(ctx, cfg.n_ssm_heads)).to(x.dtype)
    return x + out, {"conv": torch.stack(convs), "state": states}


def ssm_init_cache(cfg: ArchConfig, batch: int, device=None,
                   ctx=None) -> Dict:
    """Zero (conv, state) for ``batch`` rows. Both leaves are f32: the SSD
    state always is, and the conv history keeps the f32 pre-pipeline
    values unrounded, so a chunk-continued conv equals the whole-prompt
    one at chunk boundaries. Under ``ctx``: this rank's heads and their
    conv channels (x of its heads, B and C whole)."""
    lo, hi = ssm_heads(cfg, ctx)
    conv_ch = (hi - lo) * cfg.ssm_headdim + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=torch.float32, device=device),
        "state": torch.zeros((batch, hi - lo, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }
