"""Transformer and Mamba-2 blocks: param specs and apply functions.

The dense- and ssm-family subset of ``repro.models.blocks``: the
attention block (QKV bias; whole-sequence and dense-cache decode
branches), the SwiGLU FFN and the
Mamba-2 (SSD) block with its three branches (whole sequence, chunk
continue, T=1 decode). No sharding context: the port serves on one card.

Cache conventions (decode): attention ``{"k", "v"}`` as (B, S, K, hd)
bf16 with the global ``lengths`` (B,); SSM (also chunked prefill)
``{"conv": (B, W-1, C) f32, "state": (B, H, P, N) f32}``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.params import spec
from repro_torch.models.ssd import ssd_chunked, ssd_decode_step


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
        raise NotImplementedError(
            "qk_norm archs are not ported yet (the port serves the dense "
            "family without per-head q/k norms)")
    return p


def _qkv(x, p, cfg: ArchConfig, positions, rope: bool = True,
         qmm_impl: str = "kernel"
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projection -> RoPE as real f32 tensors, ONE rounding at the end:
    q/k/v feed the int8 KV encode in the serving engine, where a one-ulp
    input flip moves a whole vector's scale."""
    f32 = torch.float32
    q = L.dense(x, p["wq"], bias=p.get("bq"), out_dtype=f32, qmm_impl=qmm_impl)
    k = L.dense(x, p["wk"], bias=p.get("bk"), out_dtype=f32, qmm_impl=qmm_impl)
    v = L.dense(x, p["wv"], bias=p.get("bv"), out_dtype=f32, qmm_impl=qmm_impl)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def attn_apply(x, p, cfg: ArchConfig, *, positions, attn_impl: str = "naive",
               causal: bool = True, return_kv: bool = False,
               qmm_impl: str = "kernel", cache: Optional[Dict] = None,
               lengths: Optional[torch.Tensor] = None
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
    reference's intended ``"pallas_decode"``. ``qmm_impl`` is a
    :func:`layers.dense` route for int8 weights."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, positions, qmm_impl=qmm_impl)
    new_cache = None
    if cache is not None:
        from repro_torch.kernels import ops as kops
        kc, vc = cache["k"], cache["v"]
        if not kc.dtype.is_floating_point:
            raise NotImplementedError(
                f"a {kc.dtype} dense cache is not ported (the reference "
                f"casts k/v to it with no scale)")
        slot = torch.clamp(lengths.long(), 0, kc.shape[1] - 1)
        rows = torch.arange(kc.shape[0], device=kc.device)
        kc[rows, slot] = k[:, 0].to(kc.dtype)
        vc[rows, slot] = v[:, 0].to(vc.dtype)
        new_cache = {"k": kc, "v": vc}
        out = kops.flash_decode(q, kc.to(q.dtype), vc.to(q.dtype),
                                (lengths + 1).int())
    else:
        out = L.attention(q, k, v, mode=attn_impl, causal=causal)
        if return_kv:
            new_cache = {"k": k, "v": v}
    y = L.dense(out, p["wo"], n_in=2, qmm_impl=qmm_impl)
    return x + y, new_cache


def ffn_specs(cfg: ArchConfig, n_stack: int) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    s, ly = (n_stack,), ("layers",)
    return {
        "ln": spec(s + (d,), ly + ("embed",), "ones"),
        "w_gate": spec(s + (d, f), ly + ("embed", "mlp")),
        "w_up": spec(s + (d, f), ly + ("embed", "mlp")),
        "w_down": spec(s + (f, d), ly + ("mlp", "embed")),
    }


def ffn_apply(x, p, cfg: ArchConfig, qmm_impl: str = "kernel"
              ) -> torch.Tensor:
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"],
                        qmm_impl=qmm_impl)


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


def _ssm_pre(h, p, cfg: ArchConfig, conv_state=None, capture_tail=False,
             n_valid=None):
    """in_proj + causal conv + splits. Returns z, x, B, C, dt and the new
    conv state (decode, chunk continue) or the conv-input tail (whole
    sequence with ``capture_tail``).

    ``n_valid`` (a (1,) or 0-dim integer tensor, chunked prefill only)
    marks the valid prefix of a right-padded chunk: dt is zeroed past it
    (a state-neutral no-op for the SSD recurrence) and the carried conv
    tail is read from the last valid inputs (a gather, no host sync).

    The whole pre-pipeline (in_proj output, conv, silu, splits) runs in
    real f32 with no rounding between ops, and the conv history is f32,
    as in the reference."""
    di, g, ns, nh = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, \
        cfg.n_ssm_heads
    zxbcdt = L.dense(h, p["in_proj"], out_dtype=torch.float32)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * g * ns]
    dt = zxbcdt[..., di + di + 2 * g * ns:]
    b, t = h.shape[0], h.shape[1]
    new_conv_state = None
    if conv_state is not None and t == 1:            # decode: T == 1
        buf = torch.cat([conv_state, xbc], dim=1)              # (B, W, C)
        w = p["conv_w"].float()
        xbc = (torch.einsum("bwc,wc->bc", buf, w)[:, None, :]
               + p["conv_b"][None, None])
        new_conv_state = buf[:, 1:]
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
    xbc = L.silu(xbc)
    xs = xbc[..., :di].reshape(b, t, nh, cfg.ssm_headdim)
    Bs = xbc[..., di: di + g * ns].reshape(b, t, g, ns)
    Cs = xbc[..., di + g * ns:].reshape(b, t, g, ns)
    dt = _softplus(dt.float() + p["dt_bias"][None, None, :])
    if n_valid is not None:
        # padded positions: dt=0 => decay exp(0)=1 and update x*dt=0, so
        # the SSD state is untouched past the valid prefix
        keep = torch.arange(t, device=dt.device) < n_valid.reshape(())
        dt = torch.where(keep[None, :, None], dt,
                         torch.zeros((), device=dt.device))
    return z, xs, Bs, Cs, dt, new_conv_state


def ssm_apply(x, p, cfg: ArchConfig, *, cache: Optional[Dict] = None,
              ssd_impl: str = "ref", return_state: bool = False,
              n_valid=None) -> Tuple[torch.Tensor, Any]:
    """Mamba-2 residual block. ``cache=None``: a whole sequence (prefill;
    ``return_state`` also returns ``{"conv", "state"}`` to resume from).
    A cache and T == 1: one decode step. A cache and T > 1: a chunk of
    chunked prefill continuing from the carried (conv, state), with
    ``n_valid`` marking the valid prefix of a right-padded chunk.
    ``ssd_impl`` is ``models.ssd.ssd_chunked``'s ``impl``."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    a = -torch.exp(p["a_log"].float())                         # (H,)
    if cache is not None and x.shape[1] == 1:
        z, xs, Bs, Cs, dt, conv_state = _ssm_pre(h, p, cfg, cache["conv"])
        y, new_state = ssd_decode_step(
            xs[:, 0], Bs[:, 0], Cs[:, 0], dt[:, 0], a, p["d_skip"],
            cache["state"])
        y = y[:, None]
        new_cache = {"conv": conv_state, "state": new_state}
    elif cache is not None:
        z, xs, Bs, Cs, dt, conv_state = _ssm_pre(h, p, cfg, cache["conv"],
                                                 n_valid=n_valid)
        y, final_state = ssd_chunked(xs, Bs, Cs, dt, a, p["d_skip"],
                                     chunk=cfg.ssm_chunk, impl=ssd_impl,
                                     init_state=cache["state"])
        new_cache = {"conv": conv_state, "state": final_state}
    else:
        z, xs, Bs, Cs, dt, conv_tail = _ssm_pre(
            h, p, cfg, capture_tail=return_state)
        y, final_state = ssd_chunked(xs, Bs, Cs, dt, a, p["d_skip"],
                                     chunk=cfg.ssm_chunk, impl=ssd_impl)
        new_cache = ({"conv": conv_tail, "state": final_state}
                     if return_state else None)
    b, t = h.shape[0], h.shape[1]
    y = y.reshape(b, t, cfg.d_inner)
    y = L.rmsnorm(y * L.silu(z), p["norm"], cfg.norm_eps)
    # f32 all the way through out_proj, ONE rounding into the residual type
    out = L.dense(y, p["out_proj"]).to(x.dtype)
    return x + out, new_cache


def ssm_init_cache(cfg: ArchConfig, batch: int, device=None) -> Dict:
    """Zero (conv, state) for ``batch`` rows. Both leaves are f32: the SSD
    state always is, and the conv history keeps the f32 pre-pipeline
    values unrounded, so a chunk-continued conv equals the whole-prompt
    one at chunk boundaries."""
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch),
                            dtype=torch.float32, device=device),
        "state": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
    }
