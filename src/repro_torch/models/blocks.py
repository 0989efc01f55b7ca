"""Dense transformer blocks: param specs and apply functions.

The dense-family subset of ``repro.models.blocks``: the attention block
(QKV bias, prefill branch) and the SwiGLU FFN. No sharding context: the
port serves on one card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.config import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.params import spec


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


def _qkv(x, p, cfg: ArchConfig, positions, rope: bool = True
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projection -> RoPE as real f32 tensors, ONE rounding at the end:
    q/k/v feed the int8 KV encode in the serving engine, where a one-ulp
    input flip moves a whole vector's scale."""
    q = L.dense(x, p["wq"], bias=p.get("bq"), out_dtype=torch.float32)
    k = L.dense(x, p["wk"], bias=p.get("bk"), out_dtype=torch.float32)
    v = L.dense(x, p["wv"], bias=p.get("bv"), out_dtype=torch.float32)
    if rope:
        q = L.apply_rope(q, positions, cfg.rope_fraction, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_fraction, cfg.rope_theta)
    return q.to(x.dtype), k.to(x.dtype), v.to(x.dtype)


def attn_apply(x, p, cfg: ArchConfig, *, positions, attn_impl: str = "naive",
               causal: bool = True, return_kv: bool = False
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self-attention residual block over a whole sequence (train/prefill
    branch of the reference); optionally returns the fresh (k, v).
    ``attn_impl`` is a :func:`layers.attention` mode."""
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(h, p, cfg, positions)
    out = L.attention(q, k, v, mode=attn_impl, causal=causal)
    y = L.dense(out, p["wo"], n_in=2)
    return x + y, ({"k": k, "v": v} if return_kv else None)


def ffn_specs(cfg: ArchConfig, n_stack: int) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    s, ly = (n_stack,), ("layers",)
    return {
        "ln": spec(s + (d,), ly + ("embed",), "ones"),
        "w_gate": spec(s + (d, f), ly + ("embed", "mlp")),
        "w_up": spec(s + (d, f), ly + ("embed", "mlp")),
        "w_down": spec(s + (f, d), ly + ("mlp", "embed")),
    }


def ffn_apply(x, p, cfg: ArchConfig) -> torch.Tensor:
    h = L.rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + L.swiglu(h, p["w_gate"], p["w_up"], p["w_down"])
