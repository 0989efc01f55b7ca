"""Jamba-v0.1-52B [arXiv:2403.19887].

32L d_model=4096 32H (GQA kv=8) d_ff=14336, vocab 65536, MoE 16e top-2.
Hybrid: 1 attention layer per 8 (attn at offset 4 within each period),
the rest are Mamba blocks; MoE FFN on every other layer.
Jamba v0.1 uses Mamba-1 internally; the SSM blocks are modelled in the
SSD (Mamba-2) form, the chunked scan the SSD kernel runs, with jamba's
state=16: d_inner 8192 in 128 heads of 64.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    n_experts=16,
    top_k=2,
    moe_every=2,
    moe_offset=1,
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_ngroups=1,
    attn_period=8,
    attn_offset=4,
    sub_quadratic=True,
)
