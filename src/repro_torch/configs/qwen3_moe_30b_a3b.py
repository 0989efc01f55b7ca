"""Qwen3-MoE-30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L d_model=2048 32H (GQA kv=4) expert d_ff=768, vocab 151936,
MoE 128 experts top-8, qk-norm (Qwen3), every layer MoE.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    norm_eps=1e-6,
    n_experts=128,
    top_k=8,
    moe_every=1,
)
