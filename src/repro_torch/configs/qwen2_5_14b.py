"""Qwen2.5-14B [hf:Qwen family].

48L d_model=5120 40H (GQA kv=8) d_ff=13824, vocab 152064, QKV bias,
rope theta 1e6, norm eps 1e-6.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-14b",
    family="dense",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    norm_eps=1e-6,
)
