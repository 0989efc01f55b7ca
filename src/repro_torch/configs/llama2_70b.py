"""Llama2-70B — paper benchmark model (GQA kv=8) [arXiv:2307.09288].

80L d_model=8192 64H (GQA kv=8) head_dim=128 d_ff=28672, vocab 32000,
no QKV bias, untied head.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="llama2-70b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32000,
)
