"""Llama2-7B — the paper's primary benchmark model [arXiv:2307.09288].

32L d_model=4096 32H (MHA kv=32) head_dim=128 d_ff=11008, vocab 32000,
no QKV bias, untied head.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
)
