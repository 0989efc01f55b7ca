"""Llama2-13B — paper benchmark model [arXiv:2307.09288].

40L d_model=5120 40H (MHA kv=40) head_dim=128 d_ff=13824, vocab 32000,
no QKV bias, untied head.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="llama2-13b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=13824,
    vocab_size=32000,
)
