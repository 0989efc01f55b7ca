"""ChatGLM3-6B [arXiv:2406.12793; hf].

28L d_model=4096 32H (GQA kv=2) d_ff=13696, vocab 65024.
2D RoPE: rotary applied to half the head dim. QKV bias.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65024,
    qkv_bias=True,
    rope_fraction=0.5,
)
