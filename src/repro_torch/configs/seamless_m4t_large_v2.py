"""SeamlessM4T-large-v2 text backbone [arXiv:2308.11596].

Encoder-decoder: 24 enc + 24 dec layers, d_model=1024 16H (kv=16),
d_ff=8192, vocab 256206. The audio frontend is a stub: callers pass
precomputed frame embeddings (B, frames, d_model) as ``frontend_embeds``.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    n_layers=24,            # decoder layers
    n_enc_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    frontend="audio",
    frontend_len=1024,      # precomputed audio-frame embeddings per sample
)
