"""InternVL2-26B language backbone (InternLM2-20B) [arXiv:2404.16821].

48L d_model=6144 48H (GQA kv=8) d_ff=16384, vocab 92553. The InternViT-6B
vision frontend is a stub: callers pass precomputed patch embeddings
(B, patches, d_model) as ``frontend_embeds``, prepended to the tokens.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    frontend="vision",
    frontend_len=256,
)
