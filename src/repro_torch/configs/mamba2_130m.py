"""Mamba2-130M [arXiv:2405.21060].

24L d_model=768, attention-free SSD (state-space duality), ssm_state=128,
vocab 50280. d_inner=1536, headdim=64 -> 24 SSD heads. d_ff=0: every
layer still carries a zero-width FFN (an rmsnorm and three empty
products, a no-op on the residual), as the reference builds it.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_ngroups=1,
    sub_quadratic=True,
    dp_over_model=True,
    tie_embeddings=True,
)
