"""DBRX-132B [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 per expert, vocab 100352,
MoE 16 experts top-4 (fine-grained), every layer MoE.
"""
from repro_torch.core.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500000.0,
    n_experts=16,
    top_k=4,
    moe_every=1,
)
