"""Architecture configuration (a copy of ``repro.core.config.ArchConfig``).

The port keeps its own copy rather than importing the JAX package. The
TPU hardware model, workload shapes and technique matrix of the
reference module stay behind: nothing on the serving path reads them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False          # qwen3-style per-head RMSNorm on q/k
    rope_fraction: float = 1.0     # chatglm3: rotary applied to half of head_dim
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_ngroups: int = 1

    # hybrid (jamba): one attention layer per `attn_period`, at `attn_offset`
    attn_period: int = 0
    attn_offset: int = 4

    # encoder-decoder
    n_enc_layers: int = 0

    # modality frontend stub
    frontend: str = "none"         # none | audio | vision
    frontend_len: int = 256

    sub_quadratic: bool = False
    dp_over_model: bool = False

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Sequence-mixer kind per layer: 'attn' or 'ssm'."""
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.n_layers))
        if self.family == "hybrid" and self.attn_period:
            return tuple(
                "attn" if (i % self.attn_period) == self.attn_offset else "ssm"
                for i in range(self.n_layers)
            )
        return tuple("attn" for _ in range(self.n_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        """FFN kind per layer: 'dense' or 'moe'."""
        if not self.is_moe:
            return tuple("dense" for _ in range(self.n_layers))
        return tuple(
            "moe" if (i % self.moe_every) == self.moe_offset else "dense"
            for i in range(self.n_layers)
        )

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameter count."""
        d, hd = self.d_model, self.head_dim
        per_attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        if self.qkv_bias:
            per_attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        per_dense_ffn = 3 * d * self.d_ff
        per_expert = 3 * d * self.d_ff
        per_moe_ffn = self.n_experts * per_expert + d * self.n_experts
        per_moe_active = self.top_k * per_expert + d * self.n_experts
        di, ns = self.d_inner, self.ssm_state
        per_ssm = (
            d * (2 * di + 2 * self.ssm_ngroups * ns + self.n_ssm_heads)
            + (di + 2 * self.ssm_ngroups * ns) * self.ssm_conv
            + di * d
            + 3 * self.n_ssm_heads
        )
        norms = 2 * d * self.n_layers + d
        total = norms + self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            total += per_attn if kind == "attn" else per_ssm
        for kind in self.ffn_kinds():
            if kind == "moe":
                total += per_moe_active if active_only else per_moe_ffn
            else:
                total += per_dense_ffn
        if self.n_enc_layers:
            total += self.n_enc_layers * (per_attn + per_dense_ffn + 2 * d)
            total += self.n_layers * (per_attn + d)
        return int(total)

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration of the same family (tiny, CPU-runnable)."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers,
                         (2 * self.attn_period) if self.attn_period else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=(min(self.n_kv_heads, 2)
                        if self.n_kv_heads < self.n_heads else 4),
            head_dim=16,
            d_ff=128,
            vocab_size=256,
        )
        if self.is_moe:
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      capacity_factor=8.0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=32)
        if self.n_enc_layers:
            kw.update(n_enc_layers=2)
        if self.frontend != "none":
            kw.update(frontend_len=8)
        return replace(self, **kw)
