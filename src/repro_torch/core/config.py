"""Architecture, workload shape and technique configuration (copies of
``repro.core.config``'s ``ArchConfig``, ``ShapeSpec``/``SHAPES`` and
``Technique``/``technique_from_label``).

The port keeps its own copy rather than importing the JAX package. The
reference module's TPU hardware model stays behind: nothing the port
runs reads it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


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


# --------------------------------------------------------------------------
# The paper's optimization-technique matrix (one row == one Technique).
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Technique:
    """A composable row of the paper's Tables III/IV/IX.

    ``zero_stage``: 0 = Naive DP (replicated params+opt, all-reduce grads);
    1 = shard optimizer state; 2 = +shard gradients (reduce-scatter);
    3 = +shard parameters (all-gather per use).
    """
    zero_stage: int = 0
    offload: bool = False          # Z1/2: opt state -> host; Z3: opt+params
    remat: str = "none"            # none | selective | full
    quant: str = "none"            # none | int8 | nf4  (weight quantization)
    flash: bool = False            # flash attention
    peft: str = "none"             # none | lora | qlora
    lora_rank: int = 64

    # parallelism plan
    tp: bool = True                # use the `model` mesh axis for TP
    sp: bool = False               # Megatron-style sequence parallelism
    attn_mode: str = "auto"        # auto | head | seq (context-parallel)
    grad_compress: bool = False    # int8 gradient compression (beyond-paper)
    grad_accum: int = 1
    # beyond-paper: gather ZeRO-3 params once per step instead of once per
    # microbatch (trades one resident TP-shard copy for accum-x fewer AGs)
    zero3_gather_once: bool = False

    # serving
    kv_quant: str = "none"         # none | int8 (LightLLM Int8KV analogue)
    kv_block: int = 256            # paged-KV block size (tokens)

    def label(self) -> str:
        """Short paper-style label, e.g. 'F+R+Z3+O'."""
        parts = []
        if self.peft == "lora":
            parts.append("L")
        elif self.peft == "qlora":
            parts.append("QL")
        if self.flash:
            parts.append("F")
        if self.remat != "none":
            parts.append("R")
        if self.zero_stage:
            parts.append(f"Z{self.zero_stage}")
        if self.offload:
            parts.append("O")
        if self.quant != "none" and self.peft == "none":
            parts.append("Q")
        return "+".join(parts) if parts else "Naive"


NAIVE = Technique()


def technique_from_label(label: str, **overrides) -> Technique:
    """Parse a paper-style label ('F+R+Z3+O', 'QL+Z2', 'Naive') into a
    Technique."""
    kw: dict = {}
    for tok in label.split("+"):
        t = tok.strip().upper()
        if t in ("", "NAIVE"):
            continue
        elif t == "L":
            kw["peft"] = "lora"
        elif t == "QL":
            kw["peft"] = "qlora"
        elif t == "F":
            kw["flash"] = True
        elif t == "R":
            kw["remat"] = "full"
        elif t == "RS":
            kw["remat"] = "selective"
        elif t in ("Z1", "Z2", "Z3"):
            kw["zero_stage"] = int(t[1])
        elif t == "O":
            kw["offload"] = True
        elif t == "Q":
            kw["quant"] = "nf4"
        elif t == "Q8":
            kw["quant"] = "int8"
        else:
            raise ValueError(f"unknown technique token {tok!r} in {label!r}")
    kw.update(overrides)
    return Technique(**kw)
