"""Architecture / run configuration system.

One ``ArchConfig`` dataclass covers every assigned model family (dense, MoE,
SSM, hybrid, enc-dec, VLM-backbone).  Each ``src/repro_torch/configs/<id>.py``
exports ``CONFIG`` (full published scale) built from this dataclass; smoke
tests call ``CONFIG.reduced()`` for a tiny same-family variant.

Input shapes are global: ``ShapeConfig`` carries (seq_len, global_batch, kind)
where kind selects which step is lowered (train / prefill / decode).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned per the brief; identical set for all LM-family archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'ssm' | 'hybrid' | 'encdec' | 'vlm'
    n_layers: int
    d_model: int
    n_heads: int          # 0 for attention-free families
    n_kv_heads: int
    d_ff: int             # per-expert d_ff for MoE
    vocab_size: int
    head_dim: int = 0     # 0 -> d_model // n_heads
    # --- attention flavour ---
    qk_norm: bool = False
    swa_window: int = 0           # 0 = full attention; >0 = sliding-window
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0   # fraction of head_dim that is rotated
    use_rope: bool = True
    causal: bool = True
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    pad_experts_to: int = 0       # tuner may pad expert count for EP legality
    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    rwkv_head_dim: int = 64
    # --- hybrid (zamba2-style): one shared attention block every k SSM blocks
    attn_every: int = 0
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 0              # padded source length (frames)
    # --- norm / act ---
    norm: str = "rmsnorm"         # 'rmsnorm' | 'layernorm'
    act: str = "silu"             # 'silu' | 'gelu'
    glu: bool = True              # gated MLP (SwiGLU/GeGLU) vs plain 2-matrix
    tie_embeddings: bool = False
    # --- modality frontend stub ---
    frontend: str = "none"        # 'none' | 'audio_frames' | 'vision_patches'
    dtype: str = "bfloat16"
    # long_500k applicability (sub-quadratic attention path exists)
    long_context_ok: bool = False

    # -- derived -----------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def n_ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def supports_shape(self, shape: ShapeConfig) -> bool:
        """long_500k needs a sub-quadratic attention path (see DESIGN.md)."""
        if shape.name == "long_500k":
            return self.long_context_ok
        return True

    # -- reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config: small width/depth, few experts, tiny vocab."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, n_heads) if n_heads else 0
        if n_kv and self.n_kv_heads < self.n_heads:
            n_kv = max(1, n_heads // 2)  # keep GQA structure
        d_model = 64
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16 if self.n_heads else 0,
            d_ff=96,
            shared_d_ff=96 if self.shared_d_ff else 0,
            vocab_size=256,
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            pad_experts_to=0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else self.ssm_head_dim,
            rwkv_head_dim=16,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            enc_len=32 if self.enc_len else 0,
        )

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and roofline)."""
        from repro_torch.models.model import count_params  # lazy import

        return count_params(self)


def param_bytes(cfg: ArchConfig, dtype_bytes: int = 2) -> int:
    return cfg.param_count() * dtype_bytes
