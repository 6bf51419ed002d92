"""internvl2-26b [vlm] — InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-style LM backbone. [arXiv:2404.16821; hf]

Backbone only per the brief; 48 heads / 8 kv heads. Full attention ->
long_500k SKIPPED.
"""
from repro_torch.configs.base import ArchConfig

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
    norm="rmsnorm",
    act="silu",
    glu=True,
    frontend="vision_patches",
)
