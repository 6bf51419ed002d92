"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]

SWA bounds the KV cache to the window, giving a sub-quadratic long-context
path -> long_500k runs for this arch (DESIGN.md §7).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32000,
    swa_window=4096,
    norm="rmsnorm",
    act="silu",
    glu=True,
    long_context_ok=True,
)
