"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 experts do not divide the 16-way model axis; the tuner may set
pad_experts_to=64 when expert parallelism is selected (DESIGN.md §7).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151936,
    n_experts=60,
    n_shared_experts=4,
    shared_d_ff=5632,
    top_k=4,
    pad_experts_to=64,
    norm="rmsnorm",
    act="silu",
    glu=True,
)
