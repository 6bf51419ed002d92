"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]

54 Mamba2 blocks with one *shared-weight* attention block applied every 6
blocks (Zamba2's signature weight-shared transformer block). ssm_state=64,
expand=2, ssm head_dim 64 -> 80 SSM heads (divisible by the 16-way model
axis). SSM state gives a sub-quadratic path -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    norm="rmsnorm",
    act="silu",
    glu=True,
    long_context_ok=True,
)
