"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; hf]

Attention-sharding knobs are inapplicable (attention-free); the tuner tunes
time-mix/channel-mix regions instead (DESIGN.md §7). O(1) decode state ->
long_500k runs.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,
    norm="layernorm",
    act="silu",
    glu=False,
    long_context_ok=True,
)
