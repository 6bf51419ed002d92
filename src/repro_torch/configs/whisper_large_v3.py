"""whisper-large-v3 [audio] — enc-dec transformer backbone; conv frontend is a
STUB (input_specs provides precomputed frame embeddings). [arXiv:2212.04356; unverified]

20 heads are not divisible by the 16-way model axis -> attention regions use
context parallelism (q-seq sharded); encoder frames padded 1500 -> 1536 so the
source length is 16-divisible (DESIGN.md §7). Full attention -> long_500k
SKIPPED.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,          # decoder layers
    n_enc_layers=32,      # encoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    enc_len=1536,         # 1500 mel frames padded to a 16-divisible length
    use_rope=False,       # sinusoidal absolute positions
    norm="layernorm",
    act="gelu",
    glu=False,
    frontend="audio_frames",
)
