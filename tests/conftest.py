"""Shared fixtures. NOTE: no XLA_FLAGS here — tests run on the real single
CPU device; only launch/dryrun.py fakes 512 devices (per the brief)."""
import jax
import jax.numpy as jnp
import pytest


@pytest.fixture(scope="session")
def key():
    return jax.random.PRNGKey(0)


def tiny_batch(cfg, key, batch=2, seq=32):
    """Concrete batch for a reduced config (with stub modality inputs)."""
    import jax.numpy as jnp
    ks = jax.random.split(key, 3)
    out = {
        "tokens": jax.random.randint(ks[0], (batch, seq), 0, cfg.vocab_size,
                                     dtype=jnp.int32),
        "labels": jax.random.randint(ks[1], (batch, seq), 0, cfg.vocab_size,
                                     dtype=jnp.int32),
    }
    if cfg.family == "encdec":
        out["frames"] = jax.random.normal(
            ks[2], (batch, cfg.enc_len, cfg.d_model)).astype(jnp.bfloat16)
    if cfg.frontend == "vision_patches":
        out["vision_embeds"] = jax.random.normal(
            ks[2], (batch, 8, cfg.d_model)).astype(jnp.bfloat16)
    return out


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: runs a CUDA kernel; skips where no CUDA device is "
                   "present")
