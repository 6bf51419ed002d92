"""The port's ``kernels.ops.matmul`` and ``kernels.ops.attention`` against
the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's wrappers run the plain PyTorch versions; the JAX side runs
the Pallas kernels ``tuned_matmul`` and ``flash_attention`` in interpret
mode, as the JAX package's own tests run them.  Shapes and tiles are those
of ``tests/test_kernels.py``; the tolerances are its own: matmul 5e-5 in
f32 and 2e-2 in bf16 (rtol, with atol ten times that), attention 1e-4.
The CUDA kernels themselves are held against their plain versions by the
``gpu`` tests (which skip without a card) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.tuned_matmul import tuned_matmul as jtuned_matmul
from repro_torch.core import counters
from repro_torch.kernels import LAUNCHES, cuda_build, ops, ref, work
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import tuned_matmul as ttm

MATMUL_CASES = [((128, 128, 128), (64, 64, 64)),
                ((256, 512, 128), (128, 128, 128)),
                ((64, 384, 256), (32, 128, 128))]
ATTN_CASES = [(128, 64, 64, 64), (256, 128, 128, 64), (128, 64, 32, 128)]
MASKS = [(True, 0), (False, 0), (True, 32)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mm_inputs(seed, M, K, N):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((M, K)) * 0.5).astype(np.float32),
            (rng.standard_normal((K, N)) * 0.5).astype(np.float32))


def _attn_inputs(seed, S, Sk, D, B=2, H=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((B, n, H, D)) * 0.5).astype(np.float32)
            for n in (S, Sk, Sk)]


@pytest.mark.parametrize("shape,blocks", MATMUL_CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matmul_matches_jax(shape, blocks, dtype):
    """ops.matmul (plain version) against the Pallas tuned_matmul in
    interpret mode, and against the JAX package's ops.matmul."""
    M, K, N = shape
    bm, bn, bk = blocks
    jdt, tdt = DTYPES[dtype]
    x, y = _mm_inputs(0, M, K, N)
    want = np.asarray(jtuned_matmul(jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                                    bm=bm, bn=bn, bk=bk, interpret=True),
                      np.float32)
    got = ops.matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt),
                     bm=bm, bn=bn, bk=bk)
    assert got.dtype == tdt and got.shape == (M, N)
    tol = 5e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * 10)
    via_ops = np.asarray(jops.matmul(jnp.asarray(x, jdt), jnp.asarray(y, jdt),
                                     bm=bm, bn=bn, bk=bk), np.float32)
    np.testing.assert_allclose(got.float().numpy(), via_ops, rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("S,D,bq,bk", ATTN_CASES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_attention_matches_jax(S, D, bq, bk, causal, window):
    """ops.attention (plain version) against the Pallas flash_attention in
    interpret mode, both in the (B, S, H, D) model layout."""
    q, k, v = _attn_inputs(1, S, S, D)
    want = np.asarray(jops.attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, window=window,
                                     block_q=bq, block_k=bk))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window, block_q=bq, block_k=bk)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,Sk,D,bq,bk,causal,window", [
    (256, 128, 64, 64, 64, True, 16),     # S != Sk, causal, rows that see
                                          # no key (qi >= Sk + window - 1)
    (128, 256, 64, 32, 32, False, 16),    # a non-causal window sees keys
                                          # past the query
    (256, 128, 64, 64, 32, False, 8),     # dead rows, non-causal
])
def test_attention_masking_cases_match_jax(S, Sk, D, bq, bk, causal, window):
    """The masking cases a tile-skipping kernel can get wrong: absolute
    positions when S != Sk, non-causal windows, and rows whose every key
    is masked (the TPU kernel's uniform result, the mean of v)."""
    q, k, v = _attn_inputs(2, S, Sk, D)
    want = np.asarray(jops.attention(*map(jnp.asarray, (q, k, v)),
                                     causal=causal, window=window,
                                     block_q=bq, block_k=bk))
    got = ops.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window, block_q=bq, block_k=bk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    dead = np.arange(S) >= Sk + window - 1
    if dead.any():
        np.testing.assert_allclose(
            got[:, dead], np.broadcast_to(v.mean(axis=1, keepdims=True),
                                          got[:, dead].shape),
            rtol=1e-5, atol=1e-5)


def test_non_dividing_tiles_raise_in_both_packages():
    x, y = _mm_inputs(3, 64, 384, 256)
    with pytest.raises(AssertionError):
        jtuned_matmul(jnp.asarray(x), jnp.asarray(y), bm=48, interpret=True)
    with pytest.raises(ValueError, match="must divide"):
        ops.matmul(torch.from_numpy(x), torch.from_numpy(y), bm=48)
    q, k, v = _attn_inputs(3, 128, 128, 64)
    with pytest.raises(AssertionError):
        jops.attention(*map(jnp.asarray, (q, k, v)), block_q=48)
    with pytest.raises(ValueError, match="must divide"):
        ops.attention(*map(torch.from_numpy, (q, k, v)), block_q=48)
    # tiles above a dim clamp to it, as in the JAX package
    got = ops.matmul(torch.from_numpy(x), torch.from_numpy(y), bm=1024)
    np.testing.assert_allclose(got.numpy(), x @ y, rtol=1e-5, atol=1e-4)


def test_cuda_wrappers_refuse_cpu_tensors_and_count_nothing():
    before = dict(LAUNCHES)
    x, y = map(torch.from_numpy, _mm_inputs(4, 64, 64, 64))
    with pytest.raises(ValueError, match="CUDA"):
        ttm.tuned_matmul(x, y)
    q = torch.zeros(4, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, q, q)
    assert dict(LAUNCHES) == before
    assert (64, 64, 64) in ttm.MENU and (128, 128, 128) in ttm.MENU


def test_build_is_lazy_and_keyed_on_source():
    for name in ("tuned_matmul", "flash_attention"):
        assert name not in cuda_build._loaded
        path = cuda_build.library_path(name)
        assert path.parent == cuda_build.build_dir()
        assert path.name.startswith(f"lib{name}_")


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 16)])
def test_meta_tensors_get_shapes_and_note_their_work(causal, window):
    """Handed meta tensors, the wrappers return empty outputs of the right
    shape and dtype and note the call's work (kernels.work) as one op."""
    def mm(a, b):
        return ops.matmul(a, b)

    x = torch.zeros(256, 512, dtype=torch.bfloat16)
    y = torch.zeros(512, 384, dtype=torch.bfloat16)
    rc = counters.collect(mm, x, y)
    nbytes, flops = work.matmul(256, 384, 512, 2)
    assert (rc.total.bytes, rc.total.flops, rc.total.ops) == (nbytes, flops, 1)
    q = torch.zeros(2, 256, 4, 64)

    def attn(a):
        out = ops.attention(a, a, a, causal=causal, window=window)
        assert out.device.type == "meta" and out.shape == a.shape
        return out

    rc = counters.collect(attn, q)
    nbytes, flops = work.attention(8, 256, 256, 64, 4, causal, window)
    assert (rc.total.bytes, rc.total.flops, rc.total.ops) == (nbytes, flops, 1)
    # the work's pair count is the plain version's mask
    qpos, kpos = np.arange(256)[:, None], np.arange(256)[None, :]
    mask = np.ones((256, 256), bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    assert work.visible_pairs(256, 256, causal, window) == int(mask.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain_versions(dtype):
    """On the card: both kernels against their plain versions within
    ref.KERNEL_TOL at every test shape, the launches counted, and a tile
    outside the matmul menu refused by name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (M, K, N), (bm, bn, bk) in MATMUL_CASES:
        x, y = (torch.from_numpy(a).cuda().to(dtype)
                for a in _mm_inputs(5, M, K, N))
        n0 = LAUNCHES["tuned_matmul"]
        got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk)
        torch.cuda.synchronize()
        assert LAUNCHES["tuned_matmul"] == n0 + 1
        assert ref.within_tol(got, ref.matmul(x, y), dtype)
    with pytest.raises(ValueError, match="instantiated"):
        ops.matmul(x, y, bm=16, bn=16, bk=16)
    for S, D, bq, bk in ATTN_CASES:
        for causal, window in MASKS:
            q, k, v = (torch.from_numpy(a).cuda().to(dtype)
                       for a in _attn_inputs(6, S, S, D))
            got = ops.attention(q, k, v, causal=causal, window=window,
                                block_q=bq, block_k=bk)
            torch.cuda.synchronize()
            want = ref.flash_attention(q, k, v, causal=causal, window=window)
            assert ref.within_tol(got, want, dtype), (S, D, bq, bk, causal,
                                                      window)
