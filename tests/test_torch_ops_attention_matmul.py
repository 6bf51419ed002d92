"""The port's ``kernels.ops.matmul`` and ``kernels.ops.attention`` against
the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's wrappers run the plain PyTorch versions; the JAX side runs
the Pallas kernels ``tuned_matmul`` and ``flash_attention`` in interpret
mode, as the JAX package's own tests run them.  Shapes and tiles are those
of ``tests/test_kernels.py``; the tolerances are its own: matmul 5e-5 in
f32 and 2e-2 in bf16 (rtol, with atol ten times that), attention 1e-4.
The matmul's tile menu and the attention wrapper's strides are checked
here too, as pure functions of shapes and strides.
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


# the default tiles (128, 128, 128) clamped to the JAX test shapes and to
# shapes with one dim of 64: each resolves to a tile of the widened menu
CLAMPED_DEFAULT_CASES = [shape for shape, _ in MATMUL_CASES] + [
    (64, 128, 128), (128, 64, 128), (128, 128, 64), (64, 64, 64),
    (64, 256, 64)]


@pytest.mark.parametrize("shape", CLAMPED_DEFAULT_CASES)
def test_menu_takes_every_tile_the_reference_computes(shape):
    """The JAX test shapes at their own tiles and at the default tiles, and
    shapes with one dim of 64, resolve to a tile of ``MENU`` (so
    ``ops.matmul`` runs them on the card), and the Pallas reference in
    interpret mode computes each: the port no longer refuses a tile the
    reference accepts."""
    M, K, N = shape
    x, y = _mm_inputs(7, M, K, N)
    own = [blocks for s, blocks in MATMUL_CASES if s == shape]
    for bm, bn, bk in own + [(128, 128, 128)]:
        assert ttm.menu_tiles(M, N, K, bm, bn, bk) in ttm.MENU
        want = np.asarray(jtuned_matmul(jnp.asarray(x), jnp.asarray(y),
                                        bm=bm, bn=bn, bk=bk, interpret=True))
        np.testing.assert_allclose(want, x @ y, rtol=5e-5, atol=5e-4)


def test_plain_matmul_is_exact_for_bf16_and_f32_for_f32():
    """The plain matmul the kernel is held to: for bf16 operands the exact
    product (f64 sum) rounded once to f32, for f32 operands the f32
    product."""
    x, y = (torch.from_numpy(a) for a in _mm_inputs(10, 64, 2048, 64))
    exact = torch.matmul(x.bfloat16().double(), y.bfloat16().double())
    got = ref.matmul(x.bfloat16(), y.bfloat16())
    assert got.dtype == torch.float32
    assert torch.equal(got, exact.float())
    assert torch.equal(ref.matmul(x, y), torch.matmul(x, y))


def test_tiles_outside_the_menu_still_raise_naming_it():
    """A tile that divides the dims but is not instantiated raises, with the
    menu in the message, and is never swapped for another tile."""
    assert len(ttm.MENU) == 12 and len(set(ttm.MENU)) == 12
    for M, N, K, tiles in [(64, 256, 384, (16, 128, 128)),
                           (96, 128, 128, (128, 128, 128)),
                           (128, 32, 128, (128, 128, 128))]:
        with pytest.raises(ValueError, match=r"takes \(bm, bn, bk\) in "
                                             r"\(\(32, 64, 64\)"):
            ttm.menu_tiles(M, N, K, *tiles)


@pytest.mark.parametrize("B,S,H,D", [(2, 8, 3, 32), (1, 16, 4, 64)])
def test_kernel_strides_address_every_layout(B, S, H, D):
    """The (batch, head, row) strides the attention wrapper hands the kernel
    address each element where ``tensor.stride()`` puts it: the folded
    (BH, S, D) layout, the contiguous model layout (batch S*H*D, head D,
    row H*D), a head slice of a wider tensor and a (B, H, S, D) tensor
    viewed back as (B, S, H, D)."""
    folded = torch.zeros(B * H, S, D)
    assert tfa.kernel_strides(folded.stride(), "bhsd") == (S * D, 0, D)
    model = torch.zeros(B, S, H, D)
    assert tfa.kernel_strides(model.stride(), "bshd") == (S * H * D, D, H * D)
    views = [model, torch.zeros(B, S, H + 2, D)[:, :, 1:H + 1],
             torch.zeros(B, H, S, D).transpose(1, 2)]
    rng = np.random.default_rng(8)
    for t in views:
        sb, sh, sr = tfa.kernel_strides(t.stride(), "bshd")
        for _ in range(20):
            b, s_, h, d = (int(rng.integers(n)) for n in t.shape)
            offset = (t[b, s_, h, d].data_ptr() - t.data_ptr()) // 4
            assert offset == b * sb + h * sh + s_ * sr + d
    with pytest.raises(ValueError, match="contiguous"):
        tfa.kernel_strides(model.transpose(2, 3).stride(), "bshd")


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
    ref.KERNEL_TOL at every test shape (the matmul at every tile of the
    menu, and at the default tiles on (64, 384, 256)), the launches
    counted, and a tile outside the matmul menu refused by name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for (M, K, N), _ in MATMUL_CASES:
        x, y = (torch.from_numpy(a).cuda().to(dtype)
                for a in _mm_inputs(5, M, K, N))
        for bm, bn, bk in ttm.MENU:
            n0 = LAUNCHES["tuned_matmul"]
            got = ops.matmul(x, y, bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            assert LAUNCHES["tuned_matmul"] == n0 + 1
            assert ref.within_tol(got, ref.matmul(x, y), dtype), (
                M, K, N, bm, bn, bk)
    x, y = (torch.from_numpy(a).cuda().to(dtype)
            for a in _mm_inputs(5, 64, 384, 256))
    assert ref.within_tol(ops.matmul(x, y), ref.matmul(x, y), dtype)
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


def _model_layout_views(dtype, view, B=2, S=256, H=2, D=64):
    """q, k, v as non-contiguous (B, S, H, D) views on the card: head
    slices of one wider tensor, or (B, H, S, D) tensors viewed back."""
    rng = np.random.default_rng(9)
    if view == "slice":
        big = torch.from_numpy(rng.standard_normal((B, S, 3 * H + 1, D))
                               .astype(np.float32)).cuda().to(dtype)
        return [big[:, :, 1 + i * H:1 + (i + 1) * H] for i in range(3)]
    return [torch.from_numpy(rng.standard_normal((B, H, S, D))
                             .astype(np.float32)).cuda().to(dtype)
            .transpose(1, 2) for _ in range(3)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["slice", "transposed"])
def test_cuda_attention_reads_model_layout_views_in_place(dtype, view):
    """On the card: ops.attention on non-contiguous model-layout views
    matches the plain version within ref.KERNEL_TOL with exactly one launch
    and no copy (the call allocates its output and nothing more)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = _model_layout_views(dtype, view)
    assert not q.is_contiguous()
    torch.cuda.synchronize()
    n0 = LAUNCHES["flash_attention"]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = ops.attention(q, k, v, window=64, block_q=64, block_k=64)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == n0 + 1
    assert torch.cuda.max_memory_allocated() - base <= (
        got.numel() * got.element_size() + 1024)
    assert got.shape == q.shape and got.is_contiguous()
    want = ref.flash_attention(q, k, v, window=64)
    assert ref.within_tol(got, want, dtype)
