"""The port's paged-attention wrappers against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages.  On the
CPU the port's wrappers run the plain PyTorch version; the JAX wrappers
run the Pallas kernel in interpret mode, as the JAX package's own tests
run it.  Tolerance 1e-5 in f32: both sides compute a softmax in f32 over
the same positions and differ only in summation order.  The CUDA kernel
itself is held against the plain version by the ``gpu`` tests (which skip
without a card) and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import LAUNCHES, cuda_build, ops, ref
from repro_torch.kernels import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, S, KVH, G, D, ps, MP, lengths, span, q_std=0.5):
    """q from N(0, q_std^2), pages from N(0, 0.5^2), non-aliasing random
    block tables covering ``lengths[b] + span`` positions per row
    (zero-length rows stay parked on the null page)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * MP                        # page 0 is the null sink
    qshape = (B, S, KVH, G, D) if S else (B, KVH, G, D)
    q = (rng.standard_normal(qshape) * q_std).astype(np.float32)
    kp = (rng.standard_normal((P, ps, KVH, D)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((P, ps, KVH, D)) * 0.5).astype(np.float32)
    perm = rng.permutation(np.arange(1, P))
    bt = np.zeros((B, MP), np.int32)
    lengths = np.asarray(lengths, np.int32)
    used = 0
    for b in range(B):
        n = -(-int(lengths[b] + span) // ps) if lengths[b] else 0
        bt[b, :n] = perm[used:used + n]
        used += n
    return q, kp, vp, bt, lengths


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("ps,MP,bk", [(8, 4, 0), (8, 4, 4), (16, 3, 8),
                                      (16, 3, 16)])
def test_paged_attention_matches_jax(ps, MP, bk):
    """Single-query decode: mixed lengths (page-aligned, ragged, and a
    zero-length inactive row — garbage by contract, checked finite)."""
    B, KVH, G, D = 3, 2, 3, 32
    args = _inputs(0, B, 0, KVH, G, D, ps, MP, [ps * MP, ps + 3, 0], 0)
    want = np.asarray(jops.paged_attention(*map(jnp.asarray, args),
                                           block_k=bk))
    got = ops.paged_attention(*_t(*args), block_k=bk).numpy()
    act = args[4] > 0
    np.testing.assert_allclose(got[act], want[act], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("ps,MP,S,bk", [(8, 4, 3, 0), (8, 4, 5, 4),
                                        (16, 3, 2, 8), (16, 3, 4, 16)])
def test_paged_attention_multiquery_matches_jax(ps, MP, S, bk):
    """Multi-query verify attention: query s sees lengths + s positions
    (staircase); ragged lengths, one zero-length inactive row."""
    B, KVH, G, D = 3, 2, 3, 32
    lengths = [ps * MP - (S - 1), ps + 2, 0]
    args = _inputs(1, B, S, KVH, G, D, ps, MP, lengths, S - 1)
    want = np.asarray(jops.paged_attention_mq(*map(jnp.asarray, args),
                                              block_k=bk))
    got = ops.paged_attention_mq(*_t(*args), block_k=bk).numpy()
    act = args[4] > 0
    np.testing.assert_allclose(got[act], want[act], **TOL)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("S", [1, 3])
def test_plain_version_matches_jax_oracle_on_every_row(S):
    """The port's plain version is the JAX oracle's function, zero-length
    rows included (both average the gathered V under an all-masked row)."""
    args = _inputs(2, 3, S, 2, 2, 16, 8, 3, [17, 4, 0], S - 1)
    want = np.asarray(jref.paged_attention_mq(*map(jnp.asarray, args)))
    got = ref.paged_attention_mq(*_t(*args)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_single_query_equals_multiquery_at_s1():
    """The S=1 multi-query wrapper is exactly the single-query one."""
    q, kp, vp, bt, lengths = _inputs(3, 2, 0, 2, 2, 16, 8, 3, [24, 5], 0)
    single = ops.paged_attention(*_t(q, kp, vp, bt, lengths))
    multi = ops.paged_attention_mq(*_t(q[:, None], kp, vp, bt, lengths))
    torch.testing.assert_close(single, multi[:, 0], rtol=0, atol=0)


def test_cpu_dispatch_keeps_dtype_and_checks_block_k():
    q, kp, vp, bt, lengths = _inputs(4, 2, 2, 2, 1, 16, 8, 2, [9, 3], 1)
    tq, tk, tv, tb, tl = _t(q, kp, vp, bt, lengths)
    out = ops.paged_attention_mq(tq.bfloat16(), tk.bfloat16(), tv.bfloat16(),
                                 tb, tl)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    with pytest.raises(ValueError, match="divide"):
        ops.paged_attention_mq(tq, tk, tv, tb, tl, block_k=3)


def test_cuda_wrapper_refuses_cpu_tensors_and_does_not_count():
    """The kernel wrapper takes CUDA tensors only: CPU tensors raise before
    anything is built or counted (the dispatch in ops is by device)."""
    before = LAUNCHES[tpa.NAME]
    args = _t(*_inputs(5, 2, 1, 2, 1, 16, 8, 2, [9, 3], 0))
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_attention_mq(*args)
    assert LAUNCHES[tpa.NAME] == before


def test_build_is_lazy_and_keyed_on_source():
    """Importing the wrapper builds nothing; the library path carries a
    hash of the source, so an edited kernel never loads a stale build."""
    assert "paged_attention" not in cuda_build._loaded
    path = cuda_build.library_path("paged_attention")
    assert path.parent == cuda_build.build_dir()
    assert path.name.startswith("libpaged_attention_")
    assert tpa.shard_kv_heads(8, 2) == 4
    with pytest.raises(ValueError):
        tpa.shard_kv_heads(6, 4)


def _bf16_faults(q, kp, vp, bt, lengths):
    """Plausible bf16-only faults of a kernel, made from the plain
    version: each returns a bf16 output shaped like q."""
    def p_in_bf16():
        B, S, KVH, G, D = q.shape
        k = kp[bt.long()].reshape(B, -1, KVH, D).float()
        v = vp[bt.long()].reshape(B, -1, KVH, D).float()
        s = torch.einsum("bshge,bkhe->bshgk", q.float(), k) / D ** 0.5
        vis = (torch.arange(k.shape[1])[None, None]
               < (lengths.long()[:, None] + torch.arange(S))[..., None])
        s = torch.where(vis[:, :, None, None], s, torch.full_like(s, -1e30))
        p = torch.softmax(s, -1).bfloat16().float()
        return torch.einsum("bshgk,bkhe->bshge", p, v).bfloat16()

    def wrong_page():
        bt2 = bt.clone()
        bt2[0, 2] = bt2[0, 3]
        return ref.paged_attention_mq(q, kp, vp, bt2, lengths).bfloat16()

    def dropped_rows():
        return ref.paged_attention_mq(q, kp, vp, bt, lengths - 8).bfloat16()

    def truncating_store():
        out = ref.paged_attention_mq(q, kp, vp, bt, lengths)
        return (out.view(torch.int32) & ~0xFFFF).view(torch.float32)

    return dict(p_in_bf16=p_in_bf16, wrong_page=wrong_page,
                dropped_rows=dropped_rows, truncating_store=truncating_store)


def _peaked_bf16_args(seed, S):
    """The kernel checks' inputs: q of std 5 (scores of std 2.5 at HD 64,
    a peaked softmax across tiles), bf16, ragged lengths and an idle row."""
    args = _inputs(seed, 4, S, 4, 2, 64, 16, 8, [100, 77, 40, 0], S - 1,
                   q_std=5.0)
    q, kp, vp, bt, lengths = _t(*args)
    return q.bfloat16(), kp.bfloat16(), vp.bfloat16(), bt, lengths


@pytest.mark.parametrize("fault", ["none", "p_in_bf16", "wrong_page",
                                   "dropped_rows", "truncating_store"])
def test_bf16_kernel_tolerance_rejects_bf16_faults(fault):
    """The bf16 bound the CUDA kernel is held to (``ref.KERNEL_TOL``, used
    by the gpu test below and by chip_smoke.py) passes the plain version's
    output rounded to nearest and fails each plausible bf16-only fault."""
    args = _peaked_bf16_args(7, 3)
    want = ref.paged_attention_mq(*args)
    act = args[4] > 0
    if fault == "none":
        assert ref.within_tol(want.bfloat16()[act], want[act], torch.bfloat16)
    else:
        got = _bf16_faults(*args)[fault]()
        assert not ref.within_tol(got[act], want[act], torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,bk", [(1, 0), (3, 8)])
def test_cuda_kernel_matches_plain_version(dtype, S, bk):
    """The CUDA kernel against the plain version on the card (skips here),
    on the peaked-softmax inputs, under ``ref.KERNEL_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, kp, vp, bt, lengths = [t.cuda() for t in _peaked_bf16_args(6, S)]
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = LAUNCHES[tpa.NAME]
    got = ops.paged_attention_mq(q, kp, vp, bt, lengths, block_k=bk)
    torch.cuda.synchronize()
    assert LAUNCHES[tpa.NAME] == before + 1
    want = ref.paged_attention_mq(q, kp, vp, bt, lengths)
    act = lengths > 0
    assert got.dtype == dtype
    assert ref.within_tol(got[act], want[act], dtype)
    assert torch.isfinite(got.float()).all()
