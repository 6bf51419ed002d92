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


# chip_smoke.py's flash-attention cases, (S, Sk, D, causal, window, std):
# the JAX kernel tests' shapes under each mask, the masking cases, and the
# timed shape (S 512, D 64) at windows 0 and 128
FLASH_SMOKE_CASES = [(S, S, D, causal, window, 0.5)
                     for S, D in ((128, 64), (256, 128), (128, 32))
                     for causal, window in ((True, 0), (False, 0),
                                            (True, 32))] + [
    (256, 128, 64, True, 16, 0.5), (128, 256, 64, False, 16, 0.5),
    (256, 128, 64, False, 8, 0.5), (512, 512, 64, True, 0, 1.0),
    (512, 512, 64, True, 128, 1.0)]


def _flash_p_roundings(q, k, v, causal, window):
    """The flash kernel's P.V under each way of feeding P to a bf16 tensor
    core product, made from the plain version (one k-tile: P = exp(s -
    row max), the sum l in f32): each returns a bf16 output."""
    S, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    s = torch.einsum("bqhe,bkhe->bhqk", q.float(), k.float()) / D ** 0.5
    qpos, kpos = torch.arange(S)[:, None], torch.arange(Sk)[None, :]
    mask = torch.ones(S, Sk, dtype=torch.bool)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l_ = p.sum(-1, keepdim=True).permute(0, 2, 1, 3)

    def pv(pp):
        return torch.einsum("bhqk,bkhe->bqhe", pp, v.float()) / l_

    hi = p.bfloat16().float()
    lo = (p - hi).bfloat16().float()
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    return dict(
        none=lambda: want.bfloat16(),
        p_in_bf16=lambda: pv(hi).bfloat16(),
        p_split_hi_lo=lambda: (pv(hi) + pv(lo)).bfloat16(),
        truncating_store=lambda: (want.contiguous().view(torch.int32)
                                  & ~0xFFFF).view(torch.float32))


@pytest.mark.parametrize("case", FLASH_SMOKE_CASES)
@pytest.mark.parametrize("rounding", ["none", "p_in_bf16", "p_split_hi_lo",
                                      "truncating_store"])
def test_bf16_tolerance_settles_how_flash_feeds_p(rounding, case):
    """The numerical contract of the bf16 flash kernel: under
    ``ref.KERNEL_TOL``, P rounded once to bf16 for the tensor cores fails
    at every smoke case, P split into hi = bf16(P) and lo = bf16(P - hi)
    (two products into one f32 sum) passes like the exact output rounded to
    nearest, and a truncating store fails (batch 1 of the smoke's 2)."""
    S, Sk, D, causal, window, std = case
    rng = np.random.default_rng(21)

    def draw(n):
        return torch.tensor(rng.standard_normal((1, n, 2, D)) * std,
                            dtype=torch.float32).bfloat16()

    q, k, v = draw(S), draw(Sk), draw(Sk)
    want = ref.flash_attention(q, k, v, causal=causal, window=window)
    got = _flash_p_roundings(q, k, v, causal, window)[rounding]()
    assert ref.within_tol(got, want, torch.bfloat16) == (
        rounding in ("none", "p_split_hi_lo"))


# the split plan: (B, S, KVH, G, HD, item, page_size, max_pages, n_sm)
PLAN_SHAPES = [(8, 1, 32, 1, 64, 2, 16, 64, 132),    # the smoke's timed call
               (8, 3, 8, 4, 128, 2, 16, 64, 132),    # qwen3-8b verify
               (8, 1, 8, 4, 80, 4, 16, 64, 132),     # h2o-danube-1.8b, f32
               (1, 1, 8, 4, 128, 2, 16, 64, 132),
               (3, 2, 2, 3, 16, 4, 8, 5, 7),
               (2, 1, 1, 1, 256, 4, 4, 9, 132),
               (5, 4, 2, 2, 32, 2, 128, 3, 16),
               # internvl2-26b (G 6): ragged last row chunks, bf16 S 1 and
               # 3 (2 of 4 rows), f32 S 3 (2 of 8)
               (8, 1, 8, 6, 128, 2, 16, 64, 132),
               (8, 3, 8, 6, 128, 2, 16, 64, 132),
               (8, 3, 8, 6, 128, 4, 16, 64, 132)]


def _splits(p, max_pages):
    """The page runs of one block-table row the kernel's blocks walk under
    plan ``p``, split by split (block ``k`` takes pages ``k * pps`` up to
    the next split's first)."""
    pps = p.pages_per_split
    return [range(k * pps, min(max_pages, (k + 1) * pps))
            for k in range(p.n_split)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_split_plan_is_a_function_of_shapes_covering_each_page_once(shape):
    """The plan reads shapes only (the same call gives the same plan) and
    its splits cover every page of a block-table row exactly once, in
    order; its row chunks cover every query row."""
    B, S, KVH, G, HD, item, ps, MP, n_sm = shape
    p = tpa.plan(*shape)
    assert p == tpa.plan(*shape)
    pages = [i for run in _splits(p, MP) for i in run]
    assert pages == list(range(MP))
    assert all(len(run) for run in _splits(p, MP))
    assert (p.row_chunks - 1) * p.rows < S * G <= p.row_chunks * p.rows
    # a row's 16-byte vectors fit the lane group, which is no wider than
    # it needs to be
    nvec = HD * item // 16
    assert p.lanes <= 32 and p.lanes * p.vecs >= nvec
    assert p.lanes == 1 or p.lanes // 2 * p.vecs < nvec
    # q and the accumulator of a block's rows stay in registers
    assert p.rows * p.vecs * (16 // item) <= 32


def test_plan_is_memoised_and_buffers_kept_per_stream():
    """The engine makes the same call every layer of every step: the plan
    is computed once per shape, and the merge counters and partials'
    workspace are made once per (device, stream), zeroed, and grown only
    when a call needs more."""
    shape = (8, 1, 32, 1, 64, 2, 16, 64, 132)
    tpa.plan(*shape)
    hits = tpa.plan.cache_info().hits
    assert tpa.plan(*shape) is tpa.plan(*shape)
    assert tpa.plan.cache_info().hits == hits + 2
    bufs, cpu = {}, torch.device("cpu")
    a = tpa._stream_buffer(bufs, cpu, 7, 10, torch.int32)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert tpa._stream_buffer(bufs, cpu, 7, a.numel(), torch.int32) is a
    assert tpa._stream_buffer(bufs, cpu, 8, 10, torch.int32) is not a
    big = tpa._stream_buffer(bufs, cpu, 7, a.numel() + 1, torch.int32)
    assert big.numel() > a.numel() and not big.any()
    assert tpa._stream_buffer(bufs, cpu, 7, 10, torch.int32) is big


@pytest.mark.parametrize("B", [8, 1])
@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("item", [2, 4])
def test_split_plan_fills_the_card_at_qwen3_widths(B, S, item):
    """At qwen3-8b's heads (KVH 8, G 4, HD 128) and max_pages 64 the grid
    holds at least as many blocks as the H100 has SMs, at 8 slots and at
    one; the timed smoke config walks 16 pages a block (four rounds of 64
    positions)."""
    p = tpa.plan(B, S, 8, 4, 128, item, 16, 64, 132)
    assert p.blocks(B, 8) >= 132
    assert tpa.plan(8, 1, 32, 1, 64, 2, 16, 64, 132).pages_per_split == 16


def _split_merge(q, kp, vp, bt, lengths, p):
    """A plain-PyTorch emulation of the kernel's split-and-merge: each
    split's partial softmax state (m, l, acc) over the visible positions
    of its pages (masked positions weigh 0), then the merge in which a
    split with l = 0 weighs 0.  Returns the output (f32) and the number of
    (split, row) partials that were empty or fully masked."""
    B, S, KVH, G, D = q.shape
    ps, MP = kp.shape[1], bt.shape[1]
    k = kp[bt.long()].reshape(B, MP * ps, KVH, D).float()
    v = vp[bt.long()].reshape(B, MP * ps, KVH, D).float()
    s = torch.einsum("bshge,bkhe->bshgk", q.float(), k) / D ** 0.5
    t = torch.arange(MP * ps)
    sees = t[None, None] < (lengths.long()[:, None]
                            + torch.arange(S))[..., None]       # (B, S, T)
    m_all, l_all, acc_all, empty = [], [], [], 0
    for run in _splits(p, MP):
        in_run = (t >= run.start * ps) & (t < run.stop * ps)
        vis = (sees & in_run)[:, :, None, None, :]              # (B,S,1,1,T)
        sm = torch.where(vis, s, torch.full_like(s, -1e30))
        m = sm.amax(-1, keepdim=True)
        e = torch.where(vis, torch.exp(sm - m), torch.zeros_like(s))
        l = e.sum(-1, keepdim=True)
        empty += int((l == 0).sum())
        m_all.append(m)
        l_all.append(l)
        acc_all.append(torch.einsum("bshgk,bkhe->bshge", e, v))
    m, l, acc = (torch.stack(x) for x in (m_all, l_all, acc_all))
    live = l > 0
    big = torch.where(live, m, torch.full_like(m, -1e30)).amax(0)
    w = torch.where(live, torch.exp(m - big), torch.zeros_like(m))
    out = (w * acc).sum(0) / (w * l).sum(0).clamp_min(1e-30)
    return out, empty


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("shape", [(3, 2, 2, 32, 8, 6, [40, 16, 0], 7),
                                   (2, 1, 4, 16, 4, 16, [62, 3], 64),
                                   (4, 2, 1, 80, 8, 8, [62, 32, 8, 0], 16)])
def test_split_merge_emulation_matches_plain_version(shape, S):
    """The split-and-merge the kernel does, emulated in plain PyTorch with
    the kernel's plan, equals ``ref.paged_attention_mq`` within f32
    rounding on every active row; the cases hold empty splits (past a
    slot's length) and splits that mask out a row entirely (the staircase
    crossing a split), and zero-length rows stay finite."""
    B, KVH, G, D, ps, MP, lengths, n_sm = shape
    args = _t(*_inputs(8, B, S, KVH, G, D, ps, MP, lengths, S - 1,
                       q_std=5.0))
    p = tpa.plan(B, S, KVH, G, D, 4, ps, MP, n_sm)
    got, empty = _split_merge(*args, p)
    want = ref.paged_attention_mq(*args)
    act = args[4] > 0
    assert p.n_split > 1 and empty > 0
    torch.testing.assert_close(got[act], want[act], **TOL)
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("hd,ok", [(80, True), (8, True), (256, True),
                                   (12, False), (0, False), (264, False)])
def test_head_width_rule(hd, ok):
    """The kernel takes any head width that is a multiple of 8 up to 256
    (h2o-danube-1.8b's 80 included) and names the rule otherwise."""
    if ok:
        tpa.check_head_dim(hd)
        assert tpa.plan(2, 1, 8, 4, hd, 2, 16, 8, 132).lanes >= 1
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            tpa.check_head_dim(hd)


def _gpu_case_args(case, S):
    """The gpu test's inputs: the peaked-softmax check, then qwen3-8b's,
    h2o-danube-1.8b's and internvl2-26b's GQA widths on ragged lengths
    (internvl2's G 6 leaves the last row chunk of a block part-filled), and
    one slot of full length at max_pages 64 (every split of the table
    live)."""
    if case == "peaked":
        return _peaked_bf16_args(6, S)
    B, KVH, G, D, ps, MP, lengths = {
        "qwen3-8b": (4, 8, 4, 128, 16, 8, [100, 77, 40, 0]),
        "internvl2-26b": (4, 8, 6, 128, 16, 8, [100, 77, 40, 0]),
        "h2o-danube-1.8b": (4, 8, 4, 80, 16, 8, [100, 77, 40, 0]),
        "long-slot": (1, 8, 4, 128, 16, 64, [16 * 64 - (S - 1)])}[case]
    return _t(*_inputs(9, B, S, KVH, G, D, ps, MP, lengths, S - 1,
                       q_std=5.0))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["peaked", "qwen3-8b", "h2o-danube-1.8b",
                                  "internvl2-26b", "long-slot"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,bk", [(1, 0), (3, 8)])
def test_cuda_kernel_matches_plain_version(dtype, S, bk, case):
    """The CUDA kernel against the plain version on the card (skips here),
    on peaked-softmax inputs at the GQA widths of qwen3-8b,
    h2o-danube-1.8b and internvl2-26b and a long slot, under
    ``ref.KERNEL_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    q, kp, vp, bt, lengths = [t.cuda() for t in _gpu_case_args(case, S)]
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
