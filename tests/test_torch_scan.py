"""The port's linear-attention scans against the JAX package's.

Inputs are made with numpy from a seed and fed to both packages, as the
JAX package's own scan tests make them: r, k, v ~ N(0, 0.3^2), decays w in
(0.45, 0.95), small u and entry state; x, b, c ~ N(0, 0.3^2), dt =
softplus(N(0, 1)), a = -exp(N(0, 0.3^2)).  On the CPU the port's wrappers
run the plain versions (:mod:`repro_torch.kernels.ref`); the JAX side runs
its ``ref`` oracles, its model forms, and its Pallas kernels in interpret
mode.  Tolerance 1e-5 (rtol and atol) in f32 everywhere: every side sums
the same f32 terms, in different orders (the chunked forms also
reassociate the recurrence, as the JAX package's own chunk-vs-fused test
allows at the same 1e-5).  The CUDA kernels are held against the plain
versions by the ``gpu`` tests (which skip without a card) and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ImportError:  # fall back to the deterministic local shim
    from _hypothesis_compat import given, settings
    from _hypothesis_compat import strategies as st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.models import scan_utils as jscan_utils
from repro_torch.kernels import LAUNCHES, cuda_build, ops, ref
from repro_torch.kernels import linear_scan as tls
from repro_torch.models import mamba2, rwkv6, scan_utils

TOL = dict(rtol=1e-5, atol=1e-5)
TS = [1, 3, 64, 100, 128]


def _wkv_np(seed, B, T, H, N):
    """Model layout: r, k, v, w (B, T, H, N); u (H, N); s0 (B, H, N, N)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    r, k, v = (n((B, T, H, N)) * 0.3 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-n((B, T, H, N))))
    return [a.astype(np.float32) for a in
            (r, k, v, w, n((H, N)) * 0.1, n((B, H, N, N)) * 0.1)]


def _ssd_np(seed, B, T, H, P, N):
    """Model layout: x (B, T, H, P); b, c (B, T, N); dt (B, T, H); a (H,);
    s0 (B, H, P, N)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return [a.astype(np.float32) for a in
            (n((B, T, H, P)) * 0.3, n((B, T, N)) * 0.3, n((B, T, N)) * 0.3,
             np.log1p(np.exp(n((B, T, H)))), -np.exp(n((H,)) * 0.3),
             n((B, H, P, N)) * 0.1)]


def _inputs(kind, seed, T, B=2):
    return _wkv_np(seed, B, T, 3, 8) if kind == "wkv" else \
        _ssd_np(seed, B, T, 3, 8, 8)


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


def _close(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or TOL))


_PLAIN = {("wkv", 0): (ref.wkv_linear_scan, jref.wkv_linear_scan),
          ("ssd", 0): (ref.ssd_linear_scan, jref.ssd_linear_scan),
          ("wkv", 1): (ref.wkv_chunk, jref.wkv_chunk),
          ("ssd", 1): (ref.ssd_chunk, jref.ssd_chunk)}


@pytest.mark.parametrize("kind,C", [("wkv", 0), ("wkv", 3), ("wkv", 64),
                                    ("ssd", 0), ("ssd", 3), ("ssd", 64),
                                    ("ssd", 256)])
@pytest.mark.parametrize("T", TS)
def test_plain_scans_match_jax_oracles(kind, T, C):
    """The four plain versions against the JAX package's ``ref`` oracles
    (C=0: the sequential recurrence; else the chunked scan with a shorter
    last chunk where C does not divide T).  C=256 for SSD only: the
    tuner's mamba-region chunk candidates reach 256."""
    arrs = _inputs(kind, T + C, T)
    port, jax_ = _PLAIN[(kind, bool(C))]
    extra = (C,) if C else ()
    _close(port(*_t(arrs), *extra), jax_(*_j(arrs), *extra))


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("C", [0, 3, 64])
def test_wkv_model_forms_match_jax(T, C):
    """``rwkv6.wkv_scan`` / ``wkv_chunked`` (through ``ops.wkv``) against
    the JAX model's forms; a chunk that does not divide T takes the
    sequential form on both sides."""
    arrs = _wkv_np(T + C, 2, T, 3, 8)
    if C:
        got = rwkv6.wkv_chunked(*_t(arrs), C)
        want = jrwkv6.wkv_chunked(*_j(arrs), C)
    else:
        got, want = rwkv6.wkv_scan(*_t(arrs)), jrwkv6.wkv_scan(*_j(arrs))
    _close(got, want)


@pytest.mark.parametrize("T", TS)
@pytest.mark.parametrize("C", [0, 3, 64, 256])
def test_ssd_model_forms_match_jax(T, C):
    """``mamba2.ssd_scan`` / ``ssd_chunked(precise=True)`` (through
    ``ops.ssd``) against the JAX model's forms."""
    arrs = _ssd_np(T + C, 2, T, 3, 8, 8)
    if C:
        got = mamba2.ssd_chunked(*_t(arrs), C, precise=True)
        want = jmamba2.ssd_chunked(*_j(arrs), C, precise=True)
    else:
        got, want = mamba2.ssd_scan(*_t(arrs)), jmamba2.ssd_scan(*_j(arrs))
    _close(got, want)


@pytest.mark.parametrize("kind", ["wkv", "ssd"])
@pytest.mark.parametrize("mode,T,bt", [("fused_recurrent", 32, 8),
                                       ("chunk", 64, 16), ("chunk", 12, 3)])
def test_ops_match_jax_pallas_interpret(kind, mode, T, bt):
    """``ops.wkv`` / ``ops.ssd`` against the JAX package's Pallas kernels
    in interpret mode, at T divisible by the time tile (the Pallas
    kernels' constraint; the port takes any T)."""
    arrs = _inputs(kind, T * bt, T)
    jfn, fn = (jops.wkv, ops.wkv) if kind == "wkv" else (jops.ssd, ops.ssd)
    want = jfn(*_j(arrs), bt=bt, mode=mode)
    got = fn(*_t(arrs), mode=mode, chunk=bt)
    _close(got, want)


@given(T=st.integers(1, 80), C=st.integers(1, 80),
       seed=st.integers(0, 2**16))
@settings(max_examples=20, deadline=None)
def test_chunk_vs_fused_at_arbitrary_boundaries(T, C, seed):
    """The ragged contract, on the port: when min(C, T) does not divide T
    the chunked forms return the sequential form's result bitwise (on the
    card the same fused kernel runs); otherwise they agree to 1e-5."""
    ragged = T % min(C, T) != 0
    for chunked, scan, arrs, extra in (
            (rwkv6.wkv_chunked, rwkv6.wkv_scan, _wkv_np(seed, 1, T, 2, 8),
             {}),
            (mamba2.ssd_chunked, mamba2.ssd_scan,
             _ssd_np(seed, 1, T, 2, 8, 8), dict(precise=True))):
        got = chunked(*_t(arrs), C, **extra)
        want = scan(*_t(arrs))
        for g, w in zip(got, want):
            if ragged:
                assert torch.equal(g, w)
            else:
                np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)


def test_chunked_scan_matches_jax():
    """``scan_utils.chunked_scan`` is the plain scan JAX's rematerialised
    one computes in a forward pass."""
    xs = np.random.default_rng(3).standard_normal((12, 4)).astype(np.float32)

    def step(c, x):                 # arithmetic both array types take
        c = 0.9 * c + x[0]
        return c, c * 2.0

    jc, jy = jscan_utils.chunked_scan(step, jnp.zeros(4), (jnp.asarray(xs),),
                                      chunk=4)
    tc, ty = scan_utils.chunked_scan(step, torch.zeros(4),
                                     (torch.from_numpy(xs),), chunk=4)
    _close((tc, ty), (jc, jy))


def test_unknown_mode_and_cpu_tensors_raise_and_count_nothing():
    """``ops`` refuses an unknown scan mode; the kernel wrappers take CUDA
    tensors only and raise before anything is built or counted."""
    arrs = _t(_wkv_np(0, 1, 4, 2, 16))
    with pytest.raises(ValueError, match="scan mode"):
        ops.wkv(*arrs, mode="auto")
    before = dict(LAUNCHES)
    kern = [t.transpose(1, 2).contiguous() if t.dim() == 4 and i < 4 else t
            for i, t in enumerate(arrs)]
    with pytest.raises(ValueError, match="CUDA"):
        tls.wkv(*kern)
    sarrs = _t(_ssd_np(0, 1, 4, 2, 16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tls.ssd(sarrs[0].transpose(1, 2).contiguous(), *sarrs[1:3],
                sarrs[3].transpose(1, 2).contiguous(), *sarrs[4:], chunk=2)
    assert LAUNCHES == before
    assert "linear_scan" not in cuda_build._loaded
    assert cuda_build.library_path("linear_scan").name.startswith(
        "liblinear_scan_")


# -- the chunk kernels' decomposition, mirrored in plain PyTorch ------------

_PHASED = {"wkv": (ref.wkv_chunk_phased, ref.wkv_chunk, jops.wkv),
           "ssd": (ref.ssd_chunk_phased, ref.ssd_chunk, jops.ssd)}


@pytest.mark.parametrize("kind", ["wkv", "ssd"])
@pytest.mark.parametrize("C", [3, 16, 64, 256, 512])
@pytest.mark.parametrize("T", [1, 3, 64, 100, 300, 512])
def test_phased_mirror_matches_plain_and_pallas(kind, T, C):
    """``ref.wkv_chunk_phased`` / ``ssd_chunk_phased`` (the CUDA chunk
    kernels' three phases, 64-step tiles and 16-step sub-tiles, in plain
    PyTorch) against the plain chunked forms at every (T, C), a shorter
    last chunk wherever C does not divide T, and against the JAX
    package's Pallas kernels in interpret mode where their time tile
    (min(C, 64), which must divide T) allows."""
    arrs = _inputs(kind, 7 * T + C, T)
    mirror, plain, jfn = _PHASED[kind]
    got = mirror(*_t(arrs), C)
    _close(got, plain(*_t(arrs), C))
    bt = min(C, 64)
    if T % bt == 0:
        _close(got, jfn(*_j(arrs), bt=bt, mode="chunk"))


@pytest.mark.parametrize("T,C", [(64, 64), (100, 16), (300, 256),
                                 (512, 512)])
def test_phased_wkv_extreme_decays_stay_finite(T, C):
    """Decays down to w = 1e-30 (log w = -69: a 16-step sub-tile spans
    e^-1100): the factorised off-diagonal products are products of
    factors <= 1 on both sides, so nothing overflows and no inf * 0 makes
    a NaN; the mirror agrees with the plain chunked form (exponents
    summed in float64) and with the sequential recurrence."""
    r, k, v, w, u, s0 = _t(_wkv_np(T, 2, T, 3, 8))
    g = torch.Generator().manual_seed(T)
    tiny = torch.rand(w.shape, generator=g) < 0.5
    w = torch.where(tiny, torch.full_like(w, 1e-30),
                    torch.rand(w.shape, generator=g) * 0.5 + 0.5)
    got = ref.wkv_chunk_phased(r, k, v, w, u, s0, C)
    for g_ in got:
        assert torch.isfinite(g_).all()
    _close(got, ref.wkv_chunk(r, k, v, w, u, s0, C))
    _close(got, ref.wkv_linear_scan(r, k, v, w, u, s0))


@pytest.mark.parametrize("T,chunk,want", [
    (1, 0, 1), (300, 0, 1), (3, 3, 1), (64, 64, 1), (64, 512, 1),
    (65, 256, 2), (100, 256, 2), (512, 512, 2), (512, 64, 3),
    (513, 512, 3), (4, 3, 3)])
def test_kernels_per_call(T, chunk, want):
    """CUDA kernels one wrapper call launches: the fused recurrence one;
    the chunked scan its chunk-state, state-pass and output kernels for
    several chunks, no state pass for one chunk, and only the output
    kernel (which then writes the final state) for one 64-step tile."""
    assert tls.kernels_per_call(T, chunk) == want


# -- the fused kernels' decomposition, mirrored in plain PyTorch ------------

_TILED = {"wkv": (ref.wkv_fused_tiled, ref.wkv_linear_scan, jops.wkv),
          "ssd": (ref.ssd_fused_tiled, ref.ssd_linear_scan, jops.ssd)}


@pytest.mark.parametrize("kind", ["wkv", "ssd"])
@pytest.mark.parametrize("width", [16, 64])
@pytest.mark.parametrize("T", [1, 3, 100])
@pytest.mark.parametrize("B", [1, 3])
def test_fused_tiled_mirror_matches_plain_and_pallas(kind, B, T, width):
    """``ref.wkv_fused_tiled`` / ``ssd_fused_tiled`` (the CUDA fused
    kernels' row or column tiles, per-lane float4 sums, xor-shuffle trees,
    cross-warp sum and once-a-step decay or bonus, in plain PyTorch), at
    every tile width the launchers take, against the plain recurrence and
    the JAX package's fused Pallas kernel in interpret mode (time tile bt
    dividing T), at widths 16 and 64 (N, and P = N for SSD)."""
    seed = 11 * T + B + width
    arrs = (_wkv_np(seed, B, T, 2, width) if kind == "wkv"
            else _ssd_np(seed, B, T, 2, width, width))
    mirror, plain, jfn = _TILED[kind]
    want = plain(*_t(arrs))
    bt = T if T < 20 else 20
    pallas = jfn(*_j(arrs), bt=bt, mode="fused_recurrent")
    # every tile the launchers take: a thread's rows of S (WKV 1, 2, 4;
    # SSD 2, 4, 8), up to the width
    most = min(4, width // 8) if kind == "wkv" else min(8, width // 8)
    for rows in ((1, 2, 4) if kind == "wkv" else (2, 4, 8)):
        if rows <= most:
            got = mirror(*_t(arrs), rows=rows)
            _close(got, want)
            _close(got, pallas)


@pytest.mark.parametrize("kind,B,H,width,want", [
    ("wkv", 1, 40, 64, 1), ("wkv", 2, 40, 64, 2), ("wkv", 8, 40, 64, 4),
    ("wkv", 64, 40, 16, 2), ("ssd", 1, 80, 64, 2), ("ssd", 2, 80, 64, 4),
    ("ssd", 8, 80, 64, 8), ("ssd", 64, 80, 16, 2)])
def test_fused_tile_choice(kind, B, H, width, want):
    """The fused launchers' state a thread (``ref.fused_per_thread``, as
    the CUDA launchers choose it): at rwkv6-3b's and zamba2-2.7b's widths a
    batch-1 call keeps 320 blocks (WKV 8-column, SSD 16-row tiles), a
    batch-8 call 640 (32 columns, 64 rows); never past the width."""
    if kind == "wkv":
        got = ref.fused_per_thread(B * H * (width // 8), 1,
                                   min(4, width // 8))
        blocks = B * H * width // (8 * got)
    else:
        got = ref.fused_per_thread(B * H * (width // 16), 2,
                                   min(8, width // 8))
        blocks = B * H * width // (8 * got)
    assert got == want
    assert blocks >= ref.FUSED_MIN_BLOCKS or got == (1 if kind == "wkv"
                                                     else 2)


def test_scan_inputs_made_aligned_for_the_kernels():
    """``ops`` hands the scan kernels 16-byte aligned f32 tensors (the
    kernels move rows as 16-byte copies): an aligned contiguous f32 view
    passes as it is, a misaligned one is copied, other dtypes converted."""
    base = torch.arange(20, dtype=torch.float32)
    assert ops._scan_f32(base) is base
    view = base[1:17]
    assert view.data_ptr() % 16 != 0
    got = ops._scan_f32(view)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, view)
    half = ops._scan_f32(base.bfloat16()[4:12])
    assert half.dtype == torch.float32 and half.data_ptr() % 16 == 0


# -- the CUDA kernels against their plain versions (skip without a card) ----

_GPU_CASES = {
    "wkv_fused": [(8, 1, 0), (1, 1, 0), (8, 3, 0), (1, 300, 0)],
    "wkv_chunk": [(8, 3, 3), (1, 512, 64), (1, 300, 64), (1, 512, 256),
                  (1, 64, 64), (1, 513, 64)],
    "ssd_fused": [(8, 1, 0), (1, 1, 0), (8, 3, 0), (1, 300, 0)],
    "ssd_chunk": [(8, 3, 3), (1, 512, 64), (1, 512, 256), (1, 300, 64),
                  (1, 64, 64), (1, 513, 64)],
}


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_GPU_CASES))
def test_cuda_scan_kernel_matches_plain_version(name):
    """Each CUDA scan kernel against its plain version on the card at the
    serve path's widths (rwkv6-3b: 40 heads of 64; zamba2-2.7b: 80 heads,
    P = N = 64), decode / verify / aligned and ragged prefill shapes:
    output and final state within ``ref.KERNEL_TOL`` in f32, one launch
    counted per call."""
    _needs_card()
    before = LAUNCHES[name]
    for B, T, chunk in _GPU_CASES[name]:
        if name.startswith("wkv"):
            arrs = [torch.from_numpy(a).cuda()
                    for a in _wkv_np(T + chunk, B, T, 40, 64)]
            got = ops.wkv(*arrs, mode="chunk" if chunk else "fused_recurrent",
                          chunk=chunk or 64)
            want = (ref.wkv_chunk(*arrs, chunk) if chunk
                    else ref.wkv_linear_scan(*arrs))
        else:
            arrs = [torch.from_numpy(a).cuda()
                    for a in _ssd_np(T + chunk, B, T, 80, 64, 64)]
            got = ops.ssd(*arrs, mode="chunk" if chunk else "fused_recurrent",
                          chunk=chunk or 64)
            want = (ref.ssd_chunk(*arrs, chunk) if chunk
                    else ref.ssd_linear_scan(*arrs))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert ref.within_tol(g, w, torch.float32), (name, B, T, chunk)
    assert LAUNCHES[name] == before + len(_GPU_CASES[name])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["wkv", "ssd"])
def test_cuda_fused_scan_kernels_at_width_16(kind):
    """The fused kernels' width-16 instantiation (``linear_scan.DIMS``;
    SSD at P = N = 16 and at P = 64, N = 16) against the plain recurrence,
    at T 1, at T 40 (three 16-step stages) and at 64 rows of 5 heads (the
    wider tiles: WKV 16 columns, SSD 16 and 64 rows): output and final
    state within ``ref.KERNEL_TOL``."""
    _needs_card()
    for B, T, P in [(3, 1, 16), (3, 40, 16), (2, 40, 64), (64, 3, 16),
                    (64, 3, 64)]:
        if kind == "wkv":
            if P != 16:
                continue
            arrs = [torch.from_numpy(a).cuda()
                    for a in _wkv_np(T + B, B, T, 5, 16)]
            got = ops.wkv(*arrs)
            want = ref.wkv_linear_scan(*arrs)
        else:
            arrs = [torch.from_numpy(a).cuda()
                    for a in _ssd_np(T + B, B, T, 5, P, 16)]
            got = ops.ssd(*arrs)
            want = ref.ssd_linear_scan(*arrs)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert ref.within_tol(g, w, torch.float32), (kind, B, T, P)


@pytest.mark.gpu
@pytest.mark.parametrize("T,C", [(512, 64), (300, 256)])
def test_cuda_wkv_chunk_extreme_decays(T, C):
    """The WKV chunk kernel at rwkv6-3b's widths with half the decays at
    w = 1e-30: finite, and within ``ref.KERNEL_TOL`` of the plain chunked
    form (exponents in float64) and of the sequential recurrence."""
    _needs_card()
    r, k, v, w, u, s0 = (torch.from_numpy(a).cuda()
                         for a in _wkv_np(T + C, 1, T, 40, 64))
    g = torch.Generator(device="cuda").manual_seed(T)
    w = torch.where(torch.rand(w.shape, generator=g, device="cuda") < 0.5,
                    torch.full_like(w, 1e-30), w)
    got = ops.wkv(r, k, v, w, u, s0, mode="chunk", chunk=C)
    for want in (ref.wkv_chunk(r, k, v, w, u, s0, C),
                 ref.wkv_linear_scan(r, k, v, w, u, s0)):
        for g_, w_ in zip(got, want):
            assert torch.isfinite(g_).all()
            assert ref.within_tol(g_, w_, torch.float32), (T, C)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,B,T,C", [("wkv", 1, 512, 64), ("wkv", 8, 3, 3),
                                        ("wkv", 8, 1, 0), ("wkv", 1, 100, 256),
                                        ("ssd", 1, 512, 64), ("ssd", 8, 3, 3),
                                        ("ssd", 1, 300, 512)])
def test_cuda_scan_kernels_per_call(kind, B, T, C):
    """One wrapper call launches ``kernels_per_call(T, chunk)`` CUDA
    kernels (torch.profiler over 10 calls), counts one launch, and
    synchronises with nothing (a call under sync debug mode 'error')."""
    from torch.profiler import ProfilerActivity, profile
    _needs_card()
    if kind == "wkv":
        arrs = [torch.from_numpy(a).cuda() for a in _wkv_np(0, B, T, 40, 64)]
        kern = [t.transpose(1, 2).contiguous() if i < 4 else t
                for i, t in enumerate(arrs)]
        call = lambda: tls.wkv(*kern, chunk=C)  # noqa: E731
    else:
        arrs = [torch.from_numpy(a).cuda()
                for a in _ssd_np(0, B, T, 80, 64, 64)]
        kern = [arrs[0].transpose(1, 2).contiguous(), *arrs[1:3],
                arrs[3].transpose(1, 2).contiguous(), *arrs[4:]]
        call = lambda: tls.ssd(*kern, chunk=C)  # noqa: E731
    call()
    torch.cuda.synchronize()
    name = f"{kind}_{'chunk' if C else 'fused'}"
    before = LAUNCHES[name]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            call()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert round(len(names) / 10) == tls.kernels_per_call(T, C), (
        len(names), sorted(set(n[:50] for n in names)))
    assert LAUNCHES[name] == before + 10
    torch.cuda.set_sync_debug_mode("error")
    try:
        call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
