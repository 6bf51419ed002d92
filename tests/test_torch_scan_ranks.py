"""The CUDA scan kernels at the head counts a rank of the sharded step
gives them, against their plain versions (``tests/test_torch_scan.py``'s
style and inputs; these tests need a card and skip without one).

zamba2-2.7b's SSD scan runs on the rank's heads: 40 of its 80 at model 2
and 5 at model 16, at P = N = 64 (the chunk output kernel groups heads
and must stop at the last one, ``csrc/linear_scan.cu``).  rwkv6-3b's WKV
scan runs head-replicated, all 40 heads of 64 on every rank; it is also
held at 5 heads.  Shapes: a training segment (B 2, T 128), a decode step
(B 8, T 1) and a chunked prefill (B 1, T 256, chunk 64).  Output and
final state within ``ref.KERNEL_TOL`` in f32, one launch counted a call.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, ops, ref

HEADS = (5, 40)


def _wkv_np(seed, B, T, H, N):
    """``tests/test_torch_scan.py``'s WKV inputs: r, k, v, w (B, T, H, N);
    u (H, N); s0 (B, H, N, N)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    r, k, v = (n((B, T, H, N)) * 0.3 for _ in range(3))
    w = 0.45 + 0.5 / (1 + np.exp(-n((B, T, H, N))))
    return [a.astype(np.float32) for a in
            (r, k, v, w, n((H, N)) * 0.1, n((B, H, N, N)) * 0.1)]


def _ssd_np(seed, B, T, H, P, N):
    """``tests/test_torch_scan.py``'s SSD inputs: x (B, T, H, P); b, c
    (B, T, N); dt (B, T, H); a (H,); s0 (B, H, P, N)."""
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    return [a.astype(np.float32) for a in
            (n((B, T, H, P)) * 0.3, n((B, T, N)) * 0.3, n((B, T, N)) * 0.3,
             np.log1p(np.exp(n((B, T, H)))), -np.exp(n((H,)) * 0.3),
             n((B, H, P, N)) * 0.1)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


#: (B, T, chunk): chunk 0 is the fused recurrence
SHAPES = [(2, 128, 0), (8, 1, 0), (1, 256, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("H", HEADS)
@pytest.mark.parametrize("kind", ["wkv", "ssd"])
def test_cuda_scans_at_a_ranks_heads(kind, H):
    _needs_card()
    for B, T, chunk in SHAPES:
        name = f"{kind}_{'chunk' if chunk else 'fused'}"
        before = LAUNCHES.get(name, 0)
        mode = "chunk" if chunk else "fused_recurrent"
        if kind == "wkv":
            arrs = [torch.from_numpy(a).cuda()
                    for a in _wkv_np(T + H, B, T, H, 64)]
            got = ops.wkv(*arrs, mode=mode, chunk=chunk or 64)
            want = (ref.wkv_chunk(*arrs, chunk) if chunk
                    else ref.wkv_linear_scan(*arrs))
        else:
            arrs = [torch.from_numpy(a).cuda()
                    for a in _ssd_np(T + H, B, T, H, 64, 64)]
            got = ops.ssd(*arrs, mode=mode, chunk=chunk or 64)
            want = (ref.ssd_chunk(*arrs, chunk) if chunk
                    else ref.ssd_linear_scan(*arrs))
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.isfinite(g).all()
            assert ref.within_tol(g, w, torch.float32), (kind, H, B, T,
                                                         chunk)
        assert LAUNCHES[name] == before + 1, (name, B, T)
