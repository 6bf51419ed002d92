"""The f32 paths of the dense kernels, emulated on the CPU: the 3xTF32
split that ``csrc/flash_attention.cu`` runs on the tensor cores and that
``csrc/tuned_matmul.cu`` was measured against before it kept the CUDA
cores; the operand checks both wrappers gained; the tensor-core f32 bound.

The split: a = hi + lo with hi = tf32(a) (``cvt.rna.tf32.f32``: to nearest,
ties away from zero, 10 bits of mantissa kept) and lo = tf32(a - hi); a
product is lo.hi + hi.lo + hi.hi, lo.lo dropped.  Each of hi.hi, lo.hi and
hi.lo is exact in f32 (11 x 11 significant bits), so the emulation sums
them with f32 matmuls here; the tensor cores' own f32 adds (not rounded to
nearest, which the kernel keeps to short spans) are not emulated.
Tolerances are ``ref.KERNEL_TOL``'s f32 (1e-5 + 1e-5 x |plain|).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import roofline
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref, work
from repro_torch.kernels import tuned_matmul as ttm

F32 = torch.float32


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna`` does, on the f32 word: add half of
    the 13 dropped bits' weight to the magnitude, then clear them (ties go
    away from zero; finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(F32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def outside(got, want) -> int:
    rtol, atol = ref.KERNEL_TOL[F32]
    return int(((got - want).abs() > atol + rtol * want.abs()).sum())


def _draw(seed, *shapes, std=0.5):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s) * std, dtype=F32)
            for s in shapes]


def test_tf32_rounds_to_nearest_with_ties_away_and_split_is_exact():
    x = _draw(0, (4096,), std=3.0)[0]
    hi, lo = split(x)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # to nearest: within half a unit of the 10-bit mantissa
    assert bool(((x - hi).abs() <= 2.0 ** -11 * x.abs()).all())
    # hi + lo keeps 22 bits: x is recovered within 2^-22 of itself
    assert bool(((x - (hi + lo)).abs() <= 2.0 ** -22 * x.abs()).all())
    # ties: 1 + 2^-11 (halfway between 1 and 1 + 2^-10) goes away from 0
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                         1 + 3 * 2.0 ** -11, 1 + 2.0 ** -12], dtype=F32)
    assert tf32(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                   1 + 2 * 2.0 ** -10, 1.0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matmul_split_is_f32_accurate_but_not_the_plain_products_order(seed):
    """(64, 2048) @ (2048, 256), std 0.5: the three-term product is as
    close to the exact product as the f32 plain product is, and a single
    TF32 pass misses the tolerance on nearly every output.  Yet the three
    terms, summed in another order than the plain product's, miss the
    tolerance against it on a few outputs: at K = 2048 two f32 orders
    differ by more than 1e-5 near zero.  That is why the f32 kernel keeps
    the plain product's order, one f32 FMA chain along K, on the CUDA cores
    (on the card the split missed on 2.2e4-5.9e4 of 11.5e6 outputs at
    2048 x 2048 @ 2048 x 5632, ``tf32_span.py``)."""
    x, y = _draw(seed, (64, 2048), (2048, 256))
    (xh, xl), (yh, yl) = split(x), split(y)
    three = xl @ yh + xh @ yl + xh @ yh
    one = xh @ yh
    plain = ref.matmul(x, y)
    exact = (x.double() @ y.double()).float()
    f32_err = float((plain - exact).abs().max())
    assert float((three - exact).abs().max()) <= 2 * f32_err
    assert outside(three, exact) <= max(2 * outside(plain, exact), 2)
    assert outside(one, plain) > 0.9 * plain.numel()
    assert float((one - exact).abs().max()) > 10 * f32_err
    assert 0 < outside(three, plain) < 1e-3 * plain.numel()


@pytest.mark.parametrize("window", [0, 128])
def test_attention_split_meets_the_f32_bound_on_one_row_block(window):
    """One (b, h) of the timed shape (S 512, D 64, std 1, causal): S =
    Q.K^T and O = P.V each as three TF32 products, the softmax in f32,
    within the tolerance of the plain version on every output; a single
    TF32 pass of either product misses it."""
    S, D = 512, 64
    q, k, v = (t.reshape(1, S, 1, D) for t in _draw(3, (S, D), (S, D),
                                                     (S, D), std=1.0))
    want = ref.flash_attention(q, k, v, window=window)

    def emulate(passes):
        Q, K, V = q[0, :, 0], k[0, :, 0], v[0, :, 0]
        (qh, ql), (kh, kl), (vh, vl) = split(Q), split(K), split(V)
        s = qh @ kh.T if passes == 1 else ql @ kh.T + qh @ kl.T + qh @ kh.T
        s = s / math.sqrt(D)
        qpos, kpos = torch.arange(S)[:, None], torch.arange(S)[None, :]
        mask = qpos >= kpos
        if window:
            mask &= qpos - kpos < window
        s = torch.where(mask, s, torch.full_like(s, ref.NEG_INF))
        p = torch.exp(s - s.amax(-1, keepdim=True))
        (ph, pl), l_ = split(p), p.sum(-1, keepdim=True)
        o = ph @ vh if passes == 1 else pl @ vh + ph @ vl + ph @ vh
        return (o / l_).reshape(1, S, 1, D)

    assert outside(emulate(3), want) == 0
    assert outside(emulate(1), want) > 0.1 * want.numel()


def test_matmul_operands_must_be_16_byte_aligned_in_both_dtypes():
    """The f32 kernel loads its tiles by 16-byte loads, as bf16 does by
    TMA: a misaligned view raises, every menu tile's shapes pass (K and N
    are multiples of 64 under the menu)."""
    for dtype in (F32, torch.bfloat16):
        for bm, bn, bk in ttm.MENU:
            x = torch.zeros(bm, bk, dtype=dtype)
            y = torch.zeros(bk, bn, dtype=dtype)
            assert ttm.menu_tiles(bm, bn, bk, bm, bn, bk) == (bm, bn, bk)
            ttm.check_aligned_operands(x, y)
        flat = torch.zeros(64 * 64 + 1, dtype=dtype)
        off = flat[1:].view(64, 64)
        with pytest.raises(ValueError, match="16-byte aligned"):
            ttm.check_aligned_operands(off, torch.zeros(64, 64, dtype=dtype))
        with pytest.raises(ValueError, match="16-byte aligned"):
            ttm.check_aligned_operands(torch.zeros(64, 64, dtype=dtype), off)


def test_attention_k_and_v_must_be_16_byte_aligned_f32_q_need_not():
    """f32 K and V rows arrive by 16-byte copies, f32 Q one element at a
    time; bf16 keeps its checks (Q read as 4-byte words)."""
    B, S, H, D = 1, 64, 2, 64

    def view(dtype, offset):
        flat = torch.zeros(B * S * H * D + offset, dtype=dtype)
        return flat[offset:].view(B, S, H, D)

    def strides(q, k, v):
        return [s for t in (q, k, v, q)
                for s in tfa.kernel_strides(t.stride(), "bshd")]

    for dtype in (F32, torch.bfloat16):
        ok = view(dtype, 0)
        tfa.check_aligned(ok, ok, ok, strides(ok, ok, ok))
        bad = view(dtype, 1)
        for q, k, v in ((ok, bad, ok), (ok, ok, bad)):
            with pytest.raises(ValueError, match="16-byte"):
                tfa.check_aligned(q, k, v, strides(q, k, v))
        if dtype == F32:
            tfa.check_aligned(bad, ok, ok, strides(bad, ok, ok))
        else:
            with pytest.raises(ValueError, match="16-byte"):
                tfa.check_aligned(bad, ok, ok, strides(bad, ok, ok))
    # a head slice of a wider model-layout tensor stays aligned
    big = torch.zeros(B, S, 3 * H + 1, D)
    k = big[:, :, 1:1 + H]
    tfa.check_aligned(k, k, k, strides(k, k, k))


def test_tf32_bound_is_three_passes_at_half_the_bf16_rate():
    for card in (roofline.H100_SXM, roofline.H100_PCIE, roofline.H100_NVL):
        # the data sheets' figures, half the bf16 ones as they round them
        assert np.isclose(card.tf32_flops, card.bf16_flops / 2, rtol=2e-3)
    assert roofline.H100_SXM.tf32_flops == 495e12
    nbytes, ops = work.matmul(2048, 5632, 2048, 4)
    ms, by = work.bound_ms(nbytes, ops, F32, tf32_passes=3)
    assert by == "operations" and np.isclose(
        ms, 3 * 2 * 2048 * 5632 * 2048 / 495e12 * 1e3)
    # the default is unchanged: f32 on the CUDA cores
    ms, by = work.bound_ms(nbytes, ops, F32)
    assert roofline.peak_ops(F32) == 67e12
    assert np.isclose(ms, 2 * 2048 * 5632 * 2048 / 67e12 * 1e3)
    # a call bound by bytes stays so
    nbytes, ops = work.attention(256, 512, 512, 64, 4, True, 128)
    ms, by = work.bound_ms(nbytes, ops, F32, tf32_passes=3)
    assert by == "bytes" and np.isclose(ms, nbytes / 3.35e12 * 1e3)
