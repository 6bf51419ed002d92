"""BOTS SparseLU analog: sparse linear algebra, irregular parallelism.

Blocked LU factorization (no pivoting) of a block-banded SPD-ish matrix;
only blocks inside the band are touched (the sparsity).  ``degree`` controls
how many trailing-submatrix block updates are batched per call.

The factorization runs eagerly, one op at a time from the host: the JAX
package traces the same loops into one compiled program.  The panel solves
of one step are one batched ``solve_triangular`` each way.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def make_matrix(nb: int = 8, bs: int = 32, band: int = 3, seed: int = 0):
    """Block-banded matrix as dense (nb, nb, bs, bs) with a band mask (CPU
    tensors; numpy's draws, so the JAX package's matrix bit for bit)."""
    rng = np.random.default_rng(seed)
    blocks = rng.standard_normal((nb, nb, bs, bs)).astype(np.float32) * 0.1
    mask = np.zeros((nb, nb), bool)
    for i in range(nb):
        for j in range(nb):
            mask[i, j] = abs(i - j) <= band
    blocks *= mask[:, :, None, None]
    for i in range(nb):  # diagonal dominance
        blocks[i, i] += np.eye(bs, dtype=np.float32) * (bs * 0.5)
    return torch.from_numpy(blocks), torch.from_numpy(mask)


def band_mask(nb: int, band: int, device) -> torch.Tensor:
    """``make_matrix``'s mask, made on ``device``."""
    i = torch.arange(nb, device=device)
    return (i[:, None] - i[None, :]).abs() <= band


def lu_blocked(blocks, mask, degree: int = 1):
    """Right-looking blocked LU. Returns combined LU factors in-place form
    (in a new tensor: ``blocks`` is not written)."""
    nb, _, bs, _ = blocks.shape
    dev = blocks.device
    eye = torch.eye(bs, dtype=blocks.dtype, device=dev)
    idx = torch.arange(nb, device=dev)

    a = blocks.clone()
    for k in range(nb):
        lu_kk = _lu_dense(a[k, k])
        a[k, k] = lu_kk
        lower = torch.tril(lu_kk, -1) + eye
        upper = torch.triu(lu_kk)
        rest = slice(k + 1, nb)
        m = nb - k - 1
        if not m:
            continue
        # panel solves, every j > k at once
        row = a[k, rest]
        a[k, rest] = torch.where(
            mask[k, rest, None, None],
            torch.linalg.solve_triangular(lower, row, upper=False,
                                          unitriangular=True), row)
        col = a[rest, k]
        a[rest, k] = torch.where(
            mask[rest, k, None, None],
            torch.linalg.solve_triangular(
                upper, col.transpose(-1, -2), upper=True).transpose(-1, -2),
            col)
        # trailing update, batched in `degree` chunks of block pairs
        ii_all = idx[rest].repeat_interleave(m)
        jj_all = idx[rest].repeat(m)
        chunk = max(m * m // max(degree, 1), 1)
        for s in range(0, m * m, chunk):
            ii = ii_all[s:s + chunk]
            jj = jj_all[s:s + chunk]
            upd = torch.einsum("bik,bkj->bij", a[ii, k], a[k, jj])
            live = mask[ii, jj][:, None, None]
            a.index_put_((ii, jj), torch.where(live, -upd, 0.0),
                         accumulate=True)
    return a


def _lu_dense(m):
    """Unblocked LU without pivoting (Doolittle).  The JAX package masks a
    full-matrix update each step (its loop body needs static shapes); here
    each step writes only the entries that update changes, with the same
    arithmetic entry for entry."""
    bs = m.shape[0]
    a = m.clone()
    for k in range(bs - 1):
        col = a[k + 1:, k] / a[k, k]
        a[k + 1:, k] = col
        a[k + 1:, k + 1:] -= col[:, None] * a[k, k + 1:][None, :]
    return a


def build(nb: int = 6, bs: int = 32, band: int = 2, degree: int = 1,
          device: DeviceLike = None):
    dev = resolve_device(device)
    blocks, _ = make_matrix(nb, bs, band)

    def fn(blocks):
        return lu_blocked(blocks, band_mask(nb, band, blocks.device), degree)

    return fn, (blocks.to(dev),)


def residual(blocks, lu, mask):
    """||A - L@U|| over the band (correctness check)."""
    nb, _, bs, _ = blocks.shape
    full_a = blocks.permute(0, 2, 1, 3).reshape(nb * bs, nb * bs)
    full_lu = lu.permute(0, 2, 1, 3).reshape(nb * bs, nb * bs)
    L = torch.tril(full_lu, -1) + torch.eye(nb * bs, dtype=full_lu.dtype,
                                            device=full_lu.device)
    U = torch.triu(full_lu)
    return float(torch.max(torch.abs(full_a - L @ U)))
