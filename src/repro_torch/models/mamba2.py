"""Mamba2 (SSD) block, as used by Zamba2, on PyTorch.

State-space recurrence with scalar-per-head decay:
  h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * x_t (x) B_t      (h: (B,H,P,N))
  y_t = h_t . C_t + D_h * x_t
The recurrence runs through :func:`repro_torch.kernels.ops.ssd`: the
hand-written kernels on the card (the fused recurrence, or the chunked scan
under ``scan_mode='chunk'``), their plain versions on the CPU.  The offline
``ssm_impl='chunked'`` form with bf16 matmul streams has no kernel and is
plain PyTorch on every device; the serve engine never takes it.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.kernels import ops
from repro_torch.models.layers import Spec, TensorSpec

CONV_K = 4
NGROUPS = 1


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * NGROUPS * cfg.ssm_state
    return d_inner, nheads, conv_dim


def mamba_spec(cfg) -> Any:
    """Input projections kept separate (x / BC / z / dt), as in the JAX
    package."""
    d = cfg.d_model
    d_inner, nheads, conv_dim = dims(cfg)
    bc = 2 * NGROUPS * cfg.ssm_state
    return {
        "in_x": Spec((d, d_inner), ("embed", "ssm_dim")),
        "in_bc": Spec((d, bc), ("embed", None)),
        "in_z": Spec((d, d_inner), ("embed", "ssm_dim")),
        "in_dt": Spec((d, nheads), ("embed", "ssm_heads")),
        "conv_x_w": Spec((CONV_K, d_inner), (None, "ssm_dim"), "small"),
        "conv_x_b": Spec((d_inner,), ("ssm_dim",), "zeros"),
        "conv_bc_w": Spec((CONV_K, bc), (None, None), "small"),
        "conv_bc_b": Spec((bc,), (None,), "zeros"),
        "a_log": Spec((nheads,), ("ssm_heads",), "small"),
        "dt_bias": Spec((nheads,), ("ssm_heads",), "small"),
        "d_skip": Spec((nheads,), ("ssm_heads",), "ones"),
        "out_norm": Spec((d_inner,), ("ssm_dim",), "ones"),
        "out_proj": Spec((d_inner, d), ("ssm_dim", "embed")),
    }


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B,T,C); w: (K,C). state: (B,K-1,C) or
    None.  Returns (silu(conv), the last K-1 input rows)."""
    if state is None:
        pad = torch.zeros((x.shape[0], CONV_K - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # (B,T+K-1,C)
    T = x.shape[1]
    out = sum(xp[:, i:i + T, :] * w[i] for i in range(CONV_K)) + b
    return F.silu(out), xp[:, -(CONV_K - 1):, :]


def _split_state(state):
    if state is None:
        return None, None, None
    return state["conv_x"], state["conv_bc"], state["s"]


def ssd_scan(xh, bt, ct, dt, a, s0):
    """The exact SSD recurrence (the ``fused_recurrent`` kernel).
    xh: (B,T,H,P); bt,ct: (B,T,N); dt: (B,T,H); a: (H,); s0: (B,H,P,N)."""
    return ops.ssd(xh, bt, ct, dt, a, s0, mode="fused_recurrent")


def _ssd_chunked_bf16(xh, bt, ct, dt, a, s0, C):
    """The offline ``ssm_impl='chunked'`` form: the intra-chunk matmul
    streams in bf16 (decay math in f32), plain PyTorch."""
    B, T, H, P = xh.shape
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=xh.device))
    s = s0
    ys = []
    for lo in range(0, T, C):
        xc, bc, cc, dc = (t[:, lo:lo + C] for t in (xh, bt, ct, dt))
        Lc = torch.cumsum(dc * a, dim=1)                    # (B,C,H)
        cb = torch.einsum("btn,bsn->bts", cc.bfloat16(), bc.bfloat16())
        ratio = torch.exp(Lc[:, :, None, :] - Lc[:, None, :, :])
        M = cb.float()[..., None] * ratio * dc[:, None, :, :]
        M = torch.where(mask[None, :, :, None], M, torch.zeros_like(M))
        y = torch.einsum("btsh,bshp->bthp", M.bfloat16(),
                         xc.bfloat16()).float()
        y = y + torch.exp(Lc)[..., None] * torch.einsum("bhpn,btn->bthp",
                                                        s, cc)
        w = torch.exp(Lc[:, -1:, :] - Lc) * dc
        s = (torch.exp(Lc[:, -1])[:, :, None, None] * s
             + torch.einsum("bshp,bsn->bhpn", xc * w[..., None], bc))
        ys.append(y)
    return torch.cat(ys, dim=1), s


def ssd_chunked(xh, bt, ct, dt, a, s0, chunk: int = 64,
                precise: bool = False):
    """Matmul-form SSD (Mamba2's semiseparable decomposition), equivalent
    to :func:`ssd_scan` up to reassociation, per chunk of
    ``C = min(chunk, T)`` steps; when C does not divide T it returns
    :func:`ssd_scan`'s result exactly.  ``precise`` keeps every stream in
    f32 (the ``chunk`` kernel: the serve engine's chunk mode, which keeps
    greedy decode token-identical with the sequential recurrence); without
    it the intra-chunk matmuls run in bf16 (plain PyTorch)."""
    T = xh.shape[1]
    C = min(chunk, T)
    if T % C:
        return ssd_scan(xh, bt, ct, dt, a, s0)
    if precise:
        return ops.ssd(xh, bt, ct, dt, a, s0, mode="chunk", chunk=C)
    return _ssd_chunked_bf16(xh, bt, ct, dt, a, s0, C)


def apply_mamba(cfg, p, x, plan: RegionPlan, state=None, name: str = "ssm"):
    """x: (B,T,D) -> (y, new_state). state: {conv_x, conv_bc: (B,K-1,C),
    s: (B,H,P,N)}."""
    with region(name) as rpath:
        B, T, D = x.shape
        d_inner, nheads, conv_dim = dims(cfg)
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        conv_x0, conv_bc0, s_prev = _split_state(state)
        xi = x @ p["in_x"]
        bc = x @ p["in_bc"]
        z = x @ p["in_z"]
        dt_raw = x @ p["in_dt"]
        xi, conv_x_state = _causal_conv(xi, p["conv_x_w"], p["conv_x_b"],
                                        conv_x0)
        bc, conv_bc_state = _causal_conv(bc, p["conv_bc_w"], p["conv_bc_b"],
                                         conv_bc0)
        bt = bc[..., :N].float()
        ct = bc[..., N:].float()
        dt = F.softplus(dt_raw.float() + p["dt_bias"])
        a = -torch.exp(p["a_log"].float())
        xh = xi.reshape(B, T, nheads, P).float()
        s0 = (s_prev if s_prev is not None
              else torch.zeros((B, nheads, P, N), dtype=torch.float32,
                               device=x.device))
        knobs = plan.config_for(rpath)
        # scan_mode (serve knob) outranks ssm_impl (offline knob); 'auto'
        # is resolved to a concrete mode by the engine before planning.
        # Serve chunk mode runs precise (f32 streams).
        if knobs.scan_mode == "chunk" and T > 1:
            y, s_new = ssd_chunked(xh, bt, ct, dt, a, s0, knobs.chunk or 64,
                                   precise=True)
        elif (not knobs.scan_mode
              and (knobs.ssm_impl or "scan") == "chunked" and T > 1):
            y, s_new = ssd_chunked(xh, bt, ct, dt, a, s0, knobs.chunk or 64)
        else:
            y, s_new = ssd_scan(xh, bt, ct, dt, a, s0)
        y = y + p["d_skip"].float()[:, None] * xh
        y = y.reshape(B, T, d_inner).to(x.dtype)
        y = y * F.silu(z)
        yf = y.float()
        y = (yf * torch.rsqrt(yf.square().mean(-1, keepdim=True) + 1e-6)
             * p["out_norm"]).to(x.dtype)
        out = y @ p["out_proj"]
        out = plan.constrain(out, rpath, ("batch", "seq", "embed"))
        return out, {"conv_x": conv_x_state, "conv_bc": conv_bc_state,
                     "s": s_new}


def state_spec(cfg, batch: int, dtype: torch.dtype = torch.bfloat16):
    d_inner, nheads, conv_dim = dims(cfg)
    bc = 2 * NGROUPS * cfg.ssm_state
    return {
        "conv_x": TensorSpec((batch, CONV_K - 1, d_inner), dtype),
        "conv_bc": TensorSpec((batch, CONV_K - 1, bc), dtype),
        "s": TensorSpec((batch, nheads, cfg.ssm_head_dim, cfg.ssm_state),
                        torch.float32),
    }
