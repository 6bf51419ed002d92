"""Shared building blocks for the model zoo, on PyTorch.

Parameters are declared once as :class:`Spec` trees (shape + logical axes +
initializer); :func:`init_params` materialises them from a
``torch.Generator``, so parameter shapes have a single source of truth.
Parameters are nested dicts of tensors with the JAX package's keys, and
every ``apply_*`` is a plain function over them, wrapped in an
instrumented region (:mod:`repro_torch.core.regions`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region

# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Spec:
    shape: tuple
    axes: tuple          # logical axis names (same length as shape)
    init: str = "normal"  # 'normal' | 'zeros' | 'ones' | 'small'
    scale: float = 1.0

    def materialise(self, gen: torch.Generator, dtype: torch.dtype,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=dtype, device=device)
        fan_in = self.shape[0] if self.shape else 1
        std = self.scale / math.sqrt(max(fan_in, 1))
        if self.init == "small":
            std = 0.02 * self.scale
        x = torch.randn(self.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * std).to(dtype)


def tree_map(fn: Callable, tree: Any):
    """Map ``fn`` over the leaves of a nested dict (keys in sorted order,
    as JAX flattens dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def init_params(spec_tree: Any, gen: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None) -> Any:
    """Materialise every Spec leaf, in sorted key order, from one
    generator."""
    return tree_map(lambda s: s.materialise(gen, dtype, device), spec_tree)


def spec_param_count(spec_tree: Any) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(spec_tree))


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """Shape and dtype of one cache leaf (the counterpart of JAX's
    ``ShapeDtypeStruct`` in the models' ``cache_spec``)."""
    shape: tuple
    dtype: torch.dtype


def zeros_from_spec(spec_tree: Any, device=None) -> Any:
    """A tree of zero tensors shaped by a tree of :class:`TensorSpec`."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), spec_tree)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------


def norm_spec(cfg, dim: Optional[int] = None) -> Any:
    d = dim or cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": Spec((d,), (None,), "ones"),
                "bias": Spec((d,), (None,), "zeros")}
    return {"scale": Spec((d,), (None,), "ones")}


def apply_norm(cfg, p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Reductions in f32, streams in the input dtype (bf16 residual tensors
    never round-trip through f32), exactly as the JAX package rounds."""
    if "bias" in p:  # layernorm
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)
        inv = torch.rsqrt(var + eps)
        out = ((x - mu.to(x.dtype)) * inv.to(x.dtype) * p["scale"]
               + p["bias"])
    else:  # rmsnorm
        ms = x.float().square().mean(-1, keepdim=True)
        out = x * torch.rsqrt(ms + eps).to(x.dtype) * p["scale"]
    return out.to(x.dtype)


def activation(cfg, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    return F.silu(x)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rotary_dim(cfg, head_dim: int) -> int:
    """Rotated width: ``head_dim * partial_rotary`` rounded down to even."""
    rot = int(head_dim * cfg.partial_rotary)
    return rot - rot % 2


def rope_frequencies(cfg, head_dim: int, device=None) -> torch.Tensor:
    rot = rotary_dim(cfg, head_dim)
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)


def apply_rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    leading ``rotary_dim`` channels as two halves (not interleaved pairs)
    and passes the rest through."""
    if not cfg.use_rope:
        return x
    head_dim = x.shape[-1]
    rot = rotary_dim(cfg, head_dim)
    if rot == 0:
        return x
    freqs = rope_frequencies(cfg, head_dim, x.device)          # (rot/2,)
    angles = positions[..., :, None].float() * freqs           # (..., S, rot/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    return torch.cat([o1.to(x.dtype), o2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------


def mlp_spec(cfg, d_ff: Optional[int] = None) -> Any:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"up": Spec((d, f), ("embed", "ff")),
         "down": Spec((f, d), ("ff", "embed"))}
    if cfg.glu:
        p["gate"] = Spec((d, f), ("embed", "ff"))
    return p


def apply_mlp(cfg, p, x: torch.Tensor, plan: RegionPlan,
              name: str = "mlp") -> torch.Tensor:
    with region(name) as rpath:
        h = x @ p["up"]
        if cfg.glu:
            h = activation(cfg, x @ p["gate"]) * h
        else:
            h = activation(cfg, h)
        h = plan.constrain(h, rpath, ("batch", "seq", "ff"))
        out = h @ p["down"]
        return plan.constrain(out, rpath, ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_spec(cfg) -> Any:
    p = {"tokens": Spec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                        "small")}
    if not cfg.tie_embeddings:
        p["unembed"] = Spec((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    return p


def apply_embed(cfg, p, tokens: torch.Tensor, plan: RegionPlan) -> torch.Tensor:
    with region("embed") as rpath:
        x = p["tokens"][tokens.long()]
        return plan.constrain(x, rpath, ("batch", "seq", "embed"))


def apply_unembed(cfg, p, x: torch.Tensor, plan: RegionPlan) -> torch.Tensor:
    with region("logits") as rpath:
        w = p["tokens"].T if cfg.tie_embeddings else p["unembed"]
        logits = x @ w
        return plan.constrain(logits, rpath, ("batch", "seq", "vocab"))
