"""Mixture-of-Experts block (qwen2-moe: 60 routed top-4 + shared; granite:
32 routed top-8), on PyTorch.

Dispatch is capacity-based, done group-wise: each group of tokens routes
its own top-k experts, and each expert takes at most ``capacity`` (token,
k) pairs of a group, in token-major, then k, order; the rest overflow and
are dropped from the routed path (the shared experts still see every
token).  Two implementations, chosen per region by the plan's
``moe_impl`` knob as in the JAX package:

  'einsum' (default): one-hot dispatch/combine products over groups of
      ``moe_group`` tokens (default :data:`DEFAULT_MOE_GROUP`);
  'scatter': capacity scatter/gather per sequence, or over the whole
      batch for ``group='flat'`` (decode).

Every expert computes all its capacity slots in both, so a step reads
every expert's weights.  Shapes are static throughout (no ``nonzero``, no
boolean-mask indexing, no host reads): the decode step is capturable as
a CUDA graph and countable on the meta device.  Like the JAX package,
``apply_moe`` looks its knobs up under the bare region name it is given
(``"moe"``), not the full path.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.models import layers as L
from repro_torch.models.layers import Spec


def n_experts_padded(cfg) -> int:
    return max(cfg.n_experts, cfg.pad_experts_to or 0)


def moe_spec(cfg) -> Any:
    d, f, e = cfg.d_model, cfg.d_ff, n_experts_padded(cfg)
    p = {
        "router": Spec((d, e), ("embed", "experts"), "small"),
        "gate": Spec((e, d, f), ("experts", "embed", "ff")),
        "up": Spec((e, d, f), ("experts", "embed", "ff")),
        "down": Spec((e, f, d), ("experts", "ff", "embed")),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.mlp_spec(cfg, cfg.shared_d_ff)
        p["shared_gate"] = Spec((d, 1), ("embed", None), "small")
    return p


def capacity(cfg, group_len: int) -> int:
    e = n_experts_padded(cfg)
    cap = int(cfg.top_k * group_len * cfg.capacity_factor / e) + 1
    return min(max(cap, cfg.top_k), group_len)


def route(cfg, p, x: torch.Tensor):
    """x: (G, s, D) -> (weights (G, s, k) in x's dtype, expert indices
    (G, s, k) int64, f32 aux loss).  Among equal probabilities the lower
    expert index ranks first, as ``jax.lax.top_k`` orders them: a stable
    descending sort, where ``torch.topk`` promises no order among ties."""
    e = n_experts_padded(cfg)
    logits = (x @ p["router"]).float()
    if cfg.pad_experts_to and cfg.pad_experts_to > cfg.n_experts:
        pad_mask = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = torch.where(pad_mask, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :cfg.top_k], idx[..., :cfg.top_k]
    w = w / w.sum(-1, keepdim=True)
    # Switch-style load-balancing aux loss
    me = probs.mean(dim=(0, 1))                             # (E,)
    ce = _one_hot(idx[..., 0], e, torch.float32).mean(dim=(0, 1))
    aux = (me * ce).sum() * e
    return w.to(x.dtype), idx, aux


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a class outside [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _slots(cfg, idx: torch.Tensor) -> torch.Tensor:
    """Slot of each (token, k) within its expert: a cumsum over the
    flattened (token, k) axis, token-major, then k.  idx: (G, s, k)."""
    G, s, k = idx.shape
    flat = _one_hot(idx, n_experts_padded(cfg), torch.int32)
    flat = flat.reshape(G, s * k, -1)
    slot = ((torch.cumsum(flat, dim=1) - 1) * flat).sum(-1)
    return slot.reshape(G, s, k)


def _expert_ffn(cfg, p, expert_in: torch.Tensor, eq_in: str,
                eq_out: str) -> torch.Tensor:
    g = torch.einsum(eq_in, expert_in, p["gate"])
    u = torch.einsum(eq_in, expert_in, p["up"])
    h = F.silu(g) * u if cfg.glu else F.silu(u)
    return torch.einsum(eq_out, h, p["down"])


def _add_shared(cfg, p, x: torch.Tensor, y: torch.Tensor,
                plan: RegionPlan) -> torch.Tensor:
    if not cfg.n_shared_experts:
        return y
    sg = torch.sigmoid(x @ p["shared_gate"])
    return y + sg * L.apply_mlp(cfg, p["shared"], x, plan,
                                name="shared_mlp", d_ff=cfg.shared_d_ff)


DEFAULT_MOE_GROUP = 256


def apply_moe(cfg, p, x: torch.Tensor, plan: RegionPlan, name: str = "moe",
              group: str = "seq"):
    """x: (B, S, D) -> (y, aux_loss).  Dispatch impl from the plan's
    entry for ``name``: 'einsum' (default) or 'scatter'.
    ``group='flat'``: the whole batch is one group — decode.
    ``group='row'``: each batch row routes as a call of its own would —
    the slot pool's decode, which the JAX package vmaps over the slots."""
    rc_knobs = plan.config_for(name)
    impl = rc_knobs.moe_impl or "einsum"
    if impl == "einsum":
        return apply_moe_einsum(cfg, p, x, plan, name, group,
                                rc_knobs.moe_group or DEFAULT_MOE_GROUP)
    return apply_moe_scatter(cfg, p, x, plan, name, group)


def apply_moe_einsum(cfg, p, x: torch.Tensor, plan: RegionPlan,
                     name: str = "moe", group: str = "seq",
                     group_len: int = DEFAULT_MOE_GROUP):
    """GShard-style dispatch over token groups of ``group_len`` (the whole
    sequence where that does not divide the tokens); as in the JAX
    package, 'seq' and 'flat' group alike, and 'row' groups each row's
    tokens alone."""
    with region(name) as rpath:
        B0, S0, D = x.shape
        e = n_experts_padded(cfg)
        tokens = S0 if group == "row" else B0 * S0
        g = min(group_len, tokens)
        if tokens % g:
            g = S0  # fall back to sequence groups
        xg = x.reshape(-1, g, D)                            # (n, g, D)
        n = xg.shape[0]
        w, idx, aux = route(cfg, p, xg)                     # (n, g, k)
        cap = capacity(cfg, g)
        slot = _slots(cfg, idx)

        # combined (expert, slot) index; an overflowed pair goes to the
        # extra column e*cap, which is dropped.  Each (token, expert) pair
        # is distinct across k, so a kept column gets exactly one write:
        # the dispatch is the JAX package's one-hot summed over k, and the
        # combine its one-hot times the weight summed over k, without the
        # (n, g, k, e*cap) one-hot (whose f32 copy the backward would keep)
        ec = torch.where(slot < cap, idx * cap + slot, e * cap)
        disp = torch.zeros((n, g, e * cap + 1), dtype=x.dtype,
                           device=x.device).scatter_(-1, ec, 1.0)
        disp = disp[..., :e * cap].reshape(n, g, e, cap)
        comb = torch.zeros((n, g, e * cap + 1), dtype=torch.float32,
                           device=x.device).scatter_add(-1, ec, w.float())
        comb = comb[..., :e * cap].reshape(n, g, e, cap).to(x.dtype)

        expert_in = torch.einsum("ngec,ngd->necd", disp, xg)
        expert_in = plan.constrain(expert_in, rpath,
                                   (None, "experts", None, "embed"))
        out = _expert_ffn(cfg, p, expert_in, "necd,edf->necf",
                          "necf,efd->necd")
        y = torch.einsum("ngec,necd->ngd", comb, out)       # combine
        y = _add_shared(cfg, p, x, y.reshape(B0, S0, D), plan)
        return plan.constrain(y, rpath, ("batch", "seq", "embed")), aux


def apply_moe_scatter(cfg, p, x: torch.Tensor, plan: RegionPlan,
                      name: str = "moe", group: str = "seq"):
    """Capacity scatter/gather per sequence ('seq' and 'row'; 'flat':
    over the whole batch as one group)."""
    with region(name) as rpath:
        B0, S0, D = x.shape
        if group == "flat":
            x = x.reshape(1, B0 * S0, D)
        B, S, D = x.shape
        e = n_experts_padded(cfg)
        cap = capacity(cfg, S)
        w, idx, aux = route(cfg, p, x)                      # (B, S, k)
        slot = _slots(cfg, idx)
        slot = torch.where(slot < cap, slot, cap)     # overflow -> waste row

        # scatter tokens into (B, E, cap+1, D); row cap absorbs the
        # overflow (the only duplicate indices) and is dropped
        b_ix = torch.arange(B, device=x.device)[:, None, None]
        expert_in = torch.zeros((B, e, cap + 1, D), dtype=x.dtype,
                                device=x.device)
        expert_in = expert_in.index_put(
            (b_ix, idx, slot), x[:, :, None, :].expand(B, S, cfg.top_k, D))
        expert_in = plan.constrain(expert_in[:, :, :cap], rpath,
                                   ("batch", "experts", None, "embed"))
        out = _expert_ffn(cfg, p, expert_in, "becd,edf->becf",
                          "becf,efd->becd")

        # gather back + combine with routing weights; slot cap reads zeros
        out_p = torch.cat([out, out.new_zeros((B, e, 1, D))], dim=2)
        y = out_p[b_ix, idx, slot]                          # (B, S, k, D)
        y = (y * w[..., None]).sum(2)
        y = plan.constrain(y, rpath, ("batch", "seq", "embed"))
        y = _add_shared(cfg, p, x, y, plan)
        y = y.reshape(B0, S0, D)
        return plan.constrain(y, rpath, ("batch", "seq", "embed")), aux
