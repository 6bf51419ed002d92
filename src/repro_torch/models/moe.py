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
every expert's weights.

Over a mesh (the JAX package's rules put ``experts`` on ``model``) a
rank holds ``E/m`` experts' leaves and as many router columns: it makes
its columns of the logits whole (``comm.gather_from_model``) before the
pad mask, the softmax and the top-k, dispatches only the (token, k)
pairs routed to its own experts, and its combine is a partial sum,
reduced over ``model`` once at tokens x d_model (before the shared
experts, an ff-split MLP reduced in its own region).  Rows split over the
batch axes group as the whole batch would: the group size comes from
the global token count, and a group that spans ranks (decode's 'flat'
group over every data rank) offsets each rank's slots by the lower
ranks' per-expert counts in it (an all-gather of (E,) counts).  The
training forward's load-balancing aux loss is the JAX package's over
the whole batch: the means all-reduced over the batch axes
(``comm.mean_over_batch``), each rank summing over its own experts and
the sum reduced over ``model``, so that its gradient reaches the router
and the input once.  Shapes are static throughout (no ``nonzero``, no
boolean-mask indexing, no host reads): the decode step is capturable as
a CUDA graph and countable on the meta device.  Like the JAX package,
``apply_moe`` looks its knobs up under the bare region name it is given
(``"moe"``), not the full path.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.policy import RegionPlan
from repro_torch.core.regions import region
from repro_torch.distributed import comm
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


def route(cfg, p, x: torch.Tensor, plan: Optional[RegionPlan] = None,
          global_aux: bool = False):
    """x: (G, s, D) -> (weights (G, s, k) in x's dtype, expert indices
    (G, s, k) int64, f32 aux loss).  Among equal probabilities the lower
    expert index ranks first, as ``jax.lax.top_k`` orders them: a stable
    descending sort, where ``torch.topk`` promises no order among ties.

    A router split over ``plan``'s ``model`` axis gives this rank's
    columns of the logits, made whole on every rank before routing.  The
    aux loss is over ``x``'s tokens and every expert; with
    ``global_aux``, over the whole batch of ``plan``'s mesh
    (:func:`_mesh_aux`)."""
    e = n_experts_padded(cfg)
    mesh = plan.mesh if plan is not None else None
    logits = x @ p["router"]
    el = logits.shape[-1]
    if el != e:
        logits = comm.gather_from_model(logits, mesh)
    logits = logits.float()
    if cfg.pad_experts_to and cfg.pad_experts_to > cfg.n_experts:
        pad_mask = torch.arange(e, device=x.device) >= cfg.n_experts
        logits = torch.where(pad_mask, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[..., :cfg.top_k], idx[..., :cfg.top_k]
    w = w / w.sum(-1, keepdim=True)
    if global_aux and mesh is not None:
        aux = _mesh_aux(cfg, probs, idx, plan, el)
    else:
        # Switch-style load-balancing aux loss
        me = probs.mean(dim=(0, 1))                         # (E,)
        ce = _one_hot(idx[..., 0], e, torch.float32).mean(dim=(0, 1))
        aux = (me * ce).sum() * e
    return w.to(x.dtype), idx, aux


def _mesh_aux(cfg, probs: torch.Tensor, idx: torch.Tensor,
              plan: RegionPlan, el: int) -> torch.Tensor:
    """The aux loss of the whole batch, ``e * sum(me * ce)``: ``me`` (the
    mean probability) and ``ce`` (the top-1 share) of this rank's ``el``
    experts, each a mean over the rank's tokens made the batch's mean
    over the batch axes; the rank's partial sum over its experts is summed
    over ``model`` (the gradient passes through unchanged: every rank's
    gradient of the whole probabilities is its part, summed by the
    logits' gather)."""
    e = n_experts_padded(cfg)
    lo = comm.model_index(plan.mesh) * el if el != e else 0
    me = probs[..., lo:lo + el].mean(dim=(0, 1))
    ce = _one_hot(idx[..., 0] - lo, el, torch.float32).mean(dim=(0, 1))
    means = comm.mean_over_batch(torch.stack([me, ce]), plan.mesh,
                                 comm.batch_axes(plan.mesh, plan.rules))
    aux = (means[0] * means[1]).sum() * e
    return comm.reduce_from_model(aux, plan.mesh) if el != e else aux


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a class outside [0, n) gives an all-zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _slots(cfg, idx: torch.Tensor,
           offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slot of each (token, k) within its expert: a cumsum over the
    flattened (token, k) axis, token-major, then k.  idx: (G, s, k);
    ``offset`` (E,): the slots of each expert that the lower ranks of a
    group spanning ranks took (:func:`_rank_offsets`)."""
    G, s, k = idx.shape
    flat = _one_hot(idx, n_experts_padded(cfg), torch.int32)
    flat = flat.reshape(G, s * k, -1)
    pos = torch.cumsum(flat, dim=1) - 1
    if offset is not None:
        pos = pos + offset
    slot = (pos * flat).sum(-1)
    return slot.reshape(G, s, k)


def _batch_split(plan: RegionPlan) -> tuple:
    """(the batch axes, their ranks) that the rows are split over."""
    if plan.mesh is None:
        return (), 1
    axes = comm.batch_axes(plan.mesh, plan.rules)
    n = 1
    for a in axes:
        n *= comm.axis_size(plan.mesh, a)
    return axes, n


def _rank_offsets(cfg, idx: torch.Tensor, plan: RegionPlan, axes: tuple,
                  span: int) -> torch.Tensor:
    """(E,) slots of each expert taken by the lower ranks of this rank's
    group, a group of ``span`` ranks' tokens: the exclusive prefix of
    their per-expert counts, all-gathered over the batch axes.  idx:
    (1, s, k), this rank's part of the group."""
    counts = _one_hot(idx, n_experts_padded(cfg), torch.int32).sum(
        (0, 1, 2), dtype=torch.int32)
    every = comm.gather_over_batch(counts, plan.mesh, axes)  # (ranks, E)
    r = comm.batch_index(plan.mesh, axes)
    return every[r - r % span:r].sum(0)


def _expert_block(cfg, p, plan: RegionPlan) -> tuple:
    """(first, count) of the experts whose leaves ``p`` holds: all of
    them, or the rank's block of the ``model`` axis that the experts are
    split over."""
    e = n_experts_padded(cfg)
    el = p["gate"].shape[0]
    if el == e:
        if p["gate"].shape[-1] != cfg.d_ff:
            raise NotImplementedError(
                "MoE expert leaves split on ff (an expert count the model "
                "axis does not divide) are not ported: pad the experts "
                "(pad_experts_to)")
        return 0, e
    return comm.model_index(plan.mesh) * el, el


def _mine(idx: torch.Tensor, lo: int, el: int,
          e: int) -> Optional[torch.Tensor]:
    """Where ``idx`` names one of this rank's experts ``[lo, lo+el)``;
    None where the rank holds all ``e``."""
    if el == e:
        return None
    return (idx >= lo) & (idx < lo + el)


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
              group: str = "seq", global_aux: bool = False):
    """x: (B, S, D) -> (y, aux_loss).  Dispatch impl from the plan's
    entry for ``name``: 'einsum' (default) or 'scatter'.
    ``group='flat'``: the whole batch is one group — decode.
    ``group='row'``: each batch row routes as a call of its own would —
    the slot pool's decode, which the JAX package vmaps over the slots.
    ``global_aux``: the aux loss of the whole batch over the plan's mesh
    (the training forward); otherwise that of this rank's rows, which the
    serving steps drop."""
    rc_knobs = plan.config_for(name)
    impl = rc_knobs.moe_impl or "einsum"
    if impl == "einsum":
        return apply_moe_einsum(cfg, p, x, plan, name, group,
                                rc_knobs.moe_group or DEFAULT_MOE_GROUP,
                                global_aux)
    return apply_moe_scatter(cfg, p, x, plan, name, group, global_aux)


def _spread(cfg, p, x: torch.Tensor, plan: RegionPlan):
    """(this rank's first expert, its expert count, ``x`` as the input of
    the products split over ``model``): behind ``copy_to_model`` where
    the experts are split, so that the ranks' parts of its gradient are
    summed."""
    lo, el = _expert_block(cfg, p, plan)
    if el != n_experts_padded(cfg):
        x = comm.copy_to_model(x, plan.mesh)
    return lo, el, x


def _reduce(cfg, y: torch.Tensor, el: int, plan: RegionPlan, rpath: str):
    """The routed output, a partial sum over ``model`` where the experts
    are split, reduced over it."""
    return plan.constrain(y, rpath, ("batch", "seq", "embed"),
                          partial=el != n_experts_padded(cfg))


def apply_moe_einsum(cfg, p, x: torch.Tensor, plan: RegionPlan,
                     name: str = "moe", group: str = "seq",
                     group_len: int = DEFAULT_MOE_GROUP,
                     global_aux: bool = False):
    """GShard-style dispatch over token groups of ``group_len`` (the whole
    sequence where that does not divide the batch's tokens); as in the
    JAX package, 'seq' and 'flat' group alike, and 'row' groups each
    row's tokens alone.  A group larger than this rank's tokens spans
    ranks of the batch axes, and holds whole ranks."""
    with region(name) as rpath:
        B0, S0, D = x.shape
        e = n_experts_padded(cfg)
        axes, ranks = ((), 1) if group == "row" else _batch_split(plan)
        tokens = S0 if group == "row" else B0 * S0 * ranks
        g = min(group_len, tokens)
        if tokens % g:
            g = S0  # fall back to sequence groups
        here = S0 if group == "row" else B0 * S0
        span = g // here if g > here else 1     # ranks a group spans
        if (here % g if span == 1 else g % here):
            raise ValueError(f"a group of {g} tokens straddles this rank's "
                             f"{here} tokens")
        lo, el, xs = _spread(cfg, p, x, plan)
        gl = min(g, here)                     # this rank's tokens a group
        xg = xs.reshape(-1, gl, D)                          # (n, gl, D)
        n = xg.shape[0]
        w, idx, aux = route(cfg, p, xg, plan, global_aux)   # (n, g, k)
        cap = capacity(cfg, g)
        offset = (_rank_offsets(cfg, idx, plan, axes, span) if span > 1
                  else None)
        slot = _slots(cfg, idx, offset)

        # combined (expert, slot) index over this rank's experts; an
        # overflowed pair, or one routed to another rank's expert, goes to
        # the extra column el*cap, which is dropped.  Each (token, expert)
        # pair is distinct across k, so a kept column gets exactly one
        # write: the dispatch is the JAX package's one-hot summed over k,
        # and the combine its one-hot times the weight summed over k,
        # without the (n, g, k, e*cap) one-hot (whose f32 copy the
        # backward would keep)
        keep = slot < cap
        mine = _mine(idx, lo, el, e)
        if mine is not None:
            keep, idx = keep & mine, idx - lo
        ec = torch.where(keep, idx * cap + slot, el * cap)
        disp = torch.zeros((n, gl, el * cap + 1), dtype=x.dtype,
                           device=x.device).scatter_(-1, ec, 1.0)
        disp = disp[..., :el * cap].reshape(n, gl, el, cap)
        comb = torch.zeros((n, gl, el * cap + 1), dtype=torch.float32,
                           device=x.device).scatter_add(-1, ec, w.float())
        comb = comb[..., :el * cap].reshape(n, gl, el, cap).to(x.dtype)

        expert_in = torch.einsum("ngec,ngd->necd", disp, xg)
        expert_in = plan.constrain(expert_in, rpath,
                                   (None, "experts", None, "embed"))
        out = _expert_ffn(cfg, p, expert_in, "necd,edf->necf",
                          "necf,efd->necd")
        y = torch.einsum("ngec,necd->ngd", comb, out)       # combine
        y = _reduce(cfg, y.reshape(B0, S0, D), el, plan, rpath)
        y = _add_shared(cfg, p, x, y, plan)
        return plan.constrain(y, rpath, ("batch", "seq", "embed")), aux


def apply_moe_scatter(cfg, p, x: torch.Tensor, plan: RegionPlan,
                      name: str = "moe", group: str = "seq",
                      global_aux: bool = False):
    """Capacity scatter/gather per sequence ('seq' and 'row'; 'flat':
    over the whole batch as one group, spanning every rank of the batch
    axes)."""
    with region(name) as rpath:
        B0, S0, D = x.shape
        axes, ranks = _batch_split(plan) if group == "flat" else ((), 1)
        if group == "flat":
            x = x.reshape(1, B0 * S0, D)
        B, S, D = x.shape
        e = n_experts_padded(cfg)
        cap = capacity(cfg, S * ranks)
        lo, el, xs = _spread(cfg, p, x, plan)
        w, idx, aux = route(cfg, p, xs, plan, global_aux)   # (B, S, k)
        offset = (_rank_offsets(cfg, idx, plan, axes, ranks) if ranks > 1
                  else None)
        slot = _slots(cfg, idx, offset)
        keep = slot < cap
        mine = _mine(idx, lo, el, e)
        if mine is not None:
            keep, idx = keep & mine, torch.where(mine, idx - lo, 0)
        slot = torch.where(keep, slot, cap)   # overflow, other ranks' -> waste

        # scatter tokens into (B, el, cap+1, D); row cap absorbs the
        # overflow and the pairs of other ranks' experts (the only
        # duplicate indices) and is dropped
        b_ix = torch.arange(B, device=x.device)[:, None, None]
        expert_in = torch.zeros((B, el, cap + 1, D), dtype=x.dtype,
                                device=x.device)
        expert_in = expert_in.index_put(
            (b_ix, idx, slot), xs[:, :, None, :].expand(B, S, cfg.top_k, D))
        expert_in = plan.constrain(expert_in[:, :, :cap], rpath,
                                   ("batch", "experts", None, "embed"))
        out = _expert_ffn(cfg, p, expert_in, "becd,edf->becf",
                          "becf,efd->becd")

        # gather back + combine with routing weights; slot cap reads zeros
        out_p = torch.cat([out, out.new_zeros((B, el, 1, D))], dim=2)
        y = out_p[b_ix, idx, slot]                          # (B, S, k, D)
        y = _reduce(cfg, (y * w[..., None]).sum(2), el, plan, rpath)
        y = _add_shared(cfg, p, x, y, plan)
        y = y.reshape(B0, S0, D)
        return plan.constrain(y, rpath, ("batch", "seq", "embed")), aux
