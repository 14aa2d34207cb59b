"""SwiGLU MLP and GShard-style top-k MoE with grouped one-hot dispatch
(counterpart of ``repro/models/mlp.py``).

The MoE keeps the reference's capacity-factor one-hot einsum form: tokens
are split into groups, each choice takes a rank inside its expert's
capacity buffer in (token, k) order, choices past the capacity are dropped
(their tokens pass on the residual path), and every expert runs over its
whole buffer.  The expert products are plain ``torch.einsum``s: the
reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.hcmp.sharding import is_dtensor, regather
from repro_torch.models import common as cm


def mlp_init(cfg, gen):
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    return {
        "w_gate": cm.dense_init(gen, d, f, dt),
        "w_up": cm.dense_init(gen, d, f, dt),
        "w_down": cm.dense_init(gen, f, d, dt),
    }


def mlp_apply(cfg, p, x):
    return cm.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def moe_init(cfg, gen):
    """One layer's MoE params: the router in float32, the experts'
    (E, d, f) / (E, f, d) stacks in the config's dtype."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    dt = getattr(torch, cfg.dtype)

    def einit(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (w * fan_in ** -0.5).to(dt)

    return {
        "router": cm.dense_init(gen, d, e, torch.float32),
        "w_gate": einit((e, d, f), d),
        "w_up": einit((e, d, f), d),
        "w_down": einit((e, f, d), f),
    }


def moe_groups(cfg, T, *, capacity_factor=1.25, group_size=256):
    """(g, G, cap) of ``T`` tokens: g is the largest divisor of T that is at
    most ``group_size``; groups of at most 32 tokens (decode, tree verify)
    run dropless (cap = g), larger ones at the capacity factor."""
    E, K = cfg.num_experts, cfg.experts_per_token
    g = min(group_size, T)
    while T % g:
        g -= 1
    cap = g if g <= 32 else max(K, int(g * K / E * capacity_factor))
    return g, T // g, cap


def _whole_groups(x, G):
    """``x`` (B, S, d) laid out so that its (G, g) token groups are whole
    on every rank: a DTensor whose batch split does not cut the G groups
    evenly (a W=16 verify at batch 128 makes 8 groups of 256 over 16
    batch shards) is gathered over the batch first, and every rank of
    that split then routes all the groups."""
    from torch.distributed.tensor import Replicate, Shard
    if not is_dtensor(x) or G == 1:
        return x
    split = [i for i, p in enumerate(x.placements) if p == Shard(0)]
    n = 1
    for i in split:
        n *= x.device_mesh.size(i)
    if G % n == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if i in split else p for i, p in enumerate(x.placements)])


def _combine(comb, ye):
    """``einsum("gsec,gecd->gsd", comb, ye)``: each token's weighted sum
    of its experts' outputs.  With the experts split over a mesh dim
    (DTensors: expert parallelism), each rank sums the experts it holds
    and the ranks' partial sums are added at the consumer: DTensor's own
    einsum would merge the split expert dim with the capacity dim, a
    strided split its rules cannot take."""
    if not is_dtensor(ye):
        return torch.einsum("gsec,gecd->gsd", comb, ye)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    experts = [p == Shard(1) for p in ye.placements]
    comb_in = [Shard(2) if e else p for e, p in zip(experts, comb.placements)]
    # a split of the groups (g) splits ye's groups alike; a split of the
    # tokens within a group needs every expert output of the group
    ye_in = [Shard(1) if e else Shard(0) if p == Shard(0) else Replicate()
             for e, p in zip(experts, comb.placements)]
    out = [Partial() if e else p for e, p in zip(experts, comb.placements)]
    return local_map(
        lambda c, y: torch.einsum("gsec,gecd->gsd", c, y),
        out_placements=out, in_placements=(comb_in, ye_in),
        device_mesh=ye.device_mesh, redistribute_inputs=True)(comb, ye)


def moe_apply(cfg, p, x, *, capacity_factor=1.25, group_size=256):
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d float32)."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    g, G, cap = moe_groups(cfg, B * S, capacity_factor=capacity_factor,
                           group_size=group_size)
    xg = _whole_groups(x, G).reshape(G, g, d)

    logits = xg.float() @ p["router"].float()                 # (G, g, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, K, dim=-1)        # (G, g, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)

    # rank of each (token, k) choice inside its expert's capacity buffer
    flat = F.one_hot(gate_idx, E).reshape(G, g * K, E)        # int64
    rank = torch.cumsum(flat, dim=1) - flat
    rank = (rank * flat).sum(dim=-1).reshape(G, g, K)
    keep = (rank < cap).to(x.dtype)                           # capacity drop

    oh_e = F.one_hot(gate_idx, E).to(x.dtype) * keep[..., None]
    # a dropped choice's rank may pass the buffer: one_hot of it is zero,
    # as jax.nn.one_hot is out of range
    oh_c = F.one_hot(torch.clamp(rank, max=cap), cap + 1)[..., :cap].to(
        x.dtype)
    disp = torch.einsum("gske,gskc->gsec", oh_e, oh_c)        # (G, g, E, cap)
    comb = torch.einsum("gske,gskc,gsk->gsec", oh_e, oh_c,
                        gate_vals.to(x.dtype))

    xe = torch.einsum("gsec,gsd->gecd", disp, xg)             # (G, E, cap, d)
    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])       # (G, E, cap, d)
    out = regather(_combine(comb, ye).reshape(B, S, d))

    # load-balance auxiliary loss (Switch-style)
    frac_tokens = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef
    return out, aux
