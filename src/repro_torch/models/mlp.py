"""SwiGLU MLP and top-k MoE (counterpart of ``repro/models/mlp.py``), in
two forms that share the router (float32 logits, softmax, top-k, the k
gates renormalised):

* ``moe_apply``, the reference's GShard-style capacity-factor one-hot
  einsum form: tokens are split into groups, each choice takes a rank
  inside its expert's capacity buffer in (token, k) order, choices past
  the capacity are dropped (their tokens pass on the residual path), and
  every expert runs over its whole buffer.  The training path takes it,
  and the tests hold it to the JAX package.
* ``moe_dropless``, the model as published and the serving forward's
  form: every choice is kept and each routed (token, choice) row is
  computed once, by grouped matrix products over the experts.
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


def _route(cfg, p, x):
    """The router on ``x`` (..., d): (probs (..., E) float32, the k gates
    renormalised (..., K), their experts (..., K))."""
    probs = torch.softmax(x.float() @ p["router"].float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _aux_loss(cfg, probs, gate_idx):
    """The load-balance auxiliary loss (Switch-style), 0-d float32."""
    E = cfg.num_experts
    lead = tuple(range(probs.dim() - 1))
    frac_tokens = F.one_hot(gate_idx[..., 0], E).float().mean(dim=lead)
    frac_probs = probs.mean(dim=lead)
    return E * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef


def moe_apply(cfg, p, x, *, capacity_factor=1.25, group_size=256):
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d float32): the capacity
    form."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    g, G, cap = moe_groups(cfg, B * S, capacity_factor=capacity_factor,
                           group_size=group_size)
    xg = _whole_groups(x, G).reshape(G, g, d)
    probs, gate_vals, gate_idx = _route(cfg, p, xg)           # (G, g, K)

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
    return out, _aux_loss(cfg, probs, gate_idx)


def moe_dropless(cfg, p, x, *, aux=False, counts=None):
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d float32 or, without
    ``aux``, None): every choice kept, each of the T x K routed rows
    computed once (``_experts``).  Shapes are static and nothing waits for
    the host (the rows each expert takes are counted on the device), so
    the captured step and the piece graphs hold it.  ``counts``, an (E,)
    int64 buffer, receives those rows (the step's ``trace.ExpertTap``).
    On a mesh whose ranks each hold a slice of the experts (DTensors:
    expert parallelism) each rank computes its experts' part for its
    tokens, and the partial sums are added at the consumer."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    probs, gates, idx = _route(cfg, p, xt)                    # (T, K)
    if is_dtensor(p["w_gate"]):
        out = _experts_on_mesh(cfg, p, xt, gates, idx)
    else:
        out = _experts(cfg, p, xt, gates, idx, counts=counts)
    return (regather(out.to(x.dtype).reshape(B, S, d)),
            _aux_loss(cfg, probs, idx) if aux else None)


def _experts(cfg, p, xt, gates, idx, lo=0, counts=None):
    """(T, d) float32: what the n experts of ``p``'s stacks, experts lo ..
    lo + n - 1 of the model, give the T tokens of ``xt`` through their
    choices ``idx`` (T, K) and gates (T, K).

    The T x K choices are sorted by expert (a stable sort: an expert's rows
    keep token order; choices of experts held elsewhere sort last), the
    token rows gathered in that order, and the three expert products run
    as grouped matrix products (``torch._grouped_mm``) over the (n, d, f)
    / (n, f, d) stacks with the experts' row offsets; an expert no choice
    picked has no rows.  Each output row goes back to its choice's place,
    and a token's K rows are summed with their gates in float32."""
    n, K = p["w_gate"].shape[0], cfg.experts_per_token
    choice = idx.reshape(-1)                                  # (T K,)
    slots = n
    if n < cfg.num_experts:
        choice = choice - lo
        choice = torch.where((choice >= 0) & (choice < n), choice, n)
        slots = n + 1
    order = torch.argsort(choice, stable=True)
    if counts is None:
        counts = torch.zeros((slots,), dtype=torch.int64, device=xt.device)
    else:
        counts.zero_()
    counts.scatter_add_(0, choice, torch.ones_like(choice))
    offs = torch.cumsum(counts[:n], 0).to(torch.int32)
    rows = xt[order // K]                                     # (T K, d)
    h = F.silu(torch._grouped_mm(rows, p["w_gate"], offs=offs))
    h = h * torch._grouped_mm(rows, p["w_up"], offs=offs)
    y = torch._grouped_mm(h, p["w_down"], offs=offs)          # by expert
    if slots > n:
        # the rows past the last offset (experts held elsewhere) are left
        # unwritten by the grouped product
        kept = torch.arange(y.shape[0], device=y.device) < offs[-1]
        y = torch.where(kept[:, None], y, 0)
    y = torch.empty_like(y).index_copy_(0, order, y)          # by choice
    return (y.view(-1, K, y.shape[-1]).float() * gates[..., None]).sum(dim=1)


def _experts_on_mesh(cfg, p, xt, gates, idx):
    """``_experts`` where the stacks are DTensors split on their expert dim
    over some mesh dims: each rank runs its own slice (its first expert
    from its coordinates on those dims; the fsdp split of d/f gathered)
    over the tokens of its batch shard, and the (T, d) result is a partial
    sum over the expert dims."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    w = p["w_gate"]
    mesh = w.device_mesh
    split = [pl == Shard(0) for pl in w.placements]
    tok = [Shard(0) if pl == Shard(0) and not s else Replicate()
           for s, pl in zip(split, xt.placements)]
    n, first = cfg.num_experts, 0
    for s, c, size in zip(split, mesh.get_coordinate(), mesh.shape):
        if s:
            n //= size
            first = first * size + c
    stacks = [Shard(0) if s else Replicate() for s in split]

    def part(xl, gl, il, wg, wu, wd):
        return _experts(cfg, {"w_gate": wg, "w_up": wu, "w_down": wd}, xl,
                        gl, il, lo=first * n)

    return local_map(
        part, out_placements=[Partial() if s else t
                              for s, t in zip(split, tok)],
        in_placements=(tok, tok, tok, stacks, stacks, stacks),
        device_mesh=mesh, redistribute_inputs=True)(
            xt, gates, idx, p["w_gate"], p["w_up"], p["w_down"])
