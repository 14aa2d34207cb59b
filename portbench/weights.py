"""Random weights from ``--seed``, made on the device in the port's
parameter layout (the nested dicts ``repro_torch.models.transformer`` and
``core/speculative/medusa.py`` read: per-layer leaves stacked on a leading
layer axis, ``x @ W`` orientation), by this module's own initialiser.

Every normal leaf of one dtype is a view of one flat buffer that a single
``torch.randn`` call on the device fills; each view is then scaled in
place.  Norm gains are ones.  The same tensors are handed to the program
and to the plain reference.
"""
from __future__ import annotations

import torch

SEED_MASK = (1 << 63) - 1


def padded_vocab(vocab: int) -> int:
    """The port's vocab padding: a multiple of 4096 (128 below 4096)."""
    mult = 128 if vocab < 4096 else 4096
    return (vocab + mult - 1) // mult * mult


def layout(cfg) -> dict:
    """``{path: (shape, dtype, init)}`` of the model's and the draft heads'
    leaves; ``init`` is a normal's scale, or "ones"."""
    d, L, hd = cfg.d_model, cfg.num_layers, cfg.head_dim
    Hq, Hkv, f = cfg.num_heads, cfg.num_kv_heads, cfg.d_ff
    Vp = padded_vocab(cfg.vocab_size)
    dt = getattr(torch, cfg.dtype)
    out = {
        ("embed",): ((Vp, d), dt, 0.02),
        ("layers", "ln1"): ((L, d), dt, "ones"),
        ("layers", "ln2"): ((L, d), dt, "ones"),
        ("layers", "attn", "wq"): ((L, d, Hq * hd), dt, d ** -0.5),
        ("layers", "attn", "wk"): ((L, d, Hkv * hd), dt, d ** -0.5),
        ("layers", "attn", "wv"): ((L, d, Hkv * hd), dt, d ** -0.5),
        ("layers", "attn", "wo"): ((L, Hq * hd, d), dt, (Hq * hd) ** -0.5),
        ("ln_f",): ((d,), dt, "ones"),
    }
    if cfg.qk_norm:
        out[("layers", "attn", "q_norm")] = ((L, hd), dt, "ones")
        out[("layers", "attn", "k_norm")] = ((L, hd), dt, "ones")
    if cfg.num_experts:
        E = cfg.num_experts
        out[("layers", "moe", "router")] = ((L, d, E), torch.float32,
                                            d ** -0.5)
        out[("layers", "moe", "w_gate")] = ((L, E, d, f), dt, d ** -0.5)
        out[("layers", "moe", "w_up")] = ((L, E, d, f), dt, d ** -0.5)
        out[("layers", "moe", "w_down")] = ((L, E, f, d), dt, f ** -0.5)
    else:
        out[("layers", "mlp", "w_gate")] = ((L, d, f), dt, d ** -0.5)
        out[("layers", "mlp", "w_up")] = ((L, d, f), dt, d ** -0.5)
        out[("layers", "mlp", "w_down")] = ((L, f, d), dt, f ** -0.5)
    if not cfg.tie_embeddings:
        out[("lm_head",)] = ((d, Vp), dt, d ** -0.5)
    H = cfg.medusa_heads
    out[("heads", "w")] = ((H, d, d), dt, 0.02)
    out[("heads", "out")] = ((H, d, Vp), dt, d ** -0.5)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make(cfg, seed: int, device):
    """(params, heads) for ``cfg`` from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & SEED_MASK)
    lay = layout(cfg)
    leaves = {}
    for dt in sorted({v[1] for v in lay.values()}, key=str):
        normal = [(p, shape, init) for p, (shape, d, init) in lay.items()
                  if d == dt and init != "ones"]
        flat = torch.randn(sum(_numel(s) for _, s, _ in normal),
                           generator=gen, device=device, dtype=dt)
        off = 0
        for p, shape, scale in normal:
            n = _numel(shape)
            leaves[p] = flat[off:off + n].view(shape).mul_(scale)
            off += n
    for p, (shape, dt, init) in lay.items():
        if init == "ones":
            leaves[p] = torch.ones(shape, dtype=dt, device=device)
    tree: dict = {}
    for p, t in leaves.items():
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = t
    heads = tree.pop("heads")
    return tree, heads
