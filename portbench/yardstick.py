"""Peaks of the chip and the operations and bytes the work needs, counted
from the configuration and the shapes of each call, never from the kernels
that ran.

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 tensor-core rate and HBM3
bandwidth, at the card's full 700 W (the result line names the card and
its power limit).  B2's byte count follows the port's own smoke check
(``chip_smoke.py::paged_bytes``): each input read once, the page pool only
at the slots a row's context holds, each output written once.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # dense bf16, H100 SXM
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
BF16 = 2                         # bytes an element


def dims(cfg: dict) -> dict:
    d = cfg["hidden_size"]
    Hq = cfg["num_attention_heads"]
    return dict(d=d, L=cfg["num_hidden_layers"], Hq=Hq,
                Hkv=cfg["num_key_value_heads"],
                hd=cfg.get("head_dim") or d // Hq, V=cfg["vocab_size"],
                E=cfg.get("num_experts") or 0,
                K=cfg.get("num_experts_per_tok") or 0,
                f=cfg.get("moe_intermediate_size")
                or cfg["intermediate_size"])


def active_params(cfg: dict) -> int:
    """Weights one token multiplies: attention, the MLP (an MoE: the router
    and k experts), the LM head; not the embedding lookup."""
    m = dims(cfg)
    d, hd = m["d"], m["hd"]
    attn = d * m["Hq"] * hd * 2 + d * m["Hkv"] * hd * 2
    ffn = m["K"] * 3 * d * m["f"] + d * m["E"] if m["E"] else 3 * d * m["f"]
    return m["L"] * (attn + ffn) + d * m["V"]


def tree_nnz(mask) -> int:
    """Ancestor-or-self pairs of a tree's (W, W) mask."""
    return int(sum(sum(bool(x) for x in row) for row in mask))


def attn_ops(cfg: dict, W: int, nnz: int, ctx) -> float:
    """q.k and p.v multiply-adds of one verify call over all layers:
    each of a row's W queries against its ``ctx`` cached keys, and the
    tree's ``nnz`` ancestor pairs."""
    m = dims(cfg)
    keys = sum(W * c + nnz for c in ctx)
    return 4.0 * m["Hq"] * m["hd"] * keys * m["L"]


def step_flops(cfg: dict, W: int, nnz: int, ctx_live) -> float:
    """Model FLOPs of one verify step: 2 x active parameters a token over
    each decoding row's W tree tokens, plus attention over its context."""
    return 2.0 * active_params(cfg) * W * len(ctx_live) \
        + attn_ops(cfg, W, nnz, ctx_live)


def b2_bound_s(cfg: dict, W: int, nnz: int, ctx) -> float:
    """Least time of the paged verify (B2) over all layers of one call, on
    ``len(ctx)`` rows with those contexts: the larger of its bytes over
    the HBM rate and its operations over the bf16 peak, layer by layer.
    Bytes a layer: K and V at each row's ``ctx`` slots, q and the output
    (W x Hq x hd a row), the fresh tree K and V (W x Hkv x hd a row)."""
    m = dims(cfg)
    B = len(ctx)
    Hq, Hkv, hd = m["Hq"], m["Hkv"], m["hd"]
    nbytes = BF16 * (2 * Hkv * hd * sum(ctx) + 2 * B * W * Hq * hd
                     + 2 * B * W * Hkv * hd)
    ops = attn_ops(cfg, W, nnz, ctx) / m["L"]
    return m["L"] * max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16_FLOPS)
