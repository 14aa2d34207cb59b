"""Shared numeric building blocks: norms, RoPE, inits, online-softmax merge.

Plain functions on tensors; params are nested dicts of tensors with the
reference's ``x @ W`` layout and per-layer stacks on a leading L axis
(counterpart of ``repro/models/common.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # mask value (finite: avoids NaN from (-inf) - (-inf))


# --------------------------------------------------------------------------
# inits (every draw comes from the caller's generator, on its device)
# --------------------------------------------------------------------------
def dense_init(gen, d_in, d_out, dtype, scale=None):
    scale = scale if scale is not None else d_in ** -0.5
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen, vocab, d, dtype):
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def stack_init(n, init_fn):
    """Run ``init_fn()`` n times and stack the nested dicts it returns on a
    leading layer axis (counterpart of the reference's vmapped init)."""
    first = init_fn()

    def alloc(x):
        if isinstance(x, dict):
            return {k: alloc(v) for k, v in x.items()}
        out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype,
                          device=x.device)
        out[0] = x
        return out

    stacked = alloc(first)

    def fill(dst, src, i):
        for k, v in src.items():
            if isinstance(v, dict):
                fill(dst[k], v, i)
            else:
                dst[k][i] = v

    for i in range(1, n):
        fill(stacked, init_fn(), i)
    return stacked


def unstack_layers(stacked, n):
    """The ``n`` per-layer dicts of a stacked param dict (views, no copy).
    One ``unbind`` per leaf: under autograd its backward stacks the layers'
    grads once, where indexing layer by layer builds a full-size grad of
    the stack for every layer."""
    per = {k: unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in stacked.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def layer_slice(stacked, i):
    """Layer ``i`` of a stacked param dict (views, no copy)."""
    return {k: layer_slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------
def rmsnorm(x, scale, eps=1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


# --------------------------------------------------------------------------
# RoPE (split-half, not interleaved)
# --------------------------------------------------------------------------
def rope_freqs(head_dim, theta, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention math (plain torch; the CUDA kernel in kernels/ mirrors this)
# --------------------------------------------------------------------------
def gqa_scores(q, k):
    """q: (B, S, Hq, hd), k: (B, T, Hkv, hd) -> scores (B, Hq, S, T).
    Query head ``h * G + g`` reads kv head ``h``."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, S, Hkv, g, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    return s.reshape(B, Hq, S, k.shape[1])


def gqa_attend(q, k, v, mask, scale):
    """Masked attention.  mask: broadcastable (B, 1|Hq, S, T) bool."""
    s = gqa_scores(q, k) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    B, Hq, S, T = s.shape
    Hkv = v.shape[2]
    g = Hq // Hkv
    pg = p.reshape(B, Hkv, g, S, T)
    o = torch.einsum("bkgst,btkd->bskgd", pg, v.float())
    return o.reshape(B, S, Hq, v.shape[-1]).to(v.dtype)


def gqa_attend_partial(q, k, v, mask, scale):
    """Attention partials for online-softmax merging (the paper's Eq.-1
    split).  Returns (o_unnormalized (B,S,Hq,hd), m (B,Hq,S), l (B,Hq,S))."""
    s = gqa_scores(q, k) * scale
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)                                # (B,Hq,S)
    # all-masked rows: keep m finite
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1)
    B, Hq, S, T = s.shape
    Hkv = v.shape[2]
    g = Hq // Hkv
    pg = p.reshape(B, Hkv, g, S, T)
    o = torch.einsum("bkgst,btkd->bskgd", pg, v.float())
    o = o.reshape(B, S, Hq, v.shape[-1])
    return o, m_safe, l


def merge_partials_carry(carry, part):
    """Fold one (o, m, l) partial into an accumulator (blocked attention)."""
    o0, m0, l0 = carry
    o1, m1, l1 = part
    m_new = torch.maximum(m0, m1)
    c0 = torch.exp(m0 - m_new)
    c1 = torch.exp(m1 - m_new)
    l_new = l0 * c0 + l1 * c1
    o_new = (o0 * c0.transpose(1, 2)[..., None]
             + o1 * c1.transpose(1, 2)[..., None])
    return o_new, m_new, l_new


def merge_partials(parts):
    """Merge a list of (o, m, l) online-softmax partials -> normalized
    output.  o: (B,S,Hq,hd) fp32 unnormalized, m/l: (B,Hq,S)."""
    m_star = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    o_star = 0.0
    l_star = 0.0
    for o, m, l in parts:
        corr = torch.exp(m - m_star)                         # (B,Hq,S)
        l_star = l_star + l * corr
        o_star = o_star + o * corr.transpose(1, 2)[..., None]
    l_star = torch.clamp(l_star, min=1e-30)
    return o_star * (1.0 / l_star.transpose(1, 2)[..., None])


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down
