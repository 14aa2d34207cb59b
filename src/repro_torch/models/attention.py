"""GQA attention block: prefill / decode / tree-verify paths (counterpart of
``repro/models/attention.py``).

The tree-verify path is the heart of Ghidorah: the W speculative tokens
attend to (a) the long KV cache, the dense part, and (b) the W fresh tree
KVs under the ancestor mask, the sparse part, merged by the paper's Eq.-1
online softmax.  Both parts run in one fused kernel
(``kernels/dispatch.py::tree_attention`` over a dense cache,
``::paged_tree_attention`` over the paged pool), or, for a paged cache
with ``tree_kernel="sparse"``, in two kernels whose partials are merged
here.  A CUDA tensor takes the hand-written CUDA kernels, a CPU tensor
their plain PyTorch versions.  Prefill stays plain torch math, like the
reference's jnp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dispatch
from repro_torch.models import common as cm
from repro_torch.runtime.cache import prefill_mask


def attn_init(cfg, gen):
    d, hd = cfg.d_model, cfg.head_dim
    dt = _dt(cfg)
    p = {
        "wq": cm.dense_init(gen, d, cfg.num_heads * hd, dt),
        "wk": cm.dense_init(gen, d, cfg.num_kv_heads * hd, dt),
        "wv": cm.dense_init(gen, d, cfg.num_kv_heads * hd, dt),
        "wo": cm.dense_init(gen, cfg.num_heads * hd, d, dt),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dt, device=dev)
    return p


def _dt(cfg):
    return getattr(torch, cfg.dtype)


def _qkv(cfg, p, x, positions):
    """x: (B, S, d) -> roped q (B,S,Hq,hd), k (B,S,Hkv,hd), v (B,S,Hkv,hd)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = cm.rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = cm.rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


BLOCKED_PREFILL_THRESHOLD = 4096      # S above which prefill uses tiling
PREFILL_BLOCK = 1024


def attn_prefill(cfg, p, x, *, window=0, causal=True):
    """Full-sequence causal (optionally windowed) or, with ``causal=False``
    (the encoder), bidirectional attention.  Returns (out, (k, v)) with k/v
    the rope'd cache entries for positions [0, S).  Long causal sequences
    use the blocked online-softmax path, which never builds the (B, H, S,
    S) score tensor; the bidirectional one always builds it, as in the
    reference."""
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q, k, v = _qkv(cfg, p, x, positions)
    scale = cfg.head_dim ** -0.5
    if causal and S >= BLOCKED_PREFILL_THRESHOLD and S % PREFILL_BLOCK == 0:
        o = _blocked_causal_attend(q, k, v, scale, window=window,
                                   block=PREFILL_BLOCK)
    else:
        if causal:
            mask = prefill_mask(S, window, device=x.device)[None, None]
        else:
            mask = torch.ones((1, 1, S, S), dtype=torch.bool,
                              device=x.device)
        o = cm.gqa_attend(q, k, v, mask, scale)
    out = o.reshape(B, S, -1) @ p["wo"]
    return out, (k, v)


def _blocked_causal_attend(q, k, v, scale, *, window=0, block=1024):
    """Tiled causal attention with an online-softmax carry: (Cq, Ck) score
    tiles instead of the (S, S) matrix.  Masked tiles are still computed,
    as in the reference."""
    B, S, Hq, hd = q.shape
    nq = S // block
    base = torch.arange(block, device=q.device)
    outs = []
    for i in range(nq):
        qi = q[:, i * block:(i + 1) * block]
        qpos = i * block + base
        o = torch.zeros((B, block, Hq, hd), dtype=torch.float32,
                        device=q.device)
        m = torch.full((B, Hq, block), cm.NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hq, block), dtype=torch.float32, device=q.device)
        for j in range(nq):
            kj = k[:, j * block:(j + 1) * block]
            vj = v[:, j * block:(j + 1) * block]
            kpos = j * block + base
            ok = kpos[None, :] <= qpos[:, None]
            if window:
                ok &= kpos[None, :] > qpos[:, None] - window
            part = cm.gqa_attend_partial(qi, kj, vj, ok[None, None], scale)
            o, m, l = cm.merge_partials_carry((o, m, l), part)
        l = torch.clamp(l, min=1e-30)
        outs.append((o * (1.0 / l.transpose(1, 2))[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1)


def attn_cross(cfg, p, x, enc_k, enc_v):
    """Encoder-decoder cross-attention: queries over the fixed encoder
    memory ``enc_k/enc_v (B, Senc, Hkv, hd)`` (``cross_kv_init``), every
    key seen; the queries are not rotated.  Plain PyTorch, as the
    reference's ``gqa_attend``."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, hd)
    if cfg.qkv_bias:
        q = q + p["bq"].reshape(cfg.num_heads, hd)
    if cfg.qk_norm:
        q = cm.rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps)
    mask = torch.ones((1, 1, S, enc_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    o = cm.gqa_attend(q, enc_k, enc_v, mask, hd ** -0.5)
    return o.reshape(B, S, -1) @ p["wo"]


def cross_kv_init(cfg, p, enc_out):
    """The cross-attention K/V memory of one decoder layer from the
    encoder's output (B, Senc, d): each (B, Senc, Hkv, hd), not rotated."""
    B, S, _ = enc_out.shape
    hd = cfg.head_dim
    k = (enc_out @ p["wk"]).reshape(B, S, cfg.num_kv_heads, hd)
    v = (enc_out @ p["wv"]).reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qkv_bias:
        k = k + p["bk"].reshape(cfg.num_kv_heads, hd)
        v = v + p["bv"].reshape(cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        k = cm.rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps)
    return k, v


def attn_verify(cfg, p, x, *, ck, cv, key_pos, pos, tree_depth, tree_mask,
                window=0, block_table=None, scale_k=None, scale_v=None,
                tree_kernel="dense"):
    """Tree-verification attention over W draft tokens (decode = W=1 case).

    x: (B, W, d); tree_depth: (W,) node depth (0 = first new token);
    tree_mask: (W, W) ancestor-or-self mask; ``pos`` (B,) and ``key_pos``
    (B, S) are per sequence.

    Cache layout: dense (``block_table=None``) reads ck/cv as per-row
    caches (B, S, Hkv, hd); paged passes ONE layer's shared pool
    ``(n_pages + 1, ps, Hkv, hd)`` with ``block_table (B, max_pages)``, and
    an int8 pool its ``scale_k/scale_v (n_pages + 1, Hkv)``: the kernel
    walks the table and dequantizes in its page walk.  ``tree_kernel=
    "sparse"`` splits a paged verify into the cache-only page walk and the
    W x W tree partial, merged by the Eq.-1 rule; a dense cache always takes
    the fused kernel.  Returns (out (B, W, d), (k_new, v_new)), the fresh
    KVs NOT yet committed.
    """
    B, W, _ = x.shape
    pos_b = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int32, device=x.device), (B,))
    positions = pos_b[:, None] + tree_depth[None, :]          # (B, W)
    q, k_new, v_new = _qkv(cfg, p, x, positions)
    if block_table is None:
        o = dispatch.tree_attention(q, ck, cv, k_new, v_new, key_pos, pos_b,
                                    tree_depth, tree_mask, window=window)
    elif tree_kernel == "sparse":
        cache_part = dispatch.paged_cache_attention(
            q, ck, cv, block_table, key_pos, pos_b, tree_depth,
            scale_k=scale_k, scale_v=scale_v)
        tree_part = dispatch.sparse_tree_attention_partial(q, k_new, v_new,
                                                           tree_mask)
        o = cm.merge_partials([cache_part, tree_part]).to(x.dtype)
    else:
        o = dispatch.paged_tree_attention(
            q, ck, cv, k_new, v_new, block_table, key_pos, pos_b, tree_depth,
            tree_mask, scale_k=scale_k, scale_v=scale_v)
    out = o.reshape(B, W, -1) @ p["wo"]
    return out, (k_new, v_new)


def attn_decode(cfg, p, x, *, ck, cv, key_pos, pos, window=0):
    """Single-token decode: W=1 tree with a trivial mask.  The new token's
    K/V is returned for the caller to commit; attention includes it via the
    tree part (self-attention to itself)."""
    dev = x.device
    return attn_verify(
        cfg, p, x, ck=ck, cv=cv, key_pos=key_pos, pos=pos,
        tree_depth=torch.zeros((1,), dtype=torch.int32, device=dev),
        tree_mask=torch.ones((1, 1), dtype=torch.bool, device=dev),
        window=window)
