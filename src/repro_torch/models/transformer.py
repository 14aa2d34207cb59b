"""Decoder-only transformer stack, dense / MoE / VLM (counterpart of
``repro/models/transformer.py``).

Per-layer params are stacked on a leading L axis, as in the reference; a
Python loop over layers replaces ``lax.scan``.  Three paths:

  prefill  tokens (B,S)             -> logits (B,S,V), filled Cache
  decode   token (B,1) + Cache      -> logits (B,1,V), updated Cache
  verify   tree tokens (B,W)+Cache  -> logits (B,W,V), uncommitted tree KVs

``commit`` writes the accepted tree path's KVs into the cache.  A paged
cache (``runtime/cache.py::PagedKVCache``) is written and committed through
its block table by ``bulk_write``/``kv_commit``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hcmp import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models.attention import attn_init, attn_prefill, attn_verify
from repro_torch.models.mlp import mlp_apply, mlp_init, moe_apply, moe_init
from repro_torch.runtime.cache import (Cache, PagedKVCache, bulk_write,
                                      init_kv_cache, kv_commit)


def init_params(cfg, gen):
    """Random params from ``gen`` (a ``torch.Generator``), on its device."""
    dt = getattr(torch, cfg.dtype)
    dev = gen.device

    def layer_init():
        p = {
            "ln1": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "ln2": torch.ones((cfg.d_model,), dtype=dt, device=dev),
            "attn": attn_init(cfg, gen),
        }
        if cfg.num_experts:
            p["moe"] = moe_init(cfg, gen)
        else:
            p["mlp"] = mlp_init(cfg, gen)
        return p

    params = {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "layers": cm.stack_init(cfg.num_layers, layer_init),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = cm.dense_init(gen, cfg.d_model, cfg.padded_vocab,
                                          dt)
    return params


def _mix(cfg, lp, h):
    """The layer's MoE with its load-balance term (0-d float32), or its
    MLP with None (the reference adds a zero)."""
    if cfg.num_experts:
        return moe_apply(cfg, lp["moe"], h)
    return mlp_apply(cfg, lp["mlp"], h), None


def _logits(cfg, params, x):
    x = cm.rmsnorm(x, params["ln_f"], cfg.rmsnorm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return cm.logits(x, head, cfg.vocab_size)


def embed_tokens(cfg, params, tokens):
    return cm.embed(params["embed"], tokens)


# --------------------------------------------------------------------------
def prefill(cfg, params, tokens, embeds=None, *, window=0, max_len=None,
            return_cache=True, last_logits=False):
    """Returns (logits (B,S,V), extras, Cache).  ``embeds`` (B,S,d)
    replaces the token embedding (the VLM path: patch embeds, then the
    token embeds).  ``max_len`` sets the cache capacity (>= S + expected
    new tokens); ``return_cache=False`` skips all KV-cache work (training:
    the path is plain autograd-safe torch).  ``extras`` holds ``aux_loss``
    (0-d float32, the layers' MoE load-balance terms summed) and
    ``hidden`` (B,S,d)."""
    x = embed_tokens(cfg, params, tokens) if embeds is None else embeds
    B, S, _ = x.shape
    ks, vs, auxs = [], [], []
    for lp in cm.unstack_layers(params["layers"], cfg.num_layers):
        a, (k, v) = attn_prefill(cfg, lp["attn"],
                                 cm.rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps),
                                 window=window)
        x = x + a
        m, aux = _mix(cfg, lp, cm.rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps))
        x = x + m
        if aux is not None:
            auxs.append(aux)
        if return_cache:
            ks.append(k)
            vs.append(v)
    logits = _logits(cfg, params, x[:, -1:] if last_logits else x)
    aux_loss = torch.stack(auxs).sum() if auxs else torch.zeros(
        (), dtype=torch.float32, device=x.device)
    extras = {"aux_loss": aux_loss, "hidden": x}
    if not return_cache:
        return logits, extras, None
    kv = init_kv_cache(cfg.num_layers, B, max(S, max_len or 0),
                       cfg.num_kv_heads, cfg.head_dim, window=window,
                       dtype=getattr(torch, cfg.dtype), device=x.device,
                       mesh=shd.mesh_of(x))
    kv = bulk_write(kv, torch.stack(ks), torch.stack(vs), start=0)
    return logits, extras, Cache(kv=kv)


# --------------------------------------------------------------------------
def verify(cfg, params, cache: Cache, tree_tokens, tree_depth, tree_mask,
           *, tree_kernel="dense"):
    """Tree-verification forward: W draft tokens vs cache + tree mask.

    Returns (logits (B,W,V), extras) with ``extras["tree_kv"]`` = (k, v),
    each (L,B,W,Hkv,hd), NOT committed: call ``commit`` with the accepted
    path.  A paged cache hands each layer its pool slice and, when the pool
    is int8, its (P, Hkv) scale slices; ``tree_kernel`` picks the fused or
    the split paged verify.
    """
    x = embed_tokens(cfg, params, tree_tokens)
    kv = cache.kv
    paged = isinstance(kv, PagedKVCache)
    k_new, v_new = [], []
    for i in range(cfg.num_layers):
        lp = cm.layer_slice(params["layers"], i)
        if paged:
            layer_kv = dict(ck=kv.pool_k[i], cv=kv.pool_v[i],
                            block_table=kv.block_table,
                            scale_k=None if kv.scale_k is None
                            else kv.scale_k[i],
                            scale_v=None if kv.scale_v is None
                            else kv.scale_v[i])
        else:
            layer_kv = dict(ck=kv.k[i], cv=kv.v[i])
        a, (k1, v1) = attn_verify(
            cfg, lp["attn"], cm.rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps),
            key_pos=kv.key_pos, pos=kv.pos, tree_depth=tree_depth,
            tree_mask=tree_mask, window=kv.window, tree_kernel=tree_kernel,
            **layer_kv)
        x = x + a
        x = x + _mix(cfg, lp, cm.rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps))[0]
        k_new.append(k1)
        v_new.append(v1)
    extras = {"tree_kv": (torch.stack(k_new), torch.stack(v_new)),
              "hidden": x}
    return _logits(cfg, params, x), extras


def decode(cfg, params, cache: Cache, tokens):
    """Plain 1-token decode (the sequential baseline step).

    tokens: (B, 1).  Returns (logits (B,1,V), updated Cache).
    """
    dev = tokens.device
    logits, extras = verify(
        cfg, params, cache, tokens,
        tree_depth=torch.zeros((1,), dtype=torch.int32, device=dev),
        tree_mask=torch.ones((1, 1), dtype=torch.bool, device=dev))
    k1, v1 = extras["tree_kv"]
    return logits, dataclasses.replace(
        cache, kv=bulk_write(cache.kv, k1, v1, start=cache.kv.pos))


def commit(cfg, cache: Cache, extras, accept_nodes, n_accept, max_depth):
    """Write each sequence's accepted tree path at [pos_b, pos_b + n_b).

    accept_nodes: (B, Dmax) node indices of the accepted paths (padded);
    n_accept: (B,) accepted tokens per sequence.  Slots beyond n_accept[b]
    keep their previous contents.
    """
    k_new, v_new = extras["tree_kv"]                         # (L,B,W,Hkv,hd)
    return dataclasses.replace(cache, kv=kv_commit(
        cache.kv, k_new, v_new, accept_nodes, n_accept, max_depth))
