"""Encoder-decoder stack, SeamlessM4T-style audio to text (counterpart of
``repro/models/encdec.py``).

The audio frontend (mel + conv codec) is stubbed: the encoder takes
precomputed frame embeddings (B, frames, d).  Its self-attention is
bidirectional and plain PyTorch.  The cross-attention K/V memory is
computed once at prefill and kept in the cache (``Cache.cross_k/cross_v``,
(L, B, Senc, Hkv, hd)); the decoder's self-attention has a dense or paged
KV cache and verifies trees through the verify kernel (B1 on a dense
cache, B2 on the page pool, an int8 pool with its scales), once per
decoder layer; its cross-attention is plain PyTorch, as the reference's
``gqa_attend``.  Frames are not decoder positions.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hcmp import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models.attention import (attn_cross, attn_init, attn_prefill,
                                          attn_verify, cross_kv_init)
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.runtime.cache import (Cache, PagedKVCache, bulk_write,
                                      init_kv_cache, kv_commit)


def init_params(cfg, gen):
    """Random params from ``gen`` (a ``torch.Generator``), on its device."""
    dt = getattr(torch, cfg.dtype)
    dev = gen.device

    def ones():
        return torch.ones((cfg.d_model,), dtype=dt, device=dev)

    def enc_layer():
        return {"ln1": ones(), "attn": attn_init(cfg, gen), "ln2": ones(),
                "mlp": mlp_init(cfg, gen)}

    def dec_layer():
        return {"ln1": ones(), "attn": attn_init(cfg, gen), "ln_c": ones(),
                "cross": attn_init(cfg, gen), "ln2": ones(),
                "mlp": mlp_init(cfg, gen)}

    return {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "encoder": cm.stack_init(cfg.num_encoder_layers, enc_layer),
        "decoder": cm.stack_init(cfg.num_layers, dec_layer),
        "ln_enc": ones(),
        "ln_f": ones(),
        "lm_head": cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt),
    }


def _logits(cfg, params, x):
    return cm.logits(cm.rmsnorm(x, params["ln_f"], cfg.rmsnorm_eps),
                     params["lm_head"], cfg.vocab_size)


def _mlp(cfg, lp, x):
    return x + mlp_apply(cfg, lp["mlp"],
                         cm.rmsnorm(x, lp["ln2"], cfg.rmsnorm_eps))


def _cross(cfg, lp, x, ck, cv):
    return x + attn_cross(cfg, lp["cross"],
                          cm.rmsnorm(x, lp["ln_c"], cfg.rmsnorm_eps), ck, cv)


def encode(cfg, params, frame_embeds):
    """frame_embeds: (B, Senc, d), the stubbed frontend's output -> the
    encoder memory (B, Senc, d)."""
    x = frame_embeds
    for lp in cm.unstack_layers(params["encoder"], cfg.num_encoder_layers):
        a, _ = attn_prefill(cfg, lp["attn"],
                            cm.rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps),
                            causal=False)
        x = _mlp(cfg, lp, x + a)
    return cm.rmsnorm(x, params["ln_enc"], cfg.rmsnorm_eps)


def cross_memory(cfg, params, enc_out):
    """Every decoder layer's cross K/V: each (L, B, Senc, Hkv, hd)."""
    ks, vs = zip(*(cross_kv_init(cfg, lp["cross"], enc_out)
                   for lp in cm.unstack_layers(params["decoder"],
                                               cfg.num_layers)))
    return torch.stack(ks), torch.stack(vs)


def prefill(cfg, params, tokens, *, enc_out=None, frame_embeds=None,
            window=0, max_len=None, return_cache=True, last_logits=False):
    """Decoder prefill over the encoder memory of ``frame_embeds`` (or a
    given ``enc_out``).  Returns (logits (B,S,V), extras, Cache with the
    KV and the cross memory, or None)."""
    x = cm.embed(params["embed"], tokens)
    B, S, _ = x.shape
    if enc_out is None:
        if frame_embeds is None:
            raise ValueError(f"{cfg.name}: the enc-dec prefill needs the "
                             f"batch's frame_embeds (or enc_out)")
        enc_out = encode(cfg, params, frame_embeds)
    cross_k, cross_v = cross_memory(cfg, params, enc_out)
    ks, vs = [], []
    for i, lp in enumerate(cm.unstack_layers(params["decoder"],
                                             cfg.num_layers)):
        a, (k, v) = attn_prefill(cfg, lp["attn"],
                                 cm.rmsnorm(x, lp["ln1"], cfg.rmsnorm_eps),
                                 window=window)
        x = _mlp(cfg, lp, _cross(cfg, lp, x + a, cross_k[i], cross_v[i]))
        if return_cache:
            ks.append(k)
            vs.append(v)
    extras = {"aux_loss": torch.zeros((), dtype=torch.float32,
                                      device=x.device), "hidden": x}
    logits = _logits(cfg, params, x[:, -1:] if last_logits else x)
    if not return_cache:
        return logits, extras, None
    kv = init_kv_cache(cfg.num_layers, B, max(S, max_len or 0),
                       cfg.num_kv_heads, cfg.head_dim, window=window,
                       dtype=getattr(torch, cfg.dtype), device=x.device,
                       mesh=shd.mesh_of(x))
    kv = bulk_write(kv, torch.stack(ks), torch.stack(vs), start=0)
    return logits, extras, Cache(kv=kv, cross_k=cross_k, cross_v=cross_v)


def verify(cfg, params, cache: Cache, tree_tokens, tree_depth, tree_mask):
    """Tree verify: each decoder layer's self-attention over its cache and
    the tree (the verify kernel: a paged cache hands over its pool slice
    and an int8 pool its scales), then the cross-attention over the cached
    memory.  Returns (logits (B,W,V), extras) with ``tree_kv`` (each
    (L,B,W,Hkv,hd), not committed) and ``hidden``."""
    x = cm.embed(params["embed"], tree_tokens)
    kv = cache.kv
    paged = isinstance(kv, PagedKVCache)
    k_new, v_new = [], []
    for i in range(cfg.num_layers):
        lp = cm.layer_slice(params["decoder"], i)
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
            tree_mask=tree_mask, window=kv.window, **layer_kv)
        x = _mlp(cfg, lp, _cross(cfg, lp, x + a, cache.cross_k[i],
                                 cache.cross_v[i]))
        k_new.append(k1)
        v_new.append(v1)
    extras = {"tree_kv": (torch.stack(k_new), torch.stack(v_new)),
              "hidden": x}
    return _logits(cfg, params, x), extras


def decode(cfg, params, cache: Cache, tokens):
    """1-token decode.  tokens: (B, 1)."""
    dev = tokens.device
    logits, extras = verify(
        cfg, params, cache, tokens,
        tree_depth=torch.zeros((1,), dtype=torch.int32, device=dev),
        tree_mask=torch.ones((1, 1), dtype=torch.bool, device=dev))
    k1, v1 = extras["tree_kv"]
    return logits, dataclasses.replace(
        cache, kv=bulk_write(cache.kv, k1, v1, start=cache.kv.pos))


def commit(cfg, cache: Cache, extras, accept_nodes, n_accept, max_depth):
    """Write each row's accepted tree path; the cross memory is kept."""
    k_new, v_new = extras["tree_kv"]
    return dataclasses.replace(cache, kv=kv_commit(
        cache.kv, k_new, v_new, accept_nodes, n_accept, max_depth))
