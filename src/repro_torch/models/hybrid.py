"""Zamba2-style hybrid stack: a Mamba2 backbone and one weight-SHARED
attention block applied after every ``shared_attention_every``-th layer,
each application site with its own KV cache slice (counterpart of
``repro/models/hybrid.py``).

A Python loop over the layers replaces the reference's grouped scans; the
shared block's params are used at every site.  Tree verify runs each
Mamba layer per path (``recurrent_verify.path_verify``: the state
replicated over the tree's P paths, D steps) and each shared-attention
site in node form under the tree mask, through the verify kernel (B1 on a
dense cache, B2 on the page pool).  ``commit`` picks each row's recurrent
state at its accepted (depth, path) and writes the accepted KVs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hcmp import sharding as shd
from repro_torch.models import common as cm
from repro_torch.models import mamba2 as mb
from repro_torch.models import recurrent_verify as rv
from repro_torch.models.attention import attn_init, attn_prefill, attn_verify
from repro_torch.models.mlp import mlp_apply, mlp_init
from repro_torch.runtime.cache import (Cache, KVCache, MambaState,
                                      PagedKVCache, bulk_write, init_kv_cache,
                                      kv_commit)


def n_sites(cfg):
    """KV cache slots: one per site, at least one (the reference's clone
    with no firing site still holds site 0)."""
    return max(cfg.num_layers // cfg.shared_attention_every, 1)


def _site(cfg, i):
    """The site that fires after layer ``i``, or None."""
    every = cfg.shared_attention_every
    return i // every if (i + 1) % every == 0 else None


def init_params(cfg, gen):
    """Random params from ``gen`` (a ``torch.Generator``), on its device."""
    dt = getattr(torch, cfg.dtype)
    dev = gen.device

    def ones():
        return torch.ones((cfg.d_model,), dtype=dt, device=dev)

    def layer_init():
        return {"ln": ones(), "mamba": mb.mamba_init(cfg, gen)}

    return {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "layers": cm.stack_init(cfg.num_layers, layer_init),
        "shared": {"ln1": ones(), "attn": attn_init(cfg, gen), "ln2": ones(),
                   "mlp": mlp_init(cfg, gen)},
        "ln_f": ones(),
        "lm_head": cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt),
    }


def _logits(cfg, params, x):
    return cm.logits(cm.rmsnorm(x, params["ln_f"], cfg.rmsnorm_eps),
                     params["lm_head"], cfg.vocab_size)


def _shared_mlp(cfg, sp, x):
    return x + mlp_apply(cfg, sp["mlp"],
                         cm.rmsnorm(x, sp["ln2"], cfg.rmsnorm_eps))


# --------------------------------------------------------------------------
def prefill(cfg, params, tokens, *, window=0, max_len=None,
            return_cache=True, last_logits=False):
    """Returns (logits (B,S,V), extras, Cache).  ``return_cache=False``
    (training) skips all cache work; the reference writes into a 1-slot
    dummy cache there, which no output reads."""
    x = cm.embed(params["embed"], tokens)
    B, S, _ = x.shape
    sp = params["shared"]
    kv = init_kv_cache(n_sites(cfg), B, max(S, max_len or 0),
                       cfg.num_kv_heads, cfg.head_dim, window=window,
                       dtype=x.dtype, device=x.device,
                       mesh=shd.mesh_of(x)) if return_cache else None
    # a sequence-sharded cache (DTensors) is written once, after the
    # stack, through bulk_write's sharded write
    sharded = kv is not None and shd.is_dtensor(kv.k)
    if kv is not None:
        size = kv.max_len
        lo = max(S - size, 0)     # a prompt past the ring keeps its tail
        abs_pos = torch.arange(lo, S, dtype=torch.int32, device=x.device)
        slots = abs_pos.remainder(size).long()
    ssm, conv, site_k, site_v = [], [], [], []
    for i, lp in enumerate(cm.unstack_layers(params["layers"],
                                             cfg.num_layers)):
        out, st = mb.mamba_prefill(cfg, lp["mamba"],
                                   cm.rmsnorm(x, lp["ln"], cfg.rmsnorm_eps))
        x = x + out
        ssm.append(st["ssm"])
        conv.append(st["conv"])
        g = _site(cfg, i)
        if g is None:
            continue
        h = cm.rmsnorm(x, sp["ln1"], cfg.rmsnorm_eps)
        a, (k1, v1) = attn_prefill(cfg, sp["attn"], h, window=window)
        x = _shared_mlp(cfg, sp, x + a)
        if sharded:
            site_k.append(k1[:, lo:])
            site_v.append(v1[:, lo:])
        elif kv is not None:
            kv.k[g][:, slots] = k1[:, lo:]
            kv.v[g][:, slots] = v1[:, lo:]
    extras = {"aux_loss": torch.zeros((), dtype=torch.float32,
                                      device=x.device), "hidden": x}
    logits = _logits(cfg, params, x[:, -1:] if last_logits else x)
    if kv is None:
        return logits, extras, None
    if sharded:
        kv = bulk_write(kv, torch.stack(site_k), torch.stack(site_v),
                        start=lo)
        return logits, extras, Cache(kv=kv, mamba=MambaState(
            ssm=torch.stack(ssm), conv=torch.stack(conv), pos=kv.pos))
    key_pos = kv.key_pos.clone()
    key_pos[:, slots] = abs_pos                  # the same row per sequence
    pos = torch.full((B,), S, dtype=torch.int32, device=x.device)
    cache = Cache(
        kv=KVCache(k=kv.k, v=kv.v, key_pos=key_pos, pos=pos,
                   window=kv.window),
        mamba=MambaState(ssm=torch.stack(ssm), conv=torch.stack(conv),
                         pos=pos))
    return logits, extras, cache


# --------------------------------------------------------------------------
def verify(cfg, params, cache: Cache, tree_tokens, tree_depth, tree_mask,
           *, paths, node_path, node_depth):
    """Tree verify: Mamba layers per path (state replication), the
    shared-attention sites in node form under the tree mask.  Returns
    (logits (B,W,V), extras for ``commit``): ``depth_states`` (each leaf
    (L, D, B*P, ...), the states after each depth, allocated once a
    verify), ``tree_k``/``tree_v`` (n_sites, B, W, Hkv, hd), ``P`` and
    ``hidden``."""
    x = cm.embed(params["embed"], tree_tokens)
    B, W, _ = x.shape
    P, D = paths.shape
    kv, ms = cache.kv, cache.mamba
    sp = params["shared"]
    L = cfg.num_layers
    paged = isinstance(kv, PagedKVCache)
    depth_states = {
        f: shd.empty((L, D, B * P) + tuple(t.shape[2:]), t,
                     (0,) + tuple(range(2, t.dim() + 1)))
        for f, t in (("ssm", ms.ssm), ("conv", ms.conv))}
    site_k, site_v = [], []
    for i in range(L):
        lp = cm.layer_slice(params["layers"], i)

        def step_fn(x_t, st, slot, lp=lp):
            return mb.mamba_step(cfg, lp["mamba"], x_t, st, out=slot)

        y_nodes, _ = rv.path_verify(
            step_fn, cm.rmsnorm(x, lp["ln"], cfg.rmsnorm_eps),
            {"ssm": ms.ssm[i], "conv": ms.conv[i]}, paths, node_path,
            node_depth, out={f: t[i] for f, t in depth_states.items()})
        x = x + y_nodes
        g = _site(cfg, i)
        if g is None:
            continue
        if paged:
            # the reference hands the pool over without an int8 pool's
            # scales (ROADMAP C); the port dequantizes in the page walk
            layer_kv = dict(ck=kv.pool_k[g], cv=kv.pool_v[g],
                            block_table=kv.block_table,
                            scale_k=None if kv.scale_k is None
                            else kv.scale_k[g],
                            scale_v=None if kv.scale_v is None
                            else kv.scale_v[g])
        else:
            layer_kv = dict(ck=kv.k[g], cv=kv.v[g])
        a, (k1, v1) = attn_verify(
            cfg, sp["attn"], cm.rmsnorm(x, sp["ln1"], cfg.rmsnorm_eps),
            key_pos=kv.key_pos, pos=kv.pos, tree_depth=tree_depth,
            tree_mask=tree_mask, window=kv.window, **layer_kv)
        x = _shared_mlp(cfg, sp, x + a)
        site_k.append(k1)
        site_v.append(v1)
    if not site_k:                    # degenerate clones (no firing site)
        z = torch.zeros((B, W, cfg.num_kv_heads, cfg.head_dim),
                        dtype=x.dtype, device=x.device)
        site_k, site_v = [z], [z]
    extras = {"depth_states": depth_states, "tree_k": torch.stack(site_k),
              "tree_v": torch.stack(site_v), "P": P, "hidden": x}
    return _logits(cfg, params, x), extras


def decode(cfg, params, cache: Cache, tokens):
    """1-token decode via the W=1 tree."""
    B = tokens.shape[0]
    dev = tokens.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    logits, extras = verify(
        cfg, params, cache, tokens, tree_depth=zeros(1),
        tree_mask=torch.ones((1, 1), dtype=torch.bool, device=dev),
        paths=zeros(1, 1), node_path=zeros(1), node_depth=zeros(1))
    cache = commit(cfg, cache, extras, accept_nodes=zeros(B, 1),
                   n_accept=torch.ones((B,), dtype=torch.int64, device=dev),
                   path_idx=zeros(B), max_depth=1)
    return logits, cache


def commit(cfg, cache: Cache, extras, accept_nodes, n_accept, path_idx,
           max_depth):
    """Commit the accepted paths: each row's recurrent state at its
    (n_accept - 1, path_idx) and its accepted tree KVs into the sites'
    cache.  A row with n_accept == 0 (frozen) keeps its previous state.
    accept_nodes (B, Dmax); n_accept/path_idx (B,)."""
    kv, ms = cache.kv, cache.mamba
    B = kv.pos.shape[0]
    P = extras["P"]
    keep = n_accept > 0

    def pick(s, n_accept, path_idx):          # (L, D, B*P, ...) -> (L, B, ...)
        b = n_accept.shape[0]                 # on DTensors: this rank's rows
        sbp = s.reshape(tuple(s.shape[:2]) + (b, P) + tuple(s.shape[3:]))
        return sbp[:, rv.committed_index(n_accept, s.shape[1]),
                   torch.arange(b, device=n_accept.device), path_idx.long()]

    def sel(s, prev):
        new = shd.per_row(pick, s, n_accept, path_idx, batch_dim=2,
                          out_batch_dim=1)
        k = keep.reshape((1, B) + (1,) * (prev.dim() - 2))
        return torch.where(k, new, prev)

    new_kv = kv_commit(kv, extras["tree_k"], extras["tree_v"], accept_nodes,
                       n_accept, max_depth)
    ds = extras["depth_states"]
    return dataclasses.replace(cache, kv=new_kv, mamba=MambaState(
        ssm=sel(ds["ssm"], ms.ssm), conv=sel(ds["conv"], ms.conv),
        pos=new_kv.pos))


def init_cache(cfg, batch, max_len, *, window=0, device="cuda"):
    di, nh, hd, N = mb.dims(cfg)
    dt = getattr(torch, cfg.dtype)
    kv = init_kv_cache(n_sites(cfg), batch, max_len, cfg.num_kv_heads,
                       cfg.head_dim, window=window, dtype=dt, device=device)
    return Cache(kv=kv, mamba=MambaState(
        ssm=torch.zeros((cfg.num_layers, batch, nh, hd, N),
                        dtype=torch.float32, device=device),
        conv=torch.zeros((cfg.num_layers, batch, cfg.ssm_conv - 1,
                          di + 2 * N), dtype=dt, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device)))
