"""Uniform model API (counterpart of ``repro/models/api.py``).

``get_model(cfg)`` returns a ``Model`` namespace with:

  init_params(gen)                               -> params
  prefill(params, batch, max_len, window)        -> logits, extras, cache
  decode(params, cache, tokens)                  -> logits, cache
  verify(params, cache, tree_tokens, tree)       -> logits, extras
    (kw: tree_kernel; families without the split paged verify accept and
     ignore it)
  commit(cache, extras, tree,
         accept_nodes (B, Dmax), n_accept (B,),
         path_idx (B,))                          -> cache

``batch`` for prefill is a dict {"tokens": (B,S)} and, for the VLM family,
{"patch_embeds": (B,T,d)}: the pre-projected patch embeddings (the vision
tower is stubbed) join the decoder sequence before the token embeddings.
The dense, MoE and VLM families share the transformer stack; the hybrid
family is Zamba2's.  xLSTM and enc-dec come with ROADMAP A11.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import hybrid, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: Any
    init_params: Callable
    prefill: Callable
    decode: Callable
    verify: Callable
    commit: Callable
    family: str


def _dense_like(cfg, family):
    def prefill(params, batch, *, max_len=None, window=0, return_cache=True):
        tokens = batch["tokens"]
        embeds = None
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            tok_e = transformer.embed_tokens(cfg, params, tokens)
            embeds = torch.cat(
                [batch["patch_embeds"].to(tok_e.dtype), tok_e], dim=1)
        return transformer.prefill(cfg, params, tokens, embeds,
                                   max_len=max_len, window=window,
                                   return_cache=return_cache)

    def verify(params, cache, tree_tokens, tree, *, tree_kernel="dense"):
        return transformer.verify(cfg, params, cache, tree_tokens,
                                  tree.depth, tree.mask,
                                  tree_kernel=tree_kernel)

    def decode(params, cache, tokens):
        return transformer.decode(cfg, params, cache, tokens)

    def commit(cache, extras, tree, accept_nodes, n_accept, path_idx):
        return transformer.commit(cfg, cache, extras, accept_nodes, n_accept,
                                  tree.max_depth)

    def init_params(gen):
        return transformer.init_params(cfg, gen)

    return Model(cfg=cfg, init_params=init_params, prefill=prefill,
                 decode=decode, verify=verify, commit=commit, family=family)


def _hybrid(cfg):
    def prefill(params, batch, *, max_len=None, window=0, return_cache=True):
        return hybrid.prefill(cfg, params, batch["tokens"], max_len=max_len,
                              window=window, return_cache=return_cache)

    def verify(params, cache, tree_tokens, tree, *, tree_kernel="dense"):
        del tree_kernel              # no split paged verify here
        return hybrid.verify(cfg, params, cache, tree_tokens, tree.depth,
                             tree.mask, paths=tree.paths,
                             node_path=tree.node_path,
                             node_depth=tree.node_depth)

    def decode(params, cache, tokens):
        return hybrid.decode(cfg, params, cache, tokens)

    def commit(cache, extras, tree, accept_nodes, n_accept, path_idx):
        return hybrid.commit(cfg, cache, extras, accept_nodes, n_accept,
                             path_idx, tree.max_depth)

    def init_params(gen):
        return hybrid.init_params(cfg, gen)

    return Model(cfg=cfg, init_params=init_params, prefill=prefill,
                 decode=decode, verify=verify, commit=commit,
                 family="hybrid")


def get_model(cfg) -> Model:
    if cfg.is_encoder_decoder or cfg.arch_type == "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family is not yet ported "
            f"(ROADMAP A11); the port serves the dense, MoE, VLM and "
            f"hybrid families")
    if cfg.arch_type == "hybrid":
        return _hybrid(cfg)
    return _dense_like(cfg, cfg.arch_type)       # dense | moe | vlm
