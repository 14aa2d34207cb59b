"""Uniform model API (counterpart of ``repro/models/api.py``).

``get_model(cfg)`` returns a ``Model`` namespace with:

  init_params(gen)                               -> params
  prefill(params, batch, max_len, window)        -> logits, extras, cache
  decode(params, cache, tokens)                  -> logits, cache
  verify(params, cache, tree_tokens, tree)       -> logits, extras
  commit(cache, extras, tree,
         accept_nodes (B, Dmax), n_accept (B,),
         path_idx (B,))                          -> cache

``batch`` for prefill is a dict {"tokens": (B,S)}.  This slice ports the
dense family; the others come with ROADMAP A11.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.models import transformer


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
        if "patch_embeds" in batch:
            raise NotImplementedError("the VLM patch-embed prefix is not "
                                      "yet ported (ROADMAP A11)")
        return transformer.prefill(cfg, params, batch["tokens"],
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


def get_model(cfg) -> Model:
    if cfg.arch_type != "dense" or cfg.is_encoder_decoder or cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} family is not yet ported "
            f"(ROADMAP A11); this slice serves dense decoders")
    return _dense_like(cfg, cfg.arch_type)
