"""Uniform model API (counterpart of ``repro/models/api.py``).

``get_model(cfg)`` returns a ``Model`` namespace with:

  init_params(gen)                               -> params
  prefill(params, batch, max_len, window)        -> logits, extras, cache
  decode(params, cache, tokens)                  -> logits, cache
  verify(params, cache, tree_tokens, tree)       -> logits, extras
    (kw: tree_kernel; families without the split paged verify accept and
     ignore it; tap, a ``trace.ExpertTap``, which families without
     experts ignore)
  commit(cache, extras, tree,
         accept_nodes (B, Dmax), n_accept (B,),
         path_idx (B,))                          -> cache

``batch`` for prefill is a dict {"tokens": (B,S)} and, for the VLM family,
{"patch_embeds": (B,T,d)}: the pre-projected patch embeddings (the vision
tower is stubbed) join the decoder sequence before the token embeddings;
for the enc-dec family {"frame_embeds": (B,Senc,d)} (or a precomputed
"enc_out"): the stubbed audio frontend's frames, which the encoder reads
and which are not decoder positions.  Embeddings are cast to the model's
dtype.  The dense, MoE and VLM families share the transformer stack; the
hybrid family is Zamba2's, the ssm family xLSTM's, the audio family the
enc-dec stack.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models import encdec, hybrid, transformer, xlstm_model


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
    def prefill(params, batch, *, max_len=None, window=0, return_cache=True,
                last_logits=False):
        tokens = batch["tokens"]
        embeds = None
        if cfg.frontend == "vision" and "patch_embeds" in batch:
            tok_e = transformer.embed_tokens(cfg, params, tokens)
            embeds = torch.cat(
                [batch["patch_embeds"].to(tok_e.dtype), tok_e], dim=1)
        return transformer.prefill(cfg, params, tokens, embeds,
                                   max_len=max_len, window=window,
                                   return_cache=return_cache,
                                   last_logits=last_logits)

    def verify(params, cache, tree_tokens, tree, *, tree_kernel="dense",
               tap=None):
        return transformer.verify(cfg, params, cache, tree_tokens,
                                  tree.depth, tree.mask,
                                  tree_kernel=tree_kernel, tap=tap)

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
    def prefill(params, batch, *, max_len=None, window=0, return_cache=True,
                last_logits=False):
        return hybrid.prefill(cfg, params, batch["tokens"], max_len=max_len,
                              window=window, return_cache=return_cache,
                              last_logits=last_logits)

    def verify(params, cache, tree_tokens, tree, *, tree_kernel="dense",
               tap=None):
        del tree_kernel, tap         # no split paged verify, no experts
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


def _xlstm(cfg):
    def prefill(params, batch, *, max_len=None, window=0, return_cache=True,
                last_logits=False):
        return xlstm_model.prefill(cfg, params, batch["tokens"],
                                   return_cache=return_cache,
                                   last_logits=last_logits)

    def verify(params, cache, tree_tokens, tree, *, tree_kernel="dense",
               tap=None):
        del tree_kernel, tap         # no KV: nothing to split; no experts
        return xlstm_model.verify(cfg, params, cache, tree_tokens,
                                  paths=tree.paths, node_path=tree.node_path,
                                  node_depth=tree.node_depth)

    def decode(params, cache, tokens):
        return xlstm_model.decode(cfg, params, cache, tokens)

    def commit(cache, extras, tree, accept_nodes, n_accept, path_idx):
        return xlstm_model.commit(cfg, cache, extras, accept_nodes, n_accept,
                                  path_idx, tree.max_depth)

    def init_params(gen):
        return xlstm_model.init_params(cfg, gen)

    return Model(cfg=cfg, init_params=init_params, prefill=prefill,
                 decode=decode, verify=verify, commit=commit, family="ssm")


def _encdec(cfg):
    def prefill(params, batch, *, max_len=None, window=0, return_cache=True,
                last_logits=False):
        dt = params["embed"].dtype
        frames, enc_out = batch.get("frame_embeds"), batch.get("enc_out")
        return encdec.prefill(
            cfg, params, batch["tokens"],
            frame_embeds=None if frames is None else frames.to(dt),
            enc_out=None if enc_out is None else enc_out.to(dt),
            max_len=max_len, window=window, return_cache=return_cache,
            last_logits=last_logits)

    def verify(params, cache, tree_tokens, tree, *, tree_kernel="dense",
               tap=None):
        del tree_kernel, tap         # always fused, as the reference
        return encdec.verify(cfg, params, cache, tree_tokens, tree.depth,
                             tree.mask)

    def decode(params, cache, tokens):
        return encdec.decode(cfg, params, cache, tokens)

    def commit(cache, extras, tree, accept_nodes, n_accept, path_idx):
        return encdec.commit(cfg, cache, extras, accept_nodes, n_accept,
                             tree.max_depth)

    def init_params(gen):
        return encdec.init_params(cfg, gen)

    return Model(cfg=cfg, init_params=init_params, prefill=prefill,
                 decode=decode, verify=verify, commit=commit, family="audio")


def get_model(cfg) -> Model:
    if cfg.is_encoder_decoder:
        return _encdec(cfg)
    if cfg.arch_type == "hybrid":
        return _hybrid(cfg)
    if cfg.arch_type == "ssm":
        return _xlstm(cfg)
    return _dense_like(cfg, cfg.arch_type)       # dense | moe | vlm
