"""xLSTM model stack: sLSTM and mLSTM layers, unrolled (counterpart of
``repro/models/xlstm_model.py``).

Purely recurrent: the cache holds no KV (``Cache(xlstm=XLSTMState(...))``),
so decode is O(1) in the context and the paged layout leaves it as it is.
The params keep the reference's tuple of per-layer dicts ``{"ln",
"block"}``, the sLSTM and mLSTM blocks of different shapes.  Tree verify
replicates each layer's state per tree path
(``recurrent_verify.path_verify``); ``commit`` picks each row's state at
its accepted (depth, path), and a frozen row (n_accept == 0) keeps its
previous state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import SLSTM
from repro_torch.models import common as cm
from repro_torch.models import recurrent_verify as rv
from repro_torch.models import xlstm as xl
from repro_torch.runtime.cache import Cache, XLSTMState


def init_params(cfg, gen):
    """Random params from ``gen`` (a ``torch.Generator``), on its device."""
    dt = getattr(torch, cfg.dtype)
    dev = gen.device
    layers = []
    for kind in cfg.blocks():
        init = xl.slstm_init if kind == SLSTM else xl.mlstm_init
        layers.append({"ln": torch.ones((cfg.d_model,), dtype=dt, device=dev),
                       "block": init(cfg, gen)})
    return {
        "embed": cm.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt),
        "layers": tuple(layers),
        "ln_f": torch.ones((cfg.d_model,), dtype=dt, device=dev),
        "lm_head": cm.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt),
    }


def _logits(cfg, params, x):
    return (cm.rmsnorm(x, params["ln_f"], cfg.rmsnorm_eps)
            @ params["lm_head"])[..., :cfg.vocab_size]


def init_cache(cfg, batch, max_len=0, *, window=0, device="cuda") -> Cache:
    sts = tuple(xl.slstm_init_state(cfg, batch, device=device)
                if kind == SLSTM else
                xl.mlstm_init_state(cfg, batch, device=device)
                for kind in cfg.blocks())
    return Cache(xlstm=XLSTMState(
        layers=sts, pos=torch.zeros((batch,), dtype=torch.int32,
                                    device=device)))


def prefill(cfg, params, tokens, *, return_cache=True):
    """Returns (logits (B,S,V), extras, Cache or None)."""
    x = params["embed"][tokens.long()]
    B, S, _ = x.shape
    cache = init_cache(cfg, B, device=x.device)
    states = []
    for lp, kind, st in zip(params["layers"], cfg.blocks(),
                            cache.xlstm.layers):
        fn = xl.slstm_prefill if kind == SLSTM else xl.mlstm_prefill
        y, st = fn(cfg, lp["block"], cm.rmsnorm(x, lp["ln"], cfg.rmsnorm_eps),
                   st)
        x = x + y
        states.append(st)
    extras = {"aux_loss": torch.zeros((), dtype=torch.float32,
                                      device=x.device), "hidden": x}
    if not return_cache:
        return _logits(cfg, params, x), extras, None
    return _logits(cfg, params, x), extras, Cache(xlstm=XLSTMState(
        layers=tuple(states), pos=(cache.xlstm.pos + S).to(torch.int32)))


def verify(cfg, params, cache: Cache, tree_tokens, *, paths, node_path,
           node_depth):
    """Tree verify: every layer per tree path with its state replicated.
    Returns (logits (B,W,V), extras for ``commit``): ``depth_states`` (per
    layer, each leaf (D, B*P, ...): the states after each depth), ``P``,
    ``B`` and ``hidden``."""
    x = params["embed"][tree_tokens.long()]
    B = x.shape[0]
    P = paths.shape[0]
    depth_states = []
    for lp, kind, st in zip(params["layers"], cfg.blocks(),
                            cache.xlstm.layers):
        if kind == SLSTM:
            def step_fn(x_t, s, slot, _p=lp["block"]):
                return xl.slstm_step(cfg, _p, x_t, s)
        else:                   # the matrix memory goes into its slot
            def step_fn(x_t, s, slot, _p=lp["block"]):
                return xl.mlstm_step(cfg, _p, x_t, s, out=slot)

        y_nodes, sts = rv.path_verify(
            step_fn, cm.rmsnorm(x, lp["ln"], cfg.rmsnorm_eps), st, paths,
            node_path, node_depth)
        x = x + y_nodes
        depth_states.append(sts)
    return _logits(cfg, params, x), {"depth_states": tuple(depth_states),
                                     "P": P, "B": B, "hidden": x}


def decode(cfg, params, cache: Cache, tokens):
    """1-token decode via the W=1 tree."""
    B = tokens.shape[0]
    dev = tokens.device

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int64, device=dev)

    logits, extras = verify(cfg, params, cache, tokens, paths=zeros(1, 1),
                            node_path=zeros(1), node_depth=zeros(1))
    cache = commit(cfg, cache, extras, accept_nodes=zeros(B, 1),
                   n_accept=torch.ones((B,), dtype=torch.int64, device=dev),
                   path_idx=zeros(B), max_depth=1)
    return logits, cache


def commit(cfg, cache: Cache, extras, accept_nodes, n_accept, path_idx,
           max_depth):
    """Each row's state after ``n_accept`` tokens along path ``path_idx``
    (both (B,)).  n_accept == 0 (a frozen row) commits nothing: the row
    keeps its previous state."""
    B, P = extras["B"], extras["P"]
    keep = n_accept > 0

    def freeze(new, old):
        return torch.where(keep.reshape((B,) + (1,) * (new.dim() - 1)),
                           new, old)

    layers = tuple(
        {k: freeze(v, old[k]) for k, v in rv.select_committed_state(
            sts, path_idx, n_accept, B, P).items()}
        for sts, old in zip(extras["depth_states"], cache.xlstm.layers))
    return dataclasses.replace(cache, xlstm=XLSTMState(
        layers=layers, pos=(cache.xlstm.pos + n_accept).to(torch.int32)))
