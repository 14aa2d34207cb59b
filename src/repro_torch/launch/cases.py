"""Dry-run case construction (counterpart of ``repro/launch/cases.py``):
(arch x input shape x TP mode x variant) -> a step function and its
arguments as DTensors on a device mesh.

Built under the caller's ``FakeTensorMode``: params, cache, optimizer
state and batch are fake tensors (shapes, dtypes and a device, no
memory), each rank's slice of them laid out by ``core/hcmp/sharding.py``.
Nothing is allocated and nothing launches; ``dryrun.py`` runs the step
once under its counters.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.core.hcmp import sharding as shd
from repro_torch.launch.mesh import data_axes
from repro_torch.models import hybrid, xlstm_model
from repro_torch.models.api import get_model
from repro_torch.runtime.cache import Cache, init_kv_cache
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train import train_step

VARIANTS = ("baseline", "last_logits", "verify16", "remat")


def decode_window(cfg, shape) -> int:
    """Sliding window is engaged only for the long-context decode shape."""
    if shape.seq_len > 32_768 and cfg.sliding_window:
        return cfg.sliding_window
    if cfg.name.startswith("llava"):
        return cfg.sliding_window          # Mistral's window is native
    return 0


def supports(cfg, shape) -> tuple[bool, str]:
    """long_500k requires sub-quadratic decode (window or recurrent state)."""
    if shape.name == "long_500k":
        if cfg.is_pure_recurrent or cfg.is_recurrent or cfg.sliding_window:
            return True, ""
        return False, "full-attention arch without sliding window"
    return True, ""


def shallow_clone(cfg, L: int, *, with_site: bool = False):
    """Full-width config with L unrolled layers (the reference's
    cost-correction clone; the port's dry run needs no correction, see
    ``dryrun.py``, and keeps it for configs cut in depth).

    ``with_site`` (hybrid): include exactly one shared-attention site."""
    kw = dict(num_layers=L, unroll_layers=True, remat=False)
    if cfg.block_pattern is not None:
        kw["block_pattern"] = tuple([cfg.block_pattern[0]] * L)
    if cfg.shared_attention_every:
        kw["shared_attention_every"] = L if with_site else L + 1
    if cfg.is_encoder_decoder:
        kw["num_encoder_layers"] = L
    return dataclasses.replace(cfg, **kw)


# --------------------------------------------------------------------------
def _batch(cfg, shape, device):
    B = shape.global_batch
    i32 = dict(dtype=torch.int32, device=device)
    dt = getattr(torch, cfg.dtype)
    prefix = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    if shape.kind == "train":
        S = shape.seq_len - prefix
        b = {"tokens": torch.zeros((B, S), **i32),
             "labels": torch.zeros((B, S), **i32)}
    elif shape.kind == "prefill":
        b = {"tokens": torch.zeros((B, shape.seq_len - prefix), **i32)}
    else:                                  # decode: one new token
        b = {"tokens": torch.zeros((B, 1), **i32)}
    if cfg.frontend == "vision" and shape.kind != "decode":
        b["patch_embeds"] = torch.zeros((B, cfg.num_frontend_tokens,
                                         cfg.d_model), dtype=dt,
                                        device=device)
    if cfg.frontend == "audio" and shape.kind != "decode":
        b["frame_embeds"] = torch.zeros((B, cfg.encoder_seq_len,
                                         cfg.d_model), dtype=dt,
                                        device=device)
    return b


def _cache(cfg, shape, device):
    B = shape.global_batch
    window = decode_window(cfg, shape)
    size = min(shape.seq_len, window) if window else shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encoder_decoder:
        kv = init_kv_cache(cfg.num_layers, B, size, cfg.num_kv_heads,
                           cfg.head_dim, window=window, dtype=dt,
                           device=device)
        shape5 = (cfg.num_layers, B, cfg.encoder_seq_len, cfg.num_kv_heads,
                  cfg.head_dim)
        return Cache(kv=kv, cross_k=torch.zeros(shape5, dtype=dt,
                                                device=device),
                     cross_v=torch.zeros(shape5, dtype=dt, device=device))
    if cfg.arch_type == "hybrid":
        return hybrid.init_cache(cfg, B, size, window=window, device=device)
    if cfg.arch_type == "ssm":
        return xlstm_model.init_cache(cfg, B, device=device)
    return Cache(kv=init_kv_cache(cfg.num_layers, B, size, cfg.num_kv_heads,
                                  cfg.head_dim, window=window, dtype=dt,
                                  device=device))


def _verify_tree(cfg, device):
    """The W=16 tree of the ``verify16`` variant: the reference's
    ``build_tree(default_accs(heads, top_k), 16)``."""
    from repro_torch.core.speculative import tree as T
    spec = T.build_tree(T.default_accs(cfg.medusa_heads, cfg.medusa_top_k),
                        16)
    return T.Tree.from_spec(spec, device=device)


def build_case(arch: str, shape_name: str, mesh, *, mode: str = "hcmp",
               cfg_override=None, variant: str = "baseline",
               device="cuda"):
    """Returns dict(cfg, label, step, args).  Call it under a
    ``FakeTensorMode``: ``args`` are DTensors of fake local tensors.

    variants:
      baseline     train_step / full-logits prefill / 1-token decode
      last_logits  prefill computing only the final position's logits
                   (serving semantics)
      verify16     Ghidorah W=16 tree-verification step instead of the
                   sequential decode step (the paper's technique at
                   cluster scale)
      remat        train_step with activation checkpointing
    """
    if variant not in VARIANTS:
        raise ValueError(f"variant is one of {VARIANTS}, got {variant!r}")
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    if variant == "remat":
        cfg = dataclasses.replace(cfg, remat=True)
    shape = INPUT_SHAPES[shape_name]
    ok, why = supports(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} x {shape_name} unsupported: {why}")
    model = get_model(cfg)
    dp = data_axes(mesh)

    gen = torch.Generator(device=device).manual_seed(0)
    params = shd.distribute_params(cfg, model.init_params(gen), mode,
                                   mesh=mesh)
    batch = shd.distribute_batch(_batch(cfg, shape, device), dp, mesh=mesh)
    label = f"{arch}/{shape_name}/{mode}"

    if shape.kind == "train":
        def step(params, opt_state, batch):
            return train_step(cfg, model, params, opt_state, batch)

        return {"cfg": cfg, "label": label, "step": step,
                "args": (params, adamw_init(params), batch)}

    if shape.kind == "prefill":
        window = cfg.sliding_window if cfg.name.startswith("llava") else 0
        last = variant == "last_logits"

        def step(params, batch):
            return model.prefill(params, batch, max_len=shape.seq_len,
                                 window=window, last_logits=last)

        return {"cfg": cfg, "label": f"{label}/{variant}", "step": step,
                "args": (params, batch)}

    # decode
    cache = shd.distribute_cache(cfg, _cache(cfg, shape, device), mesh=mesh,
                                 batch_axes=dp)

    if variant == "verify16":
        tree = _verify_tree(cfg, device)
        batch = {"tokens": torch.zeros((shape.global_batch, 16),
                                       dtype=torch.int32, device=device)}
        batch = shd.distribute_batch(batch, dp, mesh=mesh)

        def step(params, cache, batch):
            return model.verify(params, cache, batch["tokens"], tree)
    else:
        def step(params, cache, batch):
            return model.decode(params, cache, batch["tokens"])

    return {"cfg": cfg, "label": f"{label}/{variant}", "step": step,
            "args": (params, cache, batch)}
