"""SwiGLU MLP (counterpart of ``repro/models/mlp.py``; the MoE half comes
with ROADMAP A11)."""
from __future__ import annotations

import torch

from repro_torch.models import common as cm


def mlp_init(cfg, gen):
    d, f = cfg.d_model, cfg.d_ff
    dt = getattr(torch, cfg.dtype)
    return {
        "w_gate": cm.dense_init(gen, d, f, dt),
        "w_up": cm.dense_init(gen, d, f, dt),
        "w_down": cm.dense_init(gen, f, d, dt),
    }


def mlp_apply(cfg, p, x):
    return cm.swiglu(x, p["w_gate"], p["w_up"], p["w_down"])
