"""AdamW over the port's param trees, nested dicts and tuples of tensors
(counterpart of ``repro/training/optimizer.py``).

The reference's exact rule, leaf by leaf: moments in float32; bias
corrections in float32 from the step count; ``delta = (m / bc1) /
(sqrt(v / bc2) + eps) + wd * p`` in float32, the decay reading the old
parameter; ``p <- (p_f32 - lr * delta).to(p.dtype)``, rounded once.
``torch.optim.AdamW`` is not that rule for a bf16 parameter: it applies
the decay and the step as two in-place bf16 roundings.

``adamw_update`` returns new tensors and a new state: the caller's trees
are never written.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass
class AdamWState:
    mu: dict             # float32 first moments, the params' structure
    nu: dict             # float32 second moments
    step: int            # updates applied so far


def adamw_init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(mu=tree_map(zeros, params),
                      nu=tree_map(zeros, params), step=0)


def _bias_correction(b, step):
    # float32 throughout, as the reference's 1 - b ** step.astype(f32)
    return float(np.float32(1.0) - np.float32(b) ** np.float32(step))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr=3e-4, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.01):
    """One AdamW step.  Returns ``(new_params, new_state)``."""
    step = state.step + 1
    bc1 = _bias_correction(b1, step)
    bc2 = _bias_correction(b2, step)

    def moment1(g, m):
        return b1 * m + (1 - b1) * g.float()

    def moment2(g, v):
        g = g.float()
        return b2 * v + (1 - b2) * (g * g)

    new_mu = tree_map(moment1, grads, state.mu)
    new_nu = tree_map(moment2, grads, state.nu)

    def upd(p, m, v):
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p32
        return (p32 - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, new_mu, new_nu)
    return new_params, AdamWState(mu=new_mu, nu=new_nu, step=step)
