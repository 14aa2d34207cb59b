"""Sampling utilities (greedy is the paper's acceptance rule)."""
from __future__ import annotations

import torch


def greedy(logits):
    """First maximal index, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1)
