"""Weight bridge: the reference's params as the port's tensors.

The reference keeps params as nested dicts (the xLSTM stack: a tuple of
per-layer dicts) with per-layer stacks on a leading L axis and the ``x @
W`` layout (``repro/models/transformer.py`` ``init_params``,
``repro/core/speculative/medusa.py`` ``init_medusa``).  The port keeps the
same structure and layout, so the bridge is a leaf-by-leaf copy.  It takes numpy arrays (the caller converts the JAX arrays; this
module imports no JAX) and never draws random numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.devices import resolve_device
from repro_torch.tree import tree_map


def _tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bfloat16: reinterpret the 16-bit payload
        t = torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    cast = dtype is not None and t.is_floating_point()
    return t.to(device=device, dtype=dtype if cast else t.dtype)


def _convert(tree, device, dtype):
    return tree_map(lambda a: _tensor(a, device, dtype), tree)


def params_from_jax(cfg, tree, device="cuda", dtype=None):
    """Model params (nested dicts and tuples of numpy arrays) -> the
    port's params.
    Every leaf keeps its dtype (the MoE router and the Mamba2 ``A_log``,
    ``D`` and ``dt_bias`` are float32 in every config) unless ``dtype``
    casts all floating leaves."""
    return _convert(tree, resolve_device(device), dtype)


def heads_from_jax(cfg, tree, device="cuda", dtype=None):
    """Medusa heads ({"w": (H,d,d), "out": (H,d,Vp)}) -> the port's heads,
    each leaf in its dtype unless ``dtype`` casts them."""
    return _convert(tree, resolve_device(device), dtype)
