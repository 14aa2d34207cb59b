"""Public kernel entry points with the model-side signatures (counterpart
of ``repro/kernels/ops.py``): they turn ``pos``/``tree_depth``/``window``
into the kernel's per-query ``q_pos``/``lo`` rows and call the wrapper,
which runs the plain version for CPU tensors and the CUDA kernel for CUDA
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.verify_attention import verify_attention


def tree_attention(q, ck, cv, k_new, v_new, key_pos, pos, tree_depth,
                   tree_mask, *, window=0):
    """``pos`` is an int or (B,) and ``key_pos`` (S,) or (B, S): sequences
    sit at different absolute positions once batched speculative commits
    diverge, so the kernel takes per-batch ``q_pos``/``lo`` rows."""
    B, S = q.shape[0], ck.shape[1]
    pos_b = torch.broadcast_to(
        torch.as_tensor(pos, dtype=torch.int32, device=q.device), (B,))
    key_pos_b = torch.broadcast_to(key_pos, (B, S)).contiguous()
    q_pos = (pos_b[:, None] + tree_depth[None, :]).to(torch.int32)   # (B, W)
    if window:
        lo = q_pos - window
    else:
        lo = torch.full_like(q_pos, -1)
    return verify_attention(q, ck, cv, k_new, v_new, key_pos_b, q_pos, lo,
                            tree_mask)


def decode_attention(q, ck, cv, k_new, v_new, key_pos, pos, *, window=0):
    """Plain decode = W=1 tree."""
    dev = q.device
    return tree_attention(q, ck, cv, k_new, v_new, key_pos, pos,
                          torch.zeros((1,), dtype=torch.int32, device=dev),
                          torch.ones((1, 1), dtype=torch.bool, device=dev),
                          window=window)
