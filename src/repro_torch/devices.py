"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  A CUDA
request without a visible GPU raises: nothing falls back to the CPU
behind the caller's back.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' (--device cpu) to "
            "run the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
