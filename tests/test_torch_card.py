"""The port's CUDA kernels on the card (marked ``gpu``; each test skips
without a GPU).  Imports no JAX, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_card.py
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402

from repro_torch.kernels.verify_attention import verify_attention  # noqa: E402


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")


@pytest.mark.gpu
def test_verify_attention_matches_plain_on_card():
    """The reference's kernel sweep and the main path's shapes, at fp32
    2e-5 / bf16 2e-2, each call one kernel launch."""
    _need_gpu()
    n = verify_attention.launches
    worst = chip_smoke.phase_kernel_check(torch, np)
    assert verify_attention.launches == n + len(chip_smoke.CASES) + 2
    assert worst < 2e-2


@pytest.mark.gpu
def test_cuda_call_launches_or_raises():
    """No fallback: a CUDA operand the kernel does not take raises; it
    never runs the plain version."""
    _need_gpu()
    args = chip_smoke.attention_inputs(torch, np, 1, 4, 4, 2, 32, 24, 20, 0,
                                       "float32", seed=0)
    bad = [args[0].double()] + list(args[1:])
    n = verify_attention.launches
    with pytest.raises(TypeError):
        verify_attention(*bad)
    assert verify_attention.launches == n
