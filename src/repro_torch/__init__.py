"""PyTorch/CUDA port of the Ghidorah serving stack (``src/repro`` is the
JAX reference it is held against).

The package mirrors the reference's module layout.  It imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``.  Verify and decode
attention run through the hand-written CUDA kernel in
``kernels/csrc/verify_attention.cu`` on a CUDA tensor and through its
plain PyTorch version on a CPU tensor.
"""
