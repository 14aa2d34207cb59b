"""Zamba2-7B [hybrid] — Mamba2 backbone + shared attention block. [arXiv:2411.15242]"""
from repro_torch.configs.base import MAMBA2, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    arch_type="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,                     # MLP of the shared attention block
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_conv=4,
    block_pattern=tuple([MAMBA2] * 81),
    shared_attention_every=6,       # one weight-shared attn block every 6 layers
    sliding_window=8192,            # shared-attn blocks windowed for long_500k
)
