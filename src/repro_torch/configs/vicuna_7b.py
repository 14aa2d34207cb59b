"""Vicuna-7B [dense] — the paper's evaluation model (LLaMA-7B architecture,
Medusa 5-head version). [hf:lmsys/vicuna-7b-v1.3 / arXiv:2302.13971]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="vicuna-7b",
    arch_type="dense",
    source="hf:lmsys/vicuna-7b-v1.3",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    rope_theta=10000.0,
    sliding_window=8192,
    medusa_heads=5,               # Medusa offers a 5-head Vicuna-7B (paper §IV-A)
)
