"""Qwen3-32B [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    sliding_window=8192,   # beyond-paper long-context decode variant (long_500k)
    fsdp=True,             # 64 GB bf16 weights: shard on data axis too
)
