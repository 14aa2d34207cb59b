"""LLaVA-NeXT-Mistral-7B [vlm] — anyres tiling; vision tower STUBBED
(input_specs provides pre-projected patch embeddings). [hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    arch_type="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1_000_000.0,
    sliding_window=4096,            # Mistral's native sliding window
    frontend="vision",
    # anyres: base 576 patches + 4 tiles x 576 = 2880 image tokens
    num_frontend_tokens=2880,
)
