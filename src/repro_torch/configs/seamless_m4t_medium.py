"""SeamlessM4T-medium [audio] — enc-dec; mel+conv frontend STUBBED
(input_specs provides frame embeddings for the encoder). [arXiv:2308.11596]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    source="arXiv:2308.11596",
    num_layers=12,                 # decoder layers
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    is_encoder_decoder=True,
    num_encoder_layers=12,
    encoder_seq_len=4096,          # stubbed audio-frame embeddings
    frontend="audio",
    num_frontend_tokens=4096,
    sliding_window=8192,           # decoder self-attn window for long_500k
)
