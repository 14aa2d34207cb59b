"""xLSTM-125M [ssm] — sLSTM + mLSTM blocks (7:1-style mix). [arXiv:2405.04517]"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig

# sLSTM at positions 3 and 9 (paper's sparse placement), mLSTM elsewhere.
_PATTERN = tuple(SLSTM if i in (3, 9) else MLSTM for i in range(12))

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    source="arXiv:2405.04517",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,                        # xLSTM blocks embed their own projections
    vocab_size=50304,
    block_pattern=_PATTERN,
)
