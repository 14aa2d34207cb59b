"""Model configuration system.

One ``ModelConfig`` dataclass covers every architecture family in the
assigned pool (dense / MoE / SSM / hybrid / enc-dec / VLM / audio).  Each
``src/repro_torch/configs/<arch>.py`` exports ``CONFIG`` (the exact assigned full
config) built from this dataclass; ``ModelConfig.reduced()`` derives the
CPU-runnable smoke variant (<=2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


# Block kinds for heterogeneous stacks (hybrid / xLSTM).
ATTN = "attn"
MAMBA2 = "mamba2"
SLSTM = "slstm"
MLSTM = "mlstm"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # --- identity -----------------------------------------------------
    name: str
    arch_type: str                      # dense | moe | hybrid | ssm | vlm | audio
    source: str = ""                    # citation (hf:... / arXiv:...)

    # --- transformer core ----------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None      # defaults to d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    qk_norm: bool = False               # RMSNorm on per-head q/k (qwen3)
    qkv_bias: bool = False              # linear bias on qkv (qwen2)
    rope_theta: float = 10000.0
    rmsnorm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE -------------------------------------------------------------
    num_experts: int = 0                # 0 => dense MLP
    experts_per_token: int = 0          # top-k
    router_aux_coef: float = 0.01       # load-balance loss coefficient

    # --- SSM / hybrid ------------------------------------------------------
    ssm_state: int = 0                  # Mamba2 state dim N
    ssm_expand: int = 2                 # Mamba2 expansion factor
    ssm_conv: int = 4                   # depthwise conv width
    ssm_heads: int = 0                  # Mamba2 heads (derived if 0)
    # Per-layer block kinds; None => all-attention dense stack.
    block_pattern: Optional[Tuple[str, ...]] = None
    shared_attention_every: int = 0     # zamba2: one shared attn block reused
                                        # every k layers (0 = off)

    # --- encoder-decoder (audio) -----------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq_len: int = 0            # fixed encoder memory length (frames)

    # --- modality frontend stub (the one allowed carve-out) --------------
    frontend: Optional[str] = None      # "vision" | "audio" | None
    num_frontend_tokens: int = 0        # patch/frame embeddings per sample

    # --- long-context ------------------------------------------------------
    sliding_window: int = 0             # 0 = full attention; >0 = window size
                                        # used for the long_500k decode shape

    # --- speculative decoding (Ghidorah) ----------------------------------
    medusa_heads: int = 4               # number of drafting heads
    medusa_top_k: int = 10              # candidates kept per head

    # --- distribution -------------------------------------------------------
    fsdp: bool = False                  # additionally shard weights on "data"
    remat: bool = False                 # activation checkpointing in training
    unroll_layers: bool = False         # python-loop layers instead of scan
                                        # (dry-run cost-correction lowers)
    mlstm_chunked: bool = True          # chunked-parallel mLSTM prefill
                                        # (False = per-step scan baseline;
                                        # EXPERIMENTS §Perf hillclimb B)
    mamba_chunked: bool = True          # chunked SSD Mamba2 prefill
                                        # (False = time-scan baseline;
                                        # EXPERIMENTS §Perf iteration F)

    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_heads % max(self.num_kv_heads, 1) == 0, (
            f"{self.name}: heads {self.num_heads} not divisible by kv {self.num_kv_heads}")
        if self.num_experts:
            assert 0 < self.experts_per_token <= self.num_experts

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up so lm_head/embed column-shard evenly (multiple of
        4096 for full-size configs, 128 for smoke configs)."""
        mult = 128 if self.vocab_size < 4096 else 4096
        return ((self.vocab_size + mult - 1) // mult) * mult

    @property
    def is_recurrent(self) -> bool:
        """True if any block carries recurrent (non-KV-cache) state."""
        if self.block_pattern is None:
            return False
        return any(k in (MAMBA2, SLSTM, MLSTM) for k in self.block_pattern)

    @property
    def is_pure_recurrent(self) -> bool:
        if self.block_pattern is None:
            return False
        return all(k in (MAMBA2, SLSTM, MLSTM) for k in self.block_pattern)

    @property
    def supports_long_context(self) -> bool:
        """long_500k eligibility: recurrent state or sliding-window attention."""
        return self.is_pure_recurrent or self.sliding_window > 0 or (
            self.is_recurrent and self.sliding_window > 0)

    def blocks(self) -> Tuple[str, ...]:
        if self.block_pattern is not None:
            return self.block_pattern
        return tuple([ATTN] * self.num_layers)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS=6ND)."""
        d, hd = self.d_model, self.head_dim
        n = 0
        n += self.vocab_size * d                      # embed
        if not self.tie_embeddings:
            n += self.vocab_size * d                  # lm head
        for kind in self.blocks():
            if kind == ATTN:
                if self.shared_attention_every:
                    continue  # counted once below
                n += self._attn_params()
                n += self._mlp_params()
            elif kind == MAMBA2:
                # Mamba2 blocks are standalone (no per-block MLP); d_ff belongs
                # to the shared attention block in hybrid stacks (zamba2).
                n += self._mamba_params()
            elif kind in (SLSTM, MLSTM):
                n += self._xlstm_params(kind)
            n += 2 * d                                 # norms
        if self.shared_attention_every:
            n += self._attn_params() + self._mlp_params()
        if self.is_encoder_decoder:
            # encoder layers: self-attn + mlp; decoder additionally cross-attn
            enc = self.num_encoder_layers * (self._attn_params() + self._mlp_params() + 2 * self.d_model)
            cross = self.num_layers * self._attn_params()
            n += enc + cross
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        b = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + b

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.num_experts:
            # gated MLP per expert + router
            return self.num_experts * 3 * d * self.d_ff + d * self.num_experts
        return 3 * d * self.d_ff                       # SwiGLU: gate, up, down

    def _mamba_params(self) -> int:
        d = self.d_model
        di = self.ssm_expand * d
        nh = self.ssm_heads or max(di // 64, 1)
        # in_proj -> [z, x, B, C, dt], conv, A, D, norm, out_proj
        in_p = d * (2 * di + 2 * self.ssm_state + nh)
        conv = self.ssm_conv * (di + 2 * self.ssm_state)
        return in_p + conv + 2 * nh + di + di * d

    def _xlstm_params(self, kind: str) -> int:
        d = self.d_model
        if kind == MLSTM:
            di = 2 * d
            return d * 2 * di + 3 * di * (di // max(self.num_heads, 1)) + di * d + 2 * di
        # sLSTM: 4 gates recurrent + input
        return 8 * d * d + 4 * d + 2 * d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k experts only)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        moe_total = len([k for k in self.blocks() if k == ATTN]) * self.num_experts * 3 * self.d_model * self.d_ff
        moe_active = len([k for k in self.blocks() if k == ATTN]) * self.experts_per_token * 3 * self.d_model * self.d_ff
        return full - moe_total + moe_active

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims (2 layers, d<=512, <=4 experts)."""
        pattern = None
        if self.block_pattern is not None:
            # keep the family's block mix, truncated to 2 layers
            uniq = []
            for k in self.block_pattern:
                if k not in uniq:
                    uniq.append(k)
            pattern = tuple((uniq * 2)[:2])
        kv = min(self.num_kv_heads, 2)
        heads = 4 if 4 % max(kv, 1) == 0 else kv * 2
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=2,
            d_model=256,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=64,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=0,
            block_pattern=pattern,
            shared_attention_every=2 if self.shared_attention_every else 0,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq_len=16 if self.is_encoder_decoder else 0,
            num_frontend_tokens=16 if self.frontend else 0,
            sliding_window=64 if self.sliding_window else 0,
            medusa_heads=4,
            medusa_top_k=4,
            fsdp=False,
            remat=False,
            dtype="float32",
        )


# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k":    InputShape("train_4k",    4_096,   256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768,   32, "prefill"),
    "decode_32k":  InputShape("decode_32k",  32_768,  128, "decode"),
    "long_500k":   InputShape("long_500k",  524_288,    1, "decode"),
}
