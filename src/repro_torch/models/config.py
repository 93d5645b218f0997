"""Model configuration: a copy of the reference's ``repro.models.config``
(one frozen dataclass covers every family: dense / MoE / MLA-MoE / SSM /
hybrid / enc-dec / VLM), kept field for field so that a configuration
means the same model in both packages. The port runs the dense family
(``models.lm.LM``); the other families' fields wait for their modules.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense|moe|mla_moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 1e4
    rotary_pct: float = 1.0        # chatglm "2d" rope: 0.5
    window: int = 0                # sliding-window attention width; 0 = full
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu
    attn_impl: str = "xla"         # xla (chunked matmul) | flash (CUDA kernel)

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    first_k_dense: int = 0         # deepseek: first k layers use dense FFN
    moe_impl: str = "dense"        # dense (one-hot dispatch) | ragged
    capacity_factor: float = 1.25

    # MLA (deepseek)
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    mtp_depth: int = 0             # multi-token-prediction extra modules

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256           # SSD chunk length (intra-chunk tile)
    attn_every: int = 0            # hybrid: shared attn block every k layers

    # enc-dec (seamless)
    n_enc_layers: int = 0          # >0 -> encoder-decoder; n_layers = decoder

    # vlm
    n_patches: int = 0             # image patch embeddings prepended (stub)

    dtype: str = "bfloat16"
    remat: bool = True             # activation checkpointing per layer

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context (bounded per-token state)?"""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def _per_layer_mamba(self) -> int:
        d = self.d_model
        di = self.ssm_expand * d
        conv_dim = di + 2 * self.ssm_ngroups * self.ssm_state
        nh = di // self.ssm_headdim
        return (d * (2 * di + 2 * self.ssm_ngroups * self.ssm_state + nh)
                + conv_dim * self.ssm_conv + di * d)

    @property
    def param_count(self) -> int:
        """Approximate total parameter count (embeddings included)."""
        d, v = self.d_model, self.vocab
        n = 2 * d * v                               # embed + head
        ffn_mult = 3 if self.mlp == "swiglu" else 2
        per_layer_ffn = ffn_mult * d * self.d_ff

        if self.family == "ssm":
            return n + self.n_layers * self._per_layer_mamba()

        per_layer_attn = (d * self.n_heads * self.dh      # wq
                          + 2 * d * self.n_kv_heads * self.dh
                          + self.n_heads * self.dh * d)
        if self.mla:
            r_q, r_kv = self.q_lora_rank, self.kv_lora_rank
            h = self.n_heads
            per_layer_attn = (d * r_q + r_q * h * (self.qk_nope_dim + self.qk_rope_dim)
                              + d * (r_kv + self.qk_rope_dim)
                              + r_kv * h * (self.qk_nope_dim + self.v_head_dim)
                              + h * self.v_head_dim * d)

        if self.family == "hybrid":
            # mamba backbone + ONE shared attn+mlp block (tied weights)
            return (n + self.n_layers * self._per_layer_mamba()
                    + per_layer_attn + per_layer_ffn)
        if self.is_moe:
            per_expert = ffn_mult * d * self.d_expert
            shared = ffn_mult * d * self.d_expert * self.n_shared_experts
            router = d * self.n_experts
            moe_layers = self.n_layers - self.first_k_dense
            return (n + self.n_layers * per_layer_attn
                    + self.first_k_dense * per_layer_ffn
                    + moe_layers * (per_expert * self.n_experts + shared + router))
        total_layers = self.n_layers + self.n_enc_layers
        return n + total_layers * (per_layer_attn + per_layer_ffn)

    @property
    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k experts only)."""
        if not self.is_moe:
            return self.param_count
        d = self.d_model
        ffn_mult = 3 if self.mlp == "swiglu" else 2
        per_expert = ffn_mult * d * self.d_expert
        moe_layers = self.n_layers - self.first_k_dense
        inactive = moe_layers * per_expert * (self.n_experts - self.moe_top_k)
        return self.param_count - inactive
