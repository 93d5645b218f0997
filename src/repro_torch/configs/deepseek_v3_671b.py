"""deepseek-v3-671b [arXiv:2412.19437; hf] — MLA + 256-expert MoE + MTP.

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280; 1 shared + 256
routed experts, top-8; first 3 layers dense (d_ff 18432); MLA with
q_lora 1536 / kv_lora 512 / qk_nope 128 / qk_rope 64 / v_head 128;
depth-1 multi-token prediction. MLA is still full quadratic attention ->
long_500k SKIPPED. Router here is softmax top-k (the paper's
sigmoid+bias noaux variant is a scoring change, not a dataflow change —
recorded in DESIGN.md §Arch-applicability).
"""
from ..models.config import ModelConfig


def full():
    return ModelConfig(
        name="deepseek-v3-671b", family="mla_moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=18432, vocab=129280,
        n_experts=256, moe_top_k=8, d_expert=2048, n_shared_experts=1,
        first_k_dense=3, mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, mtp_depth=1,
        rope_theta=1e4)


def smoke():
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="mla_moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, n_experts=8, moe_top_k=2, d_expert=48,
        n_shared_experts=1, first_k_dense=1, mla=True, q_lora_rank=32,
        kv_lora_rank=16, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        mtp_depth=1, dtype="float32", remat=False)
