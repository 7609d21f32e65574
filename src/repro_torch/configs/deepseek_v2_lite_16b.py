"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (kv=16) vocab=102400 —
MLA (kv_lora=512, qk_nope=128, qk_rope=64), layer 0 dense FFN (10944), layers
1..26 MoE with 2 shared + 64 routed experts (d_ff_expert=1408), top-6.

NOTE: the assignment line says both "MoE 64e top-6" and "2 shared+160
routed"; 160 routed is full DeepSeek-V2 (236B) — the *lite* model has 64
routed (DESIGN.md deviation 5). [arXiv:2405.04434]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-v2-lite-16b"


def full(act_impl: str = "cordic_fixed", router_score: str = "softmax") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, d_ff_dense=10944, vocab_size=102400,
        block_pattern=("mla_dense",) + ("mla_moe",) * 26,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared_experts=2, router_score=router_score),
        rope_theta=1e4, act_impl=act_impl, head_dim=128,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, d_ff_dense=96, vocab_size=512,
        block_pattern=("mla_dense", "mla_moe", "mla_moe"),
        mla=MLAConfig(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=32, num_shared_experts=1),
        rope_theta=1e4, act_impl=act_impl, head_dim=16, dtype="float32",
    )
