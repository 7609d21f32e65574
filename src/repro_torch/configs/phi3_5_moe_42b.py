"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) vocab=32064,
16 experts top-2, d_ff_expert=6400. [hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=6400, vocab_size=32064,
        block_pattern=("gqa_moe",) * 32,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
        rope_theta=1e4, act_impl=act_impl,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=64, vocab_size=512,
        block_pattern=("gqa_moe",) * 2,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64),
        rope_theta=1e4, act_impl=act_impl, dtype="float32",
    )
