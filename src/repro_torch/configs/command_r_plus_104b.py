"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias. [hf:CohereForAI/c4ai-command-r*]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "command-r-plus-104b"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=64, d_model=12288, num_heads=96, num_kv_heads=8,
        d_ff=33792, vocab_size=256000, qkv_bias=False,
        rope_theta=1e6, act_impl=act_impl,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=96, num_heads=6, num_kv_heads=2,
        d_ff=192, vocab_size=512, qkv_bias=False,
        rope_theta=1e4, act_impl=act_impl, dtype="float32",
    )
