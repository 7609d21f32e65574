"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000 —
llama-arch GQA. [arXiv:2403.04652]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "yi-9b"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000, qkv_bias=False,
        rope_theta=1e4, act_impl=act_impl,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512, qkv_bias=False,
        rope_theta=1e4, act_impl=act_impl, dtype="float32",
    )
