"""deepseek-coder-33b [dense]: 62L d_model=7168 56H (GQA kv=8) d_ff=19200
vocab=32256 — llama-arch. [arXiv:2401.14196]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "deepseek-coder-33b"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=62, d_model=7168, num_heads=56, num_kv_heads=8,
        d_ff=19200, vocab_size=32256, qkv_bias=False,
        rope_theta=1e5, act_impl=act_impl,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=160, vocab_size=512, qkv_bias=False,
        rope_theta=1e4, act_impl=act_impl, dtype="float32",
    )
