"""qwen2.5-32b [dense]: 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA with QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "qwen2.5-32b"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=27648, vocab_size=152064, qkv_bias=True,
        rope_theta=1e6, act_impl=act_impl,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, qkv_bias=True,
        rope_theta=1e4, act_impl=act_impl, dtype="float32",
    )
