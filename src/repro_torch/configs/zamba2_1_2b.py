"""zamba2-1.2b [hybrid]: 38L d_model=2048 32H d_ff=8192 vocab=32000,
ssm_state=64 — Mamba2 backbone + ONE shared attention+MLP block (shared
weights) applied every 6 layers, each application with its own KV cache.
Sub-quadratic (Mamba2 state + O(L)-per-token attention decode) -> runs
long_500k. [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

ARCH_ID = "zamba2-1.2b"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        block_pattern=("mamba2",) * 38,
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
        shared_block="dense", shared_period=6,
        rope_theta=1e4, act_impl=act_impl, sub_quadratic=True,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512,
        block_pattern=("mamba2",) * 4,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk=16),
        shared_block="dense", shared_period=2,
        rope_theta=1e4, act_impl=act_impl, sub_quadratic=True, dtype="float32",
    )
