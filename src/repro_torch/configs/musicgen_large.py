"""musicgen-large [audio]: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048
— decoder-only over EnCodec tokens, GELU MLP. The EnCodec frontend is a STUB:
input_specs() provides precomputed frame embeddings (B,S,d); the LM head
predicts a flattened single-codebook stream (vocab 2048 — DESIGN.md dev. 6).
[arXiv:2306.05284]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "musicgen-large"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048, mlp_kind="gelu",
        rope_theta=1e4, act_impl=act_impl, input_mode="embeds",
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=128, mlp_kind="gelu",
        rope_theta=1e4, act_impl=act_impl, input_mode="embeds", dtype="float32",
    )
