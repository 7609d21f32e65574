"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT + InternLM2 backbone; the InternViT patch frontend
is a STUB (input_specs provides precomputed patch+text embeddings).
[arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig

ARCH_ID = "internvl2-1b"


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
        d_ff=4864, vocab_size=151655,
        rope_theta=1e6, act_impl=act_impl, input_mode="embeds",
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        num_layers=2, d_model=56, num_heads=7, num_kv_heads=1,
        d_ff=112, vocab_size=512,
        rope_theta=1e4, act_impl=act_impl, input_mode="embeds", dtype="float32",
    )
