"""Architecture registry of the port: ``get_config(arch_id)`` /
``get_smoke(arch_id)`` over the ten archs of ``repro.configs``.

Dense GQA: ``yi-9b``, ``qwen2.5-32b`` (QKV bias), ``deepseek-coder-33b``
and ``command-r-plus-104b``; ``deepseek-v2-lite-16b`` (MLA attention, a
dense first layer, then GShard MoE layers); ``phi3.5-moe-42b-a6.6b`` (GQA
+ GShard MoE); the recurrent families ``xlstm-1.3b`` (mLSTM / sLSTM) and
``zamba2-1.2b`` (Mamba2 with a shared attention block), which serve on the
dense plane only; and the two ``input_mode="embeds"`` archs whose frontends
are stubs (models/frontends.py), ``musicgen-large`` (a GELU MLP, 32 MHA
heads) and ``internvl2-1b`` (a group of 7, vocab 151,655): the launchers
train and serve them on token inputs, as the JAX launchers do. The paper's
own activation configuration is ``configs/paper_sigmoid.py``.
"""
from __future__ import annotations

from repro_torch.configs import (command_r_plus_104b, deepseek_coder_33b,
                                 deepseek_v2_lite_16b, internvl2_1b,
                                 musicgen_large, phi3_5_moe_42b, qwen2_5_32b,
                                 xlstm_1_3b, yi_9b, zamba2_1_2b)
from repro_torch.configs.base import ModelConfig, SHAPES, ShapeConfig  # noqa: F401

_MODULES = {
    "yi-9b": yi_9b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "xlstm-1.3b": xlstm_1_3b,
    "zamba2-1.2b": zamba2_1_2b,
    "qwen2.5-32b": qwen2_5_32b,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "command-r-plus-104b": command_r_plus_104b,
    "musicgen-large": musicgen_large,
    "internvl2-1b": internvl2_1b,
}

ARCH_IDS = tuple(_MODULES.keys())


def get_config(arch_id: str, **kw) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id].full(**kw)


def get_smoke(arch_id: str, **kw) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _MODULES[arch_id].smoke(**kw)
