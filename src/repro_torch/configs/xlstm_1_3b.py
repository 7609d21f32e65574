"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks at the xLSTM[7:1] ratio (every 8th layer is sLSTM). Sub-quadratic:
O(1) recurrent state -> runs long_500k. [arXiv:2405.04517]

This arch is the paper technique's richest habitat: all mLSTM forget gates,
sLSTM input/forget/output gates, and the block output gates are sigmoids
evaluated by the MR-HRC CORDIC pipeline when act_impl=cordic_*.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

ARCH_ID = "xlstm-1.3b"


def _pattern(n_layers: int, period: int = 8):
    return tuple("slstm" if (i + 1) % period == 0 else "mlstm"
                 for i in range(n_layers))


def full(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        block_pattern=_pattern(48),
        xlstm=XLSTMConfig(proj_factor=2.0, d_conv=4, chunk=256),
        act_impl=act_impl, sub_quadratic=True,
    )


def smoke(act_impl: str = "cordic_fixed") -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
        d_ff=0, vocab_size=512,
        block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
        xlstm=XLSTMConfig(proj_factor=2.0, d_conv=4, chunk=16),
        act_impl=act_impl, sub_quadratic=True, dtype="float32",
    )
