"""Model/shape configuration system.

`ModelConfig` covers every assigned architecture family (dense GQA, MLA+MoE,
GQA+MoE, Mamba2 hybrid, xLSTM, audio/VLM backbones with stub frontends).
`block_pattern` drives the generic decoder in models/transformer.py: a tuple
with one entry per layer naming the block builder; runs of equal entries are
stacked and executed with lax.scan (O(1) HLO size for 64-layer configs).

`ShapeConfig` encodes the assigned input shapes (train_4k / prefill_32k /
decode_32k / long_500k) and which step function they lower (train vs serve).

In this PyTorch port, ``act_impl="cordic_pallas"``, ``softmax_impl=
"cordic_pallas"`` and ``paged_attend_impl="pallas"`` select the hand-written
CUDA kernels of ``repro_torch.kernels`` (the values keep their JAX names).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    router_score: str = "softmax"       # "softmax" | "sigmoid" (V3-style)
    normalize_gates: bool = True
    aux_loss_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0            # mLSTM up-projection factor
    ffn_factor: float = 4.0 / 3.0 * 2   # sLSTM post-FFN factor
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense|ssm|hybrid|moe|audio|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = ()  # len == num_layers (+ shared apps)
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    mlp_kind: str = "swiglu"             # swiglu | gelu
    d_ff_dense: int = 0                  # dense-FFN width in MoE archs (0 -> d_ff)
    act_impl: str = "cordic_fixed"       # exact|cordic_float|cordic_fixed|cordic_pallas
    softmax_impl: str = "exact"          # exact | cordic_fixed | cordic_pallas:
                                         # attention-row softmax via the fused
                                         # CORDIC-exp + LVC-normalize kernel
    loss_impl: str = "exact"             # exact | cordic | cordic_pallas:
                                         # cross-entropy log-softmax via the
                                         # CORDIC exp + hyperbolic-vectoring
                                         # log legs (train/losses.py); the
                                         # backward pass is always the
                                         # analytic softmax - onehot form
    attn_chunk: int = 1024
    kv_impl: str = "dense"               # dense | paged: decode KV layout —
                                         # one max_len buffer per slot vs a
                                         # global block pool + per-slot block
                                         # tables (serve/kv_pager.py); decode
                                         # output is bit-identical either way
    kv_block_len: int = 16               # positions per KV block (paged) and
                                         # the prefill-bucket granularity
    paged_attend_impl: str = "gather"    # gather | pallas: how a paged decode
                                         # attends — full-table gather (dense-
                                         # shaped transient, provably bit-
                                         # identical) vs the block-walking
                                         # Pallas kernel (O(block_len) VMEM
                                         # transient per step, token-identical;
                                         # kernels/paged_attention.py)
    kv_quant: str = "none"               # none | int8 | q2_14: paged-pool
                                         # storage format (core/kv_quant.py) —
                                         # K/V quantized at pool-write time
                                         # against per-block-per-head amax
                                         # scales, dequantized at every read
                                         # (gather attend and inside the
                                         # Pallas kernel's per-chunk VMEM
                                         # step) via the CORDIC linear-
                                         # rotation multiply. Requires
                                         # kv_impl="paged"; GQA only
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    input_mode: str = "tokens"           # tokens | embeds (stub frontends)
    remat: str = "none"                  # none | full | dots (per-layer ckpt)
    score_dtype: str = "f32"             # f32 (cast) | bf16_mxu (f32 accum)
    kv_shard: str = "auto"               # auto | seq_model (flash-decode SP)
    pad_heads_to: int = 0                # pad H/KH up to a multiple (0=off);
                                         # makes awkward head counts TP-shardable
                                         # exactly (padded wo rows are zero)
    slstm_state: str = "auto"            # auto | replicated: pin the sLSTM
                                         # recurrent state off the model axis
                                         # (kills per-timestep TP collectives)
    sub_quadratic: bool = False          # eligible for long_500k
    dtype: str = "bfloat16"
    # zamba2-style shared block: applied after layers i with i% period == offset
    shared_block: Optional[str] = None   # e.g. "dense" (attn+mlp, shared weights)
    shared_period: int = 6

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.d_ff_dense == 0:
            object.__setattr__(self, "d_ff_dense", self.d_ff)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", ("dense",) * self.num_layers)
        assert len(self.block_pattern) == self.num_layers

    # ---- parameter counting (roofline MODEL_FLOPS) -------------------------
    def param_counts(self) -> dict:
        """Returns dict(total=..., active=...) parameter counts (no embeds
        double count; active = per-token touched params for MoE)."""
        d, hd = self.d_model, self.head_dim
        H, KH = self.num_heads, self.num_kv_heads
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        active = emb
        for blk in self.block_pattern:
            t, a = self._block_params(blk)
            total += t
            active += a
        if self.shared_block is not None:
            t, a = self._block_params(self.shared_block)
            total += t
            n_apps = sum(1 for i in range(self.num_layers)
                         if (i + 1) % self.shared_period == 0)
            active += a * max(n_apps - 1, 0)  # reused weights, extra compute
        return dict(total=total, active=active)

    def _block_params(self, blk: str):
        d, hd = self.d_model, self.head_dim
        H, KH = self.num_heads, self.num_kv_heads
        attn = d * hd * (H + 2 * KH) + H * hd * d
        mlp = 3 * d * self.d_ff if self.mlp_kind == "swiglu" else 2 * d * self.d_ff
        if blk == "dense":
            return attn + mlp, attn + mlp
        if blk == "mla_dense" or blk == "mla_moe":
            m = self.mla
            a = (d * H * (m.qk_nope_dim + m.qk_rope_dim)
                 + d * (m.kv_lora_rank + m.qk_rope_dim)
                 + m.kv_lora_rank * H * (m.qk_nope_dim + m.v_dim)
                 + H * m.v_dim * d)
            if blk == "mla_dense":
                md = 3 * d * self.d_ff_dense
                return a + md, a + md
            e = self.moe
            routed = 3 * d * e.d_ff_expert
            shared = 3 * d * e.d_ff_expert * e.num_shared_experts
            tot = a + routed * e.num_experts + shared + d * e.num_experts
            act = a + routed * e.top_k + shared + d * e.num_experts
            return tot, act
        if blk == "gqa_moe":
            e = self.moe
            routed = 3 * d * e.d_ff_expert
            tot = attn + routed * e.num_experts + d * e.num_experts
            act = attn + routed * e.top_k + d * e.num_experts
            return tot, act
        if blk == "mamba2":
            s = self.ssm
            di = s.expand * d
            nh = di // s.head_dim
            conv_dim = di + 2 * s.n_groups * s.d_state
            p = (d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                 + s.d_conv * conv_dim + conv_dim + 3 * nh + di + di * d)
            return p, p
        if blk == "mlstm":
            x = self.xlstm
            di = int(d * x.proj_factor)
            p = (d * 2 * di + x.d_conv * di + di + 3 * di * di
                 + di * 2 * H + 2 * H + di + di * d)
            return p, p
        if blk == "slstm":
            x = self.xlstm
            dff = int(d * x.ffn_factor)
            dh = d // H
            p = d * 4 * d + 4 * d + 4 * H * dh * dh + d + 3 * d * dff
            return p, p
        raise ValueError(blk)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Per-spec skip rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{cfg.name} is a full-attention arch (skip per spec)")
    return True, ""
