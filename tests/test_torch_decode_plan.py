"""The host side of the paged decode kernels (``gqa_decode``, ``mla_decode``):
the launch plan the wrappers derive from the static shapes alone (grids,
chunking, workspace, shared memory) and the checks they make before a
launch. The kernels themselves run only on the card (chip_smoke.py holds
them against the plain versions); on the CPU the wrappers take the plain
versions, so the launch-time checks are reached here through tensors on the
``meta`` device, which are not on the CPU and never reach a kernel.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as PA  # noqa: E402

#: (B, KH, G, hd, L, M) / (B, H, R, P, L, M): Yi-9B's and DeepSeek-V2-Lite's
#: decode at the launcher's max_len 128 and at max_len 4096, and M = 1
GQA = {"launcher": (4, 4, 8, 128, 16, 8), "long": (4, 4, 8, 128, 16, 256),
       "one_column": (4, 4, 8, 128, 16, 1)}
MLA = {"launcher": (4, 16, 512, 64, 16, 8), "long": (4, 16, 512, 64, 16, 256),
       "one_column": (4, 16, 512, 64, 16, 1)}


@pytest.mark.parametrize("shape", sorted(GQA))
def test_gqa_plan_grids_and_workspace(shape):
    B, KH, G, hd, L, M = GQA[shape]
    plan = PA.gqa_plan(B, KH, G, hd, L, M)
    chunk = {"launcher": 1, "long": 4, "one_column": 1}[shape]
    assert plan.chunk == chunk
    blocks = (math.ceil(M / chunk), KH, B)
    assert plan.score_grid == plan.pv_grid == blocks
    assert plan.softmax_grid == plan.fold_grid == (KH * G, B, 1)
    rows = B * KH * G
    assert plan.workspace_floats == rows * (3 * M * L + M + 1 + M * hd)
    assert plan.softmax_tile == M                # the whole row staged once
    assert plan.smem[1] == 4 * (M * L + 3 * M)
    assert max(plan.smem) <= 48 * 1024          # no opt-in shared memory
    if shape != "one_column":
        # more than the old (slot, kv-head) grid's 16 CTAs in every phase
        assert min(plan.ctas) >= 128


@pytest.mark.parametrize("shape", sorted(MLA))
def test_mla_plan_grids_and_workspace(shape):
    B, H, R, P, L, M = MLA[shape]
    plan = PA.mla_plan(B, H, R, P, L, M)
    chunk = plan.chunk
    assert chunk == {"launcher": 1, "long": 4, "one_column": 1}[shape]
    heads = 16 if chunk > 1 else 4                 # the latent staged once a group
    assert plan.score_grid == (math.ceil(M / chunk), H // heads, B)
    assert plan.score_heads == heads
    assert plan.softmax_grid == (H, B, 1)                       # one head a CTA
    assert plan.fold_grid == (H * R // 128, B, 1)
    assert plan.pv_grid == (math.ceil(M / chunk), R // 128, B)
    assert plan.workspace_floats == B * H * (3 * M * L + M + 1 + M * R)
    assert max(plan.smem) <= 232448
    if shape != "one_column":
        assert plan.ctas == (M // chunk * H // heads * B, 64, M // chunk * 4 * B, 256)


@pytest.mark.parametrize("L", [1, 16, 32, 64])
def test_plans_carry_the_score_dots_order(L):
    """Each plan takes its score dots' order from ``dot_order`` (GQA by its
    G and KV heads, MLA by its heads over both widths), and an MLA score
    CTA's shared memory holds that many partials a score."""
    gqa = PA.gqa_plan(4, 4, 8, 128, L, 8)
    assert gqa.order == PA.dot_order("gqa", 8, 128, L, heads=4)
    mla = PA.mla_plan(4, 16, 512, 64, L, 8)
    assert mla.order == PA.dot_order("mla", 16, 64, L)
    assert mla.order.partials == {1: 8, 16: 4, 32: 2, 64: 1}[L]
    hs = mla.score_heads
    assert mla.smem[0] == 4 * (hs * 576 + L * (576 + 8) + 2 * hs * L * (mla.order.partials + 1))


def test_plan_ignores_lengths_and_counts_live_ctas():
    """The grids come from the shapes only; the score CTAs that find live
    blocks follow k_len: a vacant slot (k_len 1) keeps one block."""
    B, KH, G, hd, L, M = GQA["long"]
    plan = PA.gqa_plan(B, KH, G, hd, L, M)
    # 256, 250, 157 and 1 live blocks in chunks of 4, for each kv head
    assert plan.live_score_ctas([4096, 4000, 2501, 1], L) == KH * (64 + 63 + 40 + 1)
    assert plan.live_score_ctas([1, 1, 1, 1], L) == KH * 4
    small = PA.gqa_plan(*GQA["launcher"])
    assert small.live_score_ctas([37, 1, 128, 5], 16) == KH * (3 + 1 + 8 + 1)
    mla = PA.mla_plan(*MLA["long"])
    assert mla.live_score_ctas([4096, 4000, 2501, 1], 16) == 64 + 63 + 40 + 1


@pytest.mark.parametrize("M", [1, 8, 64, 65, 128, 256, 1024])
def test_chunk_grows_with_the_table_up_to_its_cap(M):
    plan = PA.gqa_plan(4, 4, 8, 128, 16, M)
    assert plan.chunk == min(4, max(1, math.ceil(M / 64)))
    assert plan.score_grid[0] * plan.chunk >= M
    assert plan.score_grid[0] <= max(64, math.ceil(M / 4))


def test_plan_rejects_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="multiples of 4"):
        PA.gqa_plan(4, 4, 8, 130, 16, 8)
    with pytest.raises(ValueError, match="multiples of 4"):
        PA.mla_plan(4, 16, 512, 66, 16, 8)
    with pytest.raises(ValueError, match="shared memory"):
        PA.gqa_plan(1, 1, 8, 128, 16, 1 << 15)       # 32768 blocks' sums
    with pytest.raises(ValueError, match="shared memory"):
        PA.gqa_plan(1, 1, 512, 128, 16, 8)           # 512 query rows


def test_softmax_tile_streams_long_rows():
    """A row longer than SOFTMAX_TILE_LANES passes through the softmax
    phase in tiles: shared memory grows by 12 bytes a table column (three
    per-block sums), not by a row's lanes, so max_len reaches 266,240 keys
    at L 16; a smaller tile is a plan of its own (the same output)."""
    L = 16
    tile = PA.SOFTMAX_TILE_LANES // L
    for M in (4096, 16640):                       # 65,536 and 266,240 keys
        plan = PA.gqa_plan(4, 4, 8, 128, L, M)
        assert plan.softmax_tile == tile
        assert plan.smem[1] == 4 * (tile * L + 3 * M) <= PA._SMEM_MAX
        assert PA.mla_plan(4, 16, 512, 64, L, M).softmax_tile == tile
    with pytest.raises(ValueError, match="shared memory"):
        PA.gqa_plan(4, 4, 8, 128, L, 16641)
    small = PA.gqa_plan(4, 4, 8, 128, L, 256, tile_lanes=64)
    assert small.softmax_tile == 4 and small.smem[1] == 4 * (64 + 3 * 256)
    assert PA.gqa_plan(4, 4, 8, 128, L, 256, tile_lanes=1).softmax_tile == 1
    assert PA.gqa_plan(4, 4, 8, 128, L, 256) is PA.gqa_plan(4, 4, 8, 128, L, 256)


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite-16b"])
def test_engine_reports_the_decode_workspace(arch):
    """ServeEngine.decode_workspace_bytes: the plan's float32 workspace at
    the engine's slots and table width on the kernel attend, 0 on the
    gather attend."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as E

    cfg = configs.get_smoke(arch, act_impl="exact")
    model = T.init(cfg, device="cpu")
    slots, max_len, L = 2, 64, 16
    kw = dict(slots=slots, max_len=max_len, kv_impl="paged", block_len=L,
              device="cpu")
    eng = E.ServeEngine(cfg, model, paged_attend_impl="pallas", **kw)
    M = max_len // L
    if cfg.mla is not None:
        plan = PA.mla_plan(slots, cfg.num_heads, cfg.mla.kv_lora_rank,
                           cfg.mla.qk_rope_dim, L, M)
    else:
        KH = cfg.num_kv_heads
        plan = PA.gqa_plan(slots, KH, cfg.num_heads // KH, cfg.head_dim, L, M)
    assert eng.decode_workspace_bytes() == 4 * plan.workspace_floats > 0
    gather = E.ServeEngine(cfg, model, paged_attend_impl="gather", **kw)
    assert gather.decode_workspace_bytes() == 0


def _gqa_meta(**over):
    B, KH, G, hd, L, M = GQA["launcher"]
    N = 1 + B * M
    t = dict(q=torch.empty(B, KH, G, hd, device="meta", dtype=torch.bfloat16),
             k_pool=torch.empty(N, L, KH, hd, device="meta"),
             v_pool=torch.empty(N, L, KH, hd, device="meta"),
             tables=torch.empty(B, M, device="meta", dtype=torch.int32),
             k_len=torch.empty(B, device="meta", dtype=torch.int32))
    t.update(over)
    return t


@pytest.mark.parametrize("case", ["q_dtype", "pool_shape", "tables_dtype",
                                  "mixed_quant_pair", "scale_pool_shape"])
def test_gqa_launch_checks_raise(case):
    """The wrapper's checks before a launch, on tensors that are not on the
    CPU (so the plain version is not taken) and reach no kernel."""
    from repro_torch.core import kv_quant as kvq

    B, KH, G, hd, L, M = GQA["launcher"]
    N = 1 + B * M
    kw = dict(scale=0.1, softmax_impl="cordic_pallas")
    t = _gqa_meta()
    err = ValueError
    if case == "q_dtype":
        t["q"] = torch.empty(B, KH, G, hd, device="meta", dtype=torch.float16)
        err = TypeError
    elif case == "pool_shape":
        t["v_pool"] = torch.empty(N, L, KH, hd + 4, device="meta")
    elif case == "tables_dtype":
        t["tables"] = torch.empty(B, M, device="meta", dtype=torch.int64)
    else:
        spec = kvq.spec_for("int8")
        t["k_pool"] = torch.empty(N, L, KH, hd, device="meta", dtype=spec.code_dtype)
        t["v_pool"] = torch.empty(N, L, KH, hd, device="meta", dtype=spec.code_dtype)
        shape = (N, 1, KH, 1) if case == "mixed_quant_pair" else (N, KH)
        kw.update(kv_quant="int8",
                  k_scale_pool=torch.empty(shape, device="meta"),
                  v_scale_pool=torch.empty(shape, device="meta"),
                  kv_dtype=torch.float32 if case == "mixed_quant_pair" else torch.bfloat16)
        err = TypeError if case == "mixed_quant_pair" else ValueError
    with pytest.raises(err):
        PA.gqa_decode(t["q"], t["k_pool"], t["v_pool"], t["tables"], t["k_len"], **kw)


@pytest.mark.parametrize("case", ["pool_dtype", "rope_shape", "k_len_shape"])
def test_mla_launch_checks_raise(case):
    B, H, R, P, L, M = MLA["launcher"]
    N = 1 + B * M
    qe = torch.empty(B, H, R, device="meta", dtype=torch.bfloat16)
    qr = torch.empty(B, H, P, device="meta", dtype=torch.bfloat16)
    cp = torch.empty(N, L, R, device="meta")
    rp = torch.empty(N, L, P, device="meta")
    tables = torch.empty(B, M, device="meta", dtype=torch.int32)
    k_len = torch.empty(B, device="meta", dtype=torch.int32)
    err = ValueError
    if case == "pool_dtype":
        cp = torch.empty(N, L, R, device="meta", dtype=torch.bfloat16)
        err = TypeError
    elif case == "rope_shape":
        rp = torch.empty(N, L, P + 4, device="meta")
    else:
        k_len = torch.empty(B + 1, device="meta", dtype=torch.int32)
    with pytest.raises(err):
        PA.mla_decode(qe, qr, cp, rp, tables, k_len, scale=0.1,
                      softmax_impl="cordic_pallas")


def test_operand_checks_need_contiguous_aligned_pools():
    """The kernels load pool rows 16 bytes at a time: a pool view that
    starts off a 16-byte boundary, or a strided operand, is refused."""
    base = torch.zeros(4 * 17)
    ok = base[:64].view(4, 16)
    PA._check_operands("gqa_decode", base.device, (ok,), (ok,))
    off = base[1:65].view(4, 16)                  # 4 bytes into the storage
    with pytest.raises(ValueError, match="16-byte aligned"):
        PA._check_operands("gqa_decode", base.device, (off,), (off,))
    with pytest.raises(ValueError, match="contiguous"):
        PA._check_operands("mla_decode", base.device, (ok.t(),), (ok,))
