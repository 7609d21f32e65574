"""PyTorch port of the decoder against the JAX model: the dense GQA model
(Yi-9B smoke) and the MLA/MoE one (DeepSeek-V2-Lite smoke: seg0 one
``mla_dense`` block, seg1 two stacked ``mla_moe`` blocks).

Yi-9B smoke config in float32, JAX weights through the bridge
(``load_jax_params``), CORDIC activations and softmax on. Tolerance: the
matrix products and row sums of the two frameworks round differently (f32
round-off, the median logit differs by about 1e-7), and where such a
difference crosses a rounding edge of a Q2.14 code, a CORDIC stage moves by
one code step: up to 3.5e-4 of a softmax probability, 6.1e-5 of an
activation. Carried through the attention output, the MLP and the head,
those steps leave the logits (|l| < 1) within 1e-3 (2.9e-4 seen), and every
argmax holds. The same bar holds the DeepSeek smoke model, whose MoE
routing (top-k of float32 router scores) comes out equal.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ATOL = 1e-3


def _cfgs(**kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke("yi-9b", act_impl="cordic_pallas"), **kw)
    cfg = dataclasses.replace(configs.get_smoke("yi-9b", act_impl="cordic_pallas"), **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _params():
    jcfg, cfg = _cfgs()
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    return jparams, T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")


def _tokens(seed=0, shape=(2, 24)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def test_bridge_copies_every_leaf():
    jparams, model = _params()
    flat = T.flatten_params(jparams)
    np.testing.assert_array_equal(model.blocks[1].attn.wq.numpy(),
                                  flat["seg0/attn/wq"][1])
    np.testing.assert_array_equal(model.blocks[0].mlp.w_down.numpy(),
                                  flat["seg0/mlp/w_down"][0])
    np.testing.assert_array_equal(model.lm_head.numpy(), flat["lm_head/table"])
    n_leaves = sum(1 for _ in model.parameters())
    assert n_leaves == 3 + 9 * configs.get_smoke("yi-9b").num_layers


@pytest.mark.parametrize("softmax_impl", ["exact", "cordic_pallas"])
def test_no_cache_logits_match_jax(softmax_impl):
    jcfg, cfg = _cfgs(softmax_impl=softmax_impl)
    jparams, model = _params()
    toks = _tokens()
    want = np.asarray(JT.apply(jparams, {"tokens": jnp.asarray(toks)}, jcfg)[0])
    got = T.apply(model, {"tokens": torch.from_numpy(toks).long()}, cfg)[0].numpy()
    diff = np.abs(got - want)
    assert np.median(diff) < 1e-6 and diff.max() < ATOL, diff.max()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_paged_prefill_matches_no_cache_forward():
    """A bucket-padded prefill through the pools sees exactly the causal
    prefix of the no-cache forward."""
    _, cfg = _cfgs(softmax_impl="cordic_pallas")
    _, model = _params()
    toks = _tokens(1, (1, 16))
    ref = T.apply(model, {"tokens": torch.from_numpy(toks).long()}, cfg)[0]
    cache = T.init_paged_cache(cfg, 2, 9, 16, 4, device="cpu")
    cache.tables[0, :1] = torch.tensor([3], dtype=torch.int32)
    logits, _, cache = T.apply(model, {"tokens": torch.from_numpy(toks).long()},
                               cfg, cache=cache.view(cache.tables[:1], cache.lens[:1]))
    assert int(cache.lens[0]) == 16
    torch.testing.assert_close(logits, ref, rtol=0, atol=ATOL)
    assert bool((cache.layers[0]["k_pool"][3] != 0).any())
    assert bool((cache.layers[0]["k_pool"][1:3] == 0).all())


def test_pool_write_decode_lands_in_table_block():
    pool = torch.zeros(5, 4, 1, 2)
    tables = torch.tensor([[2, 4], [0, 0]], dtype=torch.int32)
    lens = torch.tensor([5, 3], dtype=torch.int32)
    new = torch.ones(2, 1, 1, 2)
    attn._pool_write(pool, tables, lens, new)
    assert pool[4, 1].eq(1).all() and pool[0, 3].eq(1).all()
    assert int(pool.ne(0).sum()) == 4


def test_init_without_gpu_raises_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    cfg = configs.get_smoke("yi-9b", act_impl="cordic_pallas")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init(cfg)
    assert T.init(cfg, device="cpu").embed.device.type == "cpu"


# ---------------------------------------------------------------------------
# DeepSeek-V2-Lite smoke: MLA attention, a dense first layer, MoE layers
# ---------------------------------------------------------------------------
DS = "deepseek-v2-lite-16b"


def spec_params(spec, seed=0):
    """A JAX param tree drawn with numpy at the spec's inits and scales
    (normal / sqrt(fan in), or the spec's scale; norms ones): faster than
    a jax.random init of the MoE stacks. The other port test files that
    need a JAX tree import it."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        if p.init in ("ones", "zeros"):
            return (np.ones if p.init == "ones" else np.zeros)(p.shape, np.float32)
        std = p.scale if p.scale is not None else p.shape[-2] ** -0.5
        return (rng.normal(size=p.shape) * std).astype(np.float32)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else jnp.asarray(leaf(v))
                for k, v in tree.items()}
    return walk(spec)


def _ds_cfgs(**kw):
    jcfg = dataclasses.replace(jconfigs.get_smoke(DS, act_impl="cordic_pallas"), **kw)
    cfg = dataclasses.replace(configs.get_smoke(DS, act_impl="cordic_pallas"), **kw)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _ds_params():
    jcfg, cfg = _ds_cfgs()
    jparams = spec_params(JT.model_spec(jcfg))
    return jparams, T.load_jax_params(cfg, T.flatten_params(jparams), device="cpu")


def test_deepseek_bridge_maps_both_segments():
    """seg0 (one mla_dense block) is unstacked, seg1 (two mla_moe blocks)
    stacked; every leaf lands and jax_tree gives the tree back."""
    jparams, model = _ds_params()
    _, cfg = _ds_cfgs()
    flat = T.flatten_params(jparams)
    assert [s[1:] for s in T.segments(cfg)] == [("mla_dense", 0, 1), ("mla_moe", 1, 2)]
    np.testing.assert_array_equal(model.blocks[0].ffn.w_gate.numpy(),
                                  flat["seg0/ffn/w_gate"])
    np.testing.assert_array_equal(model.blocks[0].attn.kv_norm.numpy(),
                                  flat["seg0/attn/kv_norm/scale"])
    np.testing.assert_array_equal(model.blocks[2].ffn.shared.w_up.numpy(),
                                  flat["seg1/ffn/shared/w_up"][1])
    np.testing.assert_array_equal(model.blocks[1].ffn.w_down.numpy(),
                                  flat["seg1/ffn/w_down"][0])
    assert len(T.jax_layout(cfg)) == sum(1 for _ in model.parameters())
    back = T.flatten_params(T.jax_tree(cfg, dict(model.named_parameters())))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]))


def test_deepseek_no_cache_logits_match_jax():
    jcfg, cfg = _ds_cfgs(softmax_impl="cordic_pallas")
    jparams, model = _ds_params()
    toks = _tokens()
    want, want_aux, _ = JT.apply(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    want = np.asarray(want)
    got, aux, _ = T.apply(model, {"tokens": torch.from_numpy(toks).long()}, cfg)
    diff = np.abs(got.numpy() - want)
    assert np.median(diff) < 1e-6 and diff.max() < ATOL, diff.max()
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


def test_deepseek_paged_prefill_matches_no_cache_forward():
    """A 16-wide prefill through the latent and rope pools sees exactly the
    causal prefix of the no-cache forward (same dispatch width, so the MoE
    routes alike)."""
    _, cfg = _ds_cfgs(softmax_impl="cordic_pallas")
    _, model = _ds_params()
    toks = torch.from_numpy(_tokens(1, (1, 16))).long()
    ref = T.apply(model, {"tokens": toks}, cfg)[0]
    cache = T.init_paged_cache(cfg, 2, 9, 16, 4, device="cpu")
    cache.tables[0, :1] = torch.tensor([3], dtype=torch.int32)
    logits, _, cache = T.apply(model, {"tokens": toks}, cfg,
                               cache=cache.view(cache.tables[:1], cache.lens[:1]))
    assert int(cache.lens[0]) == 16
    torch.testing.assert_close(logits, ref, rtol=0, atol=ATOL)
    layer = cache.layers[2]
    assert set(layer) == {"c_kv_pool", "k_rope_pool", "tables", "lens"}
    assert bool((layer["c_kv_pool"][3] != 0).any())
    assert bool((layer["k_rope_pool"][1:3] == 0).all())
    m = cfg.mla
    assert cache.pool_bytes() == 3 * 9 * 16 * (m.kv_lora_rank + m.qk_rope_dim) * 4


# ---------------------------------------------------------------------------
# The paper-faithful datapath: act_impl and softmax_impl "cordic_fixed" (the
# registry's silu through sigmoid_cordic_wide, functions.softmax), plain
# torch against the JAX package's plain jnp, with the same bar
# ---------------------------------------------------------------------------
FIXED = dict(act_impl="cordic_fixed", softmax_impl="cordic_fixed")


@pytest.mark.parametrize("arch", ["yi-9b", DS])
def test_cordic_fixed_logits_match_jax(arch):
    if arch == DS:
        jcfg, cfg = _ds_cfgs(**FIXED)
        jparams, model = _ds_params()
    else:
        jcfg, cfg = _cfgs(**FIXED)
        jparams, model = _params()
    toks = _tokens()
    want, want_aux, _ = JT.apply(jparams, {"tokens": jnp.asarray(toks)}, jcfg)
    want = np.asarray(want)
    got, aux, _ = T.apply(model, {"tokens": torch.from_numpy(toks).long()}, cfg)
    diff = np.abs(got.numpy() - want)
    assert np.median(diff) < 1e-6 and diff.max() < ATOL, diff.max()
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5, atol=1e-12)


def test_gelu_mlp_matches_jax():
    """The GELU MLP (no served arch uses it yet) against the JAX block."""
    from repro.models import mlp as JM
    from repro_torch.models import mlp as M

    rng = np.random.default_rng(4)
    d, f = 16, 40
    p = M.GeluMLP(d, f, dtype=torch.float32, device="cpu",
                  gen=torch.Generator().manual_seed(0))
    with torch.no_grad():
        p.b_in.copy_(torch.from_numpy(rng.normal(size=f).astype(np.float32)))
        p.b_out.copy_(torch.from_numpy(rng.normal(size=d).astype(np.float32)))
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.named_parameters()}
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    for impl in ("cordic_fixed", "cordic_pallas"):
        cfg = dataclasses.replace(configs.get_smoke("yi-9b"), act_impl=impl)
        jcfg = dataclasses.replace(jconfigs.get_smoke("yi-9b"), act_impl=impl)
        want = np.asarray(jax.jit(lambda a: JM.gelu_mlp_apply(jp, a, jcfg))(x))
        got = M.gelu_mlp_apply(p, torch.from_numpy(x), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
