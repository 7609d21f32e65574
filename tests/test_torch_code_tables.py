"""The code tables of the kernels' table route against the JAX stages.

The card builds the tables with the pipeline's own device functions and
chip_smoke.py holds them equal to the plain builders here; these tests hold
the plain builders to the JAX stages over every code, and the table route's
arithmetic (the lookups plus the unchanged boundary code, emulated in plain
torch through ``tables=``) to the pipeline's plain versions, bit for bit.
The emulation's lookups refuse a code outside the table, so every equality
here is also a range check.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import cordic_act as JK  # noqa: E402
from repro_torch.core import fixed_point as fp  # noqa: E402
from repro_torch.cordic_engine.core import PAPER_FIXED, FixedConfig  # noqa: E402
from repro_torch.cordic_engine.schedule import PAPER_SCHEDULE, mr_schedule_for  # noqa: E402
from repro_torch.kernels import code_tables as CT  # noqa: E402
from repro_torch.kernels import cordic_act as K  # noqa: E402
from repro_torch.kernels import softmax_cordic as S  # noqa: E402

TABLE_OPS = tuple(op for op in K.OPS if op != "log")


@functools.lru_cache(maxsize=None)
def _tables():
    return CT.code_tables(PAPER_SCHEDULE, PAPER_FIXED, "cpu")


def _codes():
    return np.arange(-8192, 8193, dtype=np.int32)


def test_tanh_table_equals_jax_stage():
    want = np.asarray(JK._cordic_tanh_q(jnp.asarray(_codes()), JK.PAPER_SCHEDULE,
                                        JK.PAPER_FIXED))
    got = CT.tanh_code_table_plain(PAPER_SCHEDULE, PAPER_FIXED).numpy()
    np.testing.assert_array_equal(got.astype(np.int32), want)


def test_exp_table_equals_jax_stage():
    c, s = JK._coshsinh_q(jnp.asarray(_codes()), JK.PAPER_SCHEDULE, JK.PAPER_FIXED)
    want = np.asarray(JK._wrap16(c + s, 16))
    got = CT.exp_code_table_plain(PAPER_SCHEDULE, PAPER_FIXED).numpy()
    np.testing.assert_array_equal(got.astype(np.int32), want)


def test_tables_layout_and_cache():
    tabs = _tables()
    assert tabs.half == 8192 and tabs.codes.dtype == torch.int16
    assert tabs.codes.shape == (2, 16385)
    assert torch.equal(tabs.codes[0], CT.tanh_code_table_plain(PAPER_SCHEDULE, PAPER_FIXED))
    assert torch.equal(tabs.codes[1], CT.exp_code_table_plain(PAPER_SCHEDULE, PAPER_FIXED))
    assert CT.code_tables(PAPER_SCHEDULE, PAPER_FIXED, "cpu") is tabs


def test_route_follows_the_format():
    q20 = FixedConfig(fmt=fp.Q2_20)
    assert CT.table_route(PAPER_FIXED) and not CT.table_route(q20)
    with pytest.raises(ValueError, match="22-bit"):
        CT.code_tables(mr_schedule_for(20), q20, "cpu")
    assert CT.table_args(None, PAPER_SCHEDULE, PAPER_FIXED, "cpu") == (None, 0)
    assert CT.table_args(CT.EXP_ROW, mr_schedule_for(20), q20, "cpu") == (None, 0)
    assert K._TABLE_ROW.get("log") is None


def _edge_lanes():
    """Normal draws, the lanes chip_smoke.py holds the kernels to, the clamp
    and range-extension edges, and the dyadic reduction's worst lanes: x at
    (k + 1/2) ln2 plus or minus a few ulps, where |r| is largest."""
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 30
    edges = [0.0, -0.0, 80, -80, 85, -85, 1e-30, 1e30, 3e38, 88, -103, 0.693,
             0.5, -0.5, 1.0, -1.0, 2.0, -2.0, 4.0, -4.0, 8.0, -8.0, 1e-45, -1e-45,
             3.4028235e38, -3.4028235e38, math.inf, -math.inf]
    half = (np.arange(-116, 116) + 0.5) * np.log(2.0)
    near = np.concatenate([np.nextafter(half.astype(np.float32), np.float32(s * np.inf))
                           for s in (-1, 1)] + [half.astype(np.float32)])
    return np.concatenate([x, np.array(edges, np.float32), near])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", TABLE_OPS)
def test_table_route_equals_pipeline(op, dtype):
    x = torch.from_numpy(_edge_lanes()).to(getattr(torch, dtype))
    if op == "gelu_erf":
        x = x[x.float().abs() < 1e18]   # past ~1.8e19 the reference carries NaN
    want = K.act_2d_plain(x, op)
    got = K.act_2d_plain(x, op, tables=_tables())
    assert torch.equal(got, want)


def _softmax_rows():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 300)).astype(np.float32) * 6
    x[:8, 100:] = -1e30
    x[8] = -1e30
    x[9] = -math.inf
    x[9, 0] = 0.0
    x[10, :] = 0.0
    x[10, 0] = 25.0
    # u at the dyadic reduction's edges: (k + 1/2) ln2 below the max
    x[11:16, 0] = 0.0
    x[11:16, 1:] = -np.abs(((np.arange(299) % 29) + 0.5) * np.log(2.0)).astype(np.float32)
    return torch.from_numpy(x)


def test_table_route_equals_softmax_plain():
    x = _softmax_rows()
    assert torch.equal(S.softmax_2d_plain(x, tables=_tables()), S.softmax_2d_plain(x))


def test_table_route_equals_log_softmax_plain():
    x = _softmax_rows()
    assert torch.equal(S.log_softmax_2d_plain(x, tables=_tables()),
                       S.log_softmax_2d_plain(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_table_route_equals_silu_mul_plain(dtype):
    g = torch.from_numpy(_edge_lanes()).to(getattr(torch, dtype))
    u = torch.from_numpy(np.random.default_rng(2).normal(size=g.numel()).astype(np.float32))
    u = u.to(g.dtype)
    assert torch.equal(K.silu_mul_2d_plain(g, u, tables=_tables()), K.silu_mul_2d_plain(g, u))


def test_lookups_refuse_codes_off_the_table():
    """The range the wrappers' inputs stay in (the equalities above hold on
    inputs out to +-inf); a NaN lane, outside the kernels' contract, is the
    only way past it, and the kernels then read the edge entry."""
    tabs = _tables()
    for z in (-8193, 8193):
        with pytest.raises(IndexError):
            tabs.exp_code(torch.tensor([z], dtype=torch.int32))
    assert int(tabs.tanh_code(torch.tensor([8192], dtype=torch.int32))) == int(
        K._cordic_tanh_q(torch.tensor([8192], dtype=torch.int32), PAPER_SCHEDULE,
                         PAPER_FIXED))


# ---------------------------------------------------------------------------
# The sigmoid-code table of act_q_2d's table route (every 16-bit z)
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _sigmoid_q_table():
    return CT.sigmoid_q_table(PAPER_SCHEDULE, PAPER_FIXED, "cpu")


def test_sigmoid_q_table_equals_the_plain_kernel_at_every_z():
    """Entry z + 32768 is act_q_2d_plain of the codes 2z and 2z + 1 (both
    halve to z), over all 65,536 z; the table is cached."""
    tab = _sigmoid_q_table()
    assert tab.shape == (CT.SIGMOID_Q_ENTRIES,) and tab.dtype == torch.int16
    z = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32)
    for x in (2 * z, 2 * z + 1):
        assert torch.equal(tab, K.act_q_2d_plain(x).to(torch.int16))
        assert torch.equal(CT.sigmoid_q_index(x), z + (1 << 15))
    assert CT.sigmoid_q_table(PAPER_SCHEDULE, PAPER_FIXED, "cpu") is tab


def test_sigmoid_q_lookup_equals_jax_on_int16_and_int32_codes():
    """The table route (emulated by ``act_q_2d_plain(table=)``) equals the
    JAX ops.sigmoid_q (Pallas act_q_2d in interpret mode) on every int16
    code and on int32 codes over the whole int32 range, +-2^31 included."""
    from repro.kernels import ops as jops

    tab = _sigmoid_q_table()
    wide = np.random.default_rng(0).integers(-(1 << 31), 1 << 31, 1 << 14, dtype=np.int64)
    wide[:6] = [-(1 << 31), (1 << 31) - 1, -(1 << 31) + 1, (1 << 31) - 2, 1 << 16,
                -(1 << 16) - 1]
    for codes in (np.arange(-(1 << 15), 1 << 15).astype(np.int16).reshape(256, 256),
                  wide.astype(np.int32).reshape(128, 128)):
        got = K.act_q_2d_plain(torch.from_numpy(codes), table=tab)
        assert got.dtype == torch.from_numpy(codes).dtype
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(jops.sigmoid_q(jnp.asarray(codes))))


def test_sigmoid_q_table_only_in_a_16_bit_format():
    """Q2.20 keeps act_q_2d on the pipeline route: no table is built."""
    q20 = FixedConfig(fmt=fp.Q2_20)
    with pytest.raises(ValueError, match="22-bit"):
        CT.sigmoid_q_table(mr_schedule_for(20), q20, "cpu")
