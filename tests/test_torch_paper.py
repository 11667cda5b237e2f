"""The paper's claim set on the port: the comparison multipliers, the
error statistics and the hardware model, against the JAX package.

* ``core.bam``, ``core.kulkarni``, ``core.etm`` and the sign-magnitude
  registry entries: bit for bit against the reference's closed forms on
  sampled pairs at wl 8, 12 and 16, and exhaustively at wl 6 against the
  dot-level oracles of ``core.ref_sim`` (bam, kulkarni) or the reference
  (etm, which has no dot-level oracle);
* ``core.ref_sim``: the port's copy equals the reference's;
* ``core.errstats.characterize`` and ``error_histogram`` for every
  family: equal floats (wl 8 exhaustive, wl 16 sampled, and one Table I
  row at wl 12 over all 2^24 pairs);
* ``core.hwmodel``: every function at the paper's points, equal floats;
* ``kernels.ref.amm_approx_ref`` and bitexact ``amm_dense`` for the
  non-Booth families (the scalar oracle path): bit for bit where the
  float32 sums are exact.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.configs.base import AmmConfig as JAmm
from repro.core import bam as j_bam
from repro.core import errstats as j_err
from repro.core import etm as j_etm
from repro.core import hwmodel as j_hw
from repro.core import kulkarni as j_kul
from repro.core import multipliers as j_mult
from repro.core import ref_sim as j_sim
from repro.kernels.ref import amm_approx_ref as j_approx
from repro.models import common as j_common
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.core import bam as t_bam
from repro_torch.core import errstats as t_err
from repro_torch.core import etm as t_etm
from repro_torch.core import hwmodel as t_hw
from repro_torch.core import kulkarni as t_kul
from repro_torch.core import multipliers as t_mult
from repro_torch.core import ref_sim as t_sim
from repro_torch.kernels.ref import amm_approx_ref as t_approx
from repro_torch.models import common as t_common

pytest_plugins = ["port_first"]

FAMILIES = [("booth", 0, 0), ("bbm0", 5, 0), ("bbm1", 5, 0), ("bam", 5, 0),
            ("bam", 3, 2), ("kulkarni", 6, 0), ("etm", 3, 0)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _pairs(wl: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << wl, n).astype(np.int32)
    b = rng.integers(0, 1 << wl, n).astype(np.int32)
    ext = np.array([1 << (wl - 1), (1 << (wl - 1)) - 1, 0, (1 << wl) - 1],
                   np.int32)
    return (np.concatenate([np.repeat(ext, 4), a]),
            np.concatenate([np.tile(ext, 4), b]))


def _grid(wl: int):
    v = np.arange(1 << wl, dtype=np.int32)
    return np.repeat(v, 1 << wl), np.tile(v, 1 << wl)


# ------------------------------------------------- the comparison multipliers
@pytest.mark.parametrize("wl", [8, 12, 16])
@pytest.mark.parametrize("name,params", [
    ("bam", [(0, 0), (5, 0), (9, 2), (11, 0)]),
    ("kulkarni", [(0, 0), (4, 0), (9, 0), (20, 0)]),
    ("etm", [(0, 0), (3, 0), (4, 0)])])
def test_signed_products_bitwise(name, params, wl):
    a, b = _pairs(wl, 3000, seed=wl)
    for param, hbl in params:
        js = j_mult.MulSpec(name, wl, param, hbl)
        ts = t_mult.MulSpec(name, wl, param, hbl)
        assert ts.is_exact == js.is_exact
        assert_array_equal(t_mult.mul(ts)(_t(a), _t(b)).numpy(),
                           np.asarray(j_mult.mul(js)(a, b)))


@pytest.mark.parametrize("wl", [8, 16])
def test_unsigned_closed_forms_bitwise(wl):
    """The unsigned functions themselves, full-range operands (their int32
    sums wrap alike past 2^31)."""
    a, b = _pairs(wl, 3000, seed=wl + 1)
    for vbl, hbl in ((0, 0), (7, 0), (5, 3)):
        assert_array_equal(t_bam.bam_mul(_t(a), _t(b), wl, vbl, hbl).numpy(),
                           np.asarray(j_bam.bam_mul(a, b, wl, vbl, hbl)))
    for k in (0, 5, 11):
        assert_array_equal(t_kul.kulkarni_mul(_t(a), _t(b), wl, k).numpy(),
                           np.asarray(j_kul.kulkarni_mul(a, b, wl, k)))
    for split in (0, 2, 5):
        assert_array_equal(t_etm.etm_mul(_t(a), _t(b), wl, split).numpy(),
                           np.asarray(j_etm.etm_mul(a, b, wl, split)))


@pytest.mark.parametrize("vbl,hbl", [(0, 0), (3, 0), (5, 0), (4, 2)])
def test_bam_exhaustive_against_the_dot_level_oracle(vbl, hbl):
    wl = 6
    a, b = _grid(wl)
    got = t_bam.bam_mul(_t(a), _t(b), wl, vbl, hbl).numpy()
    want = [t_sim.bam_ref(int(x), int(y), wl, vbl, hbl) for x, y in zip(a, b)]
    assert_array_equal(got, np.array(want))


@pytest.mark.parametrize("k", [0, 4, 6, 9])
def test_kulkarni_exhaustive_against_the_block_oracle(k):
    wl = 6
    a, b = _grid(wl)
    got = t_kul.kulkarni_mul(_t(a), _t(b), wl, k).numpy()
    want = [t_sim.kulkarni_ref(int(x), int(y), wl, k) for x, y in zip(a, b)]
    assert_array_equal(got, np.array(want))


@pytest.mark.parametrize("split", [0, 1, 2, 3])
def test_etm_exhaustive_against_the_reference(split):
    wl = 6
    a, b = _grid(wl)
    assert_array_equal(t_etm.etm_mul(_t(a), _t(b), wl, split).numpy(),
                       np.asarray(j_etm.etm_mul(a, b, wl, split)))
    # and the signed wrap: a magnitude's product with the sign of both
    ts = t_mult.MulSpec("etm", wl, split)
    assert_array_equal(t_mult.mul(ts)(_t(a), _t(b)).numpy(),
                       np.asarray(j_mult.mul(j_mult.MulSpec("etm", wl,
                                                            split))(a, b)))


def test_ref_sim_copy_equals_the_reference():
    rng = np.random.default_rng(9)
    for wl in (4, 8, 12):
        for a, b in rng.integers(0, 1 << wl, (40, 2)).tolist():
            assert t_sim.booth_rows_ref(a, b, wl) \
                == j_sim.booth_rows_ref(a, b, wl)
            for vbl in (0, 3, wl - 1):
                for kind in (0, 1):
                    assert t_sim.bbm_ref(a, b, wl, vbl, kind) \
                        == j_sim.bbm_ref(a, b, wl, vbl, kind)
                assert t_sim.bam_ref(a, b, wl, vbl, 1) \
                    == j_sim.bam_ref(a, b, wl, vbl, 1)
                assert t_sim.kulkarni_ref(a, b, wl, vbl + 3) \
                    == j_sim.kulkarni_ref(a, b, wl, vbl + 3)


# ---------------------------------------------------------- error statistics
def _stats_equal(t, j):
    for f in ("mean", "mse", "prob", "min", "max", "var", "n"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.row() == j.row()


@pytest.mark.parametrize("name,param,hbl", FAMILIES)
def test_characterize_every_family_equals_the_reference(name, param, hbl):
    for wl, kw in ((8, {}), (16, dict(sample=1 << 16, seed=4))):
        js = j_mult.MulSpec(name, wl, param, hbl)
        ts = t_mult.MulSpec(name, wl, param, hbl)
        _stats_equal(t_err.characterize(ts, device="cpu", **kw),
                     j_err.characterize(js, **kw))


@pytest.mark.parametrize("name,param,hbl", FAMILIES)
def test_error_histogram_every_family_equals_the_reference(name, param,
                                                           hbl):
    js = j_mult.MulSpec(name, 8, param, hbl)
    ts = t_mult.MulSpec(name, 8, param, hbl)
    jc, jp = j_err.error_histogram(js, bins=41)
    tc, tp = t_err.error_histogram(ts, bins=41, device="cpu")
    assert_array_equal(tc, jc)
    assert_array_equal(tp, jp)


def test_table1_row_exhaustive_wl12_equals_the_reference():
    """One of Table I's rows over all 2^24 pairs (the paper's N)."""
    st = t_err.characterize(t_mult.MulSpec("bbm0", 12, 9), device="cpu")
    assert st.n == 1 << 24
    _stats_equal(st, j_err.characterize(j_mult.MulSpec("bbm0", 12, 9)))


def test_characterize_refuses_sums_past_2_53(monkeypatch):
    """The exactness guard: a float64 sum past 2^53 stops being the
    reference's float, so it raises instead of returning it."""
    monkeypatch.setattr(t_err, "_EXACT", 1e6)
    with pytest.raises(ValueError, match="2\\^53"):
        t_err.characterize(t_mult.MulSpec("bbm0", 8, 7), device="cpu")


# ------------------------------------------------------------ hardware model
SPECS = [("booth", w, 0, 0) for w in (4, 8, 12, 16)] \
    + [("bbm0", w, w - 1, 0) for w in (4, 8, 12, 16)] \
    + [("bbm1", 16, v, 0) for v in (5, 13, 15)] \
    + [("bam", 16, v, h) for v, h in ((0, 0), (13, 0), (15, 2))] \
    + [("kulkarni", 16, k, 0) for k in (0, 8, 15)] \
    + [("etm", 16, s, 0) for s in (4, 8)]


def test_hwmodel_calibration_and_constants_equal_the_reference():
    assert dataclasses.astuple(t_hw.calibrate()) \
        == dataclasses.astuple(j_hw.calibrate())
    for name in ("PAPER_POWER_REDUCTION", "PAPER_AREA_REDUCTION",
                 "PAPER_TABLE4", "PAPER_TMIN_ACCURATE_NS",
                 "PAPER_TMIN_APPROX_NS", "FIR_TAPS"):
        assert getattr(t_hw, name) == getattr(j_hw, name), name


@pytest.mark.parametrize("name,wl,param,hbl", SPECS)
def test_hwmodel_functions_equal_the_reference(name, wl, param, hbl):
    ts, js = t_mult.MulSpec(name, wl, param, hbl), \
        j_mult.MulSpec(name, wl, param, hbl)
    for fn in ("area", "power", "tmin", "pdp_avg"):
        assert getattr(t_hw, fn)(ts) == getattr(j_hw, fn)(js), fn
    for t_ns in (1.0, 1.13, 1.21, 1.75, 3.0):
        assert t_hw.power_at(ts, t_ns) == j_hw.power_at(js, t_ns)
    ti, ji = t_hw.dot_inventory(ts), j_hw.dot_inventory(js)
    assert ti.keys() == ji.keys()
    for k in ti:
        assert_array_equal(np.asarray(ti[k]), np.asarray(ji[k]))


def test_hwmodel_fir_and_quap_equal_the_reference():
    for wl, vbl in list(t_hw.PAPER_TABLE4) + [(16, 15), (12, 9)]:
        assert t_hw.fir_power(wl, vbl) == j_hw.fir_power(wl, vbl)
        assert t_hw.fir_area(wl, vbl) == j_hw.fir_area(wl, vbl)
    assert t_hw.quap(25.0, 12.3, 17.1) == j_hw.quap(25.0, 12.3, 17.1)


# --------------------------------------------- the scalar oracle, non-Booth
def _dyadic(seed):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-8, 9, (2, 3, 32)) / 8).astype(np.float32)
    w = (rng.integers(-8, 9, (32, 24)) / 16).astype(np.float32)
    return x, w


@pytest.mark.parametrize("name,param,hbl", [("bam", 5, 0), ("bam", 3, 2),
                                            ("kulkarni", 6, 0),
                                            ("etm", 3, 0)])
def test_non_booth_oracle_and_bitexact_amm_dense_bitwise(name, param, hbl):
    """wl 8, K 32: every product sum is an integer below 2^24, so the
    float32 sums are exact in any order; dyadic operands make the exact
    products exact too."""
    x, w = _dyadic(len(name) + param)
    js = j_mult.MulSpec(name, 8, param, hbl)
    ts = t_mult.MulSpec(name, 8, param, hbl)
    assert_array_equal(
        t_approx(torch.from_numpy(x), torch.from_numpy(w), ts).numpy(),
        np.asarray(j_approx(jnp.asarray(x), jnp.asarray(w), js)))
    if hbl:                 # AmmConfig has no hbl: the layer's BAM is hbl 0
        return
    cfg = dict(mode="bitexact", mul=name, wl=8, param=param)
    jrt = j_common.AmmRuntime.build(JAmm(**cfg))
    trt = t_common.AmmRuntime.build(TAmm(**cfg))
    want = np.asarray(j_common.amm_dense(jnp.asarray(x), jnp.asarray(w),
                                         jrt))
    got = t_common.amm_dense(torch.from_numpy(x), torch.from_numpy(w), trt)
    assert_array_equal(got.numpy(), want)
    assert not trt.cacheable and trt.precode(torch.from_numpy(w)) is None
