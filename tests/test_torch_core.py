"""Parity of the port's core arithmetic with the JAX package, bit for bit.

Inputs are numpy arrays from a seed; the JAX function and its counterpart
in ``repro_torch`` run on the same arrays (the port on the CPU, where
every function is plain PyTorch) and every comparison is exact: the
whole datapath is integer, or float64 on the host.
"""
from __future__ import annotations

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import bbm as j_bbm
from repro.core import booth as j_booth
from repro.core import guards as j_guards
from repro.core import multipliers as j_mult
from repro.dsp import fixed_point as j_fp
from repro.kernels import booth_rows as j_rows
from repro.kernels import fir_kernel as j_fk
from repro_torch.core import bbm as t_bbm
from repro_torch.core import booth as t_booth
from repro_torch.core import guards as t_guards
from repro_torch.core import multipliers as t_mult
from repro_torch.dsp import fixed_point as t_fp
from repro_torch.kernels import booth_rows as t_rows
from repro_torch.kernels import fir_kernel as t_fk

pytest_plugins = ["port_first"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pairs(wl: int, n: int, seed: int):
    """``n`` sampled (a, b) wl-bit codes, both extremes included."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << wl, n).astype(np.int32)
    b = rng.integers(0, 1 << wl, n).astype(np.int32)
    lo, hi = 1 << (wl - 1), (1 << (wl - 1)) - 1   # -2^(wl-1) and max code
    ext = np.array([lo, hi, 0, (1 << wl) - 1], np.int32)
    a = np.concatenate([np.repeat(ext, len(ext)), a])
    b = np.concatenate([np.tile(ext, len(ext)), b])
    return a, b


def _exhaustive(wl: int):
    a, b = np.meshgrid(np.arange(1 << wl), np.arange(1 << wl), indexing="ij")
    return a.ravel().astype(np.int32), b.ravel().astype(np.int32)


# ------------------------------------------------------------ closed forms
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("vbl", [0, 3, 5, 8, 11, 16])
def test_bbm_mul_exhaustive_wl8(vbl, kind):
    a, b = _exhaustive(8)
    want = np.asarray(j_bbm.bbm_mul(a, b, 8, vbl, kind))
    assert_array_equal(_np(t_bbm.bbm_mul(_t(a), _t(b), 8, vbl, kind)), want)


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("wl,vbl", [(12, 0), (12, 7), (12, 11), (16, 0),
                                    (16, 13), (16, 15)])
def test_bbm_mul_sampled(wl, vbl, kind):
    a, b = _pairs(wl, 20_000, seed=wl * 100 + vbl)
    want = np.asarray(j_bbm.bbm_mul(a, b, wl, vbl, kind))
    assert_array_equal(_np(t_bbm.bbm_mul(_t(a), _t(b), wl, vbl, kind)), want)


@pytest.mark.parametrize("wl", [8, 12, 16])
def test_booth_recoding_and_exact_product(wl):
    a, b = _exhaustive(8) if wl == 8 else _pairs(wl, 20_000, seed=wl)
    for fn in ("to_signed", "to_unsigned"):
        assert_array_equal(_np(getattr(t_booth, fn)(_t(a), wl)),
                           np.asarray(getattr(j_booth, fn)(a, wl)))
    d_t, n_t = t_booth.booth_digits(_t(b), wl)
    d_j, n_j = j_booth.booth_digits(b, wl)
    assert_array_equal(_np(d_t), np.asarray(d_j))
    assert_array_equal(_np(n_t), np.asarray(n_j))
    exact = _np(t_booth.booth_mul_exact(_t(a), _t(b), wl))
    assert_array_equal(exact, np.asarray(j_booth.booth_mul_exact(a, b, wl)))
    sa = np.asarray(j_booth.to_signed(a, wl), np.int64)
    sb = np.asarray(j_booth.to_signed(b, wl), np.int64)
    assert_array_equal(exact, sa * sb)


@pytest.mark.parametrize("wl,vbl", [(8, 17), (16, 27), (16, -1)])
def test_bbm_rejects_unsafe_vbl_like_reference(wl, vbl):
    with pytest.raises(ValueError):
        j_bbm.bbm_mul(np.int32(1), np.int32(1), wl, vbl, 0)
    with pytest.raises(ValueError):
        t_bbm.bbm_mul(_t([1]), _t([1]), wl, vbl, 0)


def test_num_pp_rows_rejects_odd_wl():
    assert t_booth.num_pp_rows(16) == j_booth.num_pp_rows(16) == 8
    with pytest.raises(ValueError):
        t_booth.num_pp_rows(7)


# ------------------------------------------------------------- multipliers
@pytest.mark.parametrize("name,param", [("booth", 0), ("booth", 5),
                                        ("bbm0", 0), ("bbm0", 13),
                                        ("bbm1", 15)])
def test_mul_spec_booth_family(name, param):
    a, b = _pairs(16, 2_000, seed=param)
    js, ts = j_mult.MulSpec(name, 16, param), t_mult.MulSpec(name, 16, param)
    assert ts.is_exact == js.is_exact
    assert_array_equal(_np(t_mult.mul(ts)(_t(a), _t(b))),
                       np.asarray(j_mult.mul(js)(a, b)))


@pytest.mark.parametrize("name,param,hbl", [("bam", 0, 0), ("bam", 0, 2),
                                            ("bam", 5, 0), ("kulkarni", 0, 0),
                                            ("kulkarni", 4, 0), ("etm", 3, 0)])
def test_mul_spec_not_ported_families(name, param, hbl):
    ts = t_mult.MulSpec(name, 16, param, hbl)
    assert ts.is_exact == j_mult.MulSpec(name, 16, param, hbl).is_exact
    with pytest.raises(NotImplementedError, match="A14"):
        t_mult.mul(ts)(_t([1]), _t([1]))


def test_mul_spec_validation_and_registry():
    assert set(t_mult.MULTIPLIERS) == set(j_mult.MULTIPLIERS)
    assert t_mult.EXACT == t_mult.MulSpec("booth", 16, 0)
    for bad in (dict(name="nope"), dict(name="bbm0", wl=15)):
        with pytest.raises(ValueError):
            j_mult.MulSpec(**bad)
        with pytest.raises(ValueError):
            t_mult.MulSpec(**bad)


# ------------------------------------------------------------- booth_rows
ROWS_GRID = [(8, 0), (8, 5), (12, 7), (12, 11), (16, 0), (16, 13), (16, 15)]


def _operands(wl: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << wl, (4, 300)).astype(np.int32)
    b = rng.integers(0, 1 << wl, (4, 1)).astype(np.int32)
    a[0, :4] = [1 << (wl - 1), (1 << (wl - 1)) - 1, 0, (1 << wl) - 1]
    b[0, 0] = (1 << wl) - 1                     # all-ones: the 111 triplets
    b[1, 0] = 1 << (wl - 1)
    return a, b


@pytest.mark.parametrize("wl", [8, 12, 16])
def test_split_signed_and_precode(wl):
    a, b = _operands(wl, seed=wl)
    for got, want in zip(t_rows.split_signed(_t(a), wl),
                         j_rows.split_signed(jnp.asarray(a), wl)):
        assert_array_equal(_np(got), np.asarray(want))
    for got, want in zip(t_rows.booth_precode(_t(b), wl),
                         j_rows.booth_precode(b, wl)):
        assert got.dtype == torch.int32
        assert_array_equal(_np(got), np.asarray(want))
    mag, neg = t_rows.booth_precode(_t(b), wl)
    jm, jn = j_rows.booth_precode(b, wl)
    for r in range(wl // 2):
        assert_array_equal(_np(t_rows.signed_digit(mag[r], neg[r])),
                           np.asarray(j_rows.signed_digit(jm[r], jn[r])))
    assert_array_equal(_np(t_rows.booth_value(mag, neg, wl=wl)),
                       np.asarray(j_rows.booth_value(jm, jn, wl=wl)))


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("wl,vbl", ROWS_GRID)
def test_row_forms_match_reference(wl, vbl, kind):
    a, b = _operands(wl, seed=wl + vbl + kind)
    _, a_s = t_rows.split_signed(_t(a), wl)
    _, ja_s = j_rows.split_signed(jnp.asarray(a), wl)
    mag, neg = t_rows.booth_precode(_t(b), wl)
    jm, jn = j_rows.booth_precode(b, wl)
    kw = dict(wl=wl, vbl=vbl, kind=kind)
    want = np.asarray(j_bbm.bbm_mul(a, b, wl, vbl, kind))
    for mf in (True, False):
        got = t_rows.bbm_rows_product_precoded(a_s, mag, neg,
                                               multiply_free=mf, **kw)
        ref = j_rows.bbm_rows_product_precoded(ja_s, jm, jn,
                                               multiply_free=mf, **kw)
        assert_array_equal(_np(got), np.asarray(ref))
        assert_array_equal(_np(got), want)
    assert_array_equal(_np(t_rows.bbm_rows_product(a_s, _t(b), **kw)), want)
    assert_array_equal(
        _np(t_rows.bbm_rows_product_dotform(a_s, mag, neg, **kw)),
        np.asarray(j_rows.bbm_rows_product_dotform(ja_s, jm, jn, **kw)))
    assert_array_equal(_np(t_rows.booth_correction(a_s, mag, neg, **kw)),
                       np.asarray(j_rows.booth_correction(ja_s, jm, jn, **kw)))
    assert_array_equal(
        _np(t_rows.booth_high_value(mag, neg, wl=wl, vbl=vbl)),
        np.asarray(j_rows.booth_high_value(jm, jn, wl=wl, vbl=vbl)))
    q_t = t_rows.scaled_trunc_rows(a_s, mag, neg, **kw)
    q_j = j_rows.scaled_trunc_rows(ja_s, jm, jn, **kw)
    assert (q_t is None) == (q_j is None) == (vbl == 0)
    if q_t is not None:
        assert_array_equal(_np(q_t), np.asarray(q_j))


def _wl_vbl_grid():
    return [(wl, vbl) for wl in range(2, 17, 2) for vbl in range(0, 2 * wl + 1)]


def test_integer_helpers_over_whole_grid():
    for wl, vbl in _wl_vbl_grid():
        assert t_rows.num_corr_rows(wl, vbl) == j_rows.num_corr_rows(wl, vbl)
        assert t_rows.amm_chunk_len(wl, vbl) == j_rows.amm_chunk_len(wl, vbl)
        assert t_rows.f32_exact_chunk_len(wl, vbl) == \
            j_rows.f32_exact_chunk_len(wl, vbl)
        for k, shift in itertools.product((1, 5, 31, 1024), (0, 5, 13, 31)):
            assert t_rows.dotform_scaled_bound(k, wl, vbl, shift) == \
                j_rows.dotform_scaled_bound(k, wl, vbl, shift)
    for taps, wl in itertools.product((1, 5, 30, 31, 64, 1000), range(2, 17, 2)):
        assert t_fk.min_safe_shift(taps, wl) == j_fk.min_safe_shift(taps, wl)
    assert t_fk._DOT_WINDOW_BUDGET == j_fk._DOT_WINDOW_BUDGET


@pytest.mark.parametrize("taps,wl,shift", [(31, 16, 4), (31, 16, 5),
                                           (5, 16, 2), (1000, 12, 0)])
def test_check_envelope_like_reference(taps, wl, shift):
    try:
        j_fk._check_envelope(taps, wl, shift)
        ok = True
    except ValueError:
        ok = False
    if ok:
        t_fk._check_envelope(taps, wl, shift)
    else:
        with pytest.raises(ValueError, match="overflow"):
            t_fk._check_envelope(taps, wl, shift)


@pytest.mark.parametrize("form", [None, "dot", "rows", "bogus"])
def test_resolve_form(form):
    if form == "bogus":
        with pytest.raises(ValueError):
            j_rows.resolve_form(form)
        with pytest.raises(ValueError):
            t_rows.resolve_form(form)
    else:
        assert t_rows.resolve_form(form) == j_rows.resolve_form(form)


# -------------------------------------------------------- fixed point, guards
@pytest.mark.parametrize("wl", [8, 12, 16])
def test_fixed_point_like_reference(wl):
    rng = np.random.default_rng(wl)
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4000),
                        (np.arange(-8, 8) + 0.5) / (1 << (wl - 1))])
    q_j = np.asarray(j_fp.quantize(jnp.asarray(x, jnp.float32), wl))
    assert_array_equal(_np(t_fp.quantize(x, wl)), q_j)
    s = np.array(j_booth.to_signed(q_j, wl))    # a writable copy
    assert_array_equal(_np(t_fp.dequantize(s, wl)),
                       np.asarray(j_fp.dequantize(jnp.asarray(s), wl)))
    assert t_fp.requant_scale(wl) == j_fp.requant_scale(wl)


@pytest.mark.parametrize("cfg", [
    dict(), dict(finite=False), dict(budget_abs=0.05, budget_every=1),
    dict(budget_abs=0.0, budget_every=2), dict(budget_abs=None,
                                               budget_every=1)])
def test_guard_rows_like_reference(cfg):
    rng = np.random.default_rng(3)
    y = rng.standard_normal((6, 40))
    y[1, 3] = np.nan
    y[4, 0] = np.inf
    y_exact = y + rng.normal(0, 0.04, y.shape) * (np.arange(6)[:, None] % 2)
    t_cfg, j_cfg = t_guards.GuardConfig(**cfg), j_guards.GuardConfig(**cfg)
    assert t_cfg.budget_active == j_cfg.budget_active
    assert_array_equal(t_guards.finite_rows(y), j_guards.finite_rows(y))
    for ref in (None, y_exact):
        got = t_guards.guard_rows(y, t_cfg, y_exact=ref)
        want = j_guards.guard_rows(y, j_cfg, y_exact=ref)
        assert (got.ok, got.tripped, got.nonfinite, got.budget_err) == \
            (want.ok, want.tripped, want.nonfinite, want.budget_err)
        assert_array_equal(got.row_ok, want.row_ok)
