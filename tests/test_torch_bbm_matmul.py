"""The port's dot-form datapath against the JAX package's, bit for bit.

Every function of the bitexact MLP path computes integers (the folded
dot form of each Broken-Booth product, exact in int32 per
``amm_chunk_len`` chunk) and then the same f32 operations in the same
order, so the port must equal the reference exactly: ``_dot_scaled``
(both the s32 and the exact-f32 routes), ``bbm_matmul_scaled``,
``dot_scaled_chunked``, ``bbm_matmul_dynamic``, ``_amm_bitexact_approx``
(f32 and bf16 activations) and ``amm_dot(ste=False)``.  The operands
carry envelope-edge codes (+lim and -lim - 1 rows and columns) and K at,
below and one past the chunk length.

The straight-through compositions ``exact + (approx - exact)`` also hold
the exact f32 product, which the two frameworks sum in different
orders: there they agree within ``_ste_bound``, derived below.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.configs.base import AmmConfig as JAmm
from repro.core.multipliers import MulSpec as JSpec
from repro.models import common as j_common
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.core.faults import apply_plane_faults as t_apply
from repro_torch.core.multipliers import MulSpec as TSpec
from repro_torch.kernels import booth_rows as t_rows
from repro_torch.kernels import ref as t_ref
from repro_torch.models import common as t_common

pytest_plugins = ["port_first"]

jb = importlib.import_module("repro.kernels.bbm_matmul")
jr = importlib.import_module("repro.kernels.booth_rows")
j_ref = importlib.import_module("repro.kernels.ref")
tb = importlib.import_module("repro_torch.kernels.bbm_matmul")

# the Booth-family cells of tests/test_amm_bitexact.py: both word-length
# ends, both kinds, a multi-chunk point (16, 3) and the exact multiplier
SWEEP = [("bbm0", 8, 5), ("bbm1", 8, 7), ("bbm0", 12, 7), ("bbm1", 12, 11),
         ("bbm0", 16, 13), ("bbm1", 16, 15), ("bbm0", 16, 3),
         ("booth", 12, 0), ("booth", 16, 0)]
KINDS = {"booth": 0, "bbm0": 0, "bbm1": 1}
U = 2.0 ** -24


def _lowering(mul, wl, vbl):
    return wl, (0 if mul == "booth" else vbl), KINDS[mul]


def _codes(m, k, n, wl, seed=0):
    """Signed wl-bit codes with envelope-edge rows and columns."""
    rng = np.random.default_rng(seed)
    lim = 1 << (wl - 1)
    x = rng.integers(-lim, lim, (m, k)).astype(np.int32)
    w = rng.integers(-lim, lim, (k, n)).astype(np.int32)
    x[0], x[1 % m] = lim - 1, -lim
    w[:, 0], w[:, 1 % n] = lim - 1, -lim
    return x, w


def _floats(m, k, n, seed=3, dtype=np.float32):
    """Float operands whose first rows/columns quantize to +-lim."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k))
    w = rng.standard_normal((k, n))
    x[0, :] = np.abs(x).max() * 1.5
    x[1, :] = -np.abs(x).max()
    w[:, 0] = np.abs(w).max() * 1.5
    w[:, 1] = -np.abs(w).max()
    return x.astype(dtype), w.astype(dtype)


def _planes(w, wl):
    jm, jn = jr.booth_precode(jnp.asarray(w), wl)
    tm, tn = t_rows.booth_precode(torch.from_numpy(w), wl)
    return (jm, jn), (tm, tn)


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
@pytest.mark.parametrize("route", ["s32", "f32"])
def test_dot_scaled_matches_jax(mul, wl, vbl, route):
    wl, vbl, kind = _lowering(mul, wl, vbl)
    k = min(40, t_rows.amm_chunk_len(wl, vbl))
    x, w = _codes(7, k, 9, wl)
    f32 = t_rows.f32_exact_chunk_len(wl, vbl) if route == "f32" else 0
    (jm, jn), (tm, tn) = _planes(w, wl)
    _, jx = jr.split_signed(jnp.asarray(x), wl)
    _, tx = t_rows.split_signed(torch.from_numpy(x), wl)
    want = jb._dot_scaled(jx, jm, jn, wl=wl, vbl=vbl, kind=kind,
                          f32_chunk=f32)
    got = tb._dot_scaled(tx, tm, tn, wl=wl, vbl=vbl, kind=kind,
                         f32_chunk=f32)
    assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", ["s32", "f32"])
def test_dot_i32_routes(route):
    rng = np.random.default_rng(5)
    x = rng.integers(-2 ** 7, 2 ** 7, (5, 300)).astype(np.int32)
    y = rng.integers(-3, 3, (300, 4)).astype(np.int32)
    f32 = 64 if route == "f32" else 0
    got = tb._dot_i32(torch.from_numpy(x), torch.from_numpy(y),
                      f32_chunk=f32)
    want = jb._dot_i32(jnp.asarray(x), jnp.asarray(y), f32_chunk=f32)
    assert got.dtype == torch.int32
    assert_array_equal(got.numpy(), np.asarray(want))
    assert_array_equal(got.numpy(), x.astype(np.int64) @ y)


def test_s32_route_refuses_operands_off_the_cpu():
    """torch has no int32 matmul on the card: the s32 route, and the
    public entries that take it, raise for operands off the CPU instead
    of moving the work there (a meta tensor stands in for a CUDA one);
    the f32 route runs on any device."""
    x = torch.empty((5, 300), dtype=torch.int32, device="meta")
    y = torch.empty((300, 4), dtype=torch.int32, device="meta")
    mag = neg = torch.empty((4, 300, 4), dtype=torch.int32, device="meta")
    for call in (lambda: tb._dot_i32(x, y),
                 lambda: tb._dot_i32(torch.zeros((5, 300),
                                                 dtype=torch.int32), y),
                 lambda: tb.bbm_matmul_scaled(x, mag, neg, wl=8, vbl=5),
                 lambda: tb.dot_scaled_chunked(x, mag, neg, wl=8, vbl=5,
                                               kind=0)):
        with pytest.raises(ValueError, match="CPU only"):
            call()
    assert tb._dot_i32(x, y, f32_chunk=64).shape == (5, 4)


def _chunk_ks(wl, vbl):
    c = t_rows.amm_chunk_len(wl, vbl)
    return sorted({max(1, c - 1), c, c + 1}) if c <= 64 else [24, 61]


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_bbm_matmul_scaled_matches_jax(mul, wl, vbl):
    wl, vbl, kind = _lowering(mul, wl, vbl)
    for k in _chunk_ks(wl, vbl):
        x, w = _codes(6, k, 5, wl, seed=k)
        (jm, jn), (tm, tn) = _planes(w, wl)
        want = jb.bbm_matmul_scaled(jnp.asarray(x), jm, jn, wl=wl, vbl=vbl,
                                    kind=kind)
        got = tb.bbm_matmul_scaled(torch.from_numpy(x), tm, tn, wl=wl,
                                   vbl=vbl, kind=kind)
        assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"K={k}")
        kern = tb.bbm_dot_scaled(torch.from_numpy(x), torch.from_numpy(w),
                                 wl=wl, vbl=vbl, kind=kind)
        assert_array_equal(kern.numpy(), np.asarray(want), err_msg=f"K={k}")


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
@pytest.mark.parametrize("f32_dots", [False, True])
def test_dot_scaled_chunked_matches_jax(mul, wl, vbl, f32_dots):
    wl, vbl, kind = _lowering(mul, wl, vbl)
    for k in _chunk_ks(wl, vbl):
        x, w = _codes(5, k, 6, wl, seed=100 + k)
        (jm, jn), (tm, tn) = _planes(w, wl)
        want = jb.dot_scaled_chunked(jnp.asarray(x), jm, jn, wl=wl,
                                     vbl=vbl, kind=kind, f32_dots=f32_dots)
        got = tb.dot_scaled_chunked(torch.from_numpy(x), tm, tn, wl=wl,
                                    vbl=vbl, kind=kind, f32_dots=f32_dots)
        assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"K={k}")


def test_dot_scaled_chunked_batched_is_per_slice():
    """The flash-amm plain version contracts every tile at once: a
    batched call equals the reference's one slice at a time."""
    wl, vbl, kind = 16, 13, 1
    rng = np.random.default_rng(9)
    x = rng.integers(-2 ** 15, 2 ** 15, (2, 3, 4, 16)).astype(np.int32)
    w = rng.integers(-2 ** 15, 2 ** 15, (2, 1, 16, 5)).astype(np.int32)
    tm, tn = t_rows.booth_precode(torch.from_numpy(w), wl)
    got = tb.dot_scaled_chunked(torch.from_numpy(x), tm, tn, wl=wl, vbl=vbl,
                                kind=kind, f32_dots=True).numpy()
    for i in range(2):
        for j in range(3):
            jm, jn = jr.booth_precode(jnp.asarray(w[i, 0]), wl)
            want = jb.dot_scaled_chunked(jnp.asarray(x[i, j]), jm, jn,
                                         wl=wl, vbl=vbl, kind=kind,
                                         f32_dots=True)
            assert_array_equal(got[i, j], np.asarray(want))


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_bbm_matmul_dynamic_matches_jax(mul, wl, vbl):
    wl, vbl, kind = _lowering(mul, wl, vbl)
    a, b = _floats(7, 24, 9)
    want = jb.bbm_matmul_dynamic(jnp.asarray(a), jnp.asarray(b), wl=wl,
                                 vbl=vbl, kind=kind)
    got = tb.bbm_matmul_dynamic(torch.from_numpy(a), torch.from_numpy(b),
                                wl=wl, vbl=vbl, kind=kind)
    assert_array_equal(got.numpy(), np.asarray(want))


def _rts(mul, wl, vbl, apply_to="mlp"):
    kw = dict(mode="bitexact", mul=mul, wl=wl, param=vbl, apply_to=apply_to)
    return (j_common.AmmRuntime.build(JAmm(**kw)),
            t_common.AmmRuntime.build(TAmm(**kw)))


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_amm_bitexact_approx_matches_jax(mul, wl, vbl, dtype):
    jrt, trt = _rts(mul, wl, vbl)
    x, w = _floats(12, 24, 9)
    x = x.reshape(2, 6, 24)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = j_common._amm_bitexact_approx(jx, jnp.asarray(w), jrt)
    got = t_common._amm_bitexact_approx(tx, torch.from_numpy(w), trt)
    assert got.dtype == tx.dtype
    assert_array_equal(got.float().numpy(),
                       np.asarray(want.astype(jnp.float32)))
    planes = trt.precode(torch.from_numpy(w))
    cached = t_common._amm_bitexact_approx(tx, torch.from_numpy(w), trt,
                                           planes=planes)
    assert torch.equal(cached, got)


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_amm_dot_without_ste_matches_jax(mul, wl, vbl):
    jrt, trt = _rts(mul, wl, vbl, apply_to="all")
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    b = rng.standard_normal((2, 3, 8, 6)).astype(np.float32)
    a[0, 0, 0] = 9.0                     # an envelope edge in one slice
    want = j_common.amm_dot(jnp.asarray(a), jnp.asarray(b), jrt, ste=False)
    got = t_common.amm_dot(torch.from_numpy(a), torch.from_numpy(b), trt,
                           ste=False)
    assert_array_equal(got.numpy(), np.asarray(want))
    oracle = t_common.amm_dot(torch.from_numpy(a), torch.from_numpy(b), trt,
                              ste=False, oracle=True)
    assert_array_equal(oracle.numpy(), np.asarray(want))


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_oracles_match_jax(mul, wl, vbl):
    x, w = _floats(5, 20, 7)
    jspec, tspec = JSpec(mul, wl, vbl), TSpec(mul, wl, vbl)
    want = j_ref.amm_approx_ref(jnp.asarray(x), jnp.asarray(w), jspec)
    got = t_ref.amm_approx_ref(torch.from_numpy(x), torch.from_numpy(w),
                               tspec)
    assert_array_equal(got.numpy(), np.asarray(want))
    wl_, vbl_, kind = _lowering(mul, wl, vbl)
    dot = t_common._amm_bitexact_approx(
        torch.from_numpy(x), torch.from_numpy(w), _rts(mul, wl, vbl)[1])
    assert_array_equal(dot.numpy(), got.numpy())
    assert t_ref.AMM_BOOTH_KINDS == j_ref.AMM_BOOTH_KINDS
    assert t_ref.amm_effective_vbl(tspec) == j_ref.amm_effective_vbl(jspec)


def _ste_bound(x, w, approx):
    """|a - b| for two f32 evaluations of ``exact + (approx - exact)``
    with equal ``approx``: the exact products (K terms, any order) differ
    by at most ``2 K u sum|x||w|``, and the two roundings of the sum by
    ``2 u (|approx| + |exact|)`` on each side."""
    k = x.shape[-1]
    t = np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))
    return 2 * k * U * t + 4 * U * (np.abs(approx) + t)


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_ste_compositions_within_bound(mul, wl, vbl):
    jrt, trt = _rts(mul, wl, vbl, apply_to="all")
    x, w = _floats(6, 24, 9)
    want = np.asarray(j_common.amm_dense(jnp.asarray(x), jnp.asarray(w),
                                         jrt), np.float64)
    got = t_common.amm_dense(torch.from_numpy(x), torch.from_numpy(w),
                             trt).double().numpy()
    approx = t_common._amm_bitexact_approx(
        torch.from_numpy(x), torch.from_numpy(w), trt).double().numpy()
    assert (np.abs(got - want) <= _ste_bound(x, w, approx)).all()
    a, b = x.reshape(2, 3, 24), np.stack([w, w[::-1]])
    want = np.asarray(j_common.amm_dot(jnp.asarray(a), jnp.asarray(b), jrt),
                      np.float64)
    got = t_common.amm_dot(torch.from_numpy(a), torch.from_numpy(b.copy()),
                           trt).double().numpy()
    approx = t_common.amm_dot(torch.from_numpy(a), torch.from_numpy(
        b.copy()), trt, ste=False).double().numpy()
    bound = np.stack([_ste_bound(a[i], b[i], approx[i]) for i in range(2)])
    assert (np.abs(got - want) <= bound).all()


def test_amm_dense_gradient_is_the_exact_products():
    """Straight-through: the bitexact layer's gradients are those of
    ``x @ w``, and no gradient passes through the datapath."""
    _, trt = _rts("bbm0", 16, 13)
    x, w = _floats(4, 16, 5)
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    t_common.amm_dense(tx, tw, trt).sum().backward()
    ex = torch.from_numpy(x).requires_grad_()
    ew = torch.from_numpy(w).requires_grad_()
    (ex @ ew).sum().backward()
    assert torch.equal(tx.grad, ex.grad) and torch.equal(tw.grad, ew.grad)


# ----------------------------------------------------- the kernel wrapper
def test_wrapper_runs_the_plain_version_on_cpu_without_counting():
    x, w = _codes(9, 33, 7, 16)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    before = tb.bbm_dot_scaled.launches
    got = tb.bbm_dot_scaled(tx, tw, wl=16, vbl=13, kind=1)
    assert torch.equal(got, tb.bbm_dot_scaled_plain(tx, tw, wl=16, vbl=13,
                                                    kind=1))
    assert tb.bbm_dot_scaled.launches == before


@pytest.mark.parametrize("case", ["dtype", "float", "contiguity", "rank",
                                  "inner", "wl", "vbl", "kind"])
def test_wrapper_refuses_bad_operands(case):
    x, w = (torch.from_numpy(a) for a in _codes(4, 6, 5, 16))
    kw = dict(wl=16, vbl=13, kind=0)
    bad = {
        "dtype": ((x.long(), w), kw, TypeError),
        "float": ((x, w.float()), kw, TypeError),
        "contiguity": ((x, w.t().contiguous().t()), kw, ValueError),
        "rank": ((x[0], w), kw, ValueError),
        "inner": ((x, w[:5]), kw, ValueError),
        "wl": ((x, w), dict(kw, wl=18), ValueError),
        "vbl": ((x, w), dict(kw, vbl=16), ValueError),
        "kind": ((x, w), dict(kw, kind=2), ValueError),
    }[case]
    with pytest.raises(bad[2]):
        tb.bbm_dot_scaled(*bad[0], **bad[1])


def test_fault_hooks_name_their_roadmap_item():
    """The ``fault=`` hooks (ROADMAP item A11, done) take a FaultSpec and
    give the reference's faulted sums: plane faults on the planes, then
    the chunked datapath with per-chunk accumulator upsets."""
    from repro.core.faults import FaultSpec as JFault
    from repro_torch.core.faults import FaultSpec as TFault
    x, w = _codes(2, 40, 3, 16)
    (jm, jn), (tm, tn) = _planes(w, 16)
    for kw in (dict(p=0.2, seed=3), dict(target="acc", p=0.5, bit=28)):
        for vbl in (13, 0):
            want = jb.bbm_matmul_scaled(jnp.asarray(x), jm, jn, wl=16,
                                        vbl=vbl, fault=JFault(**kw))
            got = tb.bbm_matmul_scaled(torch.from_numpy(x), tm, tn, wl=16,
                                       vbl=vbl, fault=TFault(**kw))
            assert_array_equal(got.numpy(), np.asarray(want))
            planes = tb.bbm_dot_planes(
                torch.from_numpy(x), *(t.contiguous() for t in t_apply(
                    tm, tn, TFault(**kw), vbl=vbl)), wl=16, vbl=vbl, kind=0,
                fault=TFault(**kw) if kw.get("target") == "acc" else None)
            assert_array_equal(planes.numpy(), np.asarray(want))
            clean = tb.bbm_matmul_scaled(torch.from_numpy(x), tm, tn, wl=16,
                                         vbl=vbl)
            assert (got != clean).any()


def test_precode_caches_codes_and_scale():
    _, trt = _rts("bbm1", 12, 7)
    w = torch.from_numpy(_floats(3, 10, 4)[1])
    entry = trt.precode(w)
    codes, s_w = t_ref.amm_quantize(w, 12)
    assert torch.equal(entry["codes"], codes) and torch.equal(entry["s_w"],
                                                              s_w)
    off = dataclasses.replace(trt, cfg=dataclasses.replace(trt.cfg,
                                                           mode="noise"))
    assert off.precode(w) is None and not off.cacheable


def test_operating_point_contracts_each_mlp_product_in_one_chunk():
    """At WL 16 / VBL 13 the int32-exact chunk is 8,191 products (the
    scaled total's bound 2^31 - 1 >> 18) and the f32-exact chunk 64, so
    qwen2-0.5b's K = 896 and 4,864 each take one int32 chunk: the
    bitexact MLP products are exact end to end."""
    assert t_rows.amm_chunk_len(16, 13) == jr.amm_chunk_len(16, 13) == 8191
    assert t_rows.f32_exact_chunk_len(16, 13) == 64
    assert t_rows.num_corr_rows(16, 13) == 7
    assert max(896, 4864) <= t_rows.amm_chunk_len(16, 13)


def test_planes_entry_refuses_plane_faults_and_counts_nothing_on_cpu():
    from repro_torch.core.faults import FaultSpec as TFault
    x, w = _codes(3, 20, 4, 12)
    tm, tn = t_rows.booth_precode(torch.from_numpy(w), 12)
    tx = torch.from_numpy(x)
    before = tb.bbm_dot_planes.launches
    with pytest.raises(ValueError, match="planes first"):
        tb.bbm_dot_planes(tx, tm, tn, wl=12, vbl=7, kind=0,
                          fault=TFault(p=0.1))
    got = tb.bbm_dot_planes(tx, tm, tn, wl=12, vbl=7, kind=1,
                            fault=TFault(p=0.0))
    assert torch.equal(got, tb.bbm_dot_scaled(tx, torch.from_numpy(w),
                                              wl=12, vbl=7, kind=1))
    assert tb.bbm_dot_planes.launches == before


# ------------------------------------------- the public matmul API (B1)
def _b1_cells():
    """wl in {8, 12, 16} x vbl in {0, 5, 13, 15} below wl x both kinds."""
    return [(wl, vbl, kind) for wl in (8, 12, 16) for vbl in (0, 5, 13, 15)
            if vbl < wl for kind in (0, 1)]


def _b1_shifts(k, wl, vbl):
    """{0 where the envelope allows it, the minimal safe shift, <= vbl,
    > vbl}."""
    lo = 0
    while k * 2 ** max(2 * wl - 1 - lo, 0) >= 2 ** 31:
        lo += 1
    return sorted({lo, max(lo, vbl), max(lo, vbl - 1), max(lo, vbl + 2)})


@pytest.mark.parametrize("wl,vbl,kind", _b1_cells())
def test_public_matmul_matches_jax(wl, vbl, kind, monkeypatch):
    """``ops.bbm_matmul`` and ``ops.bbm_matmul_precoded`` on the CPU in
    every form against the reference's dot form and its closed-form
    oracle ``bbm_matmul_ref``: ragged shapes, the most negative codes,
    and the plain versions' row blocks cut to a few rows."""
    t_ops = importlib.import_module("repro_torch.kernels.ops")
    monkeypatch.setattr(tb, "_ROW_BLOCK", 3 * 37 * 7)
    x, w = _codes(10, 37, 7, wl, seed=wl + vbl + kind)
    x[2], w[:, 2] = -(1 << (wl - 1)), -(1 << (wl - 1))
    (jm, jn), (tm, tn) = _planes(w, wl)
    for shift in _b1_shifts(37, wl, vbl):
        kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift)
        want = np.asarray(j_ref.bbm_matmul_ref(jnp.asarray(x),
                                               jnp.asarray(w), **kw))
        dot = jb.bbm_matmul_precoded(jnp.asarray(x), jm, jn, form="dot", **kw)
        assert_array_equal(np.asarray(dot), want)
        assert_array_equal(t_ref.bbm_matmul_ref(
            torch.from_numpy(x), torch.from_numpy(w), **kw).numpy(), want)
        for form in ("rows", "dot", None):
            got = t_ops.bbm_matmul(x, w, form=form, device="cpu", **kw)
            assert got.dtype == torch.int32
            assert_array_equal(got.numpy(), want, err_msg=f"{shift} {form}")
            got = t_ops.bbm_matmul_precoded(x, tm, tn, form=form,
                                            device="cpu", **kw)
            assert_array_equal(got.numpy(), want, err_msg=f"{shift} {form}")


def test_faulted_planes_run_through_both_forms():
    """Faulted planes are not the decode of any code; both forms (and the
    reference's dot form) take them alike."""
    from repro.core.faults import FaultSpec as JFault
    from repro.core.faults import apply_plane_faults as j_apply
    from repro_torch.core.faults import FaultSpec as TFault
    x, w = _codes(6, 40, 9, 16, seed=5)
    (jm, jn), (tm, tn) = _planes(w, 16)
    for kw in (dict(p=0.3, seed=2), dict(model="stuck1", lane="neg",
                                          p=0.5, seed=4)):
        jfm, jfn = j_apply(jm, jn, JFault(**kw), vbl=13)
        tfm, tfn = t_apply(tm, tn, TFault(**kw), vbl=13)
        for kind in (0, 1):
            for shift in (13, 15):
                want = jb.bbm_matmul_precoded(jnp.asarray(x), jfm, jfn,
                                              wl=16, vbl=13, kind=kind,
                                              shift=shift, form="dot")
                for form in ("rows", "dot"):
                    got = tb.bbm_matmul_precoded(
                        torch.from_numpy(x), tfm, tfn, wl=16, vbl=13,
                        kind=kind, shift=shift, form=form)
                    assert_array_equal(got.numpy(), np.asarray(want))


def test_auto_form_matches_the_reference_rule(monkeypatch):
    """``form=None`` picks what the reference's ``bbm_matmul_precoded``
    picks (its body run unjitted, the budget cut down so that small
    shapes cross it, and its form resolver recording the choice)."""
    budget = 500
    monkeypatch.setattr(jb, "_DOT_CORR_BUDGET", budget)
    monkeypatch.setattr(tb, "_DOT_CORR_BUDGET", budget)
    seen = []

    def record(form):
        seen.append(form)
        return "dot"                      # never the Pallas rows launch
    monkeypatch.setattr(jb, "resolve_form", record)
    ran = set()
    for m, k, n in ((2, 5, 7), (5, 11, 10), (9, 8, 7), (1, 500, 1)):
        x, w = _codes(m, k, n, 12, seed=m)
        jm, jn = jr.booth_precode(jnp.asarray(w), 12)
        for vbl in (0, 5, 7):
            for shift in (vbl - 1, vbl, vbl + 1, vbl + 3):
                if shift < 0:
                    continue
                for form in (None, "rows", "dot"):
                    seen.clear()
                    jb.bbm_matmul_precoded.__wrapped__(
                        jnp.asarray(x), jm, jn, wl=12, vbl=vbl, shift=shift,
                        form=form)
                    want = "dot" if seen[0] in (None, "dot") else "rows"
                    got = tb.matmul_form(form, m, k, n, shift=shift, vbl=vbl)
                    assert got == want, (m, k, n, vbl, shift, form)
                    ran.add(got)
    assert ran == {"rows", "dot"}
    assert tb.matmul_form(None, 2048, 896, 4864, shift=15, vbl=13) == "rows"
    assert tb.matmul_form(None, 2048, 896, 4864, shift=13, vbl=13) == "dot"


def test_matmul_envelope_raises_where_jax_does():
    j_ops = importlib.import_module("repro.kernels.ops")
    t_ops = importlib.import_module("repro_torch.kernels.ops")
    cases = 0
    for k in (1, 2, 63, 64, 65, 1 << 16, (1 << 16) + 1, 1 << 20):
        for wl in (2, 8, 12, 16):
            for shift in (0, 1, 5, 15, 16, 31):
                raised = []
                for env in (j_ops._matmul_envelope, t_ops._matmul_envelope):
                    try:
                        env(k, wl, shift)
                        raised.append(False)
                    except ValueError:
                        raised.append(True)
                assert raised[0] == raised[1], (k, wl, shift)
                cases += raised[0]
    assert cases > 10
    x, w = _codes(2, 65, 3, 16)
    for fn in (lambda: t_ops.bbm_matmul(x, w, wl=16, vbl=13, shift=6,
                                        device="cpu"),
               lambda: tb.bbm_matmul_rows(*_b1_operands(x, w), wl=16,
                                          vbl=13, shift=6)):
        with pytest.raises(ValueError, match="overflow"):
            fn()


def _b1_operands(x, w, wl=16):
    tm, tn = t_rows.booth_precode(torch.from_numpy(w), wl)
    return torch.from_numpy(x), tm, tn
