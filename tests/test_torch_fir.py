"""Parity of the port's FIR filterbank with the JAX package, bit for bit.

Covers the two kernels' plain PyTorch versions (what a wrapper runs for
CPU tensors) against the reference's closed-form oracle
``repro.kernels.ref.fir_bank_ref`` and its XLA dot form, the entry
points built on them (``fir_bbm_bank*``, ``kernels.ops``,
``dsp.fir_apply``, ``PrecodedBank``, the tap-bank converter), the paper's
golden SNR claim, and the auto-form rule.  Inputs come from numpy with a
seed; every comparison is exact.  The reference's Pallas rows launch
does not trace on the CPU here, so its oracle and dot form are the
reference.
"""
from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core.multipliers import MulSpec as JSpec
from repro.dsp import fir as j_fir
from repro.dsp import testbed as j_tb
from repro.kernels import booth_rows as j_rows
from repro.kernels import fir_kernel as j_fk
from repro.kernels import ops as j_ops
from repro.kernels.ref import fir_bank_ref as j_fir_bank_ref
from repro_torch.convert import precoded_bank_from_numpy
from repro_torch.core.multipliers import MulSpec
from repro_torch.dsp import fir as t_fir
from repro_torch.dsp import testbed as t_tb
from repro_torch.kernels import booth_rows as t_rows
from repro_torch.kernels import fir_kernel as t_fk
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels.ref import fir_bank_ref as t_fir_bank_ref

pytest_plugins = ["port_first"]

CPU = "cpu"
# the (wl, vbl) pairs of tests/test_filterbank.py plus the exact vbl = 0
GRID = [(8, 0), (8, 5), (12, 7), (12, 11), (16, 13), (16, 15), (16, 0)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def _codes(wl: int, taps: int, seed: int, c: int = 3, n: int = 700):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << wl, (c, n)).astype(np.int32)
    h = rng.integers(0, 1 << wl, (c, taps)).astype(np.int32)
    ext = [1 << (wl - 1), (1 << (wl - 1)) - 1, (1 << wl) - 1]
    x[0, :3] = ext[:n]
    h[0, 0] = (1 << wl) - 1            # 111 triplets in every row
    h[-1, -1] = 1 << (wl - 1)
    return x, h


def _port_all_forms(x, h, **kw):
    """Every port route of the filterbank on CPU tensors."""
    hm, hn = t_rows.booth_precode(_t(h), kw["wl"])
    xt = _t(x)
    outs = {
        "rows_plain": t_fk.fir_bank_rows_plain(xt, hm, hn, **kw),
        "dot_plain": t_fk.fir_bank_dot_plain(xt, hm, hn, **kw),
        "rows": t_fk.fir_bank_rows(xt, hm, hn, **kw),
        "dot": t_fk.fir_bank_dot(xt, hm, hn, **kw),
    }
    for form in (None, "rows", "dot"):
        outs[f"precoded-{form}"] = t_fk.fir_bbm_bank_precoded(
            xt, hm, hn, form=form, **kw)
    return {k: v.numpy() for k, v in outs.items()}


def _jax_dot(x, h, windowed: bool, **kw):
    jm, jn = j_rows.booth_precode(jnp.asarray(h), kw["wl"])
    return np.asarray(j_fk._fir_bank_dotform(jnp.asarray(x), jm, jn,
                                             windowed=windowed, **kw))


# ------------------------------------------------------------ the kernels
@pytest.mark.parametrize("shift_mode", ["zero", "min_safe"])
@pytest.mark.parametrize("taps", [5, 31])
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("wl,vbl", GRID)
def test_plain_forms_match_reference(wl, vbl, kind, taps, shift_mode):
    x, h = _codes(wl, taps, seed=wl * 1000 + vbl * 10 + kind + taps)
    shift = 0 if shift_mode == "zero" else t_fk.min_safe_shift(taps, wl)
    kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift)
    if taps * 2 ** (2 * wl - 1 - shift) >= 2 ** 31:
        # outside the int32 envelope: both packages refuse before dispatch
        jm, jn = j_rows.booth_precode(jnp.asarray(h), wl)
        with pytest.raises(ValueError, match="overflow"):
            j_fk.fir_bbm_bank_precoded(jnp.asarray(x), jm, jn, form="dot",
                                       **kw)
        hm, hn = t_rows.booth_precode(_t(h), wl)
        for fn in (t_fk.fir_bank_rows, t_fk.fir_bank_dot,
                   t_fk.fir_bbm_bank_precoded):
            with pytest.raises(ValueError, match="overflow"):
                fn(_t(x), hm, hn, **kw)
        return
    want = np.asarray(j_fir_bank_ref(jnp.asarray(x), jnp.asarray(h), **kw))
    assert_array_equal(_jax_dot(x, h, True, **kw), want)
    assert_array_equal(_jax_dot(x, h, False, **kw), want)
    assert_array_equal(t_fir_bank_ref(_t(x), _t(h), **kw).numpy(), want)
    for name, got in _port_all_forms(x, h, **kw).items():
        assert got.dtype == np.int32, name
        assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("wl,vbl,kind,shift", [(8, 5, 0, 9), (8, 0, 1, 3),
                                               (12, 7, 1, 10),
                                               (16, 13, 0, 15),
                                               (16, 15, 1, 17)])
def test_shift_above_vbl_floors_per_product(wl, vbl, kind, shift):
    x, h = _codes(wl, 31, seed=shift)
    kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift)
    want = np.asarray(j_fir_bank_ref(jnp.asarray(x), jnp.asarray(h), **kw))
    assert_array_equal(_jax_dot(x, h, False, **kw), want)
    for name, got in _port_all_forms(x, h, **kw).items():
        assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("n", [1, 30, 513])
def test_short_and_ragged_signals(n):
    x, h = _codes(16, 31, seed=n, c=2, n=n)
    kw = dict(wl=16, vbl=13, kind=1, shift=5)
    want = np.asarray(j_fir_bank_ref(jnp.asarray(x), jnp.asarray(h), **kw))
    for name, got in _port_all_forms(x, h, **kw).items():
        assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("form", [None, "rows", "dot"])
def test_raw_code_entry_points(form):
    x, h = _codes(12, 9, seed=7)
    kw = dict(wl=12, vbl=7, kind=1, shift=0)
    want = np.asarray(j_fk.fir_bbm_bank(jnp.asarray(x), jnp.asarray(h),
                                        form="dot", **kw))
    assert_array_equal(
        t_fk.fir_bbm_bank(_t(x), _t(h), form=form, **kw).numpy(), want)
    shared = np.asarray(j_fk.fir_bbm_bank(jnp.asarray(x), jnp.asarray(h[1]),
                                          form="dot", **kw))
    assert_array_equal(
        t_fk.fir_bbm_bank(_t(x), _t(h[1]), form=form, **kw).numpy(), shared)
    one = np.asarray(j_fk.fir_bbm(jnp.asarray(x[2]), jnp.asarray(h[2]),
                                  form="dot", **kw))
    assert_array_equal(
        t_fk.fir_bbm(_t(x[2]), _t(h[2]), form=form, **kw).numpy(), one)
    # kernels.ops: numpy in, int32 codes out, on the device asked for
    j_out = np.asarray(j_ops.fir_filterbank(jnp.asarray(x), jnp.asarray(h),
                                            form="dot", **kw))
    assert_array_equal(t_ops.fir_filterbank(x, h, form=form, device=CPU,
                                            **kw).numpy(), j_out)
    hm, hn = (p.numpy() for p in t_rows.booth_precode(_t(h), 12))
    got = t_ops.fir_filterbank_precoded(x, hm, hn, form=form, device=CPU,
                                        **kw)
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    assert_array_equal(got.numpy(), j_out)


# ----------------------------------------------------------- the auto form
@pytest.mark.parametrize("form", [None, "rows", "dot"])
@pytest.mark.parametrize("accelerator", [False, True])
@pytest.mark.parametrize("c,n,taps", [(64, 33825, 31), (64, 33826, 31),
                                      (1, 1 << 20, 64), (1, 1 << 20, 65)])
def test_auto_form_matches_reference_rule(c, n, taps, accelerator, form):
    """Run the reference's own selection code with its backend faked, and
    record which branch it takes; the port keys the same rule on the
    tensors' device."""
    seen = []

    def fake_pallas_call(kernel, **kw):
        seen.append("rows")
        return lambda *args: jnp.zeros(kw["out_shape"].shape, jnp.int32)

    planes = jnp.zeros((8, c, taps), jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_fk.pl, "pallas_call", fake_pallas_call)
        mp.setattr(j_fk, "pltpu", types.SimpleNamespace(
            VMEM=lambda *a: None, TPUCompilerParams=lambda **kw: None))
        mp.setattr(j_fk, "_fir_bank_dotform",
                   lambda x, *a, **kw: seen.append("dot") or x)
        if accelerator:
            mp.setattr(jax, "default_backend", lambda: "gpu")
        j_fk.fir_bbm_bank_precoded.__wrapped__(
            jnp.zeros((c, n), jnp.int32), planes, planes, wl=16, vbl=13,
            shift=min(t_fk.min_safe_shift(taps, 16) + 1, 31), form=form)
    device = "cuda" if accelerator else "cpu"
    assert t_fk.auto_form(form, c, n, taps, device) == seen[0]


# -------------------------------------------------------------- fir_apply
def _banks():
    return np.stack([j_fir.design_lowpass(),
                     j_fir.design_lowpass(stop_weight=0.5)])


@pytest.mark.parametrize("shift", [None, 0])
@pytest.mark.parametrize("datapath", ["full", "wlbit"])
@pytest.mark.parametrize("form", [None, "rows", "dot"])
@pytest.mark.parametrize("name,vbl", [("booth", 0), ("bbm0", 13),
                                      ("bbm1", 15)])
def test_fir_apply_host_matches_reference(name, vbl, form, datapath, shift):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 300)) * np.array([[1.0], [0.2], [3.0]])
    h = _banks()[[0, 1, 0]]
    jspec, tspec = JSpec(name, 16, vbl), MulSpec(name, 16, vbl)
    kw = dict(backend="host", datapath=datapath, shift=shift, form=form)

    def both(xx, hh, bank_kw=None):
        try:
            want = j_fir.fir_apply(xx, hh, jspec, **kw)
        except ValueError:
            with pytest.raises(ValueError):
                t_fir.fir_apply(xx, hh, tspec, device=CPU, **kw)
            return
        got = t_fir.fir_apply(xx, hh, tspec, device=CPU, **kw)
        assert got.shape == want.shape and got.dtype == np.float64
        assert_array_equal(got, want)
        jb = j_fir.PrecodedBank(hh, jspec)
        tb = t_fir.PrecodedBank(hh, tspec, device=CPU)
        assert_array_equal(t_fir.fir_apply(xx, tb, device=CPU, **kw),
                           j_fir.fir_apply(xx, jb, **kw))

    both(x, h)                       # (C, N) with per-channel banks
    both(x[1], h[1])                 # (N,) with one bank
    both(x, h[0])                    # one bank shared by every channel


@pytest.mark.parametrize("form", [None, "dot", "rows"])
@pytest.mark.parametrize("name,vbl", [("booth", 0), ("bbm0", 13),
                                      ("bbm1", 15)])
def test_fir_apply_kernel_backend_matches_reference(name, vbl, form):
    """backend="cuda" on the CPU runs the kernels' plain versions; the
    reference's interpreter backend traces its dot form on the CPU."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 400))
    h = _banks()[[0, 1, 1, 0]]
    jspec, tspec = JSpec(name, 16, vbl), MulSpec(name, 16, vbl)
    # the reference's Pallas rows launch does not trace here; every form
    # is bit-identical, so its dot form stands in for it
    want = j_fir.fir_apply(x, h, jspec, backend="pallas-interpret",
                           form="dot" if form == "rows" else form)
    got = t_fir.fir_apply(x, h, tspec, backend="cuda", form=form, device=CPU)
    assert_array_equal(got, want)
    bank = t_fir.PrecodedBank(h, tspec, device=CPU)
    assert_array_equal(t_fir.fir_apply(x, bank, backend="cuda", form=form,
                                       device=CPU), want)


def test_kernel_backend_rejects_what_the_reference_rejects():
    x = np.ones((2, 64))
    h = _banks()
    for spec, dp in ((MulSpec("kulkarni", 16, 4), "full"),
                     (MulSpec("bbm0", 16, 13), "wlbit")):
        with pytest.raises(ValueError):
            j_fir.fir_apply(x, h, JSpec(spec.name, spec.wl, spec.param),
                            backend="pallas-interpret", datapath=dp)
        with pytest.raises(ValueError):
            t_fir.fir_apply(x, h, spec, backend="cuda", datapath=dp,
                            device=CPU)
    with pytest.raises(ValueError, match="backend"):
        t_fir.fir_apply(x, h, MulSpec("bbm0", 16, 13), backend="pallas",
                        device=CPU)


def test_converted_bank_computes_what_the_reference_bank_does():
    jspec = JSpec("bbm1", 16, 13)
    jb = j_fir.PrecodedBank(_banks(), jspec)
    mag, neg = (np.asarray(p) for p in jb.planes)
    tb = precoded_bank_from_numpy(jb.h_real, jb.hq, mag, neg, jspec,
                                  device=CPU)
    assert tb.spec == MulSpec("bbm1", 16, 13)
    native = t_fir.PrecodedBank(_banks(), tb.spec, device=CPU)
    assert_array_equal(tb.hq, native.hq)
    for p, q in zip(tb.planes, native.planes):
        assert_array_equal(p.numpy(), q.numpy())
    rng = np.random.default_rng(9)
    x = rng.standard_normal((5, 257))
    idx = [1, 0, 0, 1, 1]
    want = j_fir.fir_apply(x, jb.take(idx))
    for backend in ("host", "cuda"):
        assert_array_equal(t_fir.fir_apply(x, tb.take(idx), backend=backend,
                                           device=CPU), want)
    # a spec without digit planes carries only its codes
    kb = precoded_bank_from_numpy(jb.h_real, jb.hq, None, None,
                                  JSpec("kulkarni", 16, 0), device=CPU)
    assert kb.planes is None
    with pytest.raises(ValueError):
        precoded_bank_from_numpy(jb.h_real, jb.hq, mag[:3], neg, jspec,
                                 device=CPU)


def test_fir_apply_fixed_and_real_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 200))
    h = _banks()
    assert_array_equal(t_fir.fir_apply_real(x, h),
                       j_fir.fir_apply_real(x, h))
    assert_array_equal(t_fir.design_lowpass(17, 0.4),
                       j_fir.design_lowpass(17, 0.4))
    for name, vbl in (("booth", 0), ("bbm0", 13)):
        for dp in ("full", "wlbit"):
            assert_array_equal(
                t_fir.fir_apply_fixed(x, h, MulSpec(name, 12, vbl), dp,
                                      device=CPU),
                j_fir.fir_apply_fixed(x, h, JSpec(name, 12, vbl), dp))


# ------------------------------------------------------- the golden claim
@functools.lru_cache(maxsize=None)
def _sig():
    return j_tb.make_signals(n=1 << 13, seed=0)


def test_testbed_signals_match_reference():
    sig = _sig()
    mine = t_tb.make_signals(n=1 << 13, seed=0)
    assert_array_equal(mine.x, sig.x)
    assert_array_equal(mine.d1, sig.d1)
    for a, b in zip(t_tb.make_filterbank_signals(3, n=512, seed=4),
                    j_tb.make_filterbank_signals(3, n=512, seed=4)):
        assert_array_equal(a.x, b.x)
    y = sig.x[::-1].copy()
    assert t_tb.snr_db(sig.d1, y, 15) == j_tb.snr_db(sig.d1, y, 15)


def test_paper_snr_penalty_golden():
    """The paper's claim through the port: bbm0 at VBL = 15 costs ~0.4 dB
    of 30-tap-FIR SNR against exact Booth, and every SNR equals the
    reference's exactly."""
    sig = _sig()
    snr = {}
    for name, vbl in (("booth", 0), ("bbm0", 15), ("bbm0", 13),
                      ("bbm1", 15)):
        want = j_tb.run_filter_case(JSpec(name, 16, vbl), sig)
        got = t_tb.run_filter_case(MulSpec(name, 16, vbl), sig, device=CPU)
        assert got == want
        snr[name, vbl] = got
    assert t_tb.run_filter_case(None, sig) == j_tb.run_filter_case(None, sig)
    assert snr["booth", 0] - snr["bbm0", 15] == pytest.approx(0.4, abs=0.15)
    # through the kernels' datapath (rescaled accumulator, shift 5)
    want = j_tb.run_filter_case(JSpec("bbm0", 16, 15), sig,
                                backend="pallas-interpret")
    assert t_tb.run_filter_case(MulSpec("bbm0", 16, 15), sig, backend="cuda",
                                device=CPU) == want


def test_filterbank_case_matches_reference():
    spec = ("bbm0", 16, 13)
    want = j_tb.run_filterbank_case(JSpec(*spec), channels=4, n=1 << 11)
    got = t_tb.run_filterbank_case(MulSpec(*spec), channels=4, n=1 << 11,
                                   device=CPU)
    assert got == want
    got_k = t_tb.run_filterbank_case(MulSpec(*spec), channels=4, n=1 << 11,
                                     backend="cuda", device=CPU)
    want_k = j_tb.run_filterbank_case(JSpec(*spec), channels=4, n=1 << 11,
                                      backend="pallas-interpret")
    assert got_k == want_k
