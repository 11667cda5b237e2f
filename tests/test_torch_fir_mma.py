"""The FIR filterbank's tensor-core route against the JAX package.

At shift <= vbl every Broken-Booth tap product is ``2^vbl * M``, so the
tap sum is one contraction.  The kernel of ``csrc/fir_mma.cuh`` computes
it as a banded (Toeplitz) product of the x window and the taps' byte
planes, two int32 sums ``lo + 256 hi`` and, at kind 1, one constant per
channel for the truncated rows' ``-neg``.  ``fir_mma_emulated`` forms the
same byte planes, band, rows of 64 outputs, k steps over their live
columns and epilogue in plain PyTorch; here it must equal the
reference's dot form ``_fir_bank_dotform`` (both ``windowed`` settings)
and ``repro.dsp.fir_apply(backend="host")`` bit for bit: over wl 8/12/16,
vbl 5/13/15, both kinds, 5 and 31 taps, shifts 0 and the minimal safe
one, signals of 1 sample, shorter than the taps and at the edges of a
row and of a tile, zero and envelope-edge codes, faulted planes.  Also
the route rule's table, the private hooks that force a route, and the
bound ``chip_smoke.py`` charges.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core.multipliers import MulSpec as JSpec
from repro.dsp import fir as j_fir
from repro.kernels import booth_rows as j_rows
from repro.kernels import fir_kernel as j_fk
from repro_torch.core import faults as t_faults
from repro_torch.core.multipliers import MulSpec
from repro_torch.dsp import fir as t_fir
from repro_torch.kernels import booth_rows as t_rows
from repro_torch.kernels import fir_kernel as t_fk

pytest_plugins = ["port_first"]

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

GRID = [(wl, vbl) for wl in (8, 12, 16) for vbl in (5, 13, 15)]
# N = 1, shorter than the taps, one below, at and one past a row of 64
# outputs and a tile of 4,096 (the short flush's tile)
LENGTHS = [1, 20, 63, 64, 65, 4095, 4096, 4097]


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def _codes(wl: int, taps: int, seed: int, c: int = 3, n: int = 300):
    """Random wl-bit codes with the envelope's edge codes: x's most
    negative and largest in channel 0, a 111-triplet tap in every row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << wl, (c, n)).astype(np.int32)
    h = rng.integers(0, 1 << wl, (c, taps)).astype(np.int32)
    ext = [1 << (wl - 1), (1 << (wl - 1)) - 1, (1 << wl) - 1]
    x[0, :3] = ext[:n]
    h[0, 0] = (1 << wl) - 1
    h[-1, -1] = 1 << (wl - 1)
    return x, h


def _shifts(wl: int, vbl: int, taps: int):
    """0 where the envelope allows it, and the minimal safe shift."""
    lo = t_fk.min_safe_shift(taps, wl)
    return sorted({lo} | ({0} if lo == 0 else set()))


def _jax_dot(x, hm, hn, windowed: bool, **kw):
    return np.asarray(j_fk._fir_bank_dotform(
        jnp.asarray(x), jnp.asarray(hm), jnp.asarray(hn), windowed=windowed,
        **kw))


def _emulated(x, hm, hn, **kw):
    return t_fk.fir_mma_emulated(_t(x), _t(hm), _t(hn), **kw).numpy()


def _planes(h, wl):
    return tuple(np.asarray(p) for p in j_rows.booth_precode(jnp.asarray(h),
                                                             wl))


@pytest.mark.parametrize("taps", [5, 31])
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("wl,vbl", GRID)
def test_emulation_equals_reference_dot_form(wl, vbl, kind, taps):
    x, h = _codes(wl, taps, seed=wl * 100 + vbl * 2 + kind + taps)
    hm, hn = _planes(h, wl)
    for shift in _shifts(wl, vbl, taps):
        kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift)
        if t_fk.fir_bank_route(wl, vbl, kind, shift, taps) != "mma":
            # (16, 5): x and bq both two bytes wide; shift > vbl
            with pytest.raises(ValueError):
                _emulated(x, hm, hn, **kw)
            continue
        want = _jax_dot(x, hm, hn, True, **kw)
        assert_array_equal(_jax_dot(x, hm, hn, False, **kw), want)
        assert_array_equal(_emulated(x, hm, hn, **kw), want,
                           err_msg=f"shift={shift}")


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("n", LENGTHS)
def test_emulation_at_short_signals_and_tile_edges(n, kind):
    """fir30's operating point: kind 1's zero history counts too."""
    x, h = _codes(16, 31, seed=n + kind, c=2, n=n)
    hm, hn = _planes(h, 16)
    kw = dict(wl=16, vbl=13, kind=kind, shift=5)
    assert_array_equal(_emulated(x, hm, hn, **kw),
                       _jax_dot(x, hm, hn, False, **kw))


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("wl,vbl,shift", [(16, 13, 5), (12, 7, 0),
                                          (8, 5, 0)])
def test_emulation_at_zero_and_edge_codes(wl, vbl, shift, kind):
    """A zero signal gives 0 at kind 0 and, at kind 1, the channel's
    constant -sum neg_r << (vbl - shift) at every output; all-extreme
    signals against all-extreme taps stay exact."""
    rng = np.random.default_rng(wl)
    h = rng.integers(0, 1 << wl, (3, 31)).astype(np.int32)
    h[1] = 1 << (wl - 1)            # the most negative tap everywhere
    h[2] = (1 << wl) - 1            # -1: 111 triplets
    hm, hn = _planes(h, wl)
    kw = dict(wl=wl, vbl=vbl, kind=kind, shift=shift)
    zero = np.zeros((3, 100), np.int32)
    got = _emulated(zero, hm, hn, **kw)
    assert_array_equal(got, _jax_dot(zero, hm, hn, False, **kw))
    if kind == 0:
        assert not got.any()
    else:
        rows = t_rows.num_corr_rows(wl, vbl)
        const = -hn[:rows].sum(axis=(0, 2)) << (vbl - shift)
        assert_array_equal(got, np.broadcast_to(const[:, None], got.shape))
    for code in (1 << (wl - 1), (1 << (wl - 1)) - 1, (1 << wl) - 1):
        xx = np.full((3, 70), code, np.int32)
        assert_array_equal(_emulated(xx, hm, hn, **kw),
                           _jax_dot(xx, hm, hn, False, **kw),
                           err_msg=f"x={code}")


FAULTS = [dict(target="plane", model="flip", p=0.05, lane="all", seed=3),
          dict(target="plane", model="stuck1", p=0.2, lane="neg", seed=5),
          dict(target="plane", model="stuck0", p=0.2, lane="mag_hi",
               rows="corr", seed=9)]


@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("fault", FAULTS, ids=str)
def test_emulation_on_faulted_planes(fault, kind):
    """Planes that no code decodes to (any mag in {0, 1, 2}, neg in {0,
    1}), as the fault study's FIR curve sends them."""
    x, h = _codes(16, 31, seed=11, c=4, n=500)
    tm, tn = t_rows.booth_precode(_t(h), 16)
    fm, fn = t_faults.apply_plane_faults(tm, tn, t_faults.FaultSpec(**fault),
                                         vbl=13)
    assert not (torch.equal(fm, tm) and torch.equal(fn, tn))
    kw = dict(wl=16, vbl=13, kind=kind, shift=5)
    fm, fn = fm.numpy(), fn.numpy()
    assert_array_equal(_emulated(x, fm, fn, **kw),
                       _jax_dot(x, fm, fn, False, **kw))


@pytest.mark.parametrize("name,vbl", [("bbm0", 13), ("bbm1", 15),
                                      ("bbm0", 15)])
def test_fir_apply_through_the_emulation_equals_the_host_path(name, vbl,
                                                              monkeypatch):
    """The port's kernel path of ``fir_apply`` with the emulation in the
    kernels' place, against the reference's host datapath."""
    rng = np.random.default_rng(vbl)
    x = rng.standard_normal((3, 700)) * np.array([[1.0], [0.3], [2.0]])
    h = np.stack([j_fir.design_lowpass(),
                  j_fir.design_lowpass(stop_weight=0.5)])[[0, 1, 0]]
    kind = {"bbm0": 0, "bbm1": 1}[name]

    def emulated(xc, hm, hn, *, wl, vbl, kind, shift, form=None):
        return t_fk.fir_mma_emulated(xc, hm, hn, wl=wl, vbl=vbl, kind=kind,
                                     shift=shift)

    monkeypatch.setattr(t_fir, "fir_bbm_bank_precoded", emulated)
    got = t_fir.fir_apply(x, h, MulSpec(name, 16, vbl), backend="cuda",
                          device="cpu")
    want = j_fir.fir_apply(x, h, JSpec(name, 16, vbl), backend="host")
    assert kind in (0, 1)
    assert_array_equal(got, want)


def test_route_rule_table():
    """The tensor cores at fir30's points and wherever shift <= vbl and
    the bytes and the band fit; the CUDA-core kernels at shift > vbl, at
    exact Booth's two-byte x and bq, and for a band too large."""
    for kind in (0, 1):
        assert t_fk.fir_bank_route(16, 13, kind, 5, 31) == "mma"
        assert t_fk.fir_bank_route(16, 15, kind, 5, 31) == "mma"
        assert t_fk.fir_bank_route(16, 13, kind, 13, 31) == "mma"
        assert t_fk.fir_bank_route(16, 13, kind, 14, 31) == "cuda-core"
        assert t_fk.fir_bank_route(16, 0, kind, 5, 31) == "cuda-core"
        assert t_fk.fir_bank_route(16, 5, kind, 5, 31) == "cuda-core"
        assert t_fk.fir_bank_route(8, 0, kind, 0, 31) == "mma"
        assert t_fk.fir_bank_route(16, 13, kind, 5, 33) == "mma"
        assert t_fk.fir_bank_route(16, 13, kind, 5, 400) == "cuda-core"
    # the band's shared memory: 3 k steps of 29 planes at kind 0 (15 at
    # kind 1) and the staged x of one 64-row group
    assert t_fk.fir_mma_band(31) == (32, 3, [(0, 32), (0, 64), (32, 64)])
    assert t_fk.fir_mma_smem(16, 13, 0, 31) == 3 * 29 * 2048 + 10400
    assert t_fk.fir_mma_smem(16, 13, 1, 31) == 3 * 15 * 2048 + 10400
    with pytest.raises(ValueError, match="kind"):
        t_fk.fir_bank_route(16, 13, 2, 5, 31)


def test_forced_route_is_checked_on_any_device():
    """A route forced through the private hooks that the tensor cores
    cannot compute raises, on CPU tensors too; an unknown route raises;
    the plain version runs on the CPU whatever route is named, counting
    no launch.  The public wrappers take no route."""
    x, h = _codes(16, 31, seed=1, c=2, n=40)
    hm, hn = t_rows.booth_precode(_t(h), 16)
    xt = _t(x)
    with pytest.raises(ValueError, match="no contraction form"):
        t_fk._fir_bank_rows_on("mma", xt, hm, hn, wl=16, vbl=13, shift=14)
    with pytest.raises(ValueError, match="third significance"):
        t_fk._fir_bank_dot_on("mma", xt, hm, hn, wl=16, vbl=5, shift=5)
    with pytest.raises(ValueError, match="unknown route"):
        t_fk._fir_bank_dot_on("wgmma", xt, hm, hn, wl=16, vbl=13, shift=5)
    for public in (t_fk.fir_bank_rows, t_fk.fir_bank_dot):
        with pytest.raises(TypeError, match="route"):
            public(xt, hm, hn, wl=16, vbl=13, shift=5, route="mma")
    counts = [(f.launches, f.mma_launches)
              for f in (t_fk.fir_bank_rows, t_fk.fir_bank_dot)]
    kw = dict(wl=16, vbl=13, kind=1, shift=5)
    want = t_fk.fir_bank_rows_plain(xt, hm, hn, **kw)
    for route in (None, "mma", "cuda-core"):
        for hook in (t_fk._fir_bank_rows_on, t_fk._fir_bank_dot_on):
            assert torch.equal(hook(route, xt, hm, hn, **kw), want)
    assert counts == [(f.launches, f.mma_launches)
                      for f in (t_fk.fir_bank_rows, t_fk.fir_bank_dot)]


def test_bound_counts_the_banded_contraction():
    """``chip_smoke.py``'s FIR bound: at shift <= vbl the contracted dot
    form's fewest int8 byte products (34 a tap product at kind 0, 21 at
    kind 1) at 2 operations each over 1,979 TOP/s, against x read once,
    y written once and the planes read once over 3.35 TB/s: bound by the
    bytes at both flushes, 0.010054 ms at flush A's (64, 65536) x 31 taps
    and 0.000318 ms at flush B's (16, 8073).  At shift > vbl the int32
    count of each CUDA-core kernel stays."""
    a = chip_smoke.fir_bound_ms("fir_bank_rows", 64, 65536, 31, wl=16,
                                vbl=13, kind=0, shift=5)
    assert a[1] == "bytes" and round(a[0], 6) == 0.010054
    assert round(a[2], 6) == 0.004468            # the products alone
    b = chip_smoke.fir_bound_ms("fir_bank_dot", 16, 8073, 31, wl=16, vbl=13,
                                kind=0, shift=5)
    assert b[1] == "bytes" and round(b[0], 6) == 0.000318
    assert round(b[2], 6) == 0.000138
    k1 = chip_smoke.fir_bound_ms("fir_bank_rows", 64, 65536, 31, wl=16,
                                 vbl=13, kind=1, shift=5)
    assert k1[0] == a[0] and k1[2] < a[2]
    for name, rows in (("fir_bank_rows", 8), ("fir_bank_dot", 8)):
        floor = chip_smoke.fir_bound_ms(name, 64, 65536, 31, wl=16, vbl=13,
                                        kind=0, shift=15)
        ops_ms = 64 * 65536 * 31 * rows / chip_smoke.INT32_OPS_PER_S * 1e3
        assert floor[1] == "operations" and floor[0] == pytest.approx(ops_ms)
