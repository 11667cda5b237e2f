"""Keyed fault injection in the port against the JAX package, bit for bit.

The reference draws every fault mask with ``jax.random.bernoulli`` on a
key folded from the spec's seed; the port draws the same bits with
``core.prng`` (threefry2x32 on the flat index).  So the masks, the
faulted digit planes, the faulted accumulators, the faulted datapath
(``bbm_matmul_dynamic(fault=)``), its scalar oracle (``amm_faulty_ref``)
and the faulted FIR bank must equal the reference exactly, at the
settings of ``benchmarks/robustness.py`` (its gate, its matmul curves,
its FIR curve at a small n).
"""
from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.core import faults as j_faults
from repro.core.multipliers import MulSpec as JSpec
from repro.dsp import fir as j_fir
from repro.kernels import booth_rows as j_rows
from repro.kernels import ref as j_ref
from repro.kernels.bbm_matmul import bbm_matmul_dynamic as j_dynamic
from repro_torch.core import faults as t_faults
from repro_torch.core import prng
from repro_torch.core.multipliers import MulSpec as TSpec
from repro_torch.dsp import fir as t_fir
from repro_torch.kernels import booth_rows as t_rows
from repro_torch.kernels import ref as t_ref
from repro_torch.kernels.bbm_matmul import bbm_matmul_dynamic as t_dynamic
from repro_torch.serve import FilterbankEngine

pytest_plugins = ["port_first"]

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "robustness_bench", ROOT / "benchmarks/robustness.py")
rob = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rob)

SHAPES = [(), (7,), (3, 70, 8)]
CHAINS = [(), (17, 2), (23, 0), (23, 69), (1, 2, 3)]
SEEDS = [0, 3, 11, 2 ** 31 - 1]

# tests/test_faults.py's sweep and fault list
SWEEP = [("bbm0", 8, 5), ("bbm1", 8, 7), ("bbm0", 12, 7),
         ("bbm1", 12, 11), ("bbm0", 16, 13), ("bbm1", 16, 15),
         ("bbm0", 16, 3), ("booth", 16, 0)]
FAULTS = [
    dict(target="plane", model="flip", p=0.05, lane="all", seed=3),
    dict(target="plane", model="stuck1", p=0.07, lane="mag_lo", seed=5),
    dict(target="plane", model="stuck0", p=0.2, lane="neg", rows="corr",
         seed=9),
    dict(target="acc", model="flip", p=0.25, bit=11, seed=7),
]
# benchmarks/robustness.py: gate_fault_equality's four faults
GATE = [None,
        dict(target="plane", model="flip", p=0.05, seed=3),
        dict(target="plane", model="stuck1", p=0.05, lane="mag_lo", seed=5),
        dict(target="acc", model="flip", p=0.3, bit=10, seed=9)]


def _keys(seed, chain):
    jk, tk = jax.random.key(seed), prng.key(seed)
    for f in chain:
        jk, tk = jax.random.fold_in(jk, f), prng.fold_in(tk, f)
    return jk, tk


def _pair(kw):
    if kw is None:
        return None, None
    return j_faults.FaultSpec(**kw), t_faults.FaultSpec(**kw)


def _kind(mul):
    return {"booth": 0, "bbm0": 0, "bbm1": 1}[mul]


# ------------------------------------------------------------ the draws
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("p", [0.0, 0.05, 0.3, 1.0])
def test_bernoulli_matches_jax(shape, p):
    for seed in SEEDS:
        for chain in CHAINS:
            jk, tk = _keys(seed, chain)
            got = prng.bernoulli(tk, p, shape, device="cpu")
            assert got.dtype == torch.bool and tuple(got.shape) == shape
            assert_array_equal(got.numpy(), np.asarray(
                jax.random.bernoulli(jk, p, shape)), err_msg=f"{seed} {chain}")


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_and_bits_match_jax(shape):
    for seed in SEEDS:
        for chain in CHAINS:
            jk, tk = _keys(seed, chain)
            u = prng.uniform(tk, shape, device="cpu")
            assert u.dtype == torch.float32
            assert_array_equal(u.numpy(), np.asarray(
                jax.random.uniform(jk, shape)))
            bits = prng.random_bits(tk, shape, device="cpu")
            assert_array_equal(bits.numpy(), np.asarray(
                jax.random.bits(jk, shape, jnp.uint32)).astype(np.int64))


def test_fault_spec_validates_as_the_reference():
    bad = [dict(target="wire"), dict(model="flaky"), dict(lane="sign"),
           dict(rows="some"), dict(p=-0.1), dict(p=1.5), dict(bit=31),
           dict(bit=-1)]
    for kw in bad:
        with pytest.raises(ValueError):
            j_faults.FaultSpec(**kw)
        with pytest.raises(ValueError):
            t_faults.FaultSpec(**kw)
    spec = t_faults.FaultSpec(p=0.1, seed=4)
    assert spec.enabled and not t_faults.FaultSpec().enabled
    assert hash(spec) == hash(t_faults.FaultSpec(p=0.1, seed=4))
    with pytest.raises(dataclasses.FrozenInstanceError):
        spec.p = 0.2
    assert [f.name for f in dataclasses.fields(t_faults.FaultSpec)] == \
        [f.name for f in dataclasses.fields(j_faults.FaultSpec)]


# --------------------------------------------------- planes and sums
def _planes(wl=16, k=40, n=6, seed=0):
    codes = np.random.default_rng(seed).integers(0, 1 << wl, (k, n)).astype(
        np.int32)
    codes[0, 0] = (1 << wl) - 1          # 111 triplets: negative zero rows
    return (j_rows.booth_precode(jnp.asarray(codes), wl),
            t_rows.booth_precode(torch.from_numpy(codes), wl))


@pytest.mark.parametrize("lane", ["mag_lo", "mag_hi", "neg", "all"])
@pytest.mark.parametrize("model", ["flip", "stuck0", "stuck1"])
@pytest.mark.parametrize("rows", ["all", "corr"])
def test_apply_plane_faults_matches_jax(lane, model, rows):
    (jm, jn), (tm, tn) = _planes()
    for p, seed, vbl in ((0.3, 1, 13), (0.05, 6, 5), (1.0, 2, 0)):
        jf, tf = _pair(dict(target="plane", model=model, p=p, lane=lane,
                            rows=rows, seed=seed))
        want = j_faults.apply_plane_faults(jm, jn, jf, vbl=vbl)
        got = t_faults.apply_plane_faults(tm, tn, tf, vbl=vbl)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[0].max()) <= 2 and int(got[1].max()) <= 1
    for spec in (None, t_faults.FaultSpec(), t_faults.FaultSpec(
            target="acc", p=0.5)):
        same = t_faults.apply_plane_faults(tm, tn, spec, vbl=13)
        assert same[0] is tm and same[1] is tn


@pytest.mark.parametrize("chunk_idx", [0, 1, 5])
@pytest.mark.parametrize("bit", [0, 10, 30])
def test_apply_acc_fault_matches_jax(chunk_idx, bit):
    acc = np.random.default_rng(bit).integers(-2 ** 31, 2 ** 31, (9, 13),
                                              dtype=np.int64).astype(np.int32)
    jf, tf = _pair(dict(target="acc", p=0.4, bit=bit, seed=8))
    want = j_faults.apply_acc_fault(jnp.asarray(acc), jf, chunk_idx)
    got = t_faults.apply_acc_fault(torch.from_numpy(acc), tf, chunk_idx)
    assert got.dtype == torch.int32
    assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != acc).any()
    jk = jax.random.fold_in(jax.random.fold_in(jax.random.key(8), 23),
                            chunk_idx)
    assert_array_equal(t_faults.acc_fault_keys(tf, chunk_idx + 1)[chunk_idx],
                       np.asarray(jax.random.key_data(jk)))
    plane = t_faults.FaultSpec(p=0.4)
    assert_array_equal(t_faults.apply_acc_fault(torch.from_numpy(acc), plane)
                       .numpy(), acc)


@pytest.mark.parametrize("wl,vbl", [(8, 5), (12, 7), (16, 13), (16, 0)])
def test_booth_precode_faulty_matches_jax(wl, vbl):
    codes = np.random.default_rng(wl).integers(0, 1 << wl, (30, 9)).astype(
        np.int32)
    for kw in FAULTS + [None]:
        jf, tf = _pair(kw)
        want = j_rows.booth_precode_faulty(jnp.asarray(codes), wl, jf,
                                           vbl=vbl)
        got = t_rows.booth_precode_faulty(torch.from_numpy(codes), wl, tf,
                                          vbl=vbl)
        for g, w in zip(got, want):
            assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------- the faulted datapath
def _operands(m=4, k=70, n=8, seed=17):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_amm_faulty_ref_matches_jax(mul, wl, vbl):
    x, w = _operands()
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for kw in FAULTS + [None]:
        jf, tf = _pair(kw)
        want = np.asarray(j_ref.amm_faulty_ref(x, w, JSpec(mul, wl, vbl),
                                               fault=jf))
        got = t_ref.amm_faulty_ref(tx, tw, TSpec(mul, wl, vbl), fault=tf)
        assert_array_equal(got.numpy(), want, err_msg=str(kw))
        v = 0 if mul == "booth" else vbl
        dyn = t_dynamic(tx, tw, wl=wl, vbl=v, kind=_kind(mul), fault=tf)
        assert_array_equal(dyn.numpy(), want, err_msg=str(kw))


@pytest.mark.parametrize("spec", rob.SPECS, ids=str)
@pytest.mark.parametrize("gate", range(len(GATE)))
def test_dynamic_at_the_robustness_gate_matches_jax(spec, gate):
    """``gate_fault_equality``'s operands and faults: the port's faulted
    datapath equals the reference's and the port's oracle; the disabled
    spec equals the unfaulted datapath."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 70)).astype(np.float32)
    w = rng.standard_normal((70, 8)).astype(np.float32)
    vbl = 0 if spec.name == "booth" else spec.param
    jf, tf = _pair(GATE[gate])
    want = np.asarray(j_dynamic(x, w, wl=spec.wl, vbl=vbl, kind=0,
                                fault=jf))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    got = t_dynamic(tx, tw, wl=spec.wl, vbl=vbl, kind=0, fault=tf).numpy()
    assert_array_equal(got, want)
    tspec = TSpec(spec.name, spec.wl, spec.param)
    assert_array_equal(got, t_ref.amm_faulty_ref(tx, tw, tspec,
                                                 fault=tf).numpy())
    if tf is None:
        assert_array_equal(got, t_ref.amm_approx_ref(tx, tw, tspec).numpy())
        for off in (t_faults.FaultSpec(), t_faults.FaultSpec(target="acc")):
            assert_array_equal(t_dynamic(tx, tw, wl=spec.wl, vbl=vbl, kind=0,
                                         fault=off).numpy(), got)


@pytest.mark.parametrize("spec", rob.SPECS, ids=str)
@pytest.mark.parametrize("target", ["plane", "acc"])
def test_matmul_resilience_curve_matches_jax(spec, target):
    """``matmul_resilience``'s settings (m = n = 32, the smoke run's
    K = 70, seed 11, every rate): each faulted product and each relative
    error equal the reference's."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 70)).astype(np.float32)
    w = rng.standard_normal((70, 32)).astype(np.float32)
    exact = x @ w
    vbl = 0 if spec.name == "booth" else spec.param
    kw = {"lane": "all"} if target == "plane" else {"bit": 12}
    curves = ([], [])
    for p in rob.FAULT_RATES:
        jf, tf = _pair(dict(target=target, model="flip", p=p, seed=11, **kw)
                       if p else None)
        want = np.asarray(j_dynamic(x, w, wl=spec.wl, vbl=vbl, kind=0,
                                    fault=jf))
        got = t_dynamic(torch.from_numpy(x), torch.from_numpy(w), wl=spec.wl,
                        vbl=vbl, kind=0, fault=tf).numpy()
        assert_array_equal(got, want, err_msg=f"p={p}")
        for curve, y in zip(curves, (want, got)):
            curve.append(float(np.linalg.norm(y - exact)
                               / np.linalg.norm(exact)))
    assert curves[0] == curves[1]
    assert curves[1][-1] > curves[1][0]


# ---------------------------------------------------- the faulted bank
@pytest.mark.parametrize("spec", rob.SPECS, ids=str)
@pytest.mark.parametrize("p", [1e-3, 1e-1])
def test_faulted_bank_fir_matches_jax(spec, p):
    """The FIR half of the fault study: a ``PrecodedBank`` whose cached
    planes carry the faults (as ``robustness._faulted_bank`` builds one)
    filters the testbed signals exactly as the reference's, through
    ``fir_apply`` and through the engine."""
    from repro.dsp.testbed import make_filterbank_signals
    channels, n = 4, 1 << 9
    sigs = make_filterbank_signals(channels, n=n)
    h_banks = np.stack([j_fir.design_lowpass(),
                        j_fir.design_lowpass(stop_weight=0.5)])
    x = np.stack([s.x for s in sigs])
    idx = [c % 2 for c in range(channels)]
    kw = dict(target="plane", model="flip", p=p, lane="all", seed=7)
    jf, tf = _pair(kw)
    want = np.asarray(j_fir.fir_apply(
        x, rob._faulted_bank(h_banks, spec, jf).take(idx), backend="host",
        form="dot"))
    tspec = TSpec(spec.name, spec.wl, spec.param)
    vbl = 0 if spec.name == "booth" else spec.param
    bank = t_fir.PrecodedBank(h_banks, tspec, device="cpu")
    bank._planes = t_faults.apply_plane_faults(*bank.planes, tf, vbl=vbl)
    got = t_fir.fir_apply(x, bank.take(idx), backend="host", form="dot",
                          device="cpu")
    assert_array_equal(got, want)
    clean = t_fir.fir_apply(x, h_banks[idx], tspec, backend="host",
                            device="cpu")
    assert (got != clean).any()
    eng = FilterbankEngine(h_banks, tspec, device="cpu")
    eng.bank._planes = bank._planes
    rids = [eng.submit(x[c], bank=idx[c]) for c in range(channels)]
    out = eng.flush()
    for c, rid in enumerate(rids):
        assert_array_equal(out[rid], want[c])
