"""The port's ``FilterbankEngine`` against the JAX package's, bit for bit.

Mixed-length requests over two tap banks, served by both engines from
the same numpy signals; plus the degradation ladder (retry, bisection
quarantine, guard-tripped exact re-serve) on the port.
"""
from __future__ import annotations

import numpy as np
import pytest
from numpy.testing import assert_array_equal

from repro.core.guards import GuardConfig as JGuard
from repro.core.multipliers import MulSpec as JSpec
from repro.dsp.fir import design_lowpass
from repro.serve.engine import FilterbankEngine as JEngine
from repro_torch.core.guards import GuardConfig
from repro_torch.core.multipliers import MulSpec
from repro_torch.dsp.fir import fir_apply
from repro_torch.serve import FilterbankEngine

pytest_plugins = ["port_first"]

CPU = "cpu"
SPEC = ("bbm0", 16, 13)


def _banks():
    return np.stack([design_lowpass(), design_lowpass(stop_weight=0.5)])


def _requests(n: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(40, 600, n)
    return [(rng.standard_normal(int(m)) * rng.uniform(0.1, 4.0), i % 2)
            for i, m in enumerate(lens)]


def _serve(engine, reqs):
    rids = [engine.submit(s, bank=b) for s, b in reqs]
    out = engine.flush()
    return [out[r] for r in rids]


# jax backend of the reference -> the port's backend
_BACKENDS = {"host": "host", "pallas-interpret": "cuda"}


@pytest.mark.parametrize("spec,backend,form,max_channels", [
    (spec, backend, form, 4)
    for spec in (SPEC, ("bbm1", 16, 15), ("booth", 16, 0))
    for backend in ("host", "pallas-interpret")
    for form in (None, "rows", "dot")
] + [(SPEC, "host", None, 64), (SPEC, "pallas-interpret", None, 64)])
def test_engine_matches_reference(spec, backend, form, max_channels):
    if backend == "pallas-interpret" and form == "rows":
        # the reference's Pallas rows launch does not trace on the CPU
        # here; every form is bit-identical, so its dot form stands in
        j_form = "dot"
    else:
        j_form = form
    reqs = _requests(9, seed=max_channels)
    ref = JEngine(_banks(), JSpec(*spec), backend=backend,
                  max_channels=max_channels, form=j_form)
    eng = FilterbankEngine(_banks(), MulSpec(*spec),
                           backend=_BACKENDS[backend],
                           max_channels=max_channels, form=form, device=CPU)
    want, got = _serve(ref, reqs), _serve(eng, reqs)
    for (s, _), w, g in zip(reqs, want, got):
        assert g.shape == s.shape
        assert_array_equal(g, w)
    assert eng.stats == ref.stats
    assert not eng.failed


def test_engine_rejects_bad_arguments():
    with pytest.raises(ValueError, match="tap bank"):
        FilterbankEngine(_banks(), MulSpec(*SPEC), device=CPU).submit(
            np.ones(8), bank=2)
    with pytest.raises(ValueError, match="form"):
        FilterbankEngine(_banks(), MulSpec("kulkarni", 16, 4), form="dot",
                         device=CPU)
    with pytest.raises(ValueError):
        FilterbankEngine(_banks(), MulSpec(*SPEC), form="bogus", device=CPU)
    with pytest.raises(ValueError, match="backend"):
        FilterbankEngine(_banks(), MulSpec(*SPEC), backend="pallas",
                         device=CPU)


def _poisoned(engine, poison_sig):
    """Make the engine's dispatch raise on batches holding one signal."""
    inner = engine._apply

    def flaky(x, h, spec, **kw):
        for row in np.asarray(x):
            if len(poison_sig) <= len(row) and np.array_equal(
                    row[: len(poison_sig)], poison_sig):
                raise RuntimeError("injected poison")
        return inner(x, h, spec, **kw)

    engine._apply = flaky


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_poison_request_is_quarantined_by_bisection(backend):
    reqs = _requests(6, seed=3)
    eng = FilterbankEngine(_banks(), MulSpec(*SPEC), backend=backend,
                           max_channels=8, max_retries=1, device=CPU)
    _poisoned(eng, reqs[3][0])
    rids = [eng.submit(s, bank=b) for s, b in reqs]
    out = eng.flush()
    assert set(out) == set(rids) - {rids[3]}
    assert rids[3] in eng.failed and "poison" in eng.failed[rids[3]]
    assert eng.stats["quarantined"] == 1 and eng.stats["bisections"] >= 1
    assert not eng._pending and eng.flush() == {}
    # the neighbours are served exactly as a clean engine serves them
    clean = FilterbankEngine(_banks(), MulSpec(*SPEC), backend=backend,
                             device=CPU)
    healthy = [r for i, r in enumerate(reqs) if i != 3]
    for (i, rid), want in zip([(i, r) for i, r in enumerate(rids) if i != 3],
                              _serve(clean, healthy)):
        assert_array_equal(out[rid], want)


def test_transient_failure_saved_by_retry():
    eng = FilterbankEngine(_banks(), MulSpec(*SPEC), max_retries=2,
                           device=CPU)
    inner = eng._apply
    calls = {"n": 0}

    def transient(x, h, spec, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient blip")
        return inner(x, h, spec, **kw)

    eng._apply = transient
    rid = eng.submit(np.ones(64))
    assert rid in eng.flush() and not eng.failed
    assert eng.stats["retries"] == 1


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_guard_trip_reserves_exactly_like_reference(backend):
    """A zero error budget trips on every approximate channel; each comes
    back served by the exact Booth datapath, as the reference serves it."""
    reqs = _requests(3, seed=8)
    ref = JEngine(_banks(), JSpec(*SPEC), backend="host",
                  guard=JGuard(budget_abs=0.0, budget_every=1))
    eng = FilterbankEngine(_banks(), MulSpec(*SPEC), backend=backend,
                           guard=GuardConfig(budget_abs=0.0, budget_every=1),
                           device=CPU)
    want, got = _serve(ref, reqs), _serve(eng, reqs)
    for w, g in zip(want, got):
        assert_array_equal(g, w)
    assert eng.stats["guard_trips"] == eng.stats["exact_reserves"] == 3
    assert eng.stats == ref.stats
    for (s, b), g in zip(reqs, got):
        exact = fir_apply(s, _banks()[b], MulSpec("booth", 16, 0),
                          device=CPU)
        assert_array_equal(g, exact)


def test_guard_finite_trip_reserves_nonfinite_channel():
    eng = FilterbankEngine(_banks(), MulSpec(*SPEC), guard=GuardConfig(),
                           device=CPU)
    inner = eng._apply

    def nan_row(x, h, spec, **kw):
        y = np.array(inner(x, h, spec, **kw))
        if not spec.is_exact:
            y[1, 5] = np.nan
        return y

    eng._apply = nan_row
    reqs = _requests(3, seed=12)
    got = _serve(eng, reqs)
    assert eng.stats["guard_trips"] == 1 and eng.stats["exact_reserves"] == 1
    s, b = reqs[1]
    assert np.isfinite(got[1]).all()
    assert_array_equal(got[1], fir_apply(s[None, :], _banks()[[b]],
                                         MulSpec("booth", 16, 0),
                                         device=CPU)[0])
