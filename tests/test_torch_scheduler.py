"""The port's ``Scheduler`` against the JAX package's, and its own
scheduling policy.

Parity: ``reduced(qwen2-0.5b)`` in the served noise setting (bbm0, WL 16,
VBL 13, the fused kernel), the reference's weights carried across, the
same arrival schedule through both schedulers in flush and continuous
mode.  The reference runs the bodies of its ``make_serve_fns`` under a plain
``jax.jit`` (its sharded ``make_serve_fns`` raises ``ShardingTypeError``
under jax 0.9.0: ROADMAP C7) and records every call's
logits; the port is then teacher-forced: each of its calls is
compared with the reference's call of the same index and hands the
reference's logits on, so both schedulers take the same tokens.  The
logits are held to 2^-6 of their largest magnitude (the bf16 residual
stream; see ``tests/test_torch_lm.py``), the port's own greedy token
must equal the reference's wherever the reference's top-2 gap exceeds
twice that, and the two ``stats`` dicts must be equal.

Policy: copies of ``tests/test_serve_continuous.py``'s FIFO,
poison-recycle, deadline and near-cap tests, on the port alone, in noise
mode (the reference runs them in bitexact attention mode with the
int-code cache; ``tests/test_torch_serve_bitexact.py`` ports them in that
mode).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get
from repro.configs import reduced as j_reduced
from repro.configs.base import AmmConfig as JAmm
from repro.models import ModelRuntime as JRT
from repro.models import lm_apply as j_apply
from repro.models import lm_init as j_init
from repro.serve import engine as j_engine
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import ModelRuntime as TRT
from repro_torch.serve import engine as t_engine

pytest_plugins = ["port_first"]

AMM = dict(mode="noise", mul="bbm0", wl=16, param=13, use_pallas=True)
SLOTS = 3
MAX_LEN = 24
LOGIT_RTOL = 2.0 ** -6
# (step, prompt, max_new): prompts of two lengths only, so the reference
# compiles two prefill programs
ARRIVALS = [(0, [5, 9, 2], 4), (0, [7, 1, 3, 8, 4, 6], 3),
            (1, [11, 12, 13], 2), (2, [3, 3, 3, 3, 3, 3], 5),
            (4, [2, 4, 6], 3)]


def _drive(sched, request_cls, arrivals=ARRIVALS, cap=200):
    reqs, t, idx = [], 0, 0
    while True:
        while idx < len(arrivals) and arrivals[idx][0] <= t:
            _, prompt, max_new = arrivals[idx]
            reqs.append(request_cls(rid=idx, prompt=list(prompt),
                                    max_new=max_new))
            sched.submit(reqs[-1])
            idx += 1
        n = sched.step()
        t += 1
        if n == 0 and idx >= len(arrivals) and not sched.queue:
            return reqs
        assert t < cap, "the scheduler failed to terminate"


@pytest.fixture(scope="module")
def lm():
    j_cfg = dataclasses.replace(j_reduced(j_get("qwen2-0.5b")),
                                amm=JAmm(**AMM))
    t_cfg = dataclasses.replace(t_reduced(t_get("qwen2-0.5b")),
                                amm=TAmm(**AMM))
    jp = j_init(j_cfg, jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return j_cfg, jp, t_cfg, tp


@pytest.fixture(scope="module")
def reference_runs(lm):
    """The reference's schedulers, every call recorded: {continuous: (log,
    requests, stats)}."""
    j_cfg, jp, _, _ = lm
    rt = JRT.build(j_cfg)

    @jax.jit
    def prefill_j(p, t, c):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=jnp.int32(0))
        return logits[:, -1], c

    @jax.jit
    def decode_j(p, t, c, q):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=q)
        return logits[:, -1], c
    runs = {}
    for continuous in (False, True):
        log = []

        def prefill(p, t, c):
            logits, c = prefill_j(p, t, c)
            log.append(("prefill", np.asarray(logits)))
            return logits, c

        def decode(p, t, c, q):
            logits, c = decode_j(p, t, c, q)
            log.append(("decode", np.asarray(logits)))
            return logits, c
        sched = j_engine.Scheduler(
            j_cfg, rt, jp, SLOTS, MAX_LEN, decode_fn=decode,
            prefill_fn=prefill if continuous else None,
            continuous=continuous)
        reqs = _drive(sched, j_engine.Request)
        runs[continuous] = (log, reqs, dict(sched.stats))
    return runs


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["flush", "continuous"])
def test_teacher_forced_against_the_reference(lm, reference_runs,
                                              continuous):
    _, _, t_cfg, tp = lm
    log, j_reqs, j_stats = reference_runs[continuous]
    rt = TRT.build(t_cfg, device="cpu")
    prefill_t, decode_t = t_engine.make_serve_fns(t_cfg, rt)
    state = {"i": 0, "clear": 0}

    def forced(kind, logits):
        want_kind, want = log[state["i"]]
        state["i"] += 1
        assert kind == want_kind
        got = logits.numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= LOGIT_RTOL * scale
        top2 = np.sort(want, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * LOGIT_RTOL * scale
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()
        state["clear"] += int(clear.sum())
        return torch.from_numpy(want.copy())

    def prefill(p, t, c):
        logits, c = prefill_t(p, t, c)
        return forced("prefill", logits), c

    def decode(p, t, c, q):
        logits, c = decode_t(p, t, c, q)
        return forced("decode", logits), c
    sched = t_engine.Scheduler(t_cfg, rt, tp, SLOTS, MAX_LEN,
                               decode_fn=decode,
                               prefill_fn=prefill if continuous else None,
                               continuous=continuous, device="cpu")
    reqs = _drive(sched, t_engine.Request)
    assert state["i"] == len(log)
    assert state["clear"] > len(log)          # most rows are decided
    assert sched.stats == j_stats
    assert [(r.out, r.done, r.error) for r in reqs] \
        == [(r.out, r.done, r.error) for r in j_reqs]


# ------------------------------------------------- the port's own policy
def _sched(lm, slots=SLOTS, **kw):
    _, _, t_cfg, tp = lm
    return t_engine.Scheduler(t_cfg, TRT.build(t_cfg, device="cpu"), tp,
                              slots, MAX_LEN,
                              continuous=True, device="cpu", **kw)


def _drain(sched, cap=300):
    steps = 0
    while sched.step():
        steps += 1
        assert steps < cap, "the scheduler failed to terminate"
    return steps


def _solo_stream(lm, prompt, max_new):
    sched = _sched(lm)
    req = t_engine.Request(rid=0, prompt=list(prompt), max_new=max_new)
    sched.submit(req)
    _drain(sched)
    assert req.done and req.error is None
    return req.out


def test_fifo_admission_under_slot_contention(lm):
    sched = _sched(lm, slots=1)
    reqs = [t_engine.Request(rid=i, prompt=[i + 1], max_new=2)
            for i in range(3)]
    for r in reqs:
        sched.submit(r)
    done_order, first_tok_order = [], []
    while sched.step() or sched.queue:
        for r in reqs:
            if r.out and r.rid not in first_tok_order:
                first_tok_order.append(r.rid)
            if r.done and r.rid not in done_order:
                done_order.append(r.rid)
    assert first_tok_order == [0, 1, 2]
    assert done_order == [0, 1, 2]


def test_slot_recycled_after_midstream_poison(lm):
    """A mid-stream decode failure frees its slot and never leaks: the
    neighbour finishes, and a later request served by the recycled slot
    gets the bits a fresh scheduler gives it."""
    sched = _sched(lm, slots=2, max_retries=1)
    inner = sched._default_fn
    state = {"calls": 0}

    def fn(p, t, c, q):
        state["calls"] += 1
        # call 3 fails, call 4 exhausts the retry, call 5 is the slot-0
        # probe reproducing it -> slot 0 is the poison
        if 3 <= state["calls"] <= 5:
            raise RuntimeError("mid-stream fault")
        return inner(p, t, c, q)

    sched.decode_fn = fn
    first = t_engine.Request(rid=0, prompt=[1, 2], max_new=8)
    second = t_engine.Request(rid=1, prompt=[3], max_new=3)
    sched.submit(first)
    sched.submit(second)
    _drain(sched)
    assert first.done and first.error and "fault" in first.error
    assert second.done and second.error is None and len(second.out) == 3
    assert sched.stats["failed"] == 1 and sched.stats["probes"] >= 1
    assert all(s is None for s in sched.slots)
    assert (sched.pos == 0).all()
    late = t_engine.Request(rid=2, prompt=[5, 6], max_new=2)
    sched.submit(late)
    _drain(sched)
    assert late.done and late.error is None
    assert late.out == _solo_stream(lm, [5, 6], 2)


def test_deadline_evicts_in_continuous_mode(lm):
    sched = _sched(lm)
    req = t_engine.Request(rid=0, prompt=[1, 2], max_new=20, deadline=3)
    sched.submit(req)
    _drain(sched)
    assert req.done and req.error == "deadline"
    assert sched.stats["deadline_expired"] == 1
    assert all(s is None for s in sched.slots)


def test_prompt_near_cap_terminates(lm):
    sched = _sched(lm)
    req = t_engine.Request(rid=0, prompt=list(range(1, MAX_LEN - 1)),
                           max_new=8)
    sched.submit(req)
    _drain(sched)
    assert req.done and req.error is None and 1 <= len(req.out) <= 8


def test_guard_reserves_on_the_exact_datapath(lm):
    """A guard trip re-serves the request on mode "off"; its stream is
    then the exact model's greedy stream."""
    from repro_torch.core.guards import GuardConfig
    sched = _sched(lm, guard=GuardConfig(budget_abs=0.0, budget_every=1))
    req = t_engine.Request(rid=0, prompt=[4, 5], max_new=3)
    sched.submit(req)
    _drain(sched)
    assert req.exact and req.done and len(req.out) == 3
    assert sched.stats["guard_trips"] == sched.stats["exact_reserves"] == 1


def test_unported_options_raise(lm):
    # noise mode has no attention lowering for the int-code cache to feed
    with pytest.raises(ValueError, match="attention lowering"):
        _sched(lm, kv_codes=True)
    with pytest.raises(ValueError, match="max_new"):
        _sched(lm).submit(t_engine.Request(rid=0, prompt=[1], max_new=0))
    with pytest.raises(ValueError, match="max_len"):
        _sched(lm).submit(t_engine.Request(
            rid=0, prompt=list(range(MAX_LEN)), max_new=1))
