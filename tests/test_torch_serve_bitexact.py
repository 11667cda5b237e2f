"""Bitexact serving on the port: the ``Scheduler`` with the int-code KV
cache, against the JAX package's and against its own solo runs.

Parity: ``reduced(qwen2-0.5b)`` with bbm0 at WL 16 / VBL 13 and
``kv_codes=True`` under ``apply_to`` "attn" and "all", the reference's
weights carried across, the same arrival schedule through both continuous
schedulers.  The reference runs the bodies of its ``make_serve_fns`` under
a plain ``jax.jit`` (its sharded ``make_serve_fns`` raises under jax 0.9.0:
ROADMAP C7), the weight planes baked in as its launcher does; the port is
teacher-forced on the reference's logits, as in
``tests/test_torch_scheduler.py``, and held to the same tolerance: 2^-6 of
the logits' largest magnitude (the bf16 residual stream; a residual
element the two frameworks round apart moves a quantized activation by
one code, which the next product spreads no further than a rounding of
the residual itself), the greedy token equal wherever the reference's
top-2 gap exceeds twice that, and equal ``stats``.

Policy: the port of ``tests/test_serve_continuous.py`` on the port alone
(WL 8 / VBL 5, ``apply_to="attn"``): every request's stream bit-equal to
its solo run under random interleavings (code cache and float cache),
FIFO admission, a resident decoding every step while prompts queue, slot
recycling after a mid-stream poison, deadline eviction, a prompt near the
cap, the code cache's dtype and bytes, the ``Scheduler``'s two kv_codes
refusals; and the launcher's flag rules.
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
from repro.models import lm_amm_planes as j_planes
from repro.models import lm_apply as j_apply
from repro.models import lm_init as j_init
from repro.serve import engine as j_engine
from repro.serve import kv_cache as j_kv
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.guards import GuardConfig
from repro_torch.launch import serve as t_launch
from repro_torch.models import ModelRuntime as TRT
from repro_torch.serve import engine as t_engine
from repro_torch.serve import kv_cache as t_kv

pytest_plugins = ["port_first"]

LOGIT_RTOL = 2.0 ** -6
PARITY_SLOTS, PARITY_LEN = 3, 32
# (step, prompt, max_new): prompts of two lengths only, so the reference
# compiles two prefill programs
ARRIVALS = [(0, [5, 9, 2], 4), (0, [7, 1, 3, 8, 4, 6], 3),
            (1, [11, 12, 13], 2), (2, [3, 3, 3, 3, 3, 3], 5),
            (4, [2, 4, 6], 3)]
WL, VBL = 8, 5
SLOTS = 3
MAX_LEN = 2 * t_kv.KV_BLOCK


def _configs(amm):
    j_cfg = dataclasses.replace(j_reduced(j_get("qwen2-0.5b")),
                                amm=JAmm(**amm))
    t_cfg = dataclasses.replace(t_reduced(t_get("qwen2-0.5b")),
                                amm=TAmm(**amm))
    return j_cfg, t_cfg


def _drive(sched, request_cls, arrivals, cap=500):
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
            return sched, reqs
        assert t < cap, "the scheduler failed to terminate"


# ------------------------------------------------- parity, teacher-forced
@pytest.fixture(scope="module")
def params():
    j_cfg, _ = _configs(dict(mode="bitexact", mul="bbm0", wl=16, param=13))
    jp = j_init(j_cfg, jax.random.key(0))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                    device="cpu")


def _reference_run(jp, j_cfg):
    """The reference's continuous scheduler with the int-code cache,
    every call's logits recorded."""
    rt = JRT.build(j_cfg)
    planes = j_planes(j_cfg, rt.amm, jp)

    @jax.jit
    def prefill_j(p, t, c):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=jnp.int32(0), amm_planes=planes)
        return logits[:, -1], c

    @jax.jit
    def decode_j(p, t, c, q):
        logits, _, c = j_apply(p, j_cfg, rt, t, mode="decode", caches=c,
                               pos=q, amm_planes=planes)
        return logits[:, -1], c
    log = []

    def prefill(p, t, c):
        logits, c = prefill_j(p, t, c)
        log.append(("prefill", np.asarray(logits)))
        return logits, c

    def decode(p, t, c, q):
        logits, c = decode_j(p, t, c, q)
        log.append(("decode", np.asarray(logits)))
        return logits, c
    sched = j_engine.Scheduler(j_cfg, rt, jp, PARITY_SLOTS, PARITY_LEN,
                               decode_fn=decode, prefill_fn=prefill,
                               continuous=True, kv_codes=True)
    sched, reqs = _drive(sched, j_engine.Request, ARRIVALS)
    return log, reqs, dict(sched.stats)


@pytest.mark.parametrize("apply_to", ["attn", "all"])
def test_teacher_forced_against_the_reference(params, apply_to):
    jp, tp = params
    j_cfg, t_cfg = _configs(dict(mode="bitexact", mul="bbm0", wl=16,
                                 param=13, apply_to=apply_to))
    log, j_reqs, j_stats = _reference_run(jp, j_cfg)
    rt = TRT.build(t_cfg)
    planes = rt.build_planes(t_cfg, tp)
    assert (planes is None) == (apply_to == "attn")
    prefill_t, decode_t = t_engine.make_serve_fns(t_cfg, rt,
                                                  amm_planes=planes,
                                                  kv_codes=True)
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
    sched = t_engine.Scheduler(t_cfg, rt, tp, PARITY_SLOTS, PARITY_LEN,
                               decode_fn=decode, prefill_fn=prefill,
                               continuous=True, kv_codes=True, device="cpu")
    assert sched.amm_planes is None      # the supplied fns carry theirs
    sched, reqs = _drive(sched, t_engine.Request, ARRIVALS)
    assert state["i"] == len(log)
    assert state["clear"] > len(log)          # most rows are decided
    assert sched.stats == j_stats
    assert [(r.out, r.done, r.error) for r in reqs] \
        == [(r.out, r.done, r.error) for r in j_reqs]


# ------------------------------------------------- the port's own policy
@pytest.fixture(scope="module")
def lm():
    _, t_cfg = _configs(dict(mode="bitexact", mul="bbm0", wl=WL, param=VBL,
                             apply_to="attn"))
    j_cfg, _ = _configs(dict(mode="bitexact", mul="bbm0", wl=WL, param=VBL,
                             apply_to="attn"))
    jp = j_init(j_cfg, jax.random.key(0))
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return t_cfg, TRT.build(t_cfg), tp


def _sched(lm, slots=SLOTS, **kw):
    cfg, rt, params = lm
    kw.setdefault("kv_codes", True)
    return t_engine.Scheduler(cfg, rt, params, slots, MAX_LEN,
                              continuous=True, device="cpu", **kw)


def _drain(sched, cap=300):
    steps = 0
    while sched.step():
        steps += 1
        assert steps < cap, "the scheduler failed to terminate"
    return steps


def _solo_stream(lm, prompt, max_new, *, kv_codes=True):
    """The reference stream: same scheduler, same slot count, one
    request."""
    sched = _sched(lm, kv_codes=kv_codes)
    req = t_engine.Request(rid=0, prompt=list(prompt), max_new=max_new)
    sched.submit(req)
    _drain(sched)
    assert req.done and req.error is None
    return req.out


def _random_arrivals(rng, vocab, n=4):
    arrivals, step = [], 0
    for _ in range(n):
        step += int(rng.integers(0, 3))
        plen = int(rng.integers(0, 9))          # 0 = empty prompt
        prompt = rng.integers(1, vocab, plen).tolist()
        arrivals.append((step, prompt, int(rng.integers(1, 5))))
    return arrivals


@pytest.mark.parametrize("seed,kv_codes", [(7, True), (23, True),
                                           (11, False)],
                         ids=["code-7", "code-23", "float-11"])
def test_streams_bitwise_equal_to_solo_runs(lm, seed, kv_codes):
    """Random interleavings: every stream equals its solo run, bit for bit
    (per-(slot, head) attention scales; the code cache freezes the codes
    at write time)."""
    cfg = lm[0]
    rng = np.random.default_rng(seed)
    arrivals = _random_arrivals(rng, cfg.vocab)
    sched, reqs = _drive(_sched(lm, kv_codes=kv_codes), t_engine.Request,
                         arrivals)
    assert sched.stats["completed"] == len(reqs)
    memo = {}
    for r, (_, prompt, max_new) in zip(reqs, arrivals):
        assert r.done and r.error is None
        key = (tuple(prompt), max_new)
        if key not in memo:
            memo[key] = _solo_stream(lm, prompt, max_new, kv_codes=kv_codes)
        assert r.out == memo[key], (r.rid, seed)


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


def test_resident_decodes_every_step_while_prompts_queue(lm):
    sched = _sched(lm)
    resident = t_engine.Request(rid=0, prompt=[1, 2], max_new=12)
    sched.submit(resident)
    sched.step()                      # prefill emits token 1, decode adds 1
    assert len(resident.out) == 2
    long = list(range(1, 13))
    for i in range(1, 4):
        sched.submit(t_engine.Request(rid=i, prompt=long, max_new=2))
    prev_out, prev_pre = len(resident.out), sched.stats["prefills"]
    while not resident.done:
        sched.step()
        assert len(resident.out) - prev_out == 1
        assert sched.stats["prefills"] - prev_pre <= 1
        prev_out, prev_pre = len(resident.out), sched.stats["prefills"]
    assert resident.error is None and len(resident.out) == 12


def test_slot_recycled_after_midstream_poison(lm):
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
    # the recycled slot serves the same bits as a fresh scheduler
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


def test_code_cache_dtype_and_memory_ratio(lm):
    """WL 8 codes are int8 and halve the bf16 cache bytes; the scale
    planes are accounted apart and stay small (the reference's
    numbers)."""
    cfg = lm[0]
    sched = _sched(lm)
    assert sched.caches["k_codes"].dtype == torch.int8
    assert sched.caches["k_scale"].dtype == torch.float32
    rep = t_kv.memory_report(cfg, SLOTS, MAX_LEN, wl=WL)
    assert rep["ratio_codes"] == 2.0
    assert rep["ratio_total"] > 1.5
    assert rep["scale_overhead"] < 0.25
    j_cfg, _ = _configs(dict(mode="bitexact", mul="bbm0", wl=WL, param=VBL))
    assert rep == j_kv.memory_report(j_cfg, SLOTS, MAX_LEN, wl=WL)


def test_kv_codes_requires_attention_routing(lm):
    _, cfg, = _configs(dict(mode="bitexact", mul="bbm0", wl=WL, param=VBL,
                            apply_to="mlp"))          # attention not routed
    with pytest.raises(ValueError, match="attention lowering"):
        t_engine.Scheduler(cfg, TRT.build(cfg), lm[2], 1, MAX_LEN,
                           kv_codes=True, device="cpu")
    with pytest.raises(ValueError, match="attention lowering"):
        t_engine.make_serve_fns(cfg, TRT.build(dataclasses.replace(
            cfg, amm=TAmm(mode="noise")), device="cpu"), kv_codes=True)


def test_kv_codes_rejects_exact_budget_guard(lm):
    guard = GuardConfig(budget_abs=0.0, budget_every=1)
    with pytest.raises(ValueError, match="guard budget audit"):
        _sched(lm, slots=1, guard=guard)


# ------------------------------------------------------------ the launcher
BITEXACT = ["--amm", "bitexact", "--amm-attn", "--kv-codes", "--continuous"]


def test_launcher_serves_bitexact_with_the_code_cache(capsys):
    steps = t_launch.main(["--reduced", "--device", "cpu", "--requests", "2",
                           "--max-new", "3", "--max-len", "32", "--wl", "8",
                           "--vbl", "5"] + BITEXACT)
    assert steps > 0
    assert "2 requests" in capsys.readouterr().out


@pytest.mark.parametrize("flags,why", [
    (["--kv-codes"], "bitexact datapath"),
    (["--kv-codes", "--amm", "noise", "--amm-attn"], "bitexact datapath"),
    (["--kv-codes", "--amm", "bitexact", "--amm-attn", "--mul", "kulkarni",
      "--vbl", "2"], "Booth-family"),
    (["--kv-codes", "--amm", "bitexact"], "amm-routed"),
    (["--amm", "off", "--amm-attn", "attn"], "approximate nothing"),
])
def test_launcher_flag_rules(flags, why, capsys):
    with pytest.raises(SystemExit):
        t_launch.main(["--reduced", "--device", "cpu"] + flags)
    assert why in capsys.readouterr().err


def test_launcher_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--reduced", "--requests", "1"] + BITEXACT)
