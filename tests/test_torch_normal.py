"""The port's ``jax.random.normal`` against JAX's, bit for bit.

* ``core.prng.normal_from_bits``: the transform from a uint32 to the
  normal is a function of its top 23 bits, so all 2^23 of them are
  checked against the JAX program that computes it (the uniform, XLA's
  ``erf_inv``, ``* sqrt(2)``), in eight slices;
* ``core.prng.normal`` against ``jax.random.normal`` itself, eager and
  inside ``jax.jit``, for several keys at shapes (7,), (3, 5, 11) and
  (8, 1, 4864);
* ``core.prng.fma_f32``, the exact fused multiply-add the plain version
  emulates, against exact rational arithmetic on adversarial operands;
* the keyed ``kernels.ref.quant_matmul_ref`` and
  ``core.noise.inject_dot_error`` against the reference's functions
  inside ``jax.jit``: XLA folds ``c * sqrt(2)`` into one constant and
  fuses its product with ``erf_inv(u)`` into an add, and the port's
  epilogues round the same way (``prng.normal_plain``); called op by
  op, the reference rounds ``sigma * z`` on its own, which the port
  does not follow;
* ``core.prng.layer_keys``: the reference's per-layer key chain;
* the plain noise branch end to end: a 2-layer reduced qwen2 in noise
  mode without the fused kernel (bbm0, WL 16, VBL 13), served through
  the continuous ``Scheduler`` teacher-forced on the reference's logits
  (within ``tests/test_torch_scheduler.py``'s 2^-6 of the largest
  logit), each layer's three MLP products drawing from that layer's key
  of the reference's chain; and two training steps, each from the
  reference's parameters, loss within ``tests/test_torch_train.py``'s
  2^-12 and every gradient leaf within 2^-5 of its largest element.

The kernel's own cases (``csrc/normal.cu`` against this plain version)
need the card and live in ``tests/test_torch_isolation.py``.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from numpy.testing import assert_array_equal

from repro.configs import get_arch as j_get
from repro.configs import reduced as j_reduced
from repro.configs.base import AmmConfig as JAmm
from repro.core.multipliers import MulSpec as JSpec
from repro.core.noise import NoiseModel as JNoise
from repro.core.noise import inject_dot_error as j_inject
from repro.data import pipeline as j_pipe
from repro.kernels.ref import quant_matmul_ref as j_qref
from repro.models import ModelRuntime as JRT
from repro.models import lm_apply as j_apply
from repro.models import lm_init as j_init
from repro.serve import engine as j_engine
from repro.train import optimizer as j_opt
from repro.train import trainstep as j_step
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import noise as t_noise
from repro_torch.core import prng
from repro_torch.core.multipliers import MulSpec as TSpec
from repro_torch.kernels.normal import normal_draw
from repro_torch.kernels.ref import quant_matmul_ref as t_qref
from repro_torch.models import ModelRuntime as TRT
from repro_torch.serve import engine as t_engine
from repro_torch.train import optimizer as t_opt
from repro_torch.train import trainstep as t_step

pytest_plugins = ["port_first"]

_LO = np.nextafter(np.float32(-1), np.float32(0))


@jax.jit
def _jax_transform(bits):
    """``jax.random.normal``'s float32 body after its random bits (the
    reference's ``_normal_real`` and ``_uniform`` with minval = lo,
    maxval = 1)."""
    fb = lax.bitwise_or(lax.shift_right_logical(bits, np.uint32(9)),
                        np.uint32(0x3F800000))
    f = lax.bitcast_convert_type(fb, jnp.float32) - np.float32(1)
    lo = jnp.float32(_LO)
    u = lax.max(lo, f * (jnp.float32(1) - lo) + lo)
    return lax.mul(np.float32(np.sqrt(2)), lax.erf_inv(u))


def _u32(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


# ------------------------------------------------ the transform, exhaustive
@pytest.mark.parametrize("part", range(8))
def test_transform_bitwise_on_all_2_23_uniforms(part):
    """Slice ``part`` of the 2^23 mantissas (the low 9 bits, which the
    transform drops, set to a pattern that changes with the mantissa)."""
    n = 1 << 20
    mant = np.arange(part * n, (part + 1) * n, dtype=np.uint32)
    bits = (mant << np.uint32(9)) | (mant & np.uint32(0x1FF))
    want = _u32(_jax_transform(bits))
    got = _u32(prng.normal_from_bits(torch.from_numpy(bits.astype(
        np.int64))).numpy())
    bad = np.nonzero(got != want)[0]
    assert bad.size == 0, (f"{bad.size} of {n} differ; first at bits "
                           f"{int(bits[bad[0]]):#x}")


def test_transform_takes_int32_bits_alike():
    bits = np.random.default_rng(0).integers(0, 2 ** 32, 4096,
                                             dtype=np.uint64)
    b32 = bits.astype(np.uint32)
    want = _u32(_jax_transform(b32))
    assert_array_equal(_u32(prng.normal_from_bits(
        torch.from_numpy(b32.view(np.int32))).numpy()), want)
    assert_array_equal(_u32(normal_draw(prng.key(0), (0,), device="cpu")),
                       np.zeros(0, np.uint32))


# ----------------------------------------------------------- whole draws
def _keys():
    out = []
    for seed in (0, 2 ** 31 - 1, -7):
        jk, tk = jax.random.key(seed), prng.key(seed)
        out.append((jk, tk))
        out.append((jax.random.split(jk)[1], prng.split(tk)[1]))
    return out


@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (8, 1, 4864)],
                         ids=["7", "3x5x11", "8x1x4864"])
def test_normal_matches_jax_random_normal(shape):
    jitted = jax.jit(lambda k: jax.random.normal(k, shape, jnp.float32))
    for jk, tk in _keys():
        got = _u32(prng.normal(tk, shape, device="cpu").numpy())
        assert_array_equal(got, _u32(jax.random.normal(jk, shape,
                                                       jnp.float32)))
        assert_array_equal(got, _u32(jitted(jk)))


def test_layer_keys_are_the_reference_chain():
    key = jax.random.key(3)
    want = []
    for _ in range(5):
        key, sub = jax.random.split(key)
        want.append(tuple(int(v) for v in jax.random.key_data(sub)))
    assert list(prng.layer_keys(3, 5)) == want
    assert prng.layer_seeds(3, 5) == tuple(prng.randint(k) for k in want)


# ------------------------------------------------------------ exact FMA
def _round_f32(q: Fraction) -> np.float32:
    """The float32 nearest ``q`` (ties to even), by exact comparison."""
    c = np.float32(float(q))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c,
                 np.nextafter(c, np.float32(np.inf))):
        if not np.isfinite(cand):
            continue
        d = abs(Fraction(float(cand)) - q)
        key = (d, int(np.array(cand).view(np.uint32)) & 1)
        if best is None or key < best[0]:
            best = (key, cand)
    return best[1]


def _fma_cases():
    rng = np.random.default_rng(5)
    f = np.float32
    cases = []
    # a*b exactly half-way between two floats, c nudging it either way
    for e in range(-20, 21, 5):
        a = f(1 + 2 ** -12) * f(2.0 ** e)
        b = f(1 + 2 ** -12)
        ab = Fraction(float(a)) * Fraction(float(b))
        for c in (f(0), f(2.0 ** (e - 60)), -f(2.0 ** (e - 60)),
                  f(2.0 ** (e - 30)), -f(2.0 ** (e - 24))):
            cases.append((a, b, c))
        cases.append((a, b, -f(float(ab))))           # cancellation
    # tiny and huge magnitudes, subnormal results, signed zeros
    cases += [(f(1e-30), f(1e-10), f(1e-45)), (f(-1e-20), f(1e-20), f(0)),
              (f(3e38), f(0.5), f(-1e38)), (f(-0.0), f(1.0), f(0.0)),
              (f(0.0), f(-1.0), f(-0.0)), (f(2.0 ** -75), f(2.0 ** -75),
                                           f(2.0 ** -149))]
    # random bit patterns (finite ones), and the transform's own steps
    raw = rng.integers(0, 2 ** 32, (3000, 3), dtype=np.uint64)
    vals = raw.astype(np.uint32).view(np.float32)
    vals = vals[np.isfinite(vals).all(axis=1)
                & (np.abs(vals) < 1e18).all(axis=1)
                & (np.abs(vals) > 1e-18).all(axis=1)]
    cases += [tuple(v) for v in vals[:2000]]
    x = rng.uniform(-0.3, 0.3, 500).astype(np.float32)
    cases += [(xi, f(0.0703768), f(-0.1151461)) for xi in x]
    return cases


def test_fma_f32_is_exact_on_adversarial_operands():
    cases = _fma_cases()
    a, b, c = (np.array([t[i] for t in cases], np.float32) for i in range(3))
    got = prng.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                       torch.from_numpy(c)).numpy()
    for i, (ai, bi, ci) in enumerate(cases):
        q = Fraction(float(ai)) * Fraction(float(bi)) + Fraction(float(ci))
        want = _round_f32(q)
        if q == 0:        # IEEE's sign of an exact zero sum
            want = np.float32(ai * bi + ci)
        assert _u32(got[i]) == _u32(want), (ai, bi, ci, got[i], want)
    # and a plain float64 emulation does round some of them twice
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice.view(np.uint32) != got.view(np.uint32)).any()


# ----------------------------------------------- keyed oracles, bit for bit
@pytest.mark.parametrize("mu,sigma", [(-3.7e3, 1.234e4), (0.0, 2.5e6),
                                      (41.0, 0.0)])
def test_quant_matmul_ref_keyed_bitwise(mu, sigma):
    """wl 8, K 64: every accumulator is an integer below 2^24, so both
    matmuls agree and the epilogue decides."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 33)).astype(np.float32)
    s_x, s_w = np.float32(0.02), np.float32(0.03)
    for seed in (5, 9):
        ref = jax.jit(lambda x, w, sx, sw, k: j_qref(
            x, w, sx, sw, mu, sigma, wl=8, key=k))
        want = _u32(ref(x, w, s_x, s_w, jax.random.key(seed)))
        got = t_qref(torch.from_numpy(x), torch.from_numpy(w), s_x, s_w,
                     mu, sigma, wl=8, key=prng.key(seed))
        assert_array_equal(_u32(got.numpy()), want)
    # no key, or no moments: no noise, as the reference
    plain = t_qref(torch.from_numpy(x), torch.from_numpy(w), s_x, s_w,
                   mu, sigma, wl=8).numpy()
    assert_array_equal(_u32(plain), _u32(j_qref(x, w, s_x, s_w, 0.0, 0.0,
                                                wl=8)))


@pytest.mark.parametrize("k,amp", [(896, 1.0), (4864, 0.7), (17, 2.5)])
def test_inject_dot_error_bitwise(k, amp):
    jm = JNoise(JSpec("bbm0", 16, 13), mean=-1234.5678, var=4.5e7)
    tm = t_noise.NoiseModel(TSpec("bbm0", 16, 13), mean=jm.mean, var=jm.var)
    y = (np.random.default_rng(k).standard_normal((4, 9, 17))
         * 1e5).astype(np.float32)
    ref = jax.jit(lambda y, key: j_inject(y, key, jm, k, amp))
    want = _u32(ref(y, jax.random.key(11)))
    got = t_noise.inject_dot_error(torch.from_numpy(y), prng.key(11), tm,
                                   k, amp)
    assert_array_equal(_u32(got.numpy()), want)
    # the input is not written
    assert_array_equal(_u32(y), _u32(y.copy()))


def test_normal_draw_epilogues_in_place():
    """``acc`` is written in place with the epilogue's value, and the
    two orders differ where they should."""
    k = prng.key(2)
    acc = torch.linspace(-1e6, 1e6, 3 * 70).reshape(3, 70)
    before = acc.clone()
    out = normal_draw(k, (3, 70), acc=acc, c1=-5.5e3, c2=7.25e4)
    assert out is acc
    ei = prng.erfinv_from_bits(prng.random_bits(k, (3, 70), "cpu"))
    c2s = prng.folded_scale(7.25e4)
    assert_array_equal(
        _u32(acc.numpy()),
        _u32(prng.fma_f32(c2s, ei, before + torch.tensor(-5.5e3)).numpy()))
    other = normal_draw(k, (3, 70), acc=before.clone(), c1=-5.5e3,
                        c2=7.25e4, order="noise")
    assert_array_equal(_u32(other.numpy()), _u32(
        (before + prng.fma_f32(c2s, ei, -5.5e3)).numpy()))
    with pytest.raises(ValueError, match="order"):
        normal_draw(k, (3, 70), acc=before.clone(), order="sideways")
    with pytest.raises(ValueError, match="contiguous float32"):
        normal_draw(k, (3, 70), acc=before.T.contiguous())


# ------------------------------------------- the plain noise branch, end to end
NOISE = dict(mode="noise", mul="bbm0", wl=16, param=13, use_pallas=False)
LOGIT_RTOL = 2.0 ** -6
LOSS_RTOL = 2.0 ** -12
GRAD_RTOL = 2.0 ** -5
SLOTS, MAX_LEN = 3, 24
ARRIVALS = [(0, [5, 9, 2], 4), (0, [7, 1, 3, 8, 4, 6], 3),
            (1, [11, 12, 13], 2), (2, [3, 3, 3, 3, 3, 3], 5)]


@pytest.fixture(scope="module")
def lm():
    j_cfg = dataclasses.replace(j_reduced(j_get("qwen2-0.5b")),
                                amm=JAmm(**NOISE))
    t_cfg = dataclasses.replace(t_reduced(t_get("qwen2-0.5b")),
                                amm=TAmm(**NOISE))
    jp = j_init(j_cfg, jax.random.key(0))
    npp = jax.tree.map(np.asarray, jp)
    return j_cfg, jp, t_cfg, npp


def _drive(sched, request_cls):
    reqs, t, idx = [], 0, 0
    while True:
        while idx < len(ARRIVALS) and ARRIVALS[idx][0] <= t:
            _, prompt, max_new = ARRIVALS[idx]
            reqs.append(request_cls(rid=idx, prompt=list(prompt),
                                    max_new=max_new))
            sched.submit(reqs[-1])
            idx += 1
        n = sched.step()
        t += 1
        if n == 0 and idx >= len(ARRIVALS) and not sched.queue:
            return reqs
        assert t < 200, "the scheduler failed to terminate"


def test_noise_serving_plain_branch_against_the_reference(lm, monkeypatch):
    j_cfg, jp, t_cfg, npp = lm
    jrt = JRT.build(j_cfg)
    assert not j_cfg.amm.use_pallas and jrt.amm.sigma > 0

    @jax.jit
    def prefill_j(p, t, c):
        logits, _, c = j_apply(p, j_cfg, jrt, t, mode="decode", caches=c,
                               pos=jnp.int32(0))
        return logits[:, -1], c

    @jax.jit
    def decode_j(p, t, c, q):
        logits, _, c = j_apply(p, j_cfg, jrt, t, mode="decode", caches=c,
                               pos=q)
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
    sched = j_engine.Scheduler(j_cfg, jrt, jp, SLOTS, MAX_LEN,
                               decode_fn=decode, prefill_fn=prefill,
                               continuous=True)
    j_reqs = _drive(sched, j_engine.Request)
    j_stats = dict(sched.stats)

    # the port, every draw's key recorded
    from repro_torch.models import common as t_common
    draws = []
    real = t_common.normal_draw

    def spy(k, shape, **kw):
        draws.append(tuple(k))
        return real(k, shape, **kw)
    monkeypatch.setattr(t_common, "normal_draw", spy)
    trt = TRT.build(t_cfg, device="cpu")
    assert (trt.amm.mu, trt.amm.sigma) == (float(jrt.amm.mu),
                                           float(jrt.amm.sigma))
    tp = lm_params_from_numpy(npp, device="cpu")
    prefill_t, decode_t = t_engine.make_serve_fns(t_cfg, trt)
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

    def t_prefill(p, t, c):
        logits, c = prefill_t(p, t, c)
        return forced("prefill", logits), c

    def t_decode(p, t, c, q):
        logits, c = decode_t(p, t, c, q)
        return forced("decode", logits), c
    sched = t_engine.Scheduler(t_cfg, trt, tp, SLOTS, MAX_LEN,
                               decode_fn=t_decode, prefill_fn=t_prefill,
                               continuous=True, device="cpu")
    reqs = _drive(sched, t_engine.Request)
    assert state["i"] == len(log) and state["clear"] > len(log)
    assert sched.stats == j_stats
    assert [(r.out, r.done, r.error) for r in reqs] \
        == [(r.out, r.done, r.error) for r in j_reqs]
    # every call's layers drew from the reference's layer keys, three
    # products a layer
    want_keys = [k for k in prng.layer_keys(0, t_cfg.n_layers)
                 for _ in range(3)]
    assert draws == want_keys * len(log)


def test_noise_training_plain_branch_against_the_reference(lm):
    """Two steps, each from the reference's parameters after the step
    before (teacher-forced), each with its own key."""
    j_cfg, jp, t_cfg, _ = lm
    jrt = JRT.build(j_cfg)
    trt = TRT.build(t_cfg, device="cpu")
    oc = j_opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    step_j = jax.jit(lambda p, o, t, l, k: (
        lambda lg: (lg[0], lg[1]) + j_opt.apply_updates(p, lg[1], o, oc)[:2]
    )(j_step.loss_and_grads(p, j_cfg, jrt, t, l, k)))
    opt = j_opt.init_opt(jp, oc)
    params = jp
    for step in range(2):
        dc = j_pipe.DataConfig(vocab=j_cfg.vocab, seq_len=40, global_batch=2)
        toks, labels = j_pipe.global_batch(dc, step)
        j_loss, j_grads, params_next, opt = step_j(
            params, opt, jnp.asarray(toks), jnp.asarray(labels),
            jax.random.key(10 + step))
        tp = lm_params_from_numpy(jax.tree.map(np.asarray, params),
                                  device="cpu")
        t_loss, t_grads, _ = t_step.loss_and_grads(
            tp, t_cfg, trt, torch.from_numpy(toks), torch.from_numpy(labels),
            prng.key(10 + step))
        j_loss = float(j_loss)
        assert abs(float(t_loss) - j_loss) <= LOSS_RTOL * abs(j_loss)
        want = jax.tree.leaves(j_grads)
        got = t_opt.tree_leaves(t_grads)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w, np.float64)
            assert np.abs(g.double().numpy() - w).max() \
                <= GRAD_RTOL * np.abs(w).max()
        params = params_next
