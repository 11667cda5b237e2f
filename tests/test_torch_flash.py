"""The port's attention on the amm datapath and its flash lowerings
against the JAX package's.

* chunked-amm (``chunked_attention(amm=...)``, group-folded GQA), its
  closed-form oracle and ``flash_amm_chunked_equiv`` against JAX, held
  by ``flash_amm_compare``; the port's dot form against its closed-form
  oracle, bit for bit;
* flash-amm's plain version against ``flash_attention_amm(use_kernel=
  False)``: the codes and scales of Q, K and V bit for bit, and the two
  runs by ``flash_amm_compare`` at every operating point.  At kind 0 the
  port skips dead tiles, whose score products the reference still forms
  and nothing reads (the mask covers them): there the reference's score
  residual is held to ``DEAD_SCORE`` after its P codes, scales and P V
  products are checked to be the dead tile's (``_as_skipped``);
* exact flash against ``kernels.ops.flash_attention`` (interpret mode)
  and ``ref.attention_ref`` within ``flash_tolerance``;
* the routing of ``attention``, with ``FlashFallbackWarning`` when the
  sequence cap is lowered;
* ``_flash_amm_ste``'s gradient against ``jax.grad`` of the reference's.

Tolerances.  ``flash_tolerance`` is the derived bound of the exact
lowering (f32 rounding of the products and sums in another order, exp in
the last place).  ``flash_amm_compare`` needs what each run formed per
tile: the approximate score products, P's codes and scales and the
approximate P V products.  The reference's are recorded while it runs
(``jax.debug.callback`` in spies of its ``_amm_product`` and of
``amm_dot``, ordered), the port's are its residuals or the same records
(``torch_amm_capture``).  It requires the score products bit-equal, P's
codes and scales within what float rounding can move, the P V products
bit-equal where P's codes agree, and the outputs within a bound charged
only for the codes that moved.  The gradients: both sides differentiate
the same straight-through schedule at the same forward values, in f32,
and differ in the order of their sums: ``GRAD_RTOL`` = 2^-16 of the
largest gradient, about 500 ulps of it (the exact gradient, for
comparison, differs from the straight-through one by about 2^-8 of it at
these inputs).
"""
from __future__ import annotations

import contextlib
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.configs.base import AmmConfig as JAmm
from repro.kernels import ops as j_ops
from repro.models import attention as j_attn
from repro.models.common import AmmRuntime as JRuntime
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.core.multipliers import MulSpec as TSpec
from repro_torch.models import attention as t_attn
from repro_torch.models.common import AmmRuntime as TRuntime
from torch_amm_capture import chunked_residuals, port_amm_dot_records

pytest_plugins = ["port_first"]

jf = importlib.import_module("repro.kernels.flash_attention")
jb = importlib.import_module("repro.kernels.bbm_matmul")
jr = importlib.import_module("repro.kernels.booth_rows")
j_ref = importlib.import_module("repro.kernels.ref")
tf = importlib.import_module("repro_torch.kernels.flash_attention")
t_ref = importlib.import_module("repro_torch.kernels.ref")

SWEEP = [("bbm0", 8, 5), ("bbm1", 8, 7), ("bbm0", 12, 7), ("bbm1", 12, 11),
         ("bbm0", 16, 13), ("bbm1", 16, 15), ("bbm0", 16, 3),
         ("booth", 16, 0)]
KINDS = {"booth": 0, "bbm0": 0, "bbm1": 1}
GRAD_RTOL = 2.0 ** -16


@pytest.fixture(autouse=True)
def _fresh_fallback_dedup():
    t_attn.reset_flash_fallback_dedup()
    yield
    t_attn.reset_flash_fallback_dedup()


def _rts(mul, wl, vbl, apply_to="all"):
    kw = dict(mode="bitexact", mul=mul, wl=wl, param=vbl, apply_to=apply_to)
    return JRuntime.build(JAmm(**kw)), TRuntime.build(TAmm(**kw))


def _lowering(mul, wl, vbl):
    return wl, (0 if mul == "booth" else vbl), KINDS[mul]


def _qkv(b=1, h=2, sq=40, skv=40, d=16, seed=3):
    """(B, H, S, D) numpy operands with envelope-edge rows."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, h, skv, d)).astype(np.float32)
    q[0, 0, 0, :] = np.abs(q).max() * 1.5
    k[0, 0, 0, :] = np.abs(k).max() * 1.5
    return q, k, v


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _within(got, want, tol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    tol = np.broadcast_to(np.asarray(tol), err.shape)
    assert (err <= tol).all(), (err.max(), tol.min())


def _compare(ops, a, b, **kw):
    rep = tf.flash_amm_compare(ops, a, b, **kw)
    assert rep["ok"], rep
    return rep


def _as_skipped(ops, run, *, kind, causal):
    """A run that formed every tile (the reference, the chunked path) as
    the port's skipping schedule leaves it: on each tile the port skips
    (kind 0, ``live_kv_tiles``), the P codes, scale and P V product must
    already be a dead tile's (0, 1e-12, 0), and the score product, which
    the mask hides from every later step, becomes ``DEAD_SCORE``."""
    if kind != 0:
        return run
    bq, bk = ops["bq"], ops["bk"]
    g, r, _ = ops["qf"].shape
    c = ops["kf"].shape[1]
    counts = tf.live_kv_tiles(r, c, bq, bk, causal=causal, kv_len=ops["skv"])
    out = dict(run, s=run["s"].clone())
    for i, n in enumerate(counts):
        rows = slice(i * bq, (i + 1) * bq)
        for j in range(n, c // bk):
            cols = slice(j * bk, (j + 1) * bk)
            assert not run["pc"][:, rows, cols].any()
            assert not run["pv"][:, j, rows].any()
            assert bool((run["ps"][:, i, j] == np.float32(1e-12)).all())
            out["s"][:, rows, cols] = tf.DEAD_SCORE
    return out


@contextlib.contextmanager
def _jax_amm_dot_records():
    """Record (a, b, approximate product) of every ``amm_dot`` call of the
    reference's ``chunked_attention``, in order; the calls return what
    they would."""
    recs, orig = [], j_attn.amm_dot

    def spy(a, b, rt, *, oracle=False, ste=True):
        approx = orig(a, b, rt, oracle=oracle, ste=False)
        jax.debug.callback(lambda *x: recs.append(x), a, b, approx,
                           ordered=True)
        return orig(a, b, rt, oracle=oracle, ste=ste)

    j_attn.amm_dot = spy
    try:
        yield recs
        jax.effects_barrier()
    finally:
        j_attn.amm_dot = orig


def _chunked_pair(port_fn, jax_fn, shape, *, wl, bq, bk):
    """Run a chunked amm attention on both sides with their ``amm_dot``
    calls recorded: (ops, port run, reference run, q_pos), the operands
    bit-equal."""
    with port_amm_dot_records() as recs:
        got = port_fn()
    ops, port, q_pos = chunked_residuals(recs, shape, got, wl=wl, bq=bq,
                                         bk=bk)
    with _jax_amm_dot_records() as jrecs:
        want = jax_fn()
    jops, ref, _ = chunked_residuals(jrecs, shape, want, wl=wl, bq=bq, bk=bk)
    for name in ("qf", "kf", "vf", "vc", "vs"):
        assert torch.equal(ops[name], jops[name]), name
    return ops, port, ref, q_pos


def _jax_flash_run(q, k, v, *, wl, vbl, kind, causal, bq, bk):
    """The reference's ``flash_attention_amm(use_kernel=False)`` with what
    every tile formed: (out, residuals in the port's layout).  A spy of
    its ``_amm_product`` records the codes, scale and approximate product
    of each tile product; within a KV step the score products of every
    (q-block, batch*head) come first, q-block major, then the P V
    products."""
    recs, orig = [], jf._amm_product

    def spy(af, bf, ac, bmag, bneg, s_a, s_b, *, wl, vbl, kind):
        yq = jb.dot_scaled_chunked(ac, bmag, bneg, wl=wl, vbl=vbl,
                                   kind=kind, f32_dots=True)
        approx = (yq * (s_a * s_b)).astype(af.dtype)
        jax.debug.callback(lambda *x: recs.append(x), ac, s_a, approx,
                           ordered=True)
        return orig(af, bf, ac, bmag, bneg, s_a, s_b, wl=wl, vbl=vbl,
                    kind=kind)

    jf._amm_product = spy
    jf._flash_amm_xla.clear_cache()
    try:
        out = jf.flash_attention_amm(*(jnp.asarray(a) for a in (q, k, v)),
                                     wl=wl, vbl=vbl, kind=kind,
                                     causal=causal, bq=bq, bk=bk,
                                     use_kernel=False)
        jax.effects_barrier()
    finally:
        jf._amm_product = orig
        jf._flash_amm_xla.clear_cache()
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bq, bk = min(bq, sq), min(bk, skv)
    nq, nk, g = -(-sq // bq), -(-skv // bk), b * h
    assert len(recs) == 2 * nk * nq * g
    res = {"s": np.zeros((g, nq * bq, nk * bk), np.float32),
           "pc": np.zeros((g, nq * bq, nk * bk), np.int16),
           "ps": np.zeros((g, nq, nk), np.float32),
           "pv": np.zeros((g, nk, nq * bq, d), np.float32)}
    for j in range(nk):
        for n in range(nq * g):
            qi, gi = divmod(n, g)
            rows, cols = slice(qi * bq, (qi + 1) * bq), slice(j * bk,
                                                             (j + 1) * bk)
            res["s"][gi, rows, cols] = recs[2 * j * nq * g + n][2]
            pc, s_p, pv = recs[(2 * j + 1) * nq * g + n]
            res["pc"][gi, rows, cols] = pc
            res["ps"][gi, qi, j] = s_p
            res["pv"][gi, j, rows] = pv
    res = {n: torch.from_numpy(a) for n, a in res.items()}
    res["out"] = torch.from_numpy(np.array(out).reshape(g, sq, d))
    return res


# ----------------------------------------------------------- chunked amm
@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_chunked_amm_matches_jax(mul, wl, vbl):
    """GQA (4 query heads on 2 KV heads), group-folded, one scale pair per
    (batch, kv-head) block, three KV blocks and a ragged one."""
    jrt, trt = _rts(mul, wl, vbl)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
    ops, port, ref, q_pos = _chunked_pair(
        lambda: t_attn.chunked_attention(*_t(q, k, v), causal=True, bq=16,
                                         bk=16, amm=trt),
        lambda: j_attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True, bq=16,
                                         bk=16, amm=jrt),
        (1, 40, 4, 16, 40, 2), wl=wl, bq=16, bk=16)
    _compare(ops, port, ref, wl=wl, vbl=_lowering(mul, wl, vbl)[1],
             causal=True, q_pos=q_pos)
    got = t_attn.chunked_attention(*_t(q, k, v), causal=True, bq=16, bk=16,
                                   amm=trt)
    oracle = t_attn.chunked_attention(*_t(q, k, v), causal=True, bq=16,
                                      bk=16, amm=trt, amm_oracle=True)
    assert torch.equal(oracle, got)


@pytest.mark.parametrize("causal", [True, False])
def test_amm_attention_oracle_matches_jax(causal):
    q, k, v = _qkv(sq=24, skv=24, d=8)
    spec = ("bbm1", 12, 7)
    jspec = __import__("repro.core.multipliers",
                       fromlist=["MulSpec"]).MulSpec(*spec)
    ops, port, ref, q_pos = _chunked_pair(
        lambda: t_ref.amm_flash_attention_ref(
            *_t(q, k, v), TSpec(*spec), causal=causal).transpose(1, 2),
        lambda: j_ref.amm_flash_attention_ref(
            *(jnp.asarray(a) for a in (q, k, v)), jspec,
            causal=causal).transpose(0, 2, 1, 3),
        (1, 24, 2, 8, 24, 2), wl=12, bq=tf.FLASH_AMM_BQ, bk=tf.FLASH_AMM_BK)
    _compare(ops, port, ref, wl=12, vbl=7, causal=causal, q_pos=q_pos)


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
def test_flash_amm_chunked_equiv_matches_jax(mul, wl, vbl):
    jrt, trt = _rts(mul, wl, vbl)
    q, k, v = _qkv(sq=150, skv=150, d=16)      # 2 flash tiles, one ragged
    ops, port, ref, q_pos = _chunked_pair(
        lambda: t_attn.flash_amm_chunked_equiv(
            *_t(q, k, v), trt, causal=True).transpose(1, 2),
        lambda: j_attn.flash_amm_chunked_equiv(
            *(jnp.asarray(a) for a in (q, k, v)), jrt,
            causal=True).transpose(0, 2, 1, 3),
        (1, 150, 2, 16, 150, 2), wl=wl, bq=tf.FLASH_AMM_BQ,
        bk=tf.FLASH_AMM_BK)
    _compare(ops, port, ref, wl=wl, vbl=_lowering(mul, wl, vbl)[1],
             causal=True, q_pos=q_pos)


# ---------------------------------------------------- flash-amm (B3)
def _j_operands(q, k, v, wl, bq, bk):
    """The reference wrapper's host side, step by step (it keeps them
    local): padded, scaled, quantized per (batch*head, block)."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    bq, bk = min(bq, sq), min(bk, skv)
    nq, nk = -(-sq // bq), -(-skv // bk)
    pad = lambda a, n: jnp.pad(jnp.asarray(a), (  # noqa: E731
        (0, 0), (0, 0), (0, n), (0, 0)))
    qf = pad(q, nq * bq - sq).reshape(b * h, nq * bq, d) * (1.0 / d ** 0.5)
    kf = pad(k, nk * bk - skv).reshape(b * h, nk * bk, d)
    vf = pad(v, nk * bk - skv).reshape(b * h, nk * bk, d)
    quant = jax.vmap(jax.vmap(lambda t: j_ref.amm_quantize(t, wl)))
    qc, qs = quant(qf.reshape(b * h, nq, bq, d))
    kc, ks = quant(kf.reshape(b * h, nk, bk, d))
    vc, vs = quant(vf.reshape(b * h, nk, bk, d))
    return dict(qf=qf, kf=kf, vf=vf, qc=qc.reshape(b * h, nq * bq, d),
                kc=kc.reshape(b * h, nk * bk, d),
                vc=vc.reshape(b * h, nk * bk, d), qs=qs, ks=ks, vs=vs,
                bq=bq, bk=bk)


@pytest.mark.parametrize("mul,wl,vbl", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_amm_plain_matches_jax(mul, wl, vbl, causal):
    wl, vbl, kind = _lowering(mul, wl, vbl)
    q, k, v = _qkv(sq=40, skv=36, d=16)
    bq = bk = 16
    ref = _jax_flash_run(q, k, v, wl=wl, vbl=vbl, kind=kind, causal=causal,
                         bq=bq, bk=bk)
    got, res = tf.flash_attention_amm(*_t(q, k, v), wl=wl, vbl=vbl,
                                      kind=kind, causal=causal, bq=bq, bk=bk,
                                      residuals=True)
    # the host side of the grid, bit for bit
    ops = tf.flash_amm_operands(*_t(q, k, v), wl=wl, bq=bq, bk=bk)
    jops = _j_operands(q, k, v, wl, bq, bk)
    for name in ("qf", "kf", "vf", "qc", "kc", "vc", "qs", "ks", "vs"):
        assert_array_equal(ops[name].numpy(),
                           np.asarray(jops[name]).reshape(ops[name].shape),
                           err_msg=name)
    # every tile's score products bit for bit, P's codes, the P V
    # products and the output held by what really differs
    _compare(ops, dict(res, out=got.reshape(2, 40, 16)),
             _as_skipped(ops, ref, kind=kind, causal=causal), wl=wl,
             vbl=vbl, causal=causal)


def test_flash_amm_equals_chunked_at_the_flash_tiles():
    """The port's flash-amm plain version and its chunked schedule at the
    flash tiles compute the same function (bit-equal in the reference;
    here held by ``flash_amm_compare``, their exact products being
    batched differently)."""
    _, trt = _rts("bbm0", 16, 13)
    q, k, v = _qkv(sq=200, skv=200, d=16)
    flash, res = tf.flash_attention_amm(*_t(q, k, v), wl=16, vbl=13, kind=0,
                                        residuals=True)
    with port_amm_dot_records() as recs:
        chunked = t_attn.flash_amm_chunked_equiv(*_t(q, k, v), trt)
    _, run, _ = chunked_residuals(recs, (1, 200, 2, 16, 200, 2),
                                  chunked.transpose(1, 2), wl=16,
                                  bq=tf.FLASH_AMM_BQ, bk=tf.FLASH_AMM_BK)
    ops = tf.flash_amm_operands(*_t(q, k, v), wl=16)
    _compare(ops, dict(res, out=flash.reshape(2, 200, 16)),
             _as_skipped(ops, dict(run, out=run["out"][:, :200]), kind=0,
                         causal=True), wl=16, vbl=13, causal=True)


@pytest.mark.parametrize("fault", ["none", "tile_scale", "code", "pv",
                                   "rescale"])
def test_compare_catches_what_a_wrong_kernel_would_change(fault):
    """``flash_amm_compare`` passes two honest runs and fails a run whose
    P tile scale is off by 0.1 % (every code of the tile moves), whose P
    code moves by more than rounding can, whose P V product differs where
    P's codes agree, or whose output is off by 1e-4 of its largest value
    (a wrong rescale)."""
    q, k, v = _t(*_qkv(sq=40, skv=36, d=16))
    ops = tf.flash_amm_operands(q, k, v, wl=16, bq=16, bk=16)
    out, res = tf.flash_amm_plain(ops, wl=16, vbl=13, kind=0, causal=True,
                                  residuals=True)
    a = dict(res, out=out)
    b = {n: t.clone() if isinstance(t, torch.Tensor) else t
         for n, t in a.items()}
    if fault == "tile_scale":
        b["ps"][0, 1, 0] *= 1.001
    elif fault == "code":
        b["pc"][1, 20, 5] += 3
    elif fault == "pv":
        b["pv"][0, 1, 20, 3] = torch.nextafter(b["pv"][0, 1, 20, 3],
                                               torch.tensor(1e9))
    elif fault == "rescale":
        b["out"][1, 30] += 1e-4 * float(out.abs().max())
    rep = tf.flash_amm_compare(ops, a, b, wl=16, vbl=13, causal=True)
    assert rep["ok"] == (fault == "none"), rep
    failed = {"tile_scale": "scales_ok", "code": "code_steps_ok",
              "pv": "pv_equal_where_codes_agree",
              "rescale": "out_within_bound"}.get(fault)
    assert failed is None or not rep[failed], rep


def test_one_hot_probabilities_are_exact():
    """Scores 125 apart make every row of P one-hot exactly (exp of the
    rest underflows to 0 in f32), so P's codes are exact and every tile's
    approximate P V product is an integer-exact function of V's codes:
    the plain version's equals the reference's dot form bit for bit, both
    kinds, and the output is that product up to the last place (XLA may
    fuse the straight-through sum)."""
    s, d, t = 64, 16, 32                 # two whole tiles: no padded rows
    q = np.zeros((1, 1, s, d), np.float32)
    k = np.zeros((1, 1, s, d), np.float32)
    q[0, 0, np.arange(s), np.arange(s) % d] = 500.0
    k[0, 0, np.arange(d), np.arange(d)] = 1.0
    v = np.random.default_rng(2).standard_normal((1, 1, s, d)).astype(
        np.float32)
    jops = _j_operands(q, k, v, 16, t, t)
    for kind in (0, 1):
        want = jf.flash_attention_amm(*(jnp.asarray(a) for a in (q, k, v)),
                                      wl=16, vbl=13, kind=kind, bq=t, bk=t,
                                      causal=False, use_kernel=False)
        got, res = tf.flash_attention_amm(*_t(q, k, v), wl=16, vbl=13,
                                          kind=kind, bq=t, bk=t,
                                          causal=False, residuals=True)
        _within(got.numpy(), want, 2 * 2.0 ** -24 * np.abs(v).max())
        for i in range(2):
            for j in range(2):
                p = np.zeros((t, t), np.float32)
                if j == 0:
                    p[np.arange(t), (i * t + np.arange(t)) % d] = 1.0
                pc, sp = j_ref.amm_quantize(jnp.asarray(p), 16)
                mag, neg = jr.booth_precode(
                    jops["vc"][0, j * t:(j + 1) * t], 16)
                yv = jb.dot_scaled_chunked(pc, mag, neg, wl=16, vbl=13,
                                           kind=kind, f32_dots=True)
                assert_array_equal(
                    res["pv"][0, j, i * t:(i + 1) * t].numpy(),
                    np.asarray(yv * (sp * jops["vs"][0, j])))


# ------------------------------------------------------- exact flash (B4)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,skv", [(40, 40), (24, 56), (33, 17)])
def test_exact_flash_matches_jax(causal, sq, skv):
    q, k, v = _qkv(sq=sq, skv=skv, d=16)
    got = tf.flash_attention(*_t(q, k, v), causal=causal, bq=16, bk=16)
    tol = tf.flash_tolerance(*_t(q, k, v)).numpy()
    want = j_ops.flash_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                 causal=causal, bq=16, bk=16)
    _within(got.numpy(), want, tol)
    if sq == skv:
        naive = j_ref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=causal)
        _within(got.numpy(), naive, tol)
        _within(t_ref.attention_ref(*_t(q, k, v), causal=causal).numpy(),
                naive, tol)


def test_wrappers_run_plain_versions_on_cpu_without_counting():
    q, k, v = _t(*_qkv(sq=20, skv=20, d=16))
    before = (tf.flash_attention.launches, tf.flash_attention_amm.launches)
    assert torch.equal(tf.flash_attention(q, k, v),
                       tf.flash_attention_plain(q, k, v))
    ops = tf.flash_amm_operands(q, k, v, wl=16)
    plain = tf.flash_amm_plain(ops, wl=16, vbl=13, kind=1)
    assert torch.equal(tf.flash_attention_amm(q, k, v, wl=16, vbl=13,
                                              kind=1),
                       plain[:, :20].reshape(q.shape))
    assert (tf.flash_attention.launches,
            tf.flash_attention_amm.launches) == before


@pytest.mark.parametrize("case", ["dtype", "rank", "heads", "tile",
                                  "lowering"])
def test_wrappers_refuse_bad_operands(case):
    q, k, v = _t(*_qkv(sq=8, skv=8, d=16))
    calls = {
        "dtype": lambda: tf.flash_attention(q.long(), k, v),
        "rank": lambda: tf.flash_attention(q[0], k, v),
        "heads": lambda: tf.flash_attention_amm(q, k[:, :1], v[:, :1],
                                                wl=16, vbl=13, kind=0),
        "tile": lambda: tf.flash_attention(q, k, v, bq=256),
        "lowering": lambda: tf.flash_attention_amm(q, k, v, wl=16, vbl=16,
                                                   kind=0),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[case]()


# ----------------------------------------------------------------- routing
def _attn_setup(amm_mode="bitexact", seq=24):
    import dataclasses
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.attention import attn_table
    cfg = reduced(get_arch("qwen2-0.5b"))
    rng = np.random.default_rng(0)
    p = {k: torch.from_numpy((0.3 * rng.standard_normal(s.shape)).astype(
        np.float32)) for k, s in attn_table(cfg).items()}
    x = torch.from_numpy(rng.standard_normal((1, seq, cfg.d_model)).astype(
        np.float32))
    pos = torch.arange(seq)[None]
    amm = TRuntime.build(TAmm(mode=amm_mode, mul="bbm0", wl=16, param=13,
                              apply_to="all"), device="cpu")
    return dataclasses.replace(cfg), p, x, pos, amm


@pytest.mark.parametrize("amm_on", [False, True])
def test_use_pallas_routes_through_the_flash_wrappers(amm_on, monkeypatch):
    cfg, p, x, pos, amm = _attn_setup()
    calls = []
    for name in ("flash_attention", "flash_attention_amm"):
        fn = getattr(t_attn, name)
        monkeypatch.setattr(t_attn, name, lambda *a, _f=fn, _n=name, **kw: (
            calls.append(_n), _f(*a, **kw))[1])
    with warnings.catch_warnings():
        warnings.simplefilter("error", t_attn.FlashFallbackWarning)
        y, _ = t_attn.attention(p, x, cfg, positions=pos, use_pallas=True,
                                amm=amm if amm_on else None)
    assert calls == (["flash_attention_amm"] if amm_on
                     else ["flash_attention"])
    ref, _ = t_attn.attention(p, x, cfg, positions=pos,
                              amm=amm if amm_on else None)
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= 1e-3 * scale


def test_seq_cap_fallback_warns_with_context(monkeypatch):
    cfg, p, x, pos, amm = _attn_setup()
    monkeypatch.setattr(t_attn, "_FLASH_SEQ_CAP", 16)
    with pytest.warns(t_attn.FlashFallbackWarning,
                      match="exceeds the flash cap.*seq=24.*cap=16"):
        y, _ = t_attn.attention(p, x, cfg, positions=pos, use_pallas=True,
                                amm=amm)
    want, _ = t_attn.attention(p, x, cfg, positions=pos, amm=amm)
    assert torch.equal(y, want)


def test_fallback_warning_deduplicated_per_site(monkeypatch):
    cfg, p, x, pos, _ = _attn_setup()
    monkeypatch.setattr(t_attn, "_FLASH_SEQ_CAP", 16)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        for _ in range(3):
            t_attn.attention(p, x, cfg, positions=pos, use_pallas=True)
    assert sum(isinstance(r.message, t_attn.FlashFallbackWarning)
               for r in rec) == 1


def test_no_lowering_fallback_warns():
    cfg, p, x, pos, _ = _attn_setup()
    noise = TRuntime.build(TAmm(mode="noise", mul="bbm0", wl=16, param=13,
                                apply_to="all", use_pallas=True),
                           device="cpu")
    assert noise.attn_lowering is None
    with pytest.warns(t_attn.FlashFallbackWarning, match="no flash lowering"):
        t_attn.attention(p, x, cfg, positions=pos, use_pallas=True,
                         amm=noise)


# --------------------------------------------------------------- gradients
def _grads_close(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        err = np.abs(g.numpy().astype(np.float64) - w).max()
        assert err <= GRAD_RTOL * np.abs(w).max(), (err, np.abs(w).max())
        assert np.isfinite(g.numpy()).all()


@pytest.mark.parametrize("mul,wl,vbl", [("bbm0", 16, 13), ("bbm1", 16, 15)])
def test_flash_amm_ste_gradient_matches_jax(mul, wl, vbl):
    jrt, trt = _rts(mul, wl, vbl)
    q, k, v = _qkv(sq=150, skv=150, d=16)

    def j_loss(q, k, v):
        return jnp.sum(jnp.square(j_attn._flash_amm_ste(jrt, True, q, k, v)))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    loss = torch.sum(torch.square(t_attn._flash_amm_ste(trt, True, tq, tk,
                                                        tv)))
    got = torch.autograd.grad(loss, (tq, tk, tv))
    _grads_close(got, want)


def test_exact_flash_gradient_matches_the_chunked_path():
    """jax.grad cannot pass through the interpreted exact-flash
    ``pallas_call`` (an AssertionError in its JVP under jax 0.9.0,
    ROADMAP C8), so the port's gradient is held against the reference's
    chunked path at the same tiles, whose gradient is the same function's
    (1e-5 of the largest: f32 sums in another order)."""
    q, k, v = _qkv(sq=150, skv=150, d=16)

    def j_loss(q, k, v):
        out = j_attn.chunked_attention(q.transpose(0, 2, 1, 3),
                                       k.transpose(0, 2, 1, 3),
                                       v.transpose(0, 2, 1, 3), causal=True,
                                       bq=128, bk=128)
        return jnp.sum(jnp.square(out))

    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                 for a in (q, k, v)))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    loss = torch.sum(torch.square(t_attn._FlashExact.apply(tq, tk, tv,
                                                           True)))
    got = torch.autograd.grad(loss, (tq, tk, tv))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
