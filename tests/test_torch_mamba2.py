"""The port's Mamba2 block against the JAX package's: the chunked SSD scan,
its sequential oracle, the one-token decode step, the causal conv, the
whole block at prefill and decode, and the ragged-length contract.

Inputs are drawn in numpy from fixed seeds and handed to both sides.

Tolerances.  The scan is f32 on both sides, with the same chunk
decomposition; the sums inside each einsum and the within-chunk cumsum
may run in another order, so outputs and states are held to 1e-5 of
their largest magnitude (f32 sums of at most a few hundred terms move by
about 1e-6 of it).  The block adds f32 projections of K = 64 and 128
terms and a gated RMSNorm, and is held to 1e-5 likewise.
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
from repro.models import mamba2 as j_m
from repro_torch.configs import get_arch as t_get
from repro_torch.configs import reduced as t_reduced
from repro_torch.models import mamba2 as t_m

pytest_plugins = ["port_first"]

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _ssd_inputs(seed, b=2, l=32, h=4, p=8, g=1, n=8):
    """x, dt (softplus of a normal, so positive), A (negative), B_, C_, D."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, l, h, p)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)) - 1.0)).astype(f)
    a = (-np.exp(rng.standard_normal(h) * 0.5)).astype(f)
    bb = rng.standard_normal((b, l, g, n)).astype(f)
    cc = rng.standard_normal((b, l, g, n)).astype(f)
    d = rng.standard_normal(h).astype(f)
    return x, dt, a, bb, cc, d


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("groups", [1, 2])
def test_ssd_chunked_matches_the_reference(chunk, groups):
    """Chunk 4 over 32 positions runs the inter-chunk recurrence over 8
    chunks; chunk 16 over 2."""
    arrs = _ssd_inputs(chunk + groups, g=groups)
    want_y, want_s = jax.jit(lambda *a: j_m.ssd_chunked(*a, chunk=chunk))(
        *_j(arrs))
    got_y, got_s = t_m.ssd_chunked(*_t(arrs), chunk=chunk)
    _close(got_y.numpy(), want_y)
    _close(got_s.numpy(), want_s)
    # and against the sequential oracle, on the port's side alone
    _close(got_y.numpy(), t_m.ssd_reference(*_t(arrs)).numpy())


def test_ssd_reference_and_decode_steps_match_the_reference():
    """The sequential oracle on both sides; then ``ssd_decode_step``
    continuing the chunked scan's final state over 4 more positions gives
    the oracle's outputs for the whole sequence, on both sides."""
    arrs = _ssd_inputs(7, l=20, g=2)
    want = jax.jit(j_m.ssd_reference)(*_j(arrs))
    got = t_m.ssd_reference(*_t(arrs))
    _close(got.numpy(), want)
    x, dt, a, bb, cc, d = _t(arrs)
    pre = 16
    y0, state = t_m.ssd_chunked(x[:, :pre], dt[:, :pre], a, bb[:, :pre],
                                cc[:, :pre], d, chunk=8)
    j_state = jax.jit(lambda *v: j_m.ssd_chunked(*v, chunk=8)[1])(
        *(jnp.asarray(v[:, :pre].numpy()) if v.ndim > 1
          else jnp.asarray(v.numpy()) for v in (x, dt, a, bb, cc, d)))
    _close(state.numpy(), j_state)
    rep = a.shape[0] // bb.shape[2]
    j_step = jax.jit(j_m.ssd_decode_step)
    ys, j_ys = [y0], []
    for t in range(pre, x.shape[1]):
        bt = torch.repeat_interleave(bb[:, t], rep, dim=1)
        ct = torch.repeat_interleave(cc[:, t], rep, dim=1)
        yt, new = t_m.ssd_decode_step(state, x[:, t], dt[:, t], a, bt, ct, d)
        jy, j_state = j_step(j_state, *(jnp.asarray(v.numpy()) for v in (
            x[:, t], dt[:, t], a, bt, ct, d)))
        _close(yt.numpy(), jy)
        _close(new.numpy(), j_state)
        ys.append(yt[:, None])
        state = new
    _close(torch.cat(ys, dim=1).numpy(), want)


@pytest.mark.parametrize("state_dtype", [None, "bfloat16", "float32"])
def test_causal_conv_matches_the_reference(state_dtype):
    """Without a history (zero padded) and with one; a bf16 history and
    the f32 input give an f32 new state on both sides (ROADMAP C12)."""
    rng = np.random.default_rng(3)
    s = 6 if state_dtype is None else 1
    xbc = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = (rng.standard_normal((4, 24)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    hist = rng.standard_normal((2, 3, 24)).astype(np.float32)
    if state_dtype is None:
        want = j_m._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                jnp.asarray(bias))
        got = t_m._causal_conv(*_t((xbc, w, bias)))
    else:
        jh = jnp.asarray(hist).astype(getattr(jnp, state_dtype))
        th = torch.from_numpy(hist).to(getattr(torch, state_dtype))
        want = j_m._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                jnp.asarray(bias), jh)
        got = t_m._causal_conv(*_t((xbc, w, bias)), th)
    assert str(got[1].dtype).split(".")[-1] == str(want[1].dtype)
    _close(got[0].numpy(), want[0])
    _close(got[1].float().numpy(), np.asarray(want[1], np.float32))


def _block():
    """A reduced mamba2 layer's parameters (a_log, dt_bias, d_skip, conv_b
    drawn too, not left at their inits) and the config, on both sides."""
    j_cfg = j_reduced(j_get("mamba2-370m"))
    t_cfg = t_reduced(t_get("mamba2-370m"))
    rng = np.random.default_rng(11)
    p = {}
    for k, spec in sorted(j_m.mamba_table(j_cfg).items()):
        scale = {"a_log": 0.5, "dt_bias": 0.5, "d_skip": 1.0,
                 "conv_b": 0.1, "norm_w": 0.1}.get(k, spec.scale)
        base = 1.0 if k == "norm_w" else 0.0
        p[k] = (base + rng.standard_normal(spec.shape) * scale).astype(
            np.float32)
    return j_cfg, t_cfg, p


@pytest.mark.parametrize("s", [1, 16, 32], ids=["s1", "one-chunk",
                                                 "two-chunks"])
def test_mamba_apply_prefill_matches_the_reference(s):
    j_cfg, t_cfg, p = _block()
    x = np.random.default_rng(s).standard_normal(
        (2, s, t_cfg.d_model)).astype(np.float32)
    # the residual stream is bf16: the block's input, rmsnorm'd, is f32
    # of bf16 values
    x = np.asarray(torch.from_numpy(x).bfloat16().float())
    want, (w_state, w_conv) = jax.jit(lambda pp, v: j_m.mamba_apply(
        pp, v, j_cfg))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got, (g_state, g_conv) = t_m.mamba_apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        t_cfg)
    _close(got.numpy(), want)
    _close(g_state.numpy(), w_state)
    _close(g_conv.numpy(), w_conv)
    assert g_conv.dtype == torch.float32 and w_conv.dtype == jnp.float32


def test_mamba_decode_steps_match_the_reference():
    """A 16-token prefill, then 3 decode steps from its states (the conv
    history handed in as bf16, as the cache holds it first)."""
    j_cfg, t_cfg, p = _block()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 19, t_cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    j_apply = jax.jit(lambda pp, v, st, cv: j_m.mamba_decode_step(
        pp, v, j_cfg, st, cv))
    _, (w_st, w_cv) = jax.jit(lambda pp, v: j_m.mamba_apply(
        pp, v, j_cfg))(jp, jnp.asarray(x[:, :16]))
    _, (g_st, g_cv) = t_m.mamba_apply(tp, torch.from_numpy(x[:, :16]), t_cfg)
    w_cv, g_cv = w_cv.astype(jnp.bfloat16), g_cv.bfloat16()
    for t in range(16, 19):
        want, (w_st, w_cv) = j_apply(jp, jnp.asarray(x[:, t:t + 1]), w_st,
                                     w_cv)
        got, (g_st, g_cv) = t_m.mamba_decode_step(
            tp, torch.from_numpy(x[:, t:t + 1]), t_cfg, g_st, g_cv)
        _close(got.numpy(), want)
        _close(g_st.numpy(), w_st)
        _close(g_cv.numpy(), w_cv)
        assert g_cv.dtype == torch.float32 and w_cv.dtype == jnp.float32


def test_ragged_prompt_raises_on_both_sides():
    """ROADMAP C11: a sequence longer than the chunk and not a multiple of
    it is refused by the reference's assertion and by the port."""
    j_cfg, t_cfg, p = _block()
    x = np.zeros((1, 24, t_cfg.d_model), np.float32)
    assert t_cfg.ssm_chunk == j_cfg.ssm_chunk == 16
    with pytest.raises(AssertionError, match="not divisible"):
        j_m.mamba_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x), j_cfg)
    with pytest.raises(ValueError, match="not divisible"):
        t_m.mamba_apply({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), t_cfg)
    # a sequence of at most one chunk is one chunk, on both sides
    cfg = dataclasses.replace(t_cfg, ssm_chunk=32)
    y, _ = t_m.mamba_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), cfg)
    assert torch.isfinite(y).all()


def test_mamba_table_and_configs_match_the_reference():
    for name in ("mamba2-370m", "zamba2-2.7b"):
        j_cfg, t_cfg = j_get(name), t_get(name)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
        for c_j, c_t in ((j_cfg, t_cfg),
                         (j_reduced(j_cfg), t_reduced(t_cfg))):
            for f in ("ssm_conv", "ssm_groups", "d_inner", "ssm_heads",
                      "ssm_state", "ssm_headdim", "ssm_chunk"):
                assert getattr(c_t, f) == getattr(c_j, f), (name, f)
            want = {k: (v.shape, v.axes, v.init, v.scale)
                    for k, v in j_m.mamba_table(c_j).items()}
            got = {k: (v.shape, v.axes, v.init, v.scale)
                   for k, v in t_m.mamba_table(c_t).items()}
            assert got == want
