"""Parity of the port's noise-mode pieces with the JAX package's.

* ``core.prng``: the threefry keys, splits and ``randint`` draws behind
  the reference's per-layer noise seeds, bit for bit (integers);
* ``core.errstats.characterize`` and ``core.noise.make_noise_model``:
  equal floats (the same integer errors, summed in the same order in
  float64 on the host);
* ``kernels.ref.amm_quantize``: bit for bit, bf16 input at full scale
  included;
* ``models.common.amm_dense`` in noise mode through the fused kernel:
  bit for bit at wl = 8 on operands whose exact f32 product has no
  rounding (both sides then hold the same ``exact`` for the
  straight-through sum), and within ``quant_matmul_tolerance`` plus one
  rounding of the straight-through sum at wl = 16 with a key; on the
  plain branch (no ``use_pallas``) with the layer key, whose draws are
  ``jax.random.normal``'s, within the same derivation.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.configs.base import AmmConfig as JAmm
from repro.core import errstats as j_err
from repro.core import multipliers as j_mult
from repro.core import noise as j_noise
from repro.kernels.ref import amm_quantize as j_quantize
from repro.models import common as j_common
from repro_torch.configs.base import AmmConfig as TAmm
from repro_torch.core import errstats as t_err
from repro_torch.core import multipliers as t_mult
from repro_torch.core import noise as t_noise
from repro_torch.core import prng
from repro_torch.kernels.ref import amm_quantize as t_quantize
from repro_torch.kernels.ref import amm_scale
from repro_torch.models import common as t_common

pytest_plugins = ["port_first"]

t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")


def _words(k):
    return tuple(int(v) for v in jax.random.key_data(k))


# ------------------------------------------------------------------ prng
def test_keys_splits_and_randint_match_jax_for_many_seeds():
    rng = np.random.default_rng(0)
    seeds = [0, 1, -1, 2 ** 31 - 1, -2 ** 31] + \
        rng.integers(-2 ** 31, 2 ** 31 - 1, 100).tolist()
    for seed in seeds:
        jk = jax.random.key(seed)
        tk = prng.key(seed)
        assert _words(jk) == tk
        assert [_words(k) for k in jax.random.split(jk, 3)] \
            == prng.split(tk, 3)
        assert int(jax.random.randint(jk, (), 0, 2 ** 31 - 1, jnp.int32)) \
            == prng.randint(tk)
        assert int(jax.random.randint(jk, (), -50, 7, jnp.int32)) \
            == prng.randint(tk, -50, 7)
        assert int(jax.random.bits(jk, (), jnp.uint32)) \
            == prng.random_bits32(tk)


def test_layer_seed_chain_of_lm_apply():
    """``lm_apply``'s chain: key(0), one split per layer, the layer key's
    ``randint`` as ``amm_dense`` draws it."""
    key = jax.random.key(0)
    want = []
    for _ in range(24):
        key, sub = jax.random.split(key)
        want.append(int(jax.random.randint(sub, (), 0, 2 ** 31 - 1,
                                           jnp.int32)))
    assert list(prng.layer_seeds(0, 24)) == want
    assert prng.layer_seeds(0, 2) == tuple(want[:2])


# ----------------------------------------------- characterize, noise model
@pytest.mark.parametrize("wl,vbl", [(16, 13), (12, 9)])
def test_characterize_and_noise_model_equal_jax(wl, vbl):
    """wl = 16: 2^18 sampled pairs; wl = 12: all 2^24 pairs."""
    j = j_err.characterize(j_mult.MulSpec("bbm0", wl, vbl), sample=1 << 18)
    t = t_err.characterize(t_mult.MulSpec("bbm0", wl, vbl), sample=1 << 18,
                           device="cpu")
    for f in ("mean", "mse", "prob", "min", "max", "var", "n"):
        assert getattr(t, f) == getattr(j, f), f
    jm = j_noise.make_noise_model(j_mult.MulSpec("bbm0", wl, vbl),
                                  sample=1 << 18)
    tm = t_noise.make_noise_model(t_mult.MulSpec("bbm0", wl, vbl),
                                  sample=1 << 18, device="cpu")
    assert (tm.mean, tm.var) == (jm.mean, jm.var)
    assert tm.dot_moments(896) == jm.dot_moments(896)
    assert t_noise.make_noise_model(t_mult.MulSpec("bbm0", wl, vbl),
                                    sample=1 << 18) is tm


def test_amm_runtime_moments_equal_jax():
    cfg = dict(mode="noise", mul="bbm0", wl=16, param=13, use_pallas=True)
    j = j_common.AmmRuntime.build(JAmm(**cfg))
    t = t_common.AmmRuntime.build(TAmm(**cfg), device="cpu")
    assert (t.mu, t.sigma) == (float(j.mu), float(j.sigma))
    assert t.mlp_active and not t.attn_active


# ---------------------------------------------------------- the quantizer
@pytest.mark.parametrize("wl", [8, 12, 16])
def test_amm_quantize_bitwise(wl):
    rng = np.random.default_rng(wl)
    v = (rng.standard_normal((37, 53)) * 3).astype(np.float32)
    v[0, 0] = 0.5 * np.abs(v).max()            # a half-way code
    for arr in (v, v.astype(jnp.bfloat16)):
        jc, js = j_quantize(jnp.asarray(arr), wl)
        tc, ts = t_quantize(torch.from_numpy(np.asarray(arr, np.float32))
                            .to(torch.bfloat16 if arr.dtype != np.float32
                                else torch.float32), wl)
        assert_array_equal(tc.numpy(), np.asarray(jc))
        assert ts.numpy() == np.asarray(js)


def test_amm_quantize_bf16_full_scale_does_not_wrap():
    """bf16 cannot hold 32767; quantizing in f32 keeps +lim."""
    x = np.ones((4, 16), np.float32)
    jc, js = j_quantize(jnp.asarray(x, jnp.bfloat16), 16)
    tc, ts = t_quantize(torch.from_numpy(x).to(torch.bfloat16), 16)
    assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.max()) == 2 ** 15 - 1 and int(tc.min()) >= -2 ** 15
    assert ts.numpy() == np.asarray(js)


# ------------------------------------------------------------- amm_dense
def _rts(wl, vbl, mul="bbm0", use_pallas=True):
    cfg = dict(mode="noise", mul=mul, wl=wl, param=vbl,
               use_pallas=use_pallas)
    return j_common.AmmRuntime.build(JAmm(**cfg)), \
        t_common.AmmRuntime.build(TAmm(**cfg), device="cpu")


def test_amm_dense_wl8_bitwise():
    """Dyadic operands with few bits: the exact product rounds nowhere,
    so both sides form the same ``exact``; at wl = 8 without a key the
    quantized product is exact too, hence the whole STE value is."""
    rng = np.random.default_rng(1)
    x = (rng.integers(-8, 9, (2, 5, 32)) / 8).astype(np.float32)
    w = (rng.integers(-8, 9, (32, 24)) / 16).astype(np.float32)
    jrt, trt = _rts(8, 5)
    want = np.asarray(j_common.amm_dense(jnp.asarray(x), jnp.asarray(w),
                                         jrt))
    got = t_common.amm_dense(torch.from_numpy(x), torch.from_numpy(w), trt)
    assert_array_equal(got.numpy(), want)
    assert got.shape == (2, 5, 24)


def test_amm_dense_wl16_keyed_within_tolerance():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((64, 40))).astype(np.float32)
    jrt, trt = _rts(16, 13)
    key = jax.random.split(jax.random.key(0))[1]
    tkey = prng.split(prng.key(0))[1]
    want = np.asarray(j_common.amm_dense(jnp.asarray(x), jnp.asarray(w), jrt,
                                         key=key), np.float64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = t_common.amm_dense(xt, wt, trt, tkey).numpy()
    tol = t_qm.quant_matmul_tolerance(xt, wt, amm_scale(xt, 16),
                                      amm_scale(wt, 16), trt.mu, trt.sigma,
                                      wl=16).numpy()
    # plus the straight-through sum's roundings on each side (the exact
    # products differ by their own f32 rounding: K * u * |x| @ |w|)
    u = 2.0 ** -24
    tol = tol + 4 * u * np.abs(want) + 2 * 64 * u * (np.abs(x) @ np.abs(w))
    assert (np.abs(got - want) <= tol).all()
    # and the noise is on: without a key the output moves
    plain = t_common.amm_dense(xt, wt, trt).numpy()
    assert np.abs(plain - got).max() > 5 * tol.max()


def test_amm_dense_raises_where_a_later_slice_ports():
    """The plain noise branch (no ``use_pallas``), once a later slice's
    (the name is kept), against the reference inside ``jax.jit`` with
    the same key: the draws are equal, the f32 matmul of the codes sums
    in another order (``quant_matmul_tolerance`` with one K chunk), and
    the straight-through sum rounds as in the keyed test above."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = (0.05 * rng.standard_normal((64, 40))).astype(np.float32)
    jrt, trt = _rts(16, 13, use_pallas=False)
    jkey = jax.random.split(jax.random.key(0))[1]
    tkey = prng.split(prng.key(0))[1]
    fn = jax.jit(lambda x, w, k: j_common.amm_dense(x, w, jrt, key=k))
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w), jkey), np.float64)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = t_common.amm_dense(xt, wt, trt, tkey).numpy()
    x2 = xt.reshape(-1, 64)
    tol = t_qm.quant_matmul_tolerance(x2, wt, amm_scale(xt, 16),
                                      amm_scale(wt, 16), trt.mu, trt.sigma,
                                      wl=16, bk=64).numpy().reshape(got.shape)
    u = 2.0 ** -24
    tol = tol + 4 * u * np.abs(want) + 2 * 64 * u * (np.abs(x) @ np.abs(w))
    assert got.shape == (2, 3, 40)
    assert (np.abs(got - want) <= tol).all()
    # the noise is on, and it is the key's: without one the output moves
    off = t_common.amm_dense(xt, wt, trt).numpy()
    assert np.abs(off - got).max() > 5 * tol.max()
    # bitexact mode, a later slice when this test was written, is ported
    bitexact = t_common.AmmRuntime.build(TAmm(mode="bitexact"))
    assert bitexact.cacheable and bitexact.attn_lowering == (16, 13, 0)
