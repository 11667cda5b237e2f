"""Parity of the port's ``quant_matmul`` with the JAX package's.

The same numpy inputs go through the reference's Pallas kernel (in
interpret mode, with a K block ``bk`` that divides K, which is where the
reference kernel is right), its oracle ``quant_matmul_ref``, and the
port's wrapper on the CPU, where it runs its plain PyTorch version.

Tolerances.  Bit for bit wherever every K-chunk partial sum is an integer
below 2^24 and there is no noise: the two sides then add the same exact
partials in the same order.  Elsewhere (wl = 12 and 16, whose products
reach 2^22 and 2^30, and with noise, whose normals come from two
libraries' ``log`` and ``cos``) the comparison takes
``quant_matmul_tolerance``: a first-order rounding bound derived in its
docstring (accumulation ``2 (K + chunks) u T``, normals within
``Z_TOL = 2^-16``, one rounding each for the noise, the sum and the
descale).  The hash's integer uniforms are compared bit for bit.
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.kernels.ref import quant_matmul_ref as j_ref
from repro_torch.kernels.ref import amm_scale
from repro_torch.kernels.ref import quant_matmul_ref as t_ref

pytest_plugins = ["port_first"]

j_qm = importlib.import_module("repro.kernels.quant_matmul")
t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")

# bbm0 at wl = 16, vbl = 13: the moments the served model injects
MU16, SIGMA16 = -18779.225471496582, 6859.595897768407
# (M, K, N, bm, bk, bn): ragged M and N, several tiles in each direction
# (multi-tile salts), several K chunks
SHAPES = [(16, 64, 24, 8, 32, 16), (20, 96, 40, 8, 32, 16),
          (33, 128, 70, 16, 64, 32), (1, 64, 130, 1, 64, 128)]


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.02 * rng.standard_normal((k, n))).astype(np.float32)
    return x, w


def _scales(x, w, wl):
    return (float(amm_scale(torch.from_numpy(x), wl)),
            float(amm_scale(torch.from_numpy(w), wl)))


def _jax(x, w, sx, sw, mu, sigma, *, wl, seed, bm, bk, bn):
    return np.asarray(j_qm.quant_matmul(
        jnp.asarray(x), jnp.asarray(w), sx, sw, mu, sigma, wl=wl, seed=seed,
        bm=bm, bk=bk, bn=bn, interpret=True))


def _port(x, w, sx, sw, mu, sigma, **kw):
    return t_qm.quant_matmul(torch.from_numpy(x), torch.from_numpy(w), sx,
                             sw, mu, sigma, **kw).numpy()


def _bound(x, w, sx, sw, mu, sigma, *, wl, bk):
    return t_qm.quant_matmul_tolerance(
        torch.from_numpy(x), torch.from_numpy(w), torch.tensor(sx),
        torch.tensor(sw), mu, sigma, wl=wl, bk=bk).numpy()


@pytest.fixture(scope="module")
def jax_runs():
    """Every JAX-side result of this module, computed once (few XLA
    programs per worker)."""
    out = {}
    for i, (m, k, n, bm, bk, bn) in enumerate(SHAPES):
        x, w = _inputs(m, k, n, seed=i)
        for wl, mu, sigma in ((8, 0.0, 0.0), (12, -789.5, 358.486),
                              (16, 0.0, 0.0), (16, MU16, SIGMA16)):
            sx, sw = _scales(x, w, wl)
            kw = dict(wl=wl, seed=1000 + i, bm=bm, bk=bk, bn=bn)
            out[i, wl, mu] = (x, w, sx, sw, mu, sigma, kw,
                              _jax(x, w, sx, sw, mu, sigma, **kw))
    return out


@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_noiseless_wl8_bitwise(jax_runs, case):
    x, w, sx, sw, mu, sigma, kw, want = jax_runs[case, 8, 0.0]
    got = _port(x, w, sx, sw, mu, sigma, **kw)
    assert_array_equal(got, want)
    assert_array_equal(got, np.asarray(j_ref(jnp.asarray(x), jnp.asarray(w),
                                             sx, sw, 0.0, 0.0, wl=8)))
    assert not _bound(x, w, sx, sw, mu, sigma, wl=8, bk=kw["bk"]).any()


@pytest.mark.parametrize("wl,mu", [(12, -789.5), (16, 0.0), (16, MU16)])
@pytest.mark.parametrize("case", range(len(SHAPES)))
def test_within_the_derived_bound(jax_runs, case, wl, mu):
    x, w, sx, sw, mu, sigma, kw, want = jax_runs[case, wl, mu]
    got = _port(x, w, sx, sw, mu, sigma, **kw)
    tol = _bound(x, w, sx, sw, mu, sigma, wl=wl, bk=kw["bk"])
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= tol).all(), (err.max(), tol.max())
    if sigma:   # the noise is there: it moves the output by sigma*sqrt(K)
        base = _port(x, w, sx, sw, 0.0, 0.0, **kw)
        assert np.abs(got - base).max() > 10 * tol.max()


@pytest.mark.parametrize("k", [896, 4864])
def test_ragged_k_is_quant_matmul_ref(k):
    """K not a multiple of the 512 K block (qwen2-0.5b's MLP): the tail
    counts as zero, so the port gives the oracle's function, finite."""
    x, w = _inputs(4, k, 24, seed=k)
    for wl in (8, 16):
        sx, sw = _scales(x, w, wl)
        got = _port(x, w, sx, sw, 0.0, 0.0, wl=wl)
        want = np.asarray(j_ref(jnp.asarray(x), jnp.asarray(w), sx, sw, 0.0,
                                0.0, wl=wl))
        assert np.isfinite(got).all()
        tol = _bound(x, w, sx, sw, 0.0, 0.0, wl=wl, bk=512)
        assert (np.abs(got.astype(np.float64) - want) <= tol).all()
        if wl == 8:        # exact chunk sums: the oracles agree bitwise
            assert_array_equal(got, want)
            assert_array_equal(got, t_ref(torch.from_numpy(x),
                                          torch.from_numpy(w), sx, sw, 0.0,
                                          0.0, wl=wl).numpy())


def _jax_words(shape, seed, salt):
    """The integer half of the reference's ``_hash_normal``, in JAX's
    uint32 arithmetic (its lines 47-59, with the two squares calls)."""
    r = jnp.arange(shape[0], dtype=jnp.uint32)[:, None]
    c = jnp.arange(shape[1], dtype=jnp.uint32)[None, :]
    ctr = r * jnp.uint32(0x9E3779B9) + c * jnp.uint32(0x85EBCA6B)
    ctr = ctr + jnp.int32(seed).astype(jnp.uint32) * jnp.uint32(0xC2B2AE35)
    ctr = ctr + jnp.int32(salt).astype(jnp.uint32) * jnp.uint32(0x27D4EB2F)

    def squares(x, key):
        x = x * key
        x = (x >> 16) | (x << 16)
        x = x * x + key
        x = (x >> 16) | (x << 16)
        return x * x + key
    return (squares(ctr, jnp.uint32(0xB5AD4ECE)),
            squares(ctr ^ jnp.uint32(0xDEADBEEF), jnp.uint32(0x548C9DEC)))


@pytest.mark.parametrize("seed,salt", [(0, 0), (123, 5), (-7, 3 * 7919 + 2),
                                       (2 ** 31 - 1, 1)])
def test_hash_uniforms_bitwise_and_normals_within_tolerance(seed, salt):
    shape = (40, 48)
    w1, w2 = _jax_words(shape, seed, salt)
    # the transcription is the reference's: Box-Muller over these words in
    # JAX reproduces its _hash_normal bit for bit
    u1 = jnp.clip(w1.astype(jnp.float32) / 4294967296.0, 1e-7, 1.0)
    u2 = w2.astype(jnp.float32) / 4294967296.0
    z_words = jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * jnp.pi * u2)
    z_ref = j_qm._hash_normal(shape, jnp.int32(seed), jnp.int32(salt))
    assert_array_equal(np.asarray(z_words), np.asarray(z_ref))
    r = torch.arange(shape[0], dtype=torch.int64)[:, None]
    c = torch.arange(shape[1], dtype=torch.int64)[None, :]
    t1, t2 = t_qm._words(r, c, seed, torch.tensor(salt))
    assert_array_equal(t1.numpy(), np.asarray(w1).astype(np.int64))
    assert_array_equal(t2.numpy(), np.asarray(w2).astype(np.int64))
    z = t_qm.hash_normal(shape, seed, salt).numpy()
    assert np.abs(z - np.asarray(z_ref)).max() <= t_qm.Z_TOL


def test_grid_hash_is_the_tile_hash():
    """The whole-output hash uses tile-local iotas and salt i*7919 + j."""
    m, n, bm, bn, seed = 20, 40, 8, 16, 99
    w1, _ = t_qm.hash_words_plain(m, n, seed, bm=bm, bn=bn)
    for i in range(-(-m // bm)):
        for j in range(-(-n // bn)):
            tile_r = torch.arange(bm, dtype=torch.int64)[:, None]
            tile_c = torch.arange(bn, dtype=torch.int64)[None, :]
            t1, _ = t_qm._words(tile_r, tile_c, seed,
                                torch.tensor(i * 7919 + j))
            blk = w1[i * bm:(i + 1) * bm, j * bn:(j + 1) * bn]
            assert torch.equal(blk, t1[:blk.shape[0], :blk.shape[1]])


def test_noise_moments():
    """The injected noise carries the calibrated (mu, sigma), as
    ``test_amm_noise_pallas_moments`` checks on the reference."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = rng.standard_normal((128, 64)).astype(np.float32)
    mu, sigma = -789.5, 358.486
    sx, sw = _scales(x, w, 12)
    base = _port(x, w, sx, sw, 0.0, 0.0, wl=12, seed=3)
    noisy = _port(x, w, sx, sw, mu, sigma, wl=12, seed=3)
    eps = (noisy.astype(np.float64) - base) / (np.float32(sx) * np.float32(sw))
    assert eps.mean() == pytest.approx(mu * 128, rel=0.1)
    assert eps.std() == pytest.approx(sigma * np.sqrt(128), rel=0.1)
    again = _port(x, w, sx, sw, mu, sigma, wl=12, seed=3)
    other = _port(x, w, sx, sw, mu, sigma, wl=12, seed=4)
    assert_array_equal(noisy, again)
    assert not np.array_equal(noisy, other)


BAD = {
    "dtype": lambda x, w: (x.double(), w, {}, TypeError),
    "contiguity": lambda x, w: (x.t().contiguous().t(), w, {}, ValueError),
    "shape": lambda x, w: (x, w[:-1].contiguous(), {}, ValueError),
    "rank": lambda x, w: (x[0], w, {}, ValueError),
    "word length": lambda x, w: (x, w, {"wl": 18}, ValueError),
    "tile": lambda x, w: (x, w, {"bk": 0}, ValueError),
    "scale": lambda x, w: (x, w, {"s_x": torch.ones(2)}, ValueError),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrapper_refuses_bad_operands(case):
    x, w = (torch.from_numpy(a) for a in _inputs(4, 64, 8, seed=0))
    if case == "contiguity":
        x = torch.from_numpy(np.ascontiguousarray(_inputs(64, 4, 8, 0)[0]))
    x, w, kw, err = BAD[case](x, w)
    s_x = kw.pop("s_x", 0.01)
    before = t_qm.quant_matmul.launches
    with pytest.raises(err):
        t_qm.quant_matmul(x, w, s_x, 0.01, **kw)
    assert t_qm.quant_matmul.launches == before


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    x, w = (torch.from_numpy(a) for a in _inputs(8, 96, 24, seed=5))
    before = t_qm.quant_matmul.launches
    got = t_qm.quant_matmul(x, w, 0.01, 0.002, MU16, SIGMA16, seed=9)
    want = t_qm.quant_matmul_plain(x, w, torch.tensor(0.01),
                                   torch.tensor(0.002), MU16, SIGMA16, wl=16,
                                   seed=9, bm=128, bk=512, bn=128)
    assert torch.equal(got, want)
    assert t_qm.quant_matmul.launches == before
