"""The flash kernels' dead-tile schedule, on the CPU.

* ``live_kv_tiles`` (the count both kernels compute) against a brute
  force over the mask: every (q-block, KV tile) pair is live exactly when
  some (row, key) pair in it is unmasked, and the live tiles of a q-block
  are a prefix of the KV axis;
* one online-softmax step over a dead tile leaves the running max, sum
  and accumulator bit for bit, in the exact schedule and on the amm
  datapath at kind 0; at kind 1 a dead tile's P V product is not 0,
  which is why kind 1 computes every tile;
* the residuals of a skipped tile hold the defined values, and a kind-1
  run computes its dead tiles;
* the precision control of ``chip_smoke.py``: its TF32 rounding, and 16
  times the plain version's f32 error against float64 attention below
  the error of 1xTF32 score products, of 3xTF32 ones short of a cross
  term, and (head dims 80 and 128) of a P V with V or P in TF32;
* the plain version of the exact kernel against the reference's exact
  flash attention (``kernels.ops.flash_attention``, interpret mode)
  within ``flash_tolerance``, with tiles of 64 and 128 and Sq != Skv.
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro.kernels import ops as j_ops
from repro_torch.kernels.booth_rows import booth_precode, num_corr_rows

pytest_plugins = ["port_first"]

tf = importlib.import_module("repro_torch.kernels.flash_attention")
tb = importlib.import_module("repro_torch.kernels.bbm_matmul")

LENGTHS = [(1, 1), (127, 127), (128, 128), (200, 200), (512, 512),
           (200, 77), (77, 200), (512, 300)]


def _brute_live(sq, skv, bq, bk, causal, kv_len):
    """(nq, nk) bool: some unmasked (row, key) pair in the tile pair."""
    kv_len = skv if kv_len is None else kv_len
    rows = np.arange(sq)[:, None]
    keys = np.arange(skv)[None, :]
    live = (keys < kv_len) & ((rows >= keys) | (not causal))
    nq, nk = -(-sq // bq), -(-skv // bk)
    out = np.zeros((nq, nk), bool)
    for i in range(nq):
        for j in range(nk):
            out[i, j] = live[i * bq:(i + 1) * bq, j * bk:(j + 1) * bk].any()
    return out


@pytest.mark.parametrize("bk", [64, 128])
@pytest.mark.parametrize("bq", [64, 128])
@pytest.mark.parametrize("short_kv", [False, True])
@pytest.mark.parametrize("sq,skv", LENGTHS)
@pytest.mark.parametrize("causal", [True, False])
def test_live_kv_tiles_match_a_brute_force_mask(causal, sq, skv, short_kv,
                                                bq, bk):
    kv_len = max(1, (2 * skv) // 3) if short_kv else None
    want = _brute_live(sq, skv, bq, bk, causal, kv_len)
    counts = tf.live_kv_tiles(sq, skv, bq, bk, causal=causal, kv_len=kv_len)
    assert len(counts) == want.shape[0]
    for i, n in enumerate(counts):
        # live exactly on the first n tiles: a prefix, tile 0 always
        assert want[i, :n].all() and not want[i, n:].any()
        assert n >= 1
    assert counts == sorted(counts)          # a suffix of q-blocks per tile


def _dead_step(m, l, acc, v, bk):
    """The exact schedule's online-softmax step over a tile whose every
    score is masked."""
    s = torch.full((m.shape[0], bk), tf.NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.exp(s - m_new)
    alpha = torch.exp(m - m_new)
    return m_new, l * alpha + p.sum(dim=-1, keepdim=True), \
        acc * alpha + p @ v, p


@pytest.mark.parametrize("seed", range(4))
def test_a_dead_tile_step_changes_no_bit(seed):
    """p = exp(-1e30 - m) = 0 and alpha = exp(0) = 1 for every finite
    running max: the state comes through bit for bit (the exact kernel's
    case, and the amm kernel's float half)."""
    rng = np.random.default_rng(seed)
    rows, bk, d = 64, 128, 64
    m = torch.from_numpy(rng.normal(0, 30, (rows, 1)).astype(np.float32))
    l = torch.from_numpy(rng.uniform(1, 100, (rows, 1)).astype(np.float32))
    acc = torch.from_numpy(rng.normal(0, 5, (rows, d)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 3, (bk, d)).astype(np.float32))
    m2, l2, acc2, p = _dead_step(m, l, acc, v, bk)
    assert not p.any()
    assert torch.equal(m2, m) and torch.equal(l2, l)
    assert torch.equal(acc2, acc)


@pytest.mark.parametrize("wl,vbl", [(16, 13), (12, 7), (8, 5)])
def test_a_dead_tile_pv_product_is_zero_at_kind_0_only(wl, vbl):
    """A dead tile's P is 0: its codes are 0 at the quantizer's floor
    scale.  The kind-0 product of code 0 is 0, so the amm step's
    straight-through P V term is 0 and skipping is exact; kind 1
    subtracts each negative digit's sign bit before the truncating
    shift, (0 - 1) >> m = -1, so its product is not 0 and kind 1 must
    compute the tile."""
    rng = np.random.default_rng(wl)
    lim = 2 ** (wl - 1)
    p = torch.zeros((1, 128, 128))
    pc, sp = tf.quantize_blocks(p, wl)
    assert not pc.any() and float(sp) == np.float32(1e-12)
    vc = torch.from_numpy(rng.integers(-lim, lim, (1, 128, 64)).astype(
        np.int32))
    vmag, vneg = booth_precode(vc, wl)
    got = {kind: tb.dot_scaled_chunked(pc, vmag, vneg, wl=wl, vbl=vbl,
                                       kind=kind, f32_dots=True)
           for kind in (0, 1)}
    assert not got[0].any()
    assert bool((got[1] != 0).any())
    # each output: 2^vbl times minus the count of negative digits in the
    # truncated rows of its column of V's codes
    neg = vneg[:num_corr_rows(wl, vbl)].sum(dim=(0, 2)).to(torch.float32)
    assert torch.equal(got[1], -2.0 ** vbl * neg[:, None, :].expand_as(
        got[1]))


def _operands(b=1, h=2, s=300, d=16, seed=5):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal((b, h, s, d)).astype(
        np.float32)) for _ in range(3))


@pytest.mark.parametrize("causal,kv_len", [(True, None), (False, 140),
                                           (True, 200)])
def test_skipped_tiles_hold_the_defined_residuals(causal, kv_len):
    """At kind 0 every skipped tile's residuals are a dead tile's: score
    product ``DEAD_SCORE``, P codes 0, P scale 1e-12, P V product 0; the
    live tiles' are formed (some score product is not 0)."""
    q, k, v = _operands(s=300)
    ops = tf.flash_amm_operands(q, k, v, wl=16, bq=64, bk=64)
    if kv_len is not None:
        ops["skv"] = kv_len
    _, res = tf.flash_amm_plain(ops, wl=16, vbl=13, kind=0, causal=causal,
                                residuals=True)
    counts = tf.live_kv_tiles(320, 320, 64, 64, causal=causal,
                              kv_len=ops["skv"])
    dead = 0
    for i, n in enumerate(counts):
        rows = slice(i * 64, (i + 1) * 64)
        assert bool((res["s"][:, rows, :n * 64] != 0).any())
        for j in range(n, 5):
            cols = slice(j * 64, (j + 1) * 64)
            assert bool((res["s"][:, rows, cols] == tf.DEAD_SCORE).all())
            assert not res["pc"][:, rows, cols].any()
            assert not res["pv"][:, j, rows].any()
            assert bool((res["ps"][:, i, j] == np.float32(1e-12)).all())
            dead += 1
    assert dead > 0


def test_kind_1_computes_its_dead_tiles():
    """Kind 1 skips no tile: the P V residual of a tile dead under the
    causal mask is the nonzero product of code 0, the same as the kind-1
    product that ``dot_scaled_chunked`` forms for it."""
    q, k, v = _operands(s=256)
    ops = tf.flash_amm_operands(q, k, v, wl=16, bq=128, bk=128)
    _, res = tf.flash_amm_plain(ops, wl=16, vbl=13, kind=1, causal=True,
                                residuals=True)
    dead = res["pv"][:, 1, :128]             # q-block 0, KV tile 1
    assert bool((dead != 0).any())
    assert not res["pc"][:, :128, 128:].any()
    vmag, vneg = booth_precode(ops["vc"][:, 128:256], 16)
    want = tb.dot_scaled_chunked(torch.zeros((2, 128, 128),
                                             dtype=torch.int32),
                                 vmag, vneg, wl=16, vbl=13, kind=1,
                                 f32_dots=True)
    scale = np.float32(1e-12) * ops["vs"][:, 1, None, None]
    assert torch.equal(dead, want * scale)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 128), (64, 128)])
@pytest.mark.parametrize("sq,skv", [(200, 200), (200, 77), (77, 200)])
def test_exact_plain_matches_the_reference_at_its_tiles(sq, skv, bq, bk):
    rng = np.random.default_rng(sq + skv + bq)
    q = rng.standard_normal((1, 2, sq, 32)).astype(np.float32)
    k = rng.standard_normal((1, 2, skv, 32)).astype(np.float32)
    v = rng.standard_normal((1, 2, skv, 32)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tf.flash_attention_plain(tq, tk, tv, causal=True, bq=bq, bk=bk)
    want = np.asarray(j_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), causal=True,
                                            bq=bq, bk=bk), np.float64)
    tol = tf.flash_tolerance(tq, tk, tv).numpy()
    assert (np.abs(got.numpy().astype(np.float64) - want) <= tol).all()


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tf32_round_rounds_to_nearest_with_ties_away():
    """The precision control's TF32 rounding: 10 mantissa bits kept, to
    nearest, a tie away from zero, as ``cvt.rna.tf32.f32``."""
    cs = _chip_smoke()
    ulp = 2.0 ** -10                           # TF32's step at [1, 2)
    x = np.array([1.0, 1 + ulp / 2, 1 + ulp / 2 - 2.0 ** -23,
                  1 + ulp / 2 + 2.0 ** -23, 1 + 1.5 * ulp, 3.0e-3,
                  2 - ulp / 4], np.float32)
    x = np.concatenate([x, -x])
    got = cs.tf32_round(torch, torch.from_numpy(x)).numpy()
    m, e = np.frexp(x.astype(np.float64))
    want = np.sign(m) * np.floor(np.abs(m) * 2 ** 11 + 0.5) * 2.0 ** (e - 11)
    assert_array_equal(got, want.astype(np.float32))
    assert got[1] == 1 + ulp and got[8] == -(1 + ulp)


@pytest.mark.parametrize("d", [16, 64, 80, 128])
def test_precision_control_separates_f32_from_tf32_scores(d):
    """The separation ``chip_smoke.py``'s precision control relies on,
    with the plain version on the CPU: 16 times its f32 error against
    float64 attention stays below the error of every lower-precision
    score product it holds the kernel apart from, and, at the head dims
    whose kernel forms P V in 3xTF32 (80, 128), below the error of a P V
    that lost its low TF32 part (V or P rounded by ``tf32_round``)."""
    cs = _chip_smoke()
    q, k, v = _operands(b=1, h=2, s=200, d=d, seed=d)
    ref = cs.attention_f64(torch, q, k, v)
    err = lambda out: float((out.double() - ref).abs().max())  # noqa: E731
    limit = cs.PRECISION_FACTOR * err(
        tf.flash_attention_plain(q, k, v, causal=True))
    qt, kt = cs.tf32_round(torch, q), cs.tf32_round(torch, k)
    for a, b in ((qt, kt), (qt, k), (q, kt)):
        assert err(cs.attention_f64(torch, a, b, v)) > 4 * limit
    if d in (80, 128):
        vt = cs.tf32_round(torch, v)
        assert err(cs.attention_f64(torch, q, k, vt)) > 4 * limit
        assert err(cs.attention_f64_p_tf32(torch, q, k, v)) > 4 * limit
