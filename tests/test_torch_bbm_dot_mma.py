"""The tensor-core route of the contracted dot form against the JAX package.

The int8 tensor-core kernel (``csrc/bbm_mma.cuh``) contracts each
truncated row's floor as byte products at one scale, two int32 sums per
chunk (``lo + 256 hi``).  ``bbm_dot_mma_emulated`` forms the same byte
operands, chunks and epilogues in plain PyTorch; here it must equal the
reference bit for bit: ``_dot_scaled`` and ``_matmul_dotform`` at shift
<= vbl (one int32 sum), ``dot_scaled_chunked`` and ``bbm_matmul_scaled``
with plane and accumulator faults (the chunked f32 datapath), at every
operating point the route takes in the tests' sweep, both kinds, ragged
shapes, envelope-edge codes, and K one below, at and one past a short
chunk.  Also: each byte split recombines to its integer within its byte
ranges, the route rule's table, and the bound ``chip_smoke.py`` charges.
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

from repro.core import faults as j_faults
from repro_torch.core import faults as t_faults
from repro_torch.kernels import booth_rows as t_rows

pytest_plugins = ["port_first"]

jb = importlib.import_module("repro.kernels.bbm_matmul")
jr = importlib.import_module("repro.kernels.booth_rows")
tb = importlib.import_module("repro_torch.kernels.bbm_matmul")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (wl, vbl) the tensor-core route takes: the issue's three points, and
# (16, 9), whose chunk of 511 products is short enough to cross
POINTS = [(8, 5), (12, 7), (16, 13), (16, 9)]
SHAPES = [(7, 40, 9), (3, 61, 1), (1, 33, 5)]
FAULTS = [dict(target="plane", model="flip", p=0.05, lane="all", seed=3),
          dict(target="plane", model="stuck0", p=0.2, lane="neg",
               rows="corr", seed=9),
          dict(target="acc", model="flip", p=0.25, bit=11, seed=7)]


def _codes(m, k, n, wl, seed=0):
    """Signed wl-bit codes with the envelope's edge codes +-2^(wl-1) - 1,
    -2^(wl-1) in the first rows and columns."""
    rng = np.random.default_rng(seed)
    lim = 1 << (wl - 1)
    x = rng.integers(-lim, lim, (m, k)).astype(np.int32)
    w = rng.integers(-lim, lim, (k, n)).astype(np.int32)
    x[0], x[-1] = -lim, lim - 1
    w[:, 0], w[:, -1] = -lim, lim - 1
    return x, w


def _planes(w, wl):
    jm, jn = jr.booth_precode(jnp.asarray(w), wl)
    return (jm, jn), (torch.from_numpy(np.asarray(jm)),
                      torch.from_numpy(np.asarray(jn)))


def _chunk_ks(wl, vbl):
    c = t_rows.amm_chunk_len(wl, vbl)
    return [c - 1, c, c + 1] if c < 1000 else [24, 61]


@pytest.mark.parametrize("wl,vbl", POINTS)
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_equals_dot_scaled(wl, vbl, kind, shape):
    """One chunk's int32 partial: ``lo + 256 hi`` == ``_dot_scaled``."""
    m, k, n = shape
    x, w = _codes(m, k, n, wl, seed=k)
    (jm, jn), (tm, tn) = _planes(w, wl)
    _, jx = jr.split_signed(jnp.asarray(x), wl)
    want = jb._dot_scaled(jx, jm, jn, wl=wl, vbl=vbl, kind=kind)
    got = tb.bbm_dot_mma_emulated(torch.from_numpy(x), wmag=tm, wneg=tn,
                                  wl=wl, vbl=vbl, kind=kind, shift=vbl)
    assert_array_equal(got.numpy(), np.asarray(want))
    from_codes = tb.bbm_dot_mma_emulated(torch.from_numpy(x),
                                         w=torch.from_numpy(w), wl=wl,
                                         vbl=vbl, kind=kind, shift=vbl)
    assert torch.equal(from_codes, got)


@pytest.mark.parametrize("wl,vbl", POINTS)
@pytest.mark.parametrize("kind", [0, 1])
def test_emulation_equals_dot_scaled_chunked(wl, vbl, kind):
    """The chunked f32 datapath, codes in, K across chunk boundaries."""
    for k in _chunk_ks(wl, vbl):
        x, w = _codes(5, k, 6, wl, seed=100 + k)
        (jm, jn), _ = _planes(w, wl)
        want = jb.dot_scaled_chunked(jnp.asarray(x), jm, jn, wl=wl, vbl=vbl,
                                     kind=kind)
        got = tb.bbm_dot_mma_emulated(torch.from_numpy(x),
                                      w=torch.from_numpy(w), wl=wl, vbl=vbl,
                                      kind=kind)
        assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"K={k}")


@pytest.mark.parametrize("wl,vbl", POINTS)
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("fault", FAULTS, ids=str)
def test_emulation_equals_faulted_bbm_matmul_scaled(wl, vbl, kind, fault):
    """Faulted planes in (packed into triplets as the kernel packs them),
    accumulator upsets per chunk: ``bbm_matmul_scaled(fault=)``."""
    jf, tf = j_faults.FaultSpec(**fault), t_faults.FaultSpec(**fault)
    for k in _chunk_ks(wl, vbl):
        x, w = _codes(6, k, 5, wl, seed=200 + k)
        (jm, jn), (tm, tn) = _planes(w, wl)
        want = jb.bbm_matmul_scaled(jnp.asarray(x), jm, jn, wl=wl, vbl=vbl,
                                    kind=kind, fault=jf)
        fm, fn = t_faults.apply_plane_faults(tm, tn, tf, vbl=vbl)
        got = tb.bbm_dot_mma_emulated(torch.from_numpy(x), wmag=fm,
                                      wneg=fn, wl=wl, vbl=vbl, kind=kind,
                                      fault=tf if tf.target == "acc"
                                      else None)
        assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"K={k}")


@pytest.mark.parametrize("wl,vbl", POINTS)
@pytest.mark.parametrize("kind", [0, 1])
def test_emulation_equals_matmul_dotform(wl, vbl, kind):
    """``bbm_matmul_dot``'s route: one int32 sum over K, << (vbl - shift),
    at every shift the envelope allows up to vbl."""
    x, w = _codes(7, 37, 9, wl, seed=wl * vbl)
    (jm, jn), (tm, tn) = _planes(w, wl)
    shifts = [s for s in range(vbl + 1)
              if 37 * 2 ** max(2 * wl - 1 - s, 0) < 2 ** 31]
    assert shifts
    for shift in shifts:
        want = jb._matmul_dotform(jnp.asarray(x), jm, jn, wl=wl, vbl=vbl,
                                  kind=kind, shift=shift)
        got = tb.bbm_dot_mma_emulated(torch.from_numpy(x), wmag=tm, wneg=tn,
                                      wl=wl, vbl=vbl, kind=kind, shift=shift)
        assert_array_equal(got.numpy(), np.asarray(want),
                           err_msg=f"shift={shift}")


@pytest.mark.parametrize("wl,vbl", POINTS)
@pytest.mark.parametrize("kind", [0, 1])
def test_byte_operands_recombine_to_each_product(wl, vbl, kind):
    """Every operand is a byte (u8 or s8 range), and per product the byte
    products recombine, 256^significance each, to the folded dot form
    ``x bq + sum_r ((d_r x - kind neg_r) >> m_r)`` of that product."""
    x, w = _codes(4, 6, 5, wl, seed=1)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    mag, neg = t_rows.booth_precode(tw, wl)
    ops = tb.bbm_mma_operands(tx, w=tw, wl=wl, vbl=vbl, kind=kind)
    total = torch.zeros((4, 6, 5), dtype=torch.int64)
    for a, b, sig in ops:
        for t in (a, b):
            assert int(t.min()) >= -128 and int(t.max()) <= 255
            assert int(t.min()) >= 0 or int(t.max()) <= 127   # one type
        assert sig in (0, 1)
        total += a[:, :, None] * b[None] * 256 ** sig
    _, xs = t_rows.split_signed(tx, wl)
    xs = xs[:, :, None].to(torch.int64)
    bq = t_rows.booth_high_value(mag, neg, wl=wl, vbl=vbl).to(torch.int64)
    q = t_rows.scaled_trunc_rows(xs, mag.to(torch.int64)[:, None],
                                 neg.to(torch.int64)[:, None], wl=wl,
                                 vbl=vbl, kind=kind)
    assert torch.equal(total, xs * bq[None] + q)


@pytest.mark.parametrize("bits", [4, 7, 8, 9, 12, 15])
def test_byte_split_recombines_to_the_integer(bits):
    """A value of ``bits`` + 1 signed bits splits into one s8, or a u8 low
    byte under an s8 high byte, and ``lo + 256 hi`` is the value."""
    v = torch.arange(-2 ** bits, 2 ** bits, dtype=torch.int64)
    nbytes = tb._byte_count(-2 ** bits, 2 ** bits - 1)
    assert nbytes == (1 if bits <= 7 else 2)
    parts = tb._split(v, nbytes)
    assert torch.equal(sum(p * 256 ** s for p, s in parts), v)
    for p, s in parts:
        lo, hi = (0, 255) if s == 0 and nbytes == 2 else (-128, 127)
        assert int(p.min()) >= lo and int(p.max()) <= hi


def test_route_rule_table():
    """The tensor cores where every chunk holds a 32-deep step, the bytes
    need two significances at most and (B1's dot twin) shift <= vbl; the
    CUDA-core tile elsewhere.  A pure function of its arguments."""
    assert tb.MMA_K_STEP == 32
    assert [t_rows.amm_chunk_len(*p) for p in ((16, 13), (12, 7), (8, 5),
                                               (16, 3), (16, 0))] == [
        8191, 32767, 2097151, 7, 1]
    for kind in (0, 1):
        for wl, vbl in ((16, 13), (12, 7), (8, 5)):
            assert tb.bbm_dot_route(wl, vbl, kind) == "mma"
            assert tb.bbm_dot_route(wl, vbl, kind, shift=vbl) == "mma"
            assert tb.bbm_dot_route(wl, vbl, kind, shift=0) == "mma"
            assert tb.bbm_dot_route(wl, vbl, kind, shift=vbl + 1) == "tile"
        for wl, vbl in ((16, 3), (16, 0)):
            assert tb.bbm_dot_route(wl, vbl, kind) == "tile"
    # a chunk of 511 rides the tensor cores; x and bq both two bytes at
    # (16, 7) (a chunk of 127) do not
    assert tb.bbm_dot_route(16, 9, 0) == "mma"
    assert tb.bbm_dot_route(16, 7, 0) == "tile"
    assert tb.mma_widths(16, 13) == (2, 1, (1, 1, 1, 2, 2, 2, 2))
    with pytest.raises(ValueError, match="kind"):
        tb.bbm_dot_route(16, 13, 2)


def test_forced_route_is_checked_on_any_device():
    """A route forced through the module's private hooks that the tensor
    cores cannot compute raises, on CPU tensors too; an unknown route
    raises; the plain version runs on the CPU whatever route is named.
    The public wrappers take no route: the rule alone picks it."""
    x = torch.zeros((3, 40), dtype=torch.int32)
    w = torch.zeros((40, 5), dtype=torch.int32)
    mag, neg = t_rows.booth_precode(w, 16)
    with pytest.raises(ValueError, match="third significance"):
        tb._bbm_dot_scaled_on("mma", x, w, wl=16, vbl=3, kind=0)
    with pytest.raises(ValueError, match="no contraction form"):
        tb._bbm_matmul_dot_on("mma", x, mag, neg, wl=16, vbl=13, shift=15)
    with pytest.raises(ValueError, match="unknown route"):
        tb._bbm_dot_planes_on("wgmma", x, mag, neg, wl=16, vbl=13, kind=0)
    for public in (tb.bbm_dot_scaled, tb.bbm_dot_planes, tb.bbm_matmul_dot):
        with pytest.raises(TypeError, match="route"):
            public(x, w, wl=16, vbl=13, kind=1, route="tile")
    before = (tb.bbm_dot_scaled.launches, tb.bbm_dot_scaled.mma_launches)
    for route in (None, "mma", "tile"):
        out = tb._bbm_dot_scaled_on(route, x, w, wl=16, vbl=13, kind=1)
        assert torch.equal(out, torch.zeros((3, 5)))
    assert torch.equal(tb.bbm_dot_scaled(x, w, wl=16, vbl=13, kind=1),
                       torch.zeros((3, 5)))
    assert (tb.bbm_dot_scaled.launches,
            tb.bbm_dot_scaled.mma_launches) == before


def test_bound_counts_the_contracted_dot_form():
    """``chip_smoke.py``'s bound of the contracted dot form: the fewest
    int8 byte products of its exact forms known, the floor split's 34 a
    code product at wl 16 / vbl 13 kind 0 and 21 at kind 1 (the
    reference's one-hot contraction takes 56 and 66), each the count of
    the byte operands ``bbm_mma_operands`` forms, at 2 operations each
    over 1,979 TOP/s: 0.307 and 0.189 ms at (2048, 896) x (896, 4864),
    against 0.016 ms of bytes (2-byte codes in, f32 out)."""
    assert chip_smoke.onehot_byte_products(16, 13, 0) == 56
    assert chip_smoke.onehot_byte_products(16, 13, 1) == 66
    assert chip_smoke.dot_byte_products(16, 13, 0) == 34
    assert chip_smoke.dot_byte_products(16, 13, 1) == 21
    x = torch.zeros((1, 1), dtype=torch.int32)
    for wl, vbl in POINTS:
        for kind in (0, 1):
            ops = tb.bbm_mma_operands(x, w=x, wl=wl, vbl=vbl, kind=kind)
            assert chip_smoke.floor_split_byte_products(wl, vbl, kind) \
                == len(ops)
            assert chip_smoke.dot_byte_products(wl, vbl, kind) == min(
                len(ops), chip_smoke.onehot_byte_products(wl, vbl, kind))
    for kind, ms in ((0, 0.307), (1, 0.189)):
        bound, by = chip_smoke.dot_scaled_bound_ms(2048, 896, 4864,
                                                   kind=kind)
        assert by == "operations" and round(bound, 3) == ms
    bytes_ms = (2 * (2048 * 896 + 896 * 4864) + 4 * 2048 * 4864) \
        / 3.35e12 * 1e3
    assert round(bytes_ms, 3) == 0.016


def test_decode_bounds_charge_codes_at_their_width():
    """At decode the dot form and the batched coded entry are bound by
    bytes, so a code is charged the bytes its width needs (2 at WL 16, 1
    at WL 8), not the int32 it is held in: (8, 896) x (896, 4864) moves
    2 (8 * 896 + 896 * 4864) + 4 * 8 * 4864 bytes, and the batched score
    product over 8 full slots of 48 positions (2 kv heads, 7 query heads,
    d 64) moves its q codes at 2 bytes, the int16 cache, the scales, the
    lengths and the f32 scores."""
    assert [chip_smoke.code_bytes(w) for w in (4, 8, 12, 16)] == [1, 1, 2, 2]
    for k, n in ((896, 4864), (4864, 896)):
        bound, by = chip_smoke.dot_scaled_bound_ms(8, k, n)
        want = (2 * (8 * k + k * n) + 4 * 8 * n) / 3.35e12 * 1e3
        assert by == "bytes" and bound == pytest.approx(want, rel=1e-12)
    ops = chip_smoke.coded_operands(torch, np.random.default_rng(0), "cpu",
                                    s=48, wl=16, kv_len=[48] * 8)
    nbytes = {"column": 2 * 16 * 7 * 64 + 4 * 16 + 2 * 768 * 64 + 4 * 48
              + 4 * 8 + 4 * 16 * 7 * 48,
              "kblock": 2 * 7 * 768 + 4 * 16 + 2 * 768 * 64 + 4 * 48
              + 4 * 8 + 4 * 16 * 7 * 64}
    for per, want in nbytes.items():
        bound, by = chip_smoke.coded_bound_ms(ops, per)
        assert by == "bytes"
        assert bound == pytest.approx(want / 3.35e12 * 1e3, rel=1e-12)
