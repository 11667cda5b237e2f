"""The flash kernels at head dims 80 and 128, on the CPU.

The kernels of ``csrc/flash_attention_wide.cuh`` run only on the card;
here, what the host decides and what the kernels' schedules compute:

* the exact kernel's P V route (3xTF32 from ``PV_3XTF32_MIN_SKV`` keys
  on, FFMA below, FFMA alone at head dims up to 64), and the error-model
  inequality that fixes that length;
* the amm kernel's route (the int8 tensor cores where ``bbm_dot_route``
  says "mma", at the wide head dims only);
* the tensor-core amm kernel's order over a contraction (32-deep slabs
  into two int32 sums, flushed once: every tensor-core operating point's
  chunk holds a whole tile), with the byte products ``bbm_mma_operands``
  forms, against the reference's chunked Broken-Booth product
  (``repro.kernels.bbm_matmul.dot_scaled_chunked``) bit for bit, for the
  score product (D = 80, 128) and P V (128 keys and a ragged tile);
* ``chip_smoke.py``'s bounds at grok-1's causal training shape, on both
  amm routes.

The kernel takes no host-side preparation beyond the codes: it decodes
K's and V's Booth planes itself, once per tile.
"""
from __future__ import annotations

import importlib
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

from repro_torch.kernels.booth_rows import amm_chunk_len, num_corr_rows

pytest_plugins = ["port_first"]

jb = importlib.import_module("repro.kernels.bbm_matmul")
jr = importlib.import_module("repro.kernels.booth_rows")
tb = importlib.import_module("repro_torch.kernels.bbm_matmul")
tf = importlib.import_module("repro_torch.kernels.flash_attention")

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

# (wl, vbl) on the tensor-core route: the main path's point, wl 12 and
# wl 8
POINTS = [(16, 13), (12, 7), (8, 5)]
# grok-1's causal training shape (4, 48, 512, 128): its live pairs
GROK_PAIRS = 4 * 48 * 512 * 513 // 2


def test_exact_route_rule():
    """3xTF32 P V at head dims 80 and 128 from ``PV_3XTF32_MIN_SKV`` keys
    on, FFMA below and at every head dim up to 64; ``chip_smoke.py``
    keeps the same length for its bounds."""
    assert tf.PV_3XTF32_MIN_SKV == chip_smoke.PV_3XTF32_MIN_SKV == 26
    for d in (16, 32, 64, 80, 128):
        for skv in (1, 20, 25, 26, 27, 32, 512, 1500):
            want = "tf32" if d in (80, 128) and skv >= 26 else "ffma"
            assert tf.flash_exact_route(d, skv) == want, (d, skv)


def test_pv_error_model_fixes_the_least_length():
    """The header's model of P V in 3xTF32: (30.04 + ceil(Skv / 8) +
    ceil(Skv / 32) - 2) u of the sum within flash_tolerance's (Skv + 8) u
    from 26 keys on, and not at 25."""
    def fits(skv):
        return 30.04 + math.ceil(skv / 8) + math.ceil(skv / 32) - 2 \
            <= skv + 8
    assert not fits(tf.PV_3XTF32_MIN_SKV - 1)
    assert all(fits(s) for s in range(tf.PV_3XTF32_MIN_SKV, 8193))


@pytest.mark.parametrize("kind", [0, 1])
def test_amm_route_rule(kind):
    """The tensor cores at head dims 80 and 128 wherever
    ``bbm_dot_route`` says "mma"; the CUDA cores elsewhere and at every
    head dim up to 64.  wl 16 / vbl 13 (the main path) takes the tensor
    cores, wl 16 / vbl 3 (chunks of 7) the CUDA cores."""
    for wl in range(2, 17, 2):
        for vbl in range(wl):
            rule = tb.bbm_dot_route(wl, vbl, kind)
            for d in (16, 32, 64, 80, 128):
                want = "mma" if d in (80, 128) and rule == "mma" else "tile"
                assert tf.flash_amm_route(d, wl, vbl, kind) == want
    assert tf.flash_amm_route(128, 16, 13, kind) == "mma"
    assert tf.flash_amm_route(128, 16, chip_smoke.HD_TILE_VBL, kind) \
        == "tile"


def test_tensor_core_chunks_hold_a_whole_tile():
    """Every operating point ``bbm_dot_route`` sends to the tensor cores
    has chunks of at least 511 products, more than a tile's product sums
    (D or bk <= 128): the kernel forms each product as one chunk, flushed
    once, and the route rule would take the CUDA cores for a shorter
    chunk."""
    for wl in range(2, 17, 2):
        for vbl in range(wl):
            for kind in (0, 1):
                if tb.bbm_dot_route(wl, vbl, kind) == "mma":
                    assert amm_chunk_len(wl, vbl) >= 511
                    assert tf.flash_amm_route(128, wl, vbl, kind) == "mma"


def _codes(m, k, n, wl, seed):
    rng = np.random.default_rng(seed)
    lim = 1 << (wl - 1)
    x = rng.integers(-lim, lim, (m, k)).astype(np.int32)
    w = rng.integers(-lim, lim, (k, n)).astype(np.int32)
    x[0], w[:, 0] = -lim, lim - 1
    return x, w


def _wrap(v):
    return (((v + 2 ** 31) % 2 ** 32) - 2 ** 31).to(torch.int64)


def _slabbed(x, w, *, wl, vbl, kind):
    """The tensor-core amm kernel's integer product of x (M, L) against
    the multiplier w (L, N) in its own order: slab by slab of 32 (the
    last ragged), the byte products into two int32 sums (lo, hi), wrapping
    as the kernel's do, then lo + 256 hi to f32 once, times 2^vbl."""
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ops = tb.bbm_mma_operands(xt, w=wt, wl=wl, vbl=vbl, kind=kind)
    part = [torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64)
            for _ in range(2)]
    for k0 in range(0, x.shape[1], 32):
        for a, b, sig in ops:
            part[sig] = _wrap(part[sig] + a[:, k0:k0 + 32] @ b[k0:k0 + 32])
    p = _wrap(part[0] + 256 * part[1])
    return p.to(torch.float32) * float(1 << vbl)


@pytest.mark.parametrize("wl,vbl", POINTS)
@pytest.mark.parametrize("kind", [0, 1])
@pytest.mark.parametrize("length", [80, 128, 100])
def test_windowed_products_equal_the_reference(wl, vbl, kind, length):
    """The score product (Q's codes against K^T over D = 80, 128) and P V
    (P's codes against V over a tile's 128 keys, or a ragged 100) on the
    kernel's order equal the reference's chunked product bit for bit."""
    x, w = _codes(16, length, 24, wl, seed=wl * 1000 + vbl * 10 + length)
    jm, jn = jr.booth_precode(jnp.asarray(w), wl)
    want = jb.dot_scaled_chunked(jnp.asarray(x), jm, jn, wl=wl, vbl=vbl,
                                 kind=kind)
    assert_array_equal(_slabbed(x, w, wl=wl, vbl=vbl, kind=kind).numpy(),
                       np.asarray(want))


def test_bound_at_grok1_on_both_routes():
    """``flash_bound_ms`` at grok-1's (4, 48, 512, 128) causal shape: the
    exact function's 3xTF32 operations (0.0782 ms); the amm function's
    Broken-Booth products as 34 int8 byte products a code product where
    ``bbm_dot_route`` says "mma" (0.2218 ms at kind 0, above its f32
    products' 0.1927; at kind 1 the 21 byte products fall below those),
    and as 1 + 3 R int32 instructions on the "tile" route (wl 16 / vbl
    3: R = 2)."""
    p, d = GROK_PAIRS, 128
    exact = chip_smoke.flash_bound_ms(p, d, 512)
    assert exact == pytest.approx(12 * p * d / 495e12 * 1e3, rel=1e-12)
    assert round(exact, 4) == 0.0782
    f32 = 4 * p * d / 67e12 * 1e3
    mma0 = chip_smoke.flash_bound_ms(p, d, 512, amm=(16, 13, 0))
    assert mma0 == pytest.approx(2 * 2 * p * d * 34 / 1979e12 * 1e3,
                                 rel=1e-12)
    assert round(mma0, 4) == 0.2218 and mma0 > f32
    mma1 = chip_smoke.flash_bound_ms(p, d, 512, amm=(16, 13, 1))
    assert mma1 == pytest.approx(f32, rel=1e-12) and round(f32, 4) == 0.1927
    rows = num_corr_rows(16, chip_smoke.HD_TILE_VBL)
    tile = chip_smoke.flash_bound_ms(p, d, 512,
                                     amm=(16, chip_smoke.HD_TILE_VBL, 0))
    assert rows == 2
    assert tile == pytest.approx(2 * p * d * (1 + 3 * rows) / (67e12 / 4)
                                 * 1e3, rel=1e-12)
    # the int32 count the tile route keeps, at the main path's point
    assert round(2 * p * d * (1 + 3 * num_corr_rows(16, 13))
                 / (67e12 / 4) * 1e3, 6) == 8.478253
