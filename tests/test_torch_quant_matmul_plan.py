"""The launch plan and summation order of the port's ``quant_matmul``.

The CUDA kernel (``csrc/quant_matmul.cu``) sums each output in the order
``quant_matmul_plan`` describes: K slabs that never cross a K chunk
(decode route: a cluster's ranks, each rank's rows cut at the chunk
boundaries; tiled route: 64-row stages of the whole chunks each rank
takes), a chunk's slabs added into its partial, the chunk partials added
in K order.  These tests hold the plan to that contract, and its plain
PyTorch emulation (``quant_matmul_emulated``) to the JAX package's oracle
and to the port's plain version on seeded numpy inputs: bit for bit at
wl 8 without noise (every chunk partial is then an integer below 2^24,
and ``quant_matmul_tolerance`` is zero), within that derived bound at
wl 12 and 16 with noise.  The tiled route's byte split of the codes
recombines to the exact integer dot product.  The
kernel itself runs only on the card (the ``cuda`` tests in
``tests/test_torch_isolation.py``).
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

pytest_plugins = ["port_first"]

t_qm = importlib.import_module("repro_torch.kernels.quant_matmul")
FORCE_DECODE, FORCE_TILED = 1 << 30, 0

# bbm0 at wl = 16, vbl = 13: the moments the served model injects
MU16, SIGMA16 = -18779.225471496582, 6859.595897768407

# (m, k, n, bk, max_decode_m): qwen2-0.5b's MLP products at decode and
# prefill, each route forced at the other's shapes, odd chunkings
PLANS = [(8, 896, 4864, 512, None), (8, 4864, 896, 512, None),
         (1, 4864, 896, 512, None), (64, 896, 4864, 512, None),
         (256, 896, 4864, 512, None), (256, 4864, 896, 512, None),
         (32, 4864, 896, 512, FORCE_TILED), (2048, 896, 4864, 512, None),
         (256, 896, 4864, 512, FORCE_DECODE), (9, 300, 7, 32, None),
         (9, 300, 7, 32, FORCE_TILED), (3, 100, 5, 100, None),
         (130, 32768, 64, 32768, None), (7, 1, 3, 1, None),
         (17, 4864, 130, 512, FORCE_TILED), (1, 64, 130, 512, None)]


def _plan(m, k, n, bk, max_m):
    if max_m is None:
        return t_qm.quant_matmul_plan(m, k, n, bk)
    return t_qm.quant_matmul_plan(m, k, n, bk, max_m)


@pytest.mark.parametrize("m,k,n,bk,max_m", PLANS)
def test_slabs_tile_k_without_crossing_a_chunk(m, k, n, bk, max_m):
    plan = _plan(m, k, n, bk, max_m)
    bk = min(bk, k)
    for k0, k1, c, r in plan.slabs:
        assert c * bk <= k0 < k1 <= min((c + 1) * bk, k), (k0, k1, c)
        assert 0 <= r < plan.cluster
    spans = sorted((k0, k1) for k0, k1, _, _ in plan.slabs)
    assert spans[0][0] == 0 and spans[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    # each rank's slabs are one contiguous run of K, ranks in K order
    runs = {}
    for k0, k1, _, r in plan.slabs:
        runs.setdefault(r, []).append((k0, k1))
    firsts = [min(v)[0] for _, v in sorted(runs.items())]
    assert firsts == sorted(firsts)
    if plan.route == "decode":
        assert plan.grid[0] == plan.cluster <= 8 and plan.rows % 8 == 0
        for r, v in runs.items():
            assert min(v)[0] == r * plan.rows
            assert max(v)[1] == min((r + 1) * plan.rows, k)
        assert plan.grid[2] == -(-m // plan.mr) and plan.tn in (32, 64, 128)
        assert plan.smem <= t_qm.DECODE_SMEM
    else:
        assert plan.grid == (plan.cluster, -(-n // 64), -(-m // 128))
        chunks = {}
        for _, _, c, r in plan.slabs:
            chunks.setdefault(c, set()).add(r)
        assert all(len(rs) == 1 for rs in chunks.values())  # whole chunks
        assert plan.smem <= t_qm.SMEM_LIMIT


@pytest.mark.parametrize("m", [1, 8, t_qm.DECODE_MAX_M,
                               t_qm.DECODE_MAX_M + 1, 256, 2048])
def test_route_by_rows(m):
    """The decode route up to the threshold (row groups of at most 16),
    the tiled route above it, at qwen2-0.5b's gate/up product."""
    plan = t_qm.quant_matmul_plan(m, 896, 4864)
    if m <= t_qm.DECODE_MAX_M:
        assert plan.route == "decode"
        assert plan.mr == min(16, 1 << (m - 1).bit_length())
        assert plan.grid[2] * plan.mr >= m > (plan.grid[2] - 1) * plan.mr
    else:
        assert plan.route == "tiled" and plan.mr == 128


def test_decode_plan_fills_one_wave():
    """At the decode shapes the plan puts about one block on each SM."""
    for k, n in ((896, 4864), (4864, 896)):
        plan = t_qm.quant_matmul_plan(8, k, n)
        blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
        assert 0.8 * t_qm.SMS <= blocks <= t_qm.SMS


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (0.02 * rng.standard_normal((k, n))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


ROUTES = {"decode": FORCE_DECODE, "tiled": FORCE_TILED}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("k", [64, 896, 4864])
def test_emulation_bitwise_at_wl8(k, route):
    m, n = (8, 40) if route == "decode" else (20, 36)
    x, w = _inputs(m, k, n, seed=k)
    sx, sw = amm_scale(x, 8), amm_scale(w, 8)
    plan = t_qm.quant_matmul_plan(m, k, n, 512, ROUTES[route])
    assert plan.route == route
    got = t_qm.quant_matmul_emulated(x, w, sx, sw, 0.0, 0.0, wl=8, seed=1,
                                     plan=plan)
    assert not t_qm.quant_matmul_tolerance(x, w, sx, sw, 0.0, 0.0,
                                           wl=8).any()
    want = np.asarray(j_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            float(sx), float(sw), 0.0, 0.0, wl=8))
    assert_array_equal(got.numpy(), want)
    plain = t_qm.quant_matmul_plain(x, w, sx, sw, 0.0, 0.0, wl=8, seed=1,
                                    bm=128, bk=512, bn=128)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("k", [64, 896, 4864])
@pytest.mark.parametrize("wl,mu,sigma", [(12, -789.5, 358.486),
                                         (16, MU16, SIGMA16)])
def test_emulation_within_the_bound(wl, mu, sigma, k, route):
    m, n = (8, 40) if route == "decode" else (20, 36)
    x, w = _inputs(m, k, n, seed=k + wl)
    sx, sw = amm_scale(x, wl), amm_scale(w, wl)
    plan = t_qm.quant_matmul_plan(m, k, n, 512, ROUTES[route])
    tol = t_qm.quant_matmul_tolerance(x, w, sx, sw, mu, sigma, wl=wl)
    got = t_qm.quant_matmul_emulated(x, w, sx, sw, mu, sigma, wl=wl, seed=5,
                                     plan=plan)
    plain = t_qm.quant_matmul_plain(x, w, sx, sw, mu, sigma, wl=wl, seed=5,
                                    bm=128, bk=512, bn=128)
    assert bool(((got.double() - plain.double()).abs() <= tol).all())
    # without noise, against the JAX package's oracle
    quiet = t_qm.quant_matmul_emulated(x, w, sx, sw, 0.0, 0.0, wl=wl,
                                       seed=5, plan=plan)
    want = np.asarray(j_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            float(sx), float(sw), 0.0, 0.0, wl=wl))
    tol0 = t_qm.quant_matmul_tolerance(x, w, sx, sw, 0.0, 0.0, wl=wl)
    assert (np.abs(quiet.double().numpy() - want) <= tol0.numpy()).all()


@pytest.mark.parametrize("entry", ["plan", "wrapper"])
def test_a_chunk_past_the_int32_range_is_refused(entry):
    """The tiled route's int32 sums hold a chunk of at most 32,768 rows:
    the plan and the wrapper refuse a longer chunk (on any device), and
    a K above it in chunks of up to 32,768 rows is served."""
    k = t_qm.MAX_CHUNK + 8
    x, w = _inputs(2, k, 3, seed=7)
    sx, sw = amm_scale(x, 8), amm_scale(w, 8)
    with pytest.raises(ValueError, match="exceed"):
        if entry == "plan":
            t_qm.quant_matmul_plan(2, k, 3, k)
        else:
            t_qm.quant_matmul(x, w, sx, sw, wl=8, bk=k)
    if entry == "plan":
        plan = t_qm.quant_matmul_plan(2, k, 3, t_qm.MAX_CHUNK, FORCE_TILED)
        assert [c for _, _, c, _ in plan.slabs][-1] == 1
    else:
        got = t_qm.quant_matmul(x, w, sx, sw, wl=8, bk=t_qm.MAX_CHUNK)
        want = t_qm.quant_matmul_plain(x, w, sx, sw, 0.0, 0.0, wl=8, seed=0,
                                       bm=128, bk=t_qm.MAX_CHUNK, bn=128)
        assert torch.equal(got, want)


def _split(q):
    """The tiled route's split of a code: q = 256 hi + lo, hi = q >> 8 in
    [-128, 127] (its signed high byte), lo = q & 255 in [0, 255] (its
    unsigned low byte), as csrc/quant_matmul.cu's split4 forms them."""
    return q >> 8, q & 255


@pytest.mark.parametrize("kind", ["random", "extreme"])
def test_byte_split_recombines_to_the_exact_dot(kind):
    """q = 256 hi + lo with hi = q >> 8 signed and lo = q & 255 unsigned;
    over a 512-row chunk the four byte products stay inside int32 and
    recombine to the exact integer dot product of wl-16 codes."""
    rng = np.random.default_rng(11)
    shape_x, shape_w = (16, 512), (512, 8)
    if kind == "random":
        qx = rng.integers(-32768, 32768, shape_x)
        qw = rng.integers(-32768, 32768, shape_w)
    else:
        qx = rng.choice([-32768, -32767, 32767, -1, 0, 255, -256], shape_x)
        qw = rng.choice([-32768, -32767, 32767, -1, 0, 255, -256], shape_w)
        qx[0], qw[:, 0] = -32768, -32768       # the largest product sum
    qx, qw = torch.from_numpy(qx), torch.from_numpy(qw)
    xh, xl = _split(qx)
    wh, wl = _split(qw)
    assert bool(((xh >= -128) & (xh <= 127) & (xl >= 0) & (xl <= 255)).all())
    assert torch.equal(256 * xh + xl, qx)
    hh, hl, lh, ll = xh @ wh, xh @ wl, xl @ wh, xl @ wl
    for part in (hh, hl + lh, ll):
        assert int(part.abs().max()) < 2 ** 31
    assert torch.equal(hh * 2 ** 16 + (hl + lh) * 2 ** 8 + ll, qx @ qw)


def _amm_scale_two_pass(v, wl):
    """``amm_scale`` as it was written before its one-pass reduction."""
    lim = 2 ** (wl - 1) - 1
    vf = torch.as_tensor(v).to(torch.float32)
    return torch.clamp_min(torch.amax(torch.abs(vf)) * (1.0 / lim), 1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random", "zeros", "signed zeros", "inf",
                                  "-inf", "nan"])
def test_amm_scale_in_one_pass_is_the_two_pass_expression(case, dtype):
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((7, 33)).astype(np.float32))
    if case == "zeros":
        v = torch.zeros(5, 6)
    elif case == "signed zeros":
        v = torch.tensor([[-0.0, 0.0], [-0.0, -0.0]])
    elif case in ("inf", "-inf", "nan"):
        v[3, 5] = float(case)
    v = v.to(dtype)
    for wl in (8, 16):
        got, want = amm_scale(v, wl), _amm_scale_two_pass(v, wl)
        assert got.dtype == want.dtype == torch.float32
        assert torch.equal(got, want) or (case == "nan" and bool(
            torch.isnan(got)) and bool(torch.isnan(want)))
